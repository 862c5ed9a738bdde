"""TC001/TC002 fixture: contract-decorated functions that violate their
contracts — a torch aux_fn that sorts across vertices (rank-normalized
degree: vertex i's aux depends on every other vertex), a numpy aux_fn that
normalizes by the mean, and an init whose values depend on the edge set.
Importing this module registers them with the port's contract registry
(the --extra-contracts hook)."""
import numpy as np
import torch

from repro_torch.analysis.contracts import elementwise, structure_independent


@elementwise
def aux_fn(out_deg, in_deg):
    # argsort couples every vertex: out[i] depends on the whole array
    order = torch.argsort(out_deg)
    rank = torch.empty_like(out_deg)
    rank[order] = torch.arange(out_deg.shape[0], dtype=out_deg.dtype)
    return rank + in_deg * 0


@elementwise
def aux_fn_host(out_deg, in_deg):
    # numpy host fn (probe path): normalizing by the mean couples vertices
    del in_deg
    return np.asarray(out_deg) / max(float(np.mean(out_deg)), 1e-9)


@structure_independent
def init(g):
    # init VALUES seeded from degrees: changes whenever the edge set does
    vals = 1.0 / np.maximum(g.out_deg, 1).astype(np.float32)
    aux = np.maximum(g.out_deg, 1).astype(np.float32)
    return vals, aux
