"""RA003 fixture: a compiled function closes over a loop-varying Python
scalar — one compiled (or captured) function per distinct value (the i2
recompile hazard)."""
import torch


def run_batches(values):
    results = []
    for i2 in (4, 8, 16, 32):
        def superstep(v):
            # i2 is baked into the compiled graph: 4 compiles for 4 cadences
            return v * i2

        results.append(torch.compile(superstep)(values))
    return results
