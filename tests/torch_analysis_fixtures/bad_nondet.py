"""RA004 fixture: torch's unseeded randomness in schedule-affecting code.

The module opts in by carrying a @deterministic contract (exactly how
ooc/prefetch.py is marked)."""
import torch

from repro_torch.analysis.contracts import deterministic


@deterministic
def rank_victims(psd):
    jitter = torch.rand(psd.shape)  # unseeded: run-dependent order
    return torch.argsort(psd + jitter * 1e-9, stable=True)


def pick_slate(rows):
    torch.manual_seed(0)  # the global seed, under everyone's feet
    return rows[torch.randint(0, rows.numel(), (4,))]


def seeded_slate(rows, gen):
    # a seeded generator is the sanctioned form: not flagged
    return rows[torch.randperm(rows.numel(), generator=gen)]
