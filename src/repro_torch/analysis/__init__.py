"""Static contract analysis for the port's engine; port of
``repro.analysis``.

Three layers, one CLI (``python -m repro_torch.analysis``):

  * :mod:`repro_torch.analysis.contracts` — machine-readable contract
    markers (``@elementwise``, ``@structure_independent``,
    ``@decision_identical``, ``@one_executable_per``,
    ``@deterministic``) and the registry ``discover()`` walks;
  * :mod:`repro_torch.analysis.lint` — repo-specific AST rules (host
    syncs inside a superstep's code, reads after donation, loop-varying
    closure captures, nondeterminism in schedule-affecting modules), with
    the torch forms of each;
  * :mod:`repro_torch.analysis.tracecheck` — enforcement of the
    registered contracts by running their targets under a torch dispatch
    mode, plus golden hashes of the aten op sequences of the entry points
    (``golden_ops.json``).

Import cost matters: this package is imported by the engine modules for
the decorators, so ``contracts`` and ``lint`` stay stdlib-only (neither
imports torch or numpy; ``tracecheck`` is only imported by the CLI and
tests).
"""
from repro_torch.analysis.contracts import (Contract, decision_identical,
                                            deterministic, discover,
                                            elementwise, one_executable_per,
                                            registry, structure_independent)

__all__ = ["Contract", "decision_identical", "deterministic", "discover",
           "elementwise", "one_executable_per", "registry",
           "structure_independent"]
