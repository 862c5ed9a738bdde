"""Contract markers: the engine's implicit invariants, machine-readable;
port of ``repro.analysis.contracts``.

Every contract that used to live only in a docstring gets a decorator
here. Decorating does two things: it stamps the function
(``fn.__contract__``) so readers and tools can see the contract at the
definition site, and it records a :class:`Contract` in a module-level
registry keyed by ``(kind, module, qualname)`` so
:mod:`repro_torch.analysis.tracecheck` can enumerate and *enforce* them.
Factory-built closures (``pagerank().aux_fn`` and friends) re-register on
every factory call — same key, latest target wins — which is exactly
what :func:`discover` exploits: it imports the contract-bearing modules
and instantiates each registered program family so the inner-function
contracts register with live targets.

This module must stay stdlib-only: it is imported by ``core``/``stream``
/``serve``/``ooc``/``kernels`` modules at definition time.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable

# Modules whose import (plus factory instantiation below) populates the
# registry. Order matters only for readability of reports.
CONTRACT_MODULES = (
    "repro_torch.core.algorithms",
    "repro_torch.core.schedule",
    "repro_torch.core.engine",
    "repro_torch.stream.engine",
    "repro_torch.serve.lanes",
    "repro_torch.ooc.prefetch",
    "repro_torch.kernels.block_sweep",
    "repro_torch.kernels._build",
)


@dataclasses.dataclass(frozen=True)
class Contract:
    kind: str  # elementwise | structure_independent | ...
    module: str
    qualname: str
    target: Callable = dataclasses.field(compare=False)
    meta: dict = dataclasses.field(default_factory=dict, compare=False)

    @property
    def key(self) -> tuple[str, str, str]:
        return (self.kind, self.module, self.qualname)

    def __str__(self) -> str:
        return f"{self.kind}: {self.module}:{self.qualname}"


_REGISTRY: dict[tuple[str, str, str], Contract] = {}


def _register(kind: str, fn: Callable, **meta: Any) -> None:
    c = Contract(kind=kind, module=fn.__module__, qualname=fn.__qualname__,
                 target=fn, meta=meta)
    _REGISTRY[c.key] = c


def registry() -> list[Contract]:
    """Current registry contents (whatever has been imported so far)."""
    return sorted(_REGISTRY.values(), key=lambda c: c.key)


def elementwise(fn: Callable | None = None, *,
                shapes: tuple | None = None) -> Callable:
    """``out[i]`` depends only on ``in[i]``: no cross-vertex (axis-0)
    gathers, scatters, reductions, sorts, or scans. The streaming engine
    leans on this to evaluate ``aux_fn`` on just the vertices whose
    degrees moved, and the sweeps lean on it for ``edge_map`` /
    ``sd_delta`` slicing.

    ``shapes`` optionally fixes the probe input shapes per argument (a
    tuple per array argument; the string ``"static"`` marks a plain Python
    scalar argument such as ``n_total``). Without it every argument is
    probed as a rank-1 vector.
    """
    def deco(f: Callable) -> Callable:
        f.__contract__ = "elementwise"
        _register("elementwise", f, shapes=shapes)
        return f
    return deco(fn) if fn is not None else deco


def structure_independent(fn: Callable) -> Callable:
    """Return VALUES are a function of ``n`` and program parameters only
    — never of the edge set. The streaming engine re-applies an
    epoch-time init snapshot to reset vertices instead of re-running init
    on the mutated graph, and serve lanes init over snapshots whose
    degrees are maintained incrementally; both are sound only under this
    contract. (The aux half of a ``VertexProgram.init`` result MAY depend
    on degrees — the contract covers element 0, the values.)"""
    fn.__contract__ = "structure_independent"
    _register("structure_independent", fn)
    return fn


def decision_identical(*, twin: Callable) -> Callable:
    """The decorated implementation makes bitwise the same decisions as
    ``twin`` (same picks, same order, same tie-breaks). This is the
    contract the out-of-core tier's bitwise guarantee hangs on: one host
    ``twin`` call predicts exactly what the device implementation will
    schedule."""
    def deco(fn: Callable) -> Callable:
        fn.__contract__ = "decision_identical"
        _register("decision_identical", fn, twin=twin)
        return fn
    return deco


def one_executable_per(*key: str) -> Callable:
    """The decorated getter returns ONE cached object per distinct ``key``
    tuple (e.g. ``("width", "trace_cap")``): repeat calls with the same
    key must return the identical object and must not grow the cache. In
    the port the object is a function the host enqueues (a chunk, the
    sweeps of a width, a row commit), a scratch, or a loaded kernel
    library; a per-call rebuild is the regression this guards against,
    and a CUDA graph captures one object per key."""
    def deco(fn: Callable) -> Callable:
        fn.__contract__ = "one_executable_per"
        _register("one_executable_per", fn, key=key)
        return fn
    return deco


def deterministic(fn: Callable) -> Callable:
    """Pure function of its inputs: stable orders, id tie-breaks, no
    clocks, no unseeded randomness. Marks the schedule-affecting ranking
    helpers; the lint layer's nondeterminism rule applies to every module
    containing one of these."""
    fn.__contract__ = "deterministic"
    _register("deterministic", fn)
    return fn


def discover() -> list[Contract]:
    """Import every contract-bearing module, instantiate the registered
    program factories so inner-function contracts register with live
    targets, and return the full registry."""
    for mod in CONTRACT_MODULES:
        importlib.import_module(mod)
    alg = importlib.import_module("repro_torch.core.algorithms")
    for factory in alg.REGISTRY.values():
        factory()
    for factory in alg.LANE_FAMILIES.values():
        factory()
    return registry()
