"""Repo-specific AST lint rules for ``src/repro_torch``; port of
``repro.analysis.lint``. On any file it gives the reference's findings,
and the torch forms below on top of them.

Rules (all stdlib ``ast``, no torch or numpy import — this layer must
run where neither is installed):

  RA001  host sync inside a superstep's code: ``.item()``,
         ``np.asarray``/``np.array``, ``jax.device_get``,
         ``float()``/``int()``/``bool()`` on a parameter, and the torch
         forms ``.cpu()``, ``.numpy()``, ``.tolist()``,
         ``torch.cuda.synchronize()``, ``.synchronize()`` on a stream or
         an event, and a tensor made from host data on a device
         (``torch.tensor``/``torch.as_tensor``/``torch.from_numpy`` with a
         ``device=`` other than ``"cpu"``, or moved by ``.to(...)``/
         ``.cuda()``: a blocking copy that waits for the stream, as the
         H100's ``set_sync_debug_mode("error")`` shows) — inside a
         function that is jitted, passed to a ``lax`` control-flow
         combinator, returned by a ``make_*`` factory (alone or in a
         tuple), returned by a ``@one_executable_per`` getter, compiled
         (``torch.compile``), captured (``torch.cuda.graph``,
         ``torch.cuda.make_graphed_callables``), or called by name from
         one. These either fail at trace or capture time or silently
         make the host wait for the device once per call.
  RA002  read after donation: a buffer passed through a
         ``donate_argnums`` position of a locally-built jit is dead; any
         later read before rebinding aliases freed device memory. Torch
         has no donation (the port updates in place instead), so the rule
         is the reference's, verbatim.
  RA003  loop-varying closure capture in a superstep's code: such a
         function capturing a name the enclosing function rebinds per loop
         iteration (``for`` target or ``+=``) is rebuilt (recompiled,
         recaptured) per distinct value — the i2 recompile hazard.
         Loop-invariant captures (width, floors, depths) are the intended
         idiom and are not flagged.
  RA004  nondeterminism in schedule-affecting code: clocks or unseeded
         randomness (``np.random``, ``random``, and torch's ``rand``,
         ``randn``, ``randint``, ``randperm`` without a ``generator=``,
         and ``torch.manual_seed``) in the scheduler/partition/prefetch
         modules (any module holding a ``@deterministic`` contract, plus a
         fixed list). The OOC tier's bitwise guarantee assumes ranking is
         a pure function of the activity state.

A finding can be suppressed with ``# lint: allow(RAxxx)`` on the line.
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

# Modules where RA004 applies even without a @deterministic marker: the
# schedule decisions and everything that predicts or ranks for them.
SCHEDULE_AFFECTING = (
    "core/schedule.py",
    "core/partition.py",
    "ooc/prefetch.py",
    "ooc/store.py",
)

# lax combinators -> positions of their traced callees
_CALLBACK_POSITIONS = {
    "while_loop": (0, 1),
    "fori_loop": (2,),
    "cond": (1, 2),
    "switch": None,  # every arg from 1 on is a branch callee
    "scan": (0,),
    "map": (0,),
    "associative_scan": (0,),
    "pallas_call": (0,),
    "checkpoint": (0,),
    "vmap": (0,),
    "pmap": (0,),
    "grad": (0,),
    "value_and_grad": (0,),
}

_HOST_SYNC_CALLS = {
    ("np", "asarray"), ("np", "array"), ("numpy", "asarray"),
    ("numpy", "array"), ("jax", "device_get"), ("onp", "asarray"),
}

_NONDET_PREFIXES = (
    ("time",), ("random",), ("np", "random"), ("numpy", "random"),
    ("os", "urandom"), ("uuid",),
)
_NONDET_SEEDED_OK = {"default_rng", "Generator", "SeedSequence"}

# torch: host tensors that become device tensors, the host reads of a
# tensor, the seeded-only samplers and the global seed
_TORCH_FROM_HOST = {("torch", "tensor"), ("torch", "as_tensor"),
                    ("torch", "from_numpy")}
_TORCH_HOST_READS = {"cpu", "numpy", "tolist"}
_TORCH_SAMPLERS = {("torch", "rand"), ("torch", "randn"),
                   ("torch", "randint"), ("torch", "randperm")}
# getters whose returned functions are superstep code, and the torch calls
# that compile or capture their callee
_GETTER_DECORATOR = "one_executable_per"
_TORCH_CAPTURE_CALLS = {("torch", "compile"),
                        ("torch", "cuda", "make_graphed_callables")}
_TORCH_GRAPH_CONTEXT = ("torch", "cuda", "graph")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    msg: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.msg}"


def _attr_chain(node: ast.AST) -> tuple[str, ...]:
    """``jax.lax.while_loop`` -> ("jax", "lax", "while_loop")."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    else:
        return ()
    return tuple(reversed(parts))


def _is_jit_expr(node: ast.AST) -> bool:
    """``jax.jit``/``jit``, or ``functools.partial(jax.jit, ...)``."""
    chain = _attr_chain(node)
    if chain and chain[-1] == "jit":
        return True
    if isinstance(node, ast.Call):
        fchain = _attr_chain(node.func)
        if fchain and fchain[-1] == "partial" and node.args:
            return _is_jit_expr(node.args[0])
    return False


def _is_capture_expr(node: ast.AST) -> bool:
    """``torch.compile`` (bare, or called with options as a decorator)
    or ``torch.cuda.make_graphed_callables``."""
    if isinstance(node, ast.Call):
        node = node.func
    return _attr_chain(node) in _TORCH_CAPTURE_CALLS


def _callee_exprs(call: ast.Call) -> list[ast.AST]:
    """Expressions holding traced callees for a jit/lax-combinator call,
    or a torch compile/capture call, or [] if this call introduces no
    trace roots."""
    if _is_jit_expr(call.func):
        # functools.partial(jax.jit, ...) is itself the wrapper — its
        # remaining args are jit options, not callees
        return list(call.args[:1])
    chain = _attr_chain(call.func)
    if chain in _TORCH_CAPTURE_CALLS:
        # torch.compile(fn, ...) / make_graphed_callables(fn or (fns), ...)
        first = call.args[:1]
        if first and isinstance(first[0], ast.Tuple):
            return list(first[0].elts)
        return list(first)
    if not chain:
        return []
    name = chain[-1]
    if name not in _CALLBACK_POSITIONS:
        return []
    if name == "switch":
        return list(call.args[1:])
    out = []
    for pos in _CALLBACK_POSITIONS[name]:
        if pos < len(call.args):
            out.append(call.args[pos])
    return out


def _unwrap_callee(expr: ast.AST) -> list[ast.AST]:
    """Resolve a callee expression to name/lambda nodes (IfExp branches,
    functools.partial first arg)."""
    if isinstance(expr, ast.IfExp):
        return _unwrap_callee(expr.body) + _unwrap_callee(expr.orelse)
    if isinstance(expr, ast.Call):
        chain = _attr_chain(expr.func)
        if chain and chain[-1] == "partial" and expr.args:
            return _unwrap_callee(expr.args[0])
        return []
    if isinstance(expr, (ast.Name, ast.Lambda)):
        return [expr]
    return []


_FuncNode = (ast.FunctionDef, ast.AsyncFunctionDef)


class _ModuleIndex:
    """Per-module maps: every function def, parentage, and name lookup."""

    def __init__(self, tree: ast.Module):
        self.defs: list[ast.AST] = []
        self.by_name: dict[str, list[ast.AST]] = {}
        self.parent_fn: dict[int, ast.AST | None] = {}

        def walk(node: ast.AST, fn: ast.AST | None) -> None:
            for child in ast.iter_child_nodes(node):
                nfn = fn
                if isinstance(child, _FuncNode):
                    self.defs.append(child)
                    self.by_name.setdefault(child.name, []).append(child)
                    self.parent_fn[id(child)] = fn
                    nfn = child
                elif isinstance(child, ast.Lambda):
                    self.defs.append(child)
                    self.parent_fn[id(child)] = fn
                    nfn = child
                walk(child, nfn)

        walk(tree, None)


def _trace_roots(tree: ast.Module, index: _ModuleIndex) -> set[int]:
    """Node ids of functions whose bodies are traced by jax: jit
    targets, lax-combinator callees, jit-decorated defs, functions
    returned by ``make_*`` factories — closed over same-module calls."""
    roots: set[int] = set()

    def mark(expr: ast.AST, scope_fn: ast.AST | None) -> None:
        for node in _unwrap_callee(expr):
            if isinstance(node, ast.Lambda):
                roots.add(id(node))
            elif isinstance(node, ast.Name):
                for d in index.by_name.get(node.id, []):
                    roots.add(id(d))

    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            for expr in _callee_exprs(node):
                mark(expr, None)
        if (isinstance(node, ast.With) and any(
                isinstance(item.context_expr, ast.Call)
                and _attr_chain(item.context_expr.func)
                == _TORCH_GRAPH_CONTEXT for item in node.items)):
            # torch.cuda.graph capture: every function called by name in
            # the captured block
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call):
                    mark(sub.func, None)
        if isinstance(node, _FuncNode):
            for deco in node.decorator_list:
                if _is_jit_expr(deco) or _is_capture_expr(deco) or (
                        isinstance(deco, ast.Call)
                        and _is_jit_expr(deco)):
                    roots.add(id(node))
            # trace factories: functions named make_* whose return value
            # is a locally-defined function (the engine idiom for
            # building traced closures: make_device_select), or a tuple
            # of them (the port's make_tiled_processor and
            # make_lane_processor return process_one, process_iterated);
            # and the torch counterpart of a compiled-function getter: the
            # functions a @one_executable_per getter returns (the chunk,
            # the sweeps of a width)
            getter = any(_attr_chain(d.func if isinstance(d, ast.Call)
                                     else d)[-1:] == (_GETTER_DECORATOR,)
                         for d in node.decorator_list)
            if node.name.startswith("make_") or getter:
                for sub in ast.walk(node):
                    if not isinstance(sub, ast.Return):
                        continue
                    value = sub.value
                    if isinstance(value, ast.Name):
                        names = [value]
                    elif isinstance(value, ast.Tuple):
                        names = [e for e in value.elts
                                 if isinstance(e, ast.Name)]
                    else:
                        names = []
                    for name in names:
                        for d in index.by_name.get(name.id, []):
                            roots.add(id(d))

    # fixpoint: a function called by name from a root body is traced too
    changed = True
    while changed:
        changed = False
        for d in list(index.defs):
            if id(d) not in roots:
                continue
            body = d.body if isinstance(d, _FuncNode) else [d.body]
            for stmt in body:
                for node in ast.walk(stmt):
                    if (isinstance(node, ast.Call)
                            and isinstance(node.func, ast.Name)):
                        for cd in index.by_name.get(node.func.id, []):
                            if id(cd) not in roots:
                                roots.add(id(cd))
                                changed = True
    return roots


def _allowed(source_lines: list[str], line: int, rule: str) -> bool:
    if 1 <= line <= len(source_lines):
        return f"lint: allow({rule})" in source_lines[line - 1]
    return False


def _check_host_sync(path: str, index: _ModuleIndex, roots: set[int],
                     lines: list[str]) -> list[Finding]:
    out = []
    for d in index.defs:
        if id(d) not in roots or not isinstance(d, _FuncNode):
            continue
        params = {a.arg for a in (d.args.args + d.args.kwonlyargs
                                  + d.args.posonlyargs)}
        for node in ast.walk(d):
            if not isinstance(node, ast.Call):
                continue
            msg = None
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr == "item" and not node.args):
                msg = ".item() forces a device->host sync"
            chain = _attr_chain(node.func)
            if chain in _HOST_SYNC_CALLS:
                msg = f"{'.'.join(chain)}() materializes on host"
            if chain and chain[-1] == "device_get":
                msg = "jax.device_get inside traced code"
            if (isinstance(node.func, ast.Name)
                    and node.func.id in ("float", "int", "bool")
                    and node.args
                    and isinstance(node.args[0], ast.Name)
                    and node.args[0].id in params):
                msg = (f"{node.func.id}() on traced parameter "
                       f"'{node.args[0].id}'")
            torch_msg = _torch_host_sync(node, chain)
            if torch_msg:
                msg = torch_msg
            if msg and not _allowed(lines, node.lineno, "RA001"):
                out.append(Finding("RA001", path, node.lineno,
                                   f"host sync in traced '{d.name}': "
                                   f"{msg}"))
    return out


def _from_host(call: ast.Call) -> bool:
    """``torch.tensor``/``as_tensor``/``from_numpy`` of host data."""
    return _attr_chain(call.func) in _TORCH_FROM_HOST


def _torch_host_sync(node: ast.Call, chain: tuple[str, ...]) -> str | None:
    """The torch host-sync forms of RA001, or None."""
    func = node.func
    if isinstance(func, ast.Attribute):
        if func.attr in _TORCH_HOST_READS and not node.args:
            return f".{func.attr}() reads the tensor back to the host"
        if func.attr == "synchronize":
            return (f"{'.'.join(chain) or '.synchronize'}() waits for the "
                    f"device")
        # a host tensor moved to a device: .to(<device>) / .cuda()
        if (func.attr in ("to", "cuda")
                and isinstance(func.value, ast.Call)
                and _from_host(func.value)
                and (func.attr == "cuda" or node.args or any(
                    kw.arg == "device" for kw in node.keywords))):
            return (f"a tensor made from host data and moved by "
                    f".{func.attr}(): a blocking copy that waits for the "
                    f"stream")
    if _from_host(node):
        for kw in node.keywords:
            if kw.arg == "device" and not (
                    isinstance(kw.value, ast.Constant)
                    and kw.value.value == "cpu"):
                return (f"{'.'.join(chain)}(..., device=...) of host "
                        f"data: a blocking copy that waits for the stream")
    return None


def _stmt_names(node: ast.AST, ctx: type) -> list[ast.Name]:
    return [n for n in ast.walk(node)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ctx)]


def _check_read_after_donate(path: str, index: _ModuleIndex,
                             lines: list[str]) -> list[Finding]:
    out = []
    for d in index.defs:
        if not isinstance(d, _FuncNode):
            continue
        # name -> donated positional indices, for jits built in this scope
        donmap: dict[str, tuple[int, ...]] = {}
        for node in ast.walk(d):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Call)
                    and _is_jit_expr(node.value.func)):
                positions: tuple[int, ...] = ()
                for kw in node.value.keywords:
                    if kw.arg == "donate_argnums":
                        if isinstance(kw.value, ast.Tuple):
                            elts = kw.value.elts
                        elif isinstance(kw.value, ast.Constant):
                            elts = [kw.value]
                        else:
                            elts = []  # computed (e.g. tuple(range(na)))
                        positions = tuple(
                            e.value for e in elts
                            if isinstance(e, ast.Constant)
                            and isinstance(e.value, int))
                        if not elts:
                            positions = ("*",)  # all positional args
                if positions:
                    donmap[node.targets[0].id] = positions
        if not donmap:
            continue

        dead: dict[str, int] = {}  # var -> donation line

        def scan(stmts: list[ast.stmt]) -> None:
            for stmt in stmts:
                # 1. reads of already-dead buffers
                for n in _stmt_names(stmt, ast.Load):
                    if n.id in dead and not _allowed(
                            lines, n.lineno, "RA002"):
                        out.append(Finding(
                            "RA002", path, n.lineno,
                            f"'{n.id}' read after being donated at line "
                            f"{dead[n.id]} (buffer freed on device)"))
                        dead.pop(n.id)  # report once
                # 2. donations made by this statement
                for node in ast.walk(stmt):
                    if (isinstance(node, ast.Call)
                            and isinstance(node.func, ast.Name)
                            and node.func.id in donmap):
                        pos = donmap[node.func.id]
                        if pos == ("*",):
                            args = node.args
                        else:
                            args = [node.args[p] for p in pos
                                    if isinstance(p, int)
                                    and p < len(node.args)]
                        for a in args:
                            if isinstance(a, ast.Starred) and isinstance(
                                    a.value, ast.Name):
                                dead[a.value.id] = node.lineno
                            elif isinstance(a, ast.Name):
                                dead[a.id] = node.lineno
                # 3. rebinds revive
                for n in _stmt_names(stmt, ast.Store):
                    dead.pop(n.id, None)
                # recurse into compound bodies in order (branches are
                # treated sequentially — over-approximate but stable)
                for field in ("body", "orelse", "finalbody"):
                    sub = getattr(stmt, field, None)
                    if sub and isinstance(sub[0], ast.stmt):
                        scan(sub)
                for handler in getattr(stmt, "handlers", []) or []:
                    scan(handler.body)

        scan(d.body)
    return out


def _check_loop_closure(path: str, index: _ModuleIndex, roots: set[int],
                        lines: list[str]) -> list[Finding]:
    out = []
    for d in index.defs:
        if id(d) not in roots or not isinstance(d, _FuncNode):
            continue
        parent = index.parent_fn.get(id(d))
        if parent is None or not isinstance(parent, _FuncNode):
            continue
        # names bound in d (params + local stores) are not captures
        local = {a.arg for a in (d.args.args + d.args.kwonlyargs
                                 + d.args.posonlyargs)}
        local |= {n.id for n in _stmt_names(d, ast.Store)}
        # loop-varying names in the ENCLOSING function: for-targets and
        # augmented assignments outside d itself
        varying: dict[str, int] = {}
        for node in ast.walk(parent):
            if any(node is x for x in ast.walk(d)):
                continue
            if isinstance(node, (ast.For, ast.AsyncFor)):
                for n in _stmt_names(node.target, ast.Store):
                    varying[n.id] = node.lineno
            if isinstance(node, ast.AugAssign) and isinstance(
                    node.target, ast.Name):
                varying[node.target.id] = node.lineno
        for n in _stmt_names(d, ast.Load):
            if (n.id in varying and n.id not in local
                    and not _allowed(lines, n.lineno, "RA003")):
                out.append(Finding(
                    "RA003", path, n.lineno,
                    f"traced '{d.name}' captures loop-varying "
                    f"'{n.id}' (rebound at line {varying[n.id]} of "
                    f"'{parent.name}') — pass it as a traced argument "
                    f"or one executable compiles per value"))
                local.add(n.id)  # report once per name
    return out


def _check_nondeterminism(path: str, tree: ast.Module,
                          lines: list[str]) -> list[Finding]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        chain = _attr_chain(node.func)
        if not chain:
            continue
        if (chain == ("torch", "manual_seed") or (
                chain in _TORCH_SAMPLERS and not any(
                    kw.arg == "generator" for kw in node.keywords))):
            if not _allowed(lines, node.lineno, "RA004"):
                what = ("the global seed" if chain[-1] == "manual_seed"
                        else "unseeded (no generator=)")
                out.append(Finding(
                    "RA004", path, node.lineno,
                    f"'{'.'.join(chain)}' ({what}) in schedule-affecting "
                    f"module (ranking must be a pure function of "
                    f"activity state)"))
            continue
        for prefix in _NONDET_PREFIXES:
            if chain[:len(prefix)] == prefix and len(chain) > len(prefix) \
                    or chain == prefix:
                if chain[-1] in _NONDET_SEEDED_OK:
                    break
                if not _allowed(lines, node.lineno, "RA004"):
                    out.append(Finding(
                        "RA004", path, node.lineno,
                        f"'{'.'.join(chain)}' in schedule-affecting "
                        f"module (ranking must be a pure function of "
                        f"activity state)"))
                break
    return out


def _is_schedule_affecting(path: str, tree: ast.Module) -> bool:
    norm = path.replace("\\", "/")
    if any(norm.endswith(suffix) for suffix in SCHEDULE_AFFECTING):
        return True
    # any module with a @deterministic contract marker opts in
    for node in ast.walk(tree):
        if isinstance(node, _FuncNode):
            for deco in node.decorator_list:
                chain = _attr_chain(deco)
                if chain and chain[-1] == "deterministic":
                    return True
    return False


def lint_file(path: str | Path) -> list[Finding]:
    path = str(path)
    src = Path(path).read_text()
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [Finding("RA000", path, e.lineno or 0,
                        f"syntax error: {e.msg}")]
    lines = src.splitlines()
    index = _ModuleIndex(tree)
    roots = _trace_roots(tree, index)
    findings = []
    findings += _check_host_sync(path, index, roots, lines)
    findings += _check_read_after_donate(path, index, lines)
    findings += _check_loop_closure(path, index, roots, lines)
    if _is_schedule_affecting(path, tree):
        findings += _check_nondeterminism(path, tree, lines)
    return findings


def lint_paths(paths: list[str | Path]) -> list[Finding]:
    """Lint every ``.py`` file under the given files/directories."""
    files: list[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            files += sorted(f for f in p.rglob("*.py")
                            if "__pycache__" not in f.parts)
        else:
            files.append(p)
    findings: list[Finding] = []
    for f in files:
        findings += lint_file(f)
    return findings
