"""CLI: ``python -m repro_torch.analysis [--check|--update-golden]``; port of
``python -m repro.analysis``.

``--check`` (the default) runs, in order:

  1. the bytecode guard — fail if ``__pycache__``/``.pyc`` files are
     git-tracked or staged (they are .gitignore'd; staging one is always
     an accident);
  2. the AST lint rules over ``src/repro_torch`` (or ``--paths``);
  3. contract discovery + run-time enforcement on ``--device`` (skippable
     with ``--no-trace`` for the pure-AST fast path, which imports neither
     torch nor numpy);
  4. the golden-op comparison (same torch version and device type only).

Exit status is the number of findings, capped at 1 — a clean tree exits
0. ``--update-golden`` regenerates ``golden_ops.json`` in place, recorded
on ``--device``. ``--extra-contracts mod[,mod...]`` imports extra modules
(e.g. a test fixture) before discovery so their decorated functions are
checked too. ``--device`` defaults to ``cuda``, like every entry point of
the port; ``--device cpu`` runs the checks on the plain versions.
"""
from __future__ import annotations

import argparse
import importlib
import subprocess
import sys
from pathlib import Path

from repro_torch.analysis import lint

REPO_SRC = Path(__file__).resolve().parents[2]  # .../src
DEFAULT_LINT_PATH = REPO_SRC / "repro_torch"


def bytecode_guard() -> list[lint.Finding]:
    """Fail if compiled bytecode is tracked or staged. Respects the
    repo's .gitignore by construction: ``git ls-files --cached`` lists
    exactly what git will commit."""
    try:
        out = subprocess.run(
            ["git", "ls-files", "--cached"],
            capture_output=True, text=True, timeout=30,
            cwd=REPO_SRC.parent, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return []  # not a git checkout (e.g. an installed wheel): no-op
    findings = []
    for line in out.splitlines():
        if line.endswith(".pyc") or "__pycache__" in line:
            findings.append(lint.Finding(
                "RA005", line, 0,
                "compiled bytecode is staged/tracked — `git rm --cached` "
                "it (the path is .gitignore'd)"))
    return findings


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument("--check", action="store_true", default=False,
                    help="run all layers (the default action)")
    ap.add_argument("--update-golden", action="store_true",
                    help="regenerate analysis/golden_ops.json")
    ap.add_argument("--paths", nargs="*", default=None,
                    help="files/dirs to lint (default: src/repro_torch)")
    ap.add_argument("--no-trace", action="store_true",
                    help="skip the run-time layers (pure-AST mode)")
    ap.add_argument("--extra-contracts", default=None,
                    help="comma-separated modules to import before "
                         "contract discovery (fixture hooks)")
    ap.add_argument("--device", default="cuda",
                    help="device of the run-time checks and the golden "
                         "ops (default: cuda; cpu runs the plain versions)")
    args = ap.parse_args(argv)

    if args.update_golden:
        from repro_torch.analysis import tracecheck
        from repro_torch.core.engine import resolve_device
        resolve_device(args.device)
        payload = tracecheck.write_golden(device=args.device)
        print(f"wrote {tracecheck.GOLDEN_PATH} "
              f"({len(payload['entries'])} entries, torch "
              f"{payload['torch_version']}, {payload['device']})")
        return 0

    findings = list(bytecode_guard())
    paths = args.paths if args.paths else [DEFAULT_LINT_PATH]
    findings += lint.lint_paths(paths)

    if not args.no_trace:
        import torch

        from repro_torch.analysis import contracts, tracecheck
        from repro_torch.core.engine import resolve_device
        resolve_device(args.device)
        discovered = contracts.discover()
        if args.extra_contracts:
            for mod in args.extra_contracts.split(","):
                importlib.import_module(mod.strip())
            discovered = contracts.registry()
        findings += tracecheck.check_contracts(discovered, args.device)
        golden_findings, status = tracecheck.check_golden(
            device=args.device)
        findings += golden_findings
        if status == "skipped":
            print(f"golden ops: SKIPPED (file recorded under another torch "
                  f"or device than {torch.__version__} on {args.device}; "
                  f"regenerate with --update-golden to re-arm)")
        else:
            print(f"golden ops: {status}")
        n_contracts = len(discovered)
    else:
        n_contracts = 0

    for f in findings:
        print(f)
    layers = "lint" if args.no_trace else (
        f"lint+trace ({n_contracts} contracts)")
    print(f"repro_torch.analysis: {len(findings)} finding(s) [{layers}]")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
