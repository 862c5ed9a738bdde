"""The port stands alone: it imports without JAX and without the reference
package, no module of it names either, and its entry points run on the
card unless the caller asks for the CPU."""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

import repro_torch
from repro_torch.core import algorithms as TA
from repro_torch.core import graph as TG
from repro_torch.core.baseline import BaselineEngine
from repro_torch.core.engine import StructureAwareEngine

PKG = pathlib.Path(repro_torch.__file__).parent
ROOT = PKG.parents[1]
# leaves first: each module must import on its own, whatever came before
MODULES = sorted(
    ("repro_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
     for p in PKG.rglob("*.py") if p.name != "__init__.py"), reverse=True)


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_module_imports_jax_or_reference(path):
    roots = set(_imported_roots(ast.parse(path.read_text())))
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def test_chip_smoke_imports_no_jax():
    roots = set(_imported_roots(ast.parse(
        (ROOT / "chip_smoke.py").read_text())))
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def test_port_imports_with_jax_blocked():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            + "".join(f"import {m}\n" for m in MODULES)
            + "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_kernel_tile_is_the_layout_tile():
    from repro_torch.core.partition import TILE
    from repro_torch.kernels.block_sweep import TILE as KERNEL_TILE
    src = (PKG / "csrc" / "block_sweep.cu").read_text()
    assert KERNEL_TILE == TILE and f"#define TILE {TILE}" in src


def test_kernel_table_bits_are_the_source_bits():
    from repro_torch.kernels import block_sweep as kb
    src = (PKG / "csrc" / "block_sweep.cu").read_text()
    assert f"#define TINFO_RUNS {kb.TINFO_RUNS}" in src
    assert f"#define TINFO_COUNT {kb.TINFO_COUNT:#x}" in src
    assert f"#define TINFO_SORTED {kb.TINFO_SORTED:#x}" in src
    assert kb.TINFO_COUNT >= kb.TILE and kb.TILE <= 1 << kb.TINFO_RUNS
    assert f"#define SWEEP_WARPS {kb.SWEEP_WARPS}" in src
    assert f"#define MAX_SUB {kb.MAX_SUB}" in src
    assert f"#define MAX_SLOTS {kb.MAX_SLOTS}" in src
    assert f"#define MAX_BLOCK {kb.MAX_BLOCK}" in src
    assert f"#define MAX_LANES {kb.MAX_LANES}" in src


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = TG.powerlaw_graph(200, 3, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StructureAwareEngine(g, TA.pagerank())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BaselineEngine(g, TA.pagerank())
    from repro_torch import graph_service, quickstart, streaming_graph
    from repro_torch.stream import StreamingEngine
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart.main(["--n", "300"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingEngine(g, TA.pagerank())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        streaming_graph.main(["--n", "300"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graph_service.main(["--n", "300"])
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import model
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced", "--prompt-len", "8", "--gen", "2"])
    cfg = configs.reduced(configs.get("llama3p2_1b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.Model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(cfg, 1, 8)


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without a card the smoke script exits non-zero and prints no result
    line, both in the checkout and alone in an empty directory."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, alone)):
        out = subprocess.run([sys.executable, str(script)],
                             capture_output=True, text=True, cwd=cwd,
                             timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
