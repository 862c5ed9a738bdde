"""The port's dry run (``repro_torch.launch.dryrun``), roofline and perf
runner on the CPU: the counterpart of tests/test_distributed.py's
``test_dryrun_plumbing_small_mesh`` (a (2, 2, 2) fake mesh, reduced
granite_moe_3b_a800m, a train and a decode cell with status ok, FLOPs and
peak bytes above zero, the graph cell's collectives above zero), the
FLOPs of a toy dense cell on a one-device mesh equal to the analytic
count of its products, the roofline's terms equal to the reference's on
the same result (its constants substituted, at sequence lengths where the
reference adds no attention term), and a perf variant written to a JSON.
The fake process group lives in subprocesses (one per group)."""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro.launch import roofline as JR
from repro_torch.launch import roofline as TR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))

TOY = """
import json
from repro_torch import configs
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.config import SHAPES, ShapeConfig
dr.fake_world(8)
dev = dr.fake_device()
SHAPES["t_train"] = ShapeConfig("t_train", 64, 8, "train")
SHAPES["t_dec"] = ShapeConfig("t_dec", 64, 8, "decode")
SHAPES["t_pre"] = ShapeConfig("t_pre", 64, 8, "prefill")
out = {}
mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), dev)
cfg = configs.reduced(configs.get("granite_moe_3b_a800m"))
for shp in ("t_train", "t_dec"):
    out[shp] = dr.lower_cell("granite_moe_3b_a800m", shp, mesh, "toy",
                             cfg=cfg)
out["graph"] = dr.lower_graph_cell(mesh, "toy", n=65536, block_size=4096,
                                   e_cap=8192)
one = make_mesh((1, 1), ("data", "model"), dev)
out["dense"] = dr.lower_cell("llama3p2_1b", "t_pre", one, "one",
                             cfg=configs.reduced(configs.get("llama3p2_1b")))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def toy():
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(TOY)],
                       capture_output=True, text=True, timeout=600,
                       cwd=ROOT, env=ENV)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_dryrun_plumbing_small_mesh(toy):
    for shp in ("t_train", "t_dec"):
        r = toy[shp]
        assert r["status"] == "ok", r
        assert r["flops"] > 0 and r["peak_bytes"] > 0
        assert r["devices"] == 8 and r["kind"] == shp[2:].replace(
            "dec", "decode")
        assert r["bytes_accessed"] > 0 and r["collective_bytes"] > 0
        assert r["peak_bytes"] >= r["argument_bytes"] > 0
    assert toy["t_train"]["num_microbatches"] == 1
    g = toy["graph"]
    assert g["status"] == "ok" and g["collective_bytes"] > 0
    # one sum and one max all-reduce over "data": (n,) and (P,) f32
    assert g["collectives"]["all-reduce"] == {"count": 2,
                                              "bytes": (65536 + 16) * 4}


def test_dryrun_flops_exact_on_a_toy_dense_cell(toy):
    """Reduced llama3p2_1b's prefill of 8 x 64 tokens on a one-device
    mesh: the counted FLOPs are its products' 2 M N K, exactly: per layer
    the q, k, v and o projections, the SwiGLU's three, the quadratic
    attention's two (S x S, masked, not halved), and the head at the last
    position only."""
    b, s = 8, 64
    d, hq, hkv, dh, f, v, layers = 64, 4, 2, 16, 128, 128, 2
    per_layer = (2 * b * s * d * (2 * hq * dh + 2 * hkv * dh)
                 + 2 * b * s * 3 * d * f + 2 * 2 * b * hq * s * s * dh)
    want = layers * per_layer + 2 * b * d * v
    r = toy["dense"]
    assert r["status"] == "ok" and r["devices"] == 1
    assert r["flops"] == want
    assert r["collective_bytes"] == 0


@pytest.mark.parametrize("key,kind", [
    ("llama3p2_1b/decode_32k/pod16x16", "decode"),
    ("granite_moe_3b_a800m/prefill_1k/pod16x16", "prefill"),
    ("qwen3_14b/train_1k/pod2x16x16", "train"),
    ("graph_pagerank/sweep/pod16x16", "graph")])
def test_analyze_cell_matches_reference(monkeypatch, key, kind):
    """The same result through both ``analyze_cell``s, the port's with the
    reference's TPU constants, at shapes where the reference's attention
    addon is 0 (decode, and S < 2048): every term and ratio equal."""
    for mod in (JR, TR):
        monkeypatch.setitem(mod.SHAPE_BS, "prefill_1k", (32, 1024))
        monkeypatch.setitem(mod.SHAPE_BS, "train_1k", (256, 1024))
        monkeypatch.setitem(mod.SHAPE_TOKENS, "prefill_1k", 32 * 1024)
        monkeypatch.setitem(mod.SHAPE_TOKENS, "train_1k", 256 * 1024)
    r = {"status": "ok", "devices": 256, "kind": kind, "flops": 3.5e12,
         "bytes_accessed": 2.5e11, "collective_bytes": 4.5e9,
         "params": 1.2e9, "active_params": 8.0e8, "peak_bytes": 7.0e9,
         "argument_bytes": 3.0e9, "temp_bytes": 4.0e9}
    if kind == "graph":
        r["kind"] = "prefill"
    want = JR.analyze_cell(key, r)
    h100 = TR.analyze_cell(key, r)
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(TR, name, getattr(JR, name))
    assert TR.analyze_cell(key, r) == want
    assert h100["t_compute_s"] == r["flops"] / 989.4e12
    assert h100["t_memory_s"] == r["bytes_accessed"] / 3.35e12


def test_roofline_table_prints_h100_projections(tmp_path, capsys):
    res = {"llama3p2_1b/decode_32k/pod16x16": {
        "status": "ok", "devices": 256, "kind": "decode", "flops": 3.4e9,
        "bytes_accessed": 1.2e10, "collective_bytes": 1.1e9,
        "params": 1237387264, "active_params": 1237387264,
        "peak_bytes": 3.0e9},
        "llama3p2_1b/long_500k/pod16x16": {"status": "skipped",
                                           "reason": "pure attention"}}
    path = tmp_path / "dry.json"
    path.write_text(json.dumps(res))
    assert TR.main(["--in", str(path), "--md", str(tmp_path / "t.md")]) == 0
    out = capsys.readouterr().out
    assert "Projections" in out and "989.4 TFLOP/s" in out
    assert "| llama3p2_1b | decode_32k |" in out
    assert "long_500k/pod16x16: pure attention" in out
    assert (tmp_path / "t.md").read_text().startswith("Projections")


def test_perf_variant_writes_json(tmp_path):
    out = tmp_path / "perf.json"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.perf", "--cell",
         "llama3p2_1b/decode_32k/pod16x16", "--name", "cast_once",
         "--set", "cast_weights_once=1", "--out", str(out),
         "--baseline-from", str(tmp_path / "none.json")],
        capture_output=True, text=True, timeout=600, cwd=ROOT, env=ENV)
    assert r.returncode == 0, r.stderr[-3000:]
    perf = json.loads(out.read_text())
    var = perf["llama3p2_1b/decode_32k/pod16x16"]["variants"]["cast_once"]
    assert var["override"] == {"cast_weights_once": 1}
    assert var["result"]["status"] == "ok"
    assert var["roofline"]["dominant"] in ("compute", "memory",
                                           "collective")
