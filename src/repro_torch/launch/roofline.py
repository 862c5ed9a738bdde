"""Roofline analysis of the dry run's counts; port of
``repro.launch.roofline`` with an NVIDIA H100 SXM's figures.

Hardware model (per GPU, NVIDIA's H100 SXM data sheet, dense rates at the
700 W limit): 989.4 TFLOP/s bf16, 3.35 TB/s HBM3; links below. Three
terms per (arch x shape x mesh) cell, from the dry run's per-device
quantities (``launch/dryrun.py``):

    compute    = flops_per_dev / peak_FLOPs
    memory     = bytes_per_dev / HBM_bw
    collective = collective_bytes_per_dev / link_bw

plus MODEL_FLOPS = 6 * N_active * D (train) or 2 * N_active * D (serve),
with the ideal attention work added, and the usefulness ratio
MODEL_FLOPS / counted FLOPs (catches remat / redundancy waste). These are
projections: counts of a program run on fake devices under data-sheet
rates, not times measured on a card.

The reference adds an analytic attention term to XLA's FLOPs and bytes
(``attention_addon``) because XLA's cost analysis counts the chunked
attention's loops once; the dry run here runs every chunk, so its counts
already hold that work and nothing is added to them. The same formula
stays inside MODEL_FLOPS as the ideal attention work.

Usage: python -m repro_torch.launch.roofline --in results/dryrun_torch.json
[--md out.md]
"""
from __future__ import annotations

import argparse
import json

PEAK_FLOPS = 989.4e12  # bf16 dense / GPU (H100 SXM data sheet)
HBM_BW = 3.35e12  # B/s / GPU (H100 SXM data sheet)
# B/s / GPU for the collectives. Every production mesh axis is 16 wide and
# so leaves an 8-GPU NVLink node: its traffic crosses InfiniBand, one NDR
# 400 Gb/s (50 GB/s) adapter per GPU in a DGX H100 (NVIDIA's DGX H100
# data sheet). Within a node NVLink 4 gives 450 GB/s per direction per
# GPU (18 links x 25 GB/s; H100 data sheet: 900 GB/s bidirectional).
LINK_BW = 50e9

SHAPE_TOKENS = {
    "train_4k": 4096 * 256,
    "prefill_32k": 32768 * 32,
    "decode_32k": 128,  # one token per sequence per step
    "long_500k": 1,
}
SHAPE_BS = {"train_4k": (256, 4096), "prefill_32k": (32, 32768),
            "decode_32k": (128, 1), "long_500k": (1, 1)}
ATTN_CHUNK = 512  # chunked_attention tile (models/attention.py)


def attention_addon(arch: str, shape: str, kind: str) -> tuple[float, float]:
    """The reference's analytic attention (flops, bytes), global: 2*B*S^2*
    Hq*Dh for q@k^T and the same for p@v, x0.5 causal, x4 for train under
    full remat; zero for decode and below S = 2048 (the loop-free paths).
    Here it enters MODEL_FLOPS only (module docstring)."""
    from repro_torch import configs
    if kind == "decode":
        return 0.0, 0.0
    cfg = configs.get(arch)
    if not cfg.has_attention:
        return 0.0, 0.0
    b, s = SHAPE_BS[shape]
    if s < 2048:
        return 0.0, 0.0
    hq, dh, hkv = cfg.num_heads, cfg.resolved_head_dim, cfg.num_kv_heads
    mult = 4.0 if kind == "train" else 1.0

    def one(s_q, s_k, causal):
        cf = 0.5 if causal else 1.0
        fl = 4.0 * b * s_q * s_k * hq * dh * cf
        nq = max(s_q // ATTN_CHUNK, 1)
        by = 2.0 * (2 * b * s_q * hq * dh
                    + nq * cf * 2 * b * s_k * hkv * dh)
        return fl, by

    fl, by = one(s, s, causal=True)
    if cfg.is_encdec:
        fe, be = one(s, s, causal=False)  # encoder self-attention
        fc, bc = one(s, s, causal=False)  # cross-attention
        fl, by = fl + fe + fc, by + be + bc
    layers = cfg.num_layers
    return mult * fl * layers, mult * by * layers


def analyze_cell(key: str, r: dict) -> dict | None:
    if r.get("status") != "ok":
        return None
    arch, shape, mesh = key.split("/")
    chips = r["devices"]
    kind = r.get("kind", "train" if shape.startswith("train") else
                 ("decode" if "decode" in shape or "long" in shape
                  else "prefill"))
    if arch == "graph_pagerank":
        attn_fl = 0.0
    else:
        attn_fl, _ = attention_addon(arch, shape, kind)
    flops_dev = r["flops"]
    bytes_dev = r["bytes_accessed"]
    t_compute = flops_dev / PEAK_FLOPS
    t_memory = bytes_dev / HBM_BW
    t_coll = r["collective_bytes"] / LINK_BW
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_coll}
    dominant = max(terms, key=terms.get)
    tokens = SHAPE_TOKENS.get(shape, 0)
    n_active = r.get("active_params", r.get("params", 0))
    mult = 6 if kind == "train" else 2
    # MODEL_FLOPS = 6/2 * N_active * D plus the inherent attention work
    model_flops = mult * n_active * tokens + \
        (attn_fl / (4.0 if kind == "train" else 1.0)) * \
        (3.0 if kind == "train" else 1.0)  # ideal = no remat recompute
    model_flops_dev = model_flops / chips
    t_ideal = model_flops_dev / PEAK_FLOPS
    t_bound = max(terms.values())
    return {
        "arch": arch, "shape": shape, "mesh": mesh, "chips": chips,
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll, "dominant": dominant,
        "model_flops": model_flops,
        "attn_flops_dev": attn_fl / chips,
        "useful_ratio": model_flops_dev / flops_dev if flops_dev else 0.0,
        "roofline_fraction": t_ideal / t_bound if t_bound else 0.0,
        "peak_gb": r.get("peak_bytes", 0) / 1e9,
        "arg_gb": r.get("argument_bytes", 0) / 1e9,
        "temp_gb": r.get("temp_bytes", 0) / 1e9,
    }


def bottleneck_hint(row: dict) -> str:
    d = row["dominant"]
    if d == "compute":
        if row["useful_ratio"] < 0.6:
            return ("compute-bound with low useful ratio: reduce remat "
                    "recompute / fuse the logits matmul")
        return ("compute-bound near-useful: raise tensor-core utilization "
                "(wgmma tile alignment, bf16 operands)")
    if d == "memory":
        return ("memory-bound: raise arithmetic intensity — larger "
                "microbatch, fuse elementwise chains into the products' "
                "epilogues, bf16 cache/params")
    return ("collective-bound: re-shard to cut resharding all-gathers, "
            "keep the widest axis inside the NVLink node, overlap "
            "collectives with compute")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--in", dest="inp", default="results/dryrun_torch.json")
    ap.add_argument("--md", default=None)
    ap.add_argument("--mesh", default="pod16x16",
                    help="mesh to tabulate (roofline table is single-pod)")
    args = ap.parse_args(argv)
    with open(args.inp) as f:
        results = json.load(f)

    rows = []
    skips = []
    for key in sorted(results):
        r = results[key]
        if r.get("status") == "skipped":
            skips.append((key, r["reason"]))
            continue
        if not key.endswith(args.mesh):
            continue
        row = analyze_cell(key, r)
        if row:
            rows.append(row)

    lines = [
        "Projections: the dry run's counts under H100 SXM data-sheet rates "
        f"({PEAK_FLOPS / 1e12:.1f} TFLOP/s bf16, {HBM_BW / 1e12:.2f} TB/s "
        f"HBM, {LINK_BW / 1e9:.0f} GB/s per GPU off the node), not "
        "measured times.",
        "",
        "| arch | shape | compute s | memory s | collective s | dominant "
        "| useful | roofline frac | peak GB/dev | what moves the needle |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_s']:.3e} | "
            f"{r['t_memory_s']:.3e} | {r['t_collective_s']:.3e} | "
            f"**{r['dominant']}** | {r['useful_ratio']:.2f} | "
            f"{r['roofline_fraction']:.2%} | {r['peak_gb']:.2f} | "
            f"{bottleneck_hint(r)} |")
    table = "\n".join(lines)
    print(table)
    if skips:
        print("\nSkipped cells:")
        for k, reason in skips:
            print(f"  - {k}: {reason}")
    if args.md:
        with open(args.md, "w") as f:
            f.write(table + "\n")
            if skips:
                f.write("\nSkipped cells:\n")
                for k, reason in skips:
                    f.write(f"- `{k}`: {reason}\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
