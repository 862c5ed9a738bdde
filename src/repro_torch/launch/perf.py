"""Perf hillclimb runner: rerun a dry-run cell with a config variant and
record the roofline terms beside the baseline's; port of
``repro.launch.perf`` over ``repro_torch.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.perf \\
        --cell llama3p2_1b/decode_32k/pod16x16 \\
        --name cast_once --set cast_weights_once=1

Results go to results/perf_torch.json as
    {cell: {baseline: {...}, variants: {name: {override, result,
    roofline}}}}
(the baseline from ``--baseline-from``, the dry run's results file).
The terms are projections under H100 data-sheet rates
(``launch/roofline.py``).
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh, production_shape
from repro_torch.launch.roofline import analyze_cell


def parse_set(items):
    out = {}
    for it in items or []:
        k, v = it.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        out[k] = v
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True,
                    help="arch/shape/mesh, e.g. llama3p2_1b/decode_32k/"
                         "pod16x16")
    ap.add_argument("--name", required=True)
    ap.add_argument("--set", nargs="*", default=[])
    ap.add_argument("--out", default="results/perf_torch.json")
    ap.add_argument("--baseline-from", default="results/dryrun_torch.json")
    args = ap.parse_args(argv)

    arch, shape, mesh_name = args.cell.split("/")
    ps = production_shape(multi_pod=mesh_name == "pod2x16x16")
    dryrun.fake_world(512)
    mesh = make_mesh(ps.shape, ps.mesh_dim_names, dryrun.fake_device())
    override = parse_set(args.set)

    perf = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            perf = json.load(f)
    entry = perf.setdefault(args.cell, {"variants": {}})
    if "baseline" not in entry and os.path.exists(args.baseline_from):
        with open(args.baseline_from) as f:
            base = json.load(f).get(args.cell)
        if base:
            entry["baseline"] = {"result": base,
                                 "roofline": analyze_cell(args.cell, base)}

    print(f"[perf] {args.cell} variant={args.name} override={override}")
    res = dryrun.lower_cell(arch, shape, mesh, mesh_name,
                            cfg_override=override)
    entry["variants"][args.name] = {
        "override": override, "result": res,
        "roofline": (analyze_cell(args.cell, res)
                     if res.get("status") == "ok" else None)}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(perf, f, indent=1, sort_keys=True)

    if res.get("status") == "ok" and entry.get("baseline"):
        b = entry["baseline"]["roofline"]
        v = entry["variants"][args.name]["roofline"]
        for t in ("t_compute_s", "t_memory_s", "t_collective_s"):
            delta = (v[t] - b[t]) / b[t] * 100 if b[t] else float("nan")
            print(f"  {t}: {b[t]:.3e} -> {v[t]:.3e}  ({delta:+.1f}%)")
        print(f"  dominant: {b['dominant']} -> {v['dominant']}; "
              f"roofline frac {b['roofline_fraction']:.2%} -> "
              f"{v['roofline_fraction']:.2%}; peak GB "
              f"{b['peak_gb']:.2f} -> {v['peak_gb']:.2f}")
    else:
        print(f"  status: {res.get('status')} {res.get('error', '')}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
