"""``python -m repro_torch.obs`` — read exported Chrome-trace JSON in a
terminal; port of ``repro.obs.__main__``.

Subcommands:

  * ``render <trace.json>`` — text timeline of the recorded spans
    (indented by nesting, with a proportional position bar) plus a phase
    breakdown table (per span name: count, total ms, share of wall) and a
    superstep-counter summary. Load the same file into
    https://ui.perfetto.dev for the interactive view.
  * ``validate <trace.json>`` — run the Chrome-trace schema check
    (:func:`repro_torch.obs.export.validate`); exit 1 on any error.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs import export


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _spans(payload: dict) -> list[dict]:
    return [e for e in payload.get("traceEvents", [])
            if e.get("ph") == "X"]


def cmd_validate(args) -> int:
    payload = _load(args.trace)
    errors = export.validate(payload)
    for e in errors:
        print(f"INVALID: {e}")
    n = len(payload.get("traceEvents", []))
    print(f"{args.trace}: {n} events, "
          f"{'INVALID' if errors else 'valid chrome-trace JSON'}")
    return 1 if errors else 0


def _phase_table(spans: list[dict], wall_us: float) -> list[str]:
    agg: dict[tuple, list] = {}
    for e in spans:
        key = (e.get("cat", "default"), e["name"])
        a = agg.setdefault(key, [0, 0.0])
        a[0] += 1
        a[1] += float(e.get("dur", 0.0))
    lines = [f"{'phase':<28}{'count':>7}{'total_ms':>12}{'wall%':>8}"]
    for (cat, name), (cnt, tot) in sorted(agg.items(),
                                          key=lambda kv: -kv[1][1]):
        share = 100.0 * tot / wall_us if wall_us else 0.0
        lines.append(f"{cat + '/' + name:<28}{cnt:>7}"
                     f"{tot / 1e3:>12.2f}{share:>7.1f}%")
    return lines


def _timeline(spans: list[dict], width: int, limit: int) -> list[str]:
    t0 = min(e["ts"] for e in spans)
    t1 = max(e["ts"] + e.get("dur", 0.0) for e in spans)
    wall = max(t1 - t0, 1e-9)
    ordered = sorted(spans, key=lambda e: (e["ts"], -e.get("dur", 0.0)))
    dropped = 0
    if len(ordered) > limit:
        # keep the longest spans (they carry the structure), in ts order
        keep = set(id(e) for e in sorted(
            ordered, key=lambda e: -e.get("dur", 0.0))[:limit])
        dropped = len(ordered) - limit
        ordered = [e for e in ordered if id(e) in keep]
    out = []
    stack: list[float] = []  # open-span end times -> nesting depth
    for e in ordered:
        end = e["ts"] + e.get("dur", 0.0)
        while stack and e["ts"] >= stack[-1] - 1e-9:
            stack.pop()
        depth = len(stack)
        stack.append(end)
        at = int((e["ts"] - t0) / wall * width)
        ln = max(1, int(e.get("dur", 0.0) / wall * width))
        bar = " " * min(at, width - 1) + "#" * min(ln, width - at)
        label = ("  " * depth + e["name"])[:24]
        out.append(f"{label:<24}{e.get('dur', 0.0) / 1e3:>10.2f}ms "
                   f"|{bar:<{width}}|")
    if dropped:
        out.append(f"... {dropped} shorter span(s) omitted "
                   f"(--limit {limit})")
    return out


def _counter_summary(payload: dict) -> list[str]:
    counters = [e for e in payload.get("traceEvents", [])
                if e.get("ph") == "C"]
    if not counters:
        return []
    totals: dict[str, float] = {}
    for e in counters:
        for k, v in e.get("args", {}).items():
            totals[k] = totals.get(k, 0) + v
    lines = [f"superstep counters ({len(counters)} samples):"]
    for k in sorted(totals):
        if k in ("superstep", "psd_sum", "psd_max", "width"):
            continue  # positional/instantaneous series — sums are noise
        lines.append(f"  {k:<22}{int(totals[k]):>16,}")
    return lines


def cmd_render(args) -> int:
    payload = _load(args.trace)
    spans = _spans(payload)
    print(f"== {args.trace} ==")
    dropped = payload.get("otherData", {}).get("dropped_events", 0)
    if dropped:
        print(f"(ring buffer dropped {dropped} oldest events)")
    if not spans:
        print("no span events recorded")
    else:
        wall_us = (max(e["ts"] + e.get("dur", 0.0) for e in spans)
                   - min(e["ts"] for e in spans))
        print(f"wall: {wall_us / 1e3:.2f}ms across {len(spans)} spans")
        print()
        print("-- timeline " + "-" * (args.width + 24))
        for line in _timeline(spans, args.width, args.limit):
            print(line)
        print()
        print("-- phase breakdown " + "-" * 36)
        for line in _phase_table(spans, wall_us):
            print(line)
    summary = _counter_summary(payload)
    if summary:
        print()
        for line in summary:
            print(line)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs")
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("render", help="text timeline + phase breakdown")
    r.add_argument("trace", help="exported Chrome-trace JSON file")
    r.add_argument("--width", type=int, default=60,
                   help="timeline bar width (columns)")
    r.add_argument("--limit", type=int, default=60,
                   help="max spans shown in the timeline")
    r.set_defaults(fn=cmd_render)
    v = sub.add_parser("validate", help="Chrome-trace schema check")
    v.add_argument("trace")
    v.set_defaults(fn=cmd_validate)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
