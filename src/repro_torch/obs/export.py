"""Chrome-trace / Perfetto JSON export of a :class:`TraceRecorder`; port of
``repro.obs.export``.

Emits the Trace Event Format ``{"traceEvents": [...]}`` JSON object (the
format chrome://tracing and https://ui.perfetto.dev load directly): spans
as complete events (``"ph": "X"``, ``ts``/``dur`` in microseconds),
per-superstep counters as counter events (``"ph": "C"``; Perfetto plots
each ``args`` key as a series), instants as ``"ph": "i"``, plus one
metadata event naming the process.

:func:`validate` is the schema check that ``python -m repro_torch.obs
validate`` runs over exported payloads, so a field drift here fails loudly
instead of silently producing a file the viewers reject.
"""
from __future__ import annotations

import json

_PID = 1
_TID = 1
_VALID_PH = {"X", "C", "M", "i", "I"}


def to_chrome(recorder, meta: dict | None = None) -> dict:
    """Convert a recorder's ring buffer to a Chrome-trace JSON object."""
    events = [{"name": "process_name", "ph": "M", "pid": _PID, "tid": _TID,
               "args": {"name": "repro_torch"}}]
    for ev in recorder.events:
        base = {"name": ev["name"], "cat": ev.get("cat") or "default",
                "pid": _PID, "tid": _TID,
                "ts": round(ev["ts"] * 1e6, 3)}
        if ev["type"] == "span":
            events.append({**base, "ph": "X",
                           "dur": round(ev["dur"] * 1e6, 3),
                           "args": ev["args"]})
        elif ev["type"] == "counter":
            events.append({**base, "ph": "C", "args": ev["values"]})
        elif ev["type"] == "instant":
            events.append({**base, "ph": "i", "s": "t",
                           "args": ev["args"]})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"dropped_events": recorder.dropped,
                          **(meta or {})}}


def write(recorder, path: str, meta: dict | None = None) -> str:
    """Export ``recorder`` to ``path`` as Chrome-trace JSON; returns the
    path."""
    with open(path, "w") as f:
        json.dump(to_chrome(recorder, meta), f, indent=1)
    return path


def validate(payload: dict) -> list[str]:
    """Chrome-trace schema check. Returns a list of human-readable
    errors — empty means the payload is loadable by chrome://tracing /
    Perfetto. Checks the envelope, per-event required fields, phase
    codes, and numeric ts/dur/counter values."""
    errors: list[str] = []
    if not isinstance(payload, dict):
        return [f"payload is {type(payload).__name__}, expected object"]
    events = payload.get("traceEvents")
    if not isinstance(events, list):
        return ["missing or non-list 'traceEvents'"]
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _VALID_PH:
            errors.append(f"{where}: bad phase {ph!r}")
            continue
        if not isinstance(ev.get("name"), str):
            errors.append(f"{where}: missing string 'name'")
        for field in ("pid", "tid"):
            if not isinstance(ev.get(field), int):
                errors.append(f"{where}: missing int '{field}'")
        if ph == "M":
            continue  # metadata events carry no timestamp
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or isinstance(ts, bool) \
                or ts < 0:
            errors.append(f"{where}: bad 'ts' {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or isinstance(dur, bool) \
                    or dur < 0:
                errors.append(f"{where}: bad 'dur' {dur!r} on X event")
        if ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not args:
                errors.append(f"{where}: C event needs non-empty args")
            else:
                for k, v in args.items():
                    if not isinstance(v, (int, float)) \
                            or isinstance(v, bool):
                        errors.append(
                            f"{where}: counter '{k}' non-numeric {v!r}")
        if ph == "i" and ev.get("s", "t") not in ("g", "p", "t"):
            errors.append(f"{where}: bad instant scope {ev.get('s')!r}")
    return errors
