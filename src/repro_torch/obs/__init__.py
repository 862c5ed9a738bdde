"""Structure-aware observability: span tracing + superstep timelines; port
of ``repro.obs``.

Two halves:

  * device side — ``engine.run(trace=True)`` writes one row per superstep
    (counter deltas, dispatch width, retirements, PSD stats) into a device
    buffer of the chunk's span, read at the existing repartition-boundary
    read and surfaced as ``RunResult.timeline``;
  * host side — :class:`TraceRecorder` collects nested spans (``run``,
    ``chunk``, ``repartition``, ``ingest``, ``reconverge``, ``snapshot``,
    ``query_batch``) from engine/stream/serve into a ring buffer, exported
    as Chrome-trace/Perfetto JSON (:mod:`repro_torch.obs.export`) and
    rendered by ``python -m repro_torch.obs``.

Typical capture::

    from repro_torch.obs import trace, export
    with trace.recording() as rec:
        service.run_pending()          # spans auto-attach
    export.write(rec, "trace_serve.json")
"""
from repro_torch.obs.export import to_chrome, validate, write  # noqa: F401
from repro_torch.obs.trace import (  # noqa: F401
    TraceRecorder, current, install, recording, span, uninstall)
