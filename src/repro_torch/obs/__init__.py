"""repro_torch.obs — structured observability: spans, meters, logs, endpoints.

``trace``  — low-overhead span recorder (spans tagged run/round/client/
             phase, each with its parent, in a bounded ring buffer) on the
             Unix-epoch ns clock that torch.profiler stamps its records
             with, with JSONL and Chrome/Perfetto trace-event export, the
             spans added to a profiler's own Chrome trace, and the
             cross-process merge used to line worker timelines up against
             the server's round windows (heartbeat-derived clock offsets).
``meters`` — one registry of counters/gauges/histograms absorbing the
             stack's scattered accounting (LinkStats bytes, fault buckets,
             retry counts, heartbeat RTT/liveness, the per-phase span
             times that ``Tracer.settle`` folds in) behind a point-in-time
             ``snapshot()`` that metrics files and HTTP endpoints render.
``http``   — a tiny threaded HTTP server exposing ``/healthz`` and
             ``/metrics`` (the registry snapshot as JSON).
``log``    — structured stderr logging with stable ``key=value`` context
             prefixes (``client``/``round``), so interleaved multi-process
             output stays attributable.

Spans are host intervals around dispatch, transport and checkpoint
boundaries and around the round's phases (``client.train``,
``client.encode``, ``server.aggregate``). A phase span opened with a CUDA
device also carries the device's times: two timing events on the stream,
settled at the round's host sync (``RoundEngine.run_block``, the socket
worker) into ``d0``/``d1`` on the same clock, with no device read of a
value and no extra sync. ``launch/train.py --profile`` captures the
device's own timeline via ``torch.profiler``; with ``--trace`` the spans
go into that file too. Model layers open spans of their own
(``layer_span``: ``mla.attention``, ``moe.routed``) and add device-side
counts (``layer_count``: ``moe.slots``, ``moe.slots.held.<j>``), both
silent with the tracer off and during a CUDA-graph capture.
"""
from repro_torch.obs.log import get_logger
from repro_torch.obs.meters import (Counter, Gauge, Histogram,
                                    MetricsRegistry, get_registry,
                                    set_registry)
from repro_torch.obs.trace import (Span, Tracer, add_to_chrome_trace,
                                   configure_tracer, get_tracer,
                                   layer_count, layer_span, merge_traces,
                                   now_ns, read_trace_jsonl, set_tracer,
                                   write_chrome_trace)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "Span",
           "Tracer", "add_to_chrome_trace", "configure_tracer",
           "get_logger", "get_registry", "get_tracer", "layer_count",
           "layer_span", "merge_traces",
           "now_ns", "read_trace_jsonl", "set_registry", "set_tracer",
           "write_chrome_trace"]
