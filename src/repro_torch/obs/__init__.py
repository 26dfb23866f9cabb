"""repro_torch.obs — structured observability: spans, meters, logs, endpoints.

``trace``  — low-overhead host-side span recorder (monotonic-clock spans
             tagged run/round/client/phase in a bounded ring buffer) with
             JSONL and Chrome/Perfetto trace-event export, plus the
             cross-process merge used to line worker timelines up against
             the server's round windows (heartbeat-derived clock offsets).
``meters`` — one registry of counters/gauges/histograms absorbing the
             stack's scattered accounting (LinkStats bytes, fault buckets,
             retry counts, heartbeat RTT/liveness) behind a point-in-time
             ``snapshot()`` that metrics files and HTTP endpoints render.
``http``   — a tiny threaded HTTP server exposing ``/healthz`` and
             ``/metrics`` (the registry snapshot as JSON).
``log``    — structured stderr logging with stable ``key=value`` context
             prefixes (``client``/``round``), so interleaved multi-process
             output stays attributable.

Everything here is HOST-side: spans wrap dispatch/transport/checkpoint
boundaries, never a device computation (use ``launch/train.py --profile``
to capture the device timeline via ``torch.profiler``).
"""
from repro_torch.obs.log import get_logger
from repro_torch.obs.meters import (Counter, Gauge, Histogram,
                                    MetricsRegistry, get_registry,
                                    set_registry)
from repro_torch.obs.trace import (Span, Tracer, configure_tracer,
                                   get_tracer, merge_traces,
                                   read_trace_jsonl, set_tracer,
                                   write_chrome_trace)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "Span",
           "Tracer", "configure_tracer", "get_logger", "get_registry",
           "get_tracer", "merge_traces", "read_trace_jsonl", "set_registry",
           "set_tracer", "write_chrome_trace"]
