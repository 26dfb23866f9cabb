"""Median over the traced rounds of the device ms of the round's server
phase: the ``server.aggregate`` span's stream markers, settled at the
round's host sync (histogram ``server.aggregate.device_ms``). None
without a CUDA device."""
import flb_spans


def read(run):
    return flb_spans.median_ms("server.aggregate.device_ms")
