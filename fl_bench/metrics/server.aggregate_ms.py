"""Median over the traced rounds of the host ms of the round's server
phase: the program's ``server.aggregate`` span (the messages through
the fused aggregate's backward, ``server_update`` and the update's norm;
histogram ``server.aggregate_ms``)."""
import flb_spans


def read(run):
    return flb_spans.median_ms("server.aggregate_ms")
