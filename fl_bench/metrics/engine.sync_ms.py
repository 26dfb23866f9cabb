"""Median over the traced rounds of the host ms the engine waits at a
round's end for the device: the program's ``engine.sync`` span (the
metrics' one fetch to the host; histogram ``engine.sync_ms``)."""
import flb_spans


def read(run):
    return flb_spans.median_ms("engine.sync_ms")
