"""Median over the traced rounds of the device ms a round of attention's
forward calls: each ``attention`` span's stream markers (every layer's
call of ``models/attention.py`` ``attention`` in local training and the
remat's recompute of it, the server's decode and any eager encode; not the
backward, and not an encode replayed from its CUDA graph, which records no
span), settled at the round's host sync and summed over the round
(histogram ``attention.device_ms``). None where the program has no such
span."""
import flb_spans


def read(run):
    return flb_spans.median_ms("attention.device_ms")
