"""Median over the traced rounds of the device ms a round of the latent
attention's forward calls: each ``mla.attention`` span's stream markers
(every layer's call in local training and the remat's recompute of it,
the server's decode and any eager encode; not the backward, and not an
encode replayed from its CUDA graph, which records no span), settled at
the round's host sync and summed over the round (histogram
``mla.attention.device_ms``). None where the program has no such span."""
import flb_spans


def read(run):
    return flb_spans.median_ms("mla.attention.device_ms")
