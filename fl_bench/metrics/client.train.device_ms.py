"""Median over the traced rounds of the device ms of the clients' local
training: each ``client.train`` span's stream markers, settled at the
round's host sync, summed over the round (histogram
``client.train.device_ms``). None without a CUDA device."""
import flb_spans


def read(run):
    return flb_spans.median_ms("client.train.device_ms")
