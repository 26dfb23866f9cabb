"""Median over the traced rounds of the device ms of the clients' 3SFC
encode: each ``client.encode`` span's stream markers, settled at the
round's host sync, summed over the round (histogram
``client.encode.device_ms``). None without a CUDA device."""
import flb_spans


def read(run):
    return flb_spans.median_ms("client.encode.device_ms")
