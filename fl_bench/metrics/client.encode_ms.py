"""Median over the traced rounds of the host ms a round spends in the
clients' 3SFC encode: the program's ``client.encode`` spans (one a
client, around the strategy's step: accumulate, the synthetic
grad-of-grad, B1, EF with B2), summed over the round (histogram
``client.encode_ms``)."""
import flb_spans


def read(run):
    return flb_spans.median_ms("client.encode_ms")
