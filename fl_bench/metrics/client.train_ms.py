"""Median over the traced rounds of the host ms a round spends in the
clients' local training: the program's ``client.train`` spans (one a
client, around ``local_train``), summed over the round (histogram
``client.train_ms``)."""
import flb_spans


def read(run):
    return flb_spans.median_ms("client.train_ms")
