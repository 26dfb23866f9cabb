"""The program's phase times a round, as its meter registry holds them.

With tracing on, the program's tracer (``repro_torch.obs``) folds each
block of rounds into the process's meter registry at the block's host
sync (``Tracer.settle`` in ``RoundEngine.run_block``): per span name one
observation a round of the host ms (histogram ``<span>_ms``) and, for a
span marked on the device, of the device ms (``<span>.device_ms``). A
reader takes the histogram's median over the traced rounds (the window's
and the profiled one) from ``snapshot()``, which creates no instrument.
A program without the histogram (or a run without the trace) reads None.
"""
from typing import Optional


def median_ms(histogram: str) -> Optional[float]:
    """The median observation of ``histogram`` in the program's registry,
    or None where it has none."""
    from repro_torch.obs import get_registry
    h = get_registry().snapshot()["histograms"].get(histogram)
    if not h or not h["count"]:
        return None
    return h["p50"]
