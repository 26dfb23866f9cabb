"""Kernel B1 (``fused_cosine_table``, the 3SFC encoder's ⟨a,b⟩, ‖a‖², ‖b‖²
over two f32 trees of d elements) against its bound: 8·d bytes read at
the card's HBM bandwidth over B1's mean device time a launch, in
percent."""
import math

import flb_peaks
import flb_trace


def tree_bytes(cell) -> float:
    d = sum(math.prod(shape) for _, shape, _ in
            cell.family.param_specs(cell.cfg))
    return 8.0 * d


def read(run):
    tr = run.get("trace")
    if not tr:
        return None
    secs, launches = flb_trace.kernel_time(tr, "fused_cosine_table")
    # the program's own count of the traced round's launches must agree
    if not launches or run["launches"]["fused_cosine"] != launches:
        return None
    return 100.0 * tree_bytes(run["cell"]) / flb_peaks.HBM_BW / (
        secs / launches)
