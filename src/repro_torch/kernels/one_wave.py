"""Grid and scratch of the one-launch reductions B5 (``sign_quant``) and B6
(``topk_mask``).

Each kernel streams one (n,) vector with a grid of at most one wave (as
many blocks as the card holds at once, from the occupancy API; past that
the grid strides) and draws a ticket per block from a word of scratch; B5
writes one partial per block into a slot of the scratch, which the block
that draws the last ticket sums in block order, and B6 carries its counts
in the ticket's word itself. So:

* ``grid_blocks(n, tile, wave)``: one block per ``tile`` elements, at most
  ``wave``. It depends on n and the card alone, never on timing, so the
  partials are summed in a fixed order and B5's scale is bitwise
  repeatable.
* ``Scratch``: per (device index, stream) ``wave + 1`` 64-bit words of
  zeros: a slot for each block of the largest grid, then the ticket's
  word. Every launch leaves them all at 0 again (the last block clears
  what it used). Made once and never inside a CUDA graph capture, so a
  captured launch keeps valid pointers and an eager one never finds the
  scratch unset.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch


def grid_blocks(n: int, tile: int, wave: int) -> int:
    """Blocks of the launch over n >= 1 elements: ``ceil(n / tile)``, at
    least 1 and at most ``wave``."""
    return max(1, min(-(-n // tile), wave))


class Scratch:
    """The slots and ticket word of one kernel, per (device index, stream).

    ``wave(device_index)`` gives the blocks of one wave on that device; it
    is read only when a stream's scratch is made, outside any capture."""

    def __init__(self, kernel: str, wave: Callable[[int], int]):
        self.kernel = kernel
        self.wave = wave
        self._made: Dict[Tuple[int, int], torch.Tensor] = {}

    def get(self, device: torch.device, stream: int) -> torch.Tensor:
        """The ``(wave + 1,)`` int64 words for launches on ``stream``: the
        slots ``[:-1]`` and the ticket's word ``[-1:]``; the grid of any
        launch is at most ``numel() - 1`` blocks."""
        key = (device.index, stream)
        got = self._made.get(key)
        if got is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"{self.kernel}: the first call on a stream is being "
                    f"captured into a CUDA graph; call it once on that "
                    f"stream before the capture, so that its scratch and "
                    f"ticket exist and are zero")
            got = torch.zeros(self.wave(device.index) + 1,
                              dtype=torch.int64, device=device)
            self._made[key] = got
        return got
