"""The one-launch plan of kernels B5 (``sign_quant``) and B6 (``topk_mask``),
on the CPU: ``kernels/one_wave.py``'s grid and scratch, and the kernels'
index maps mirrored in numpy.

* The grid is a function of n and the wave alone, at least one block and at
  most one wave, and one block per tile below the wave.
* Mirrors of the two kernels' loops (B5: 8 consecutive elements per thread
  per step, the grid striding over steps; B6: one float4 per thread per
  step, coalesced across the block) visit every element of n exactly once,
  at lengths at ±1 of a step, of a tile and of a wave of a small stand-in
  wave that makes the grid stride.
* The scratch has a zeroed slot per block of the largest grid and then the
  ticket's word, is made once per (device, stream), and is never made
  while a CUDA graph is being captured; a stream whose scratch exists may
  be captured.
* The CUDA sources' block shapes are the Python plan's.

The kernels' numbers are held to their plain versions on the card by
``chip_smoke.py`` phase 11; their parity with the JAX package on the CPU is
in tests/test_torch_compressors.py.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, one_wave
from repro_torch.kernels import sign_quant as sq_mod
from repro_torch.kernels import topk_mask as tm_mod

torch.set_num_threads(2)

# a stand-in wave small enough that the mirrors stride
WAVE = 3


def lengths(tile: int, wave: int) -> list:
    return sorted({1, 2, 3, 4, 5, 15, 16, 17, tile - 1, tile, tile + 1,
                   wave * tile - 1, wave * tile, wave * tile + 1,
                   2 * wave * tile + 7})


@pytest.mark.parametrize("n", [1, 5, 4095, 4096, 4097, 199_210,
                               (1 << 22) + 5, 1 << 40])
@pytest.mark.parametrize("wave", [1, 132, 1056])
def test_grid_covers_n_in_at_most_a_wave(n, wave):
    tile = sq_mod.TILE
    blocks = one_wave.grid_blocks(n, tile, wave)
    assert blocks == one_wave.grid_blocks(n, tile, wave)
    assert 1 <= blocks <= wave
    if blocks < wave:
        # one block per tile: the last one holds the tail
        assert (blocks - 1) * tile < n <= blocks * tile


def b5_visits(n: int, blocks: int) -> np.ndarray:
    """How often the B5 kernel's loop visits each of the n elements."""
    steps = -(-n // sq_mod.STEP)
    stride = blocks * sq_mod.THREADS
    seen = np.zeros(n, np.int64)
    for first in range(stride):           # thread (b, t) = b * THREADS + t
        for c in range(first, steps, stride):
            e0 = c * sq_mod.STEP
            seen[e0:min(e0 + sq_mod.STEP, n)] += 1
    return seen


def b6_visits(n: int, blocks: int) -> np.ndarray:
    """How often the B6 kernel's loop visits each of the n elements."""
    slots = -(-n // 4)
    steps = -(-slots // tm_mod.THREADS)
    seen = np.zeros(n, np.int64)
    for b in range(blocks):
        for s in range(b, steps, blocks):
            j = s * tm_mod.THREADS + np.arange(tm_mod.THREADS)
            for i in range(4):
                seen[4 * j[4 * j + i < n] + i] += 1
    return seen


@pytest.mark.parametrize("n", lengths(sq_mod.TILE, WAVE))
def test_b5_loop_visits_every_element_once(n):
    blocks = one_wave.grid_blocks(n, sq_mod.TILE, WAVE)
    assert np.all(b5_visits(n, blocks) == 1)


@pytest.mark.parametrize("n", lengths(tm_mod.TILE, WAVE))
def test_b6_loop_visits_every_element_once(n):
    blocks = one_wave.grid_blocks(n, tm_mod.TILE, WAVE)
    assert np.all(b6_visits(n, blocks) == 1)


@pytest.mark.parametrize("mod", [sq_mod, tm_mod])
def test_scratch_holds_the_largest_grid(mod, monkeypatch):
    """A zeroed slot per block of a full wave, then the ticket's word; made
    once per (device, stream)."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    scratch = one_wave.Scratch(mod._SCRATCH.kernel, lambda index: 1056)
    cpu = torch.device("cpu")
    words = scratch.get(cpu, 7)
    assert words.dtype == torch.int64 and words.numel() == 1056 + 1
    assert not words.any()
    for n in (1, mod.TILE, 1056 * mod.TILE + 1, 1 << 40):
        assert one_wave.grid_blocks(n, mod.TILE, words.numel() - 1) <= 1056
    assert scratch.get(cpu, 7) is words
    assert scratch.get(cpu, 8) is not words


@pytest.mark.parametrize("mod", [sq_mod, tm_mod])
def test_first_call_on_a_stream_inside_a_capture_raises(mod, monkeypatch):
    """No scratch is made (and no wave read) while a CUDA graph is being
    captured; a stream whose scratch exists may be captured."""
    asked, capturing = [], [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    scratch = one_wave.Scratch(mod._SCRATCH.kernel,
                               lambda index: asked.append(index) or 4)
    cpu = torch.device("cpu")
    made = scratch.get(cpu, 1)
    capturing[0] = True
    with pytest.raises(RuntimeError, match="captured"):
        scratch.get(cpu, 2)
    assert scratch.get(cpu, 1) is made
    assert len(asked) == 1


def test_topk_mask_refuses_a_count_past_its_bits():
    """The count shares a 64-bit word with the ticket: 40 bits of it."""
    assert tm_mod.MAX_N == (1 << 40) - 1
    src = (_build.CSRC / "topk_mask.cu").read_text()
    assert _constant(src, "kCountBits") == 40


def _constant(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_sources_have_the_python_plan():
    sq = (_build.CSRC / "sign_quant.cu").read_text()
    tm = (_build.CSRC / "topk_mask.cu").read_text()
    assert (_constant(sq, "kThreads"), _constant(sq, "kStep")) == \
        (sq_mod.THREADS, sq_mod.STEP)
    assert _constant(tm, "kThreads") == tm_mod.THREADS
    assert sq_mod.TILE == sq_mod.THREADS * sq_mod.STEP
    assert tm_mod.TILE == tm_mod.THREADS * 4
    assert "constexpr int kTile = kThreads * 4;" in tm
    # one launch per call, through the shared PDL launch
    for src in (sq, tm):
        assert src.count("port::launch_pdl(") == 1
        assert "<<<" not in src
