"""Pack tables: how kernel B3a (``pack_signs``) packs a tree's leaves into
one sign stream, reading them where they lie, in one launch per table.

Element ``i`` of the leaves taken in order (their concatenation, never
built) goes to word ``i // 32``, bit ``i % 32``. A launch owns a run of
whole words ``[first_word, first_word + words)`` and carries a table of at
most ``TABLE`` segments by value, one per leaf it reads: (leaf, the leaf's
first element in this launch, that element's stream position, count).
Words may take their bits from several leaves (a 200-element bias ends
mid-word), so a tree of more than ``TABLE`` non-empty leaves is split on a
word boundary, not on a leaf boundary: every word is written by exactly
one launch, and a leaf may be cut between two tables. Stream positions at
or past the last leaf's end, up to the last word's end, pack as +1 (the
reference pads with +1.0).

The kernel sizes its own grid (one wave at most, a warp per tile of words)
from a launch's word count. Nothing here touches a device, so the CPU tests
reach all of it; the wrapper checks ``TABLE`` against the CUDA source's
constant when it loads the library.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Tuple

# segments per launch: an entry is 24 bytes, so a table is 1,536 bytes of
# kernel parameters, under the classic 4 KB
TABLE = 64


class PackLaunch(NamedTuple):
    """One launch: its words, and ``segments`` as (leaf, leaf start, stream
    start, count) in stream order."""
    first_word: int
    words: int
    segments: Tuple[Tuple[int, int, int, int], ...]


@functools.lru_cache(maxsize=256)
def _plan(sizes: Tuple[int, ...]) -> Tuple[PackLaunch, ...]:
    segs, pos = [], 0
    for leaf, n in enumerate(sizes):
        if n > 0:
            segs.append((leaf, pos, n))
            pos += n
    d = pos
    launches = []
    begin = i = 0            # the launch's first position, a multiple of 32
    while i < len(segs):
        chunk = segs[i:i + TABLE]
        if i + TABLE >= len(segs):
            end = d
        else:
            # cut on the last word boundary of the table's last segment:
            # the TABLE segments cover at least 64 positions past `begin`,
            # so the launch owns at least two words
            _, start, n = chunk[-1]
            end = (start + n) // 32 * 32
        table = []
        for leaf, start, n in chunk:
            lo, hi = max(start, begin), min(start + n, end)
            if lo < hi:
                table.append((leaf, lo - start, lo, hi - lo))
        first = begin // 32
        words = -(-end // 32) - first
        launches.append(PackLaunch(first, words, tuple(table)))
        begin = end
        while i < len(segs) and segs[i][1] + segs[i][2] <= end:
            i += 1
    return tuple(launches)


def pack_plan(sizes: Sequence[int]) -> Tuple[PackLaunch, ...]:
    """The launches that pack leaves of ``sizes`` elements, in leaf order,
    at most ``TABLE`` segments each; empty leaves take no segment, so a
    tree of empty leaves takes no launch."""
    return _plan(tuple(int(n) for n in sizes))
