"""Leaf tables: how kernels B1 (``fused_cosine``) and B2 (``ef_update``)
take a tree's leaves in place, in one launch per table.

A launch carries a table of at most ``TABLE`` segments by value, one per
non-empty leaf. Each segment gets ``segment_blocks(n)`` blocks, a function
of its length alone, and the launch's blocks are numbered segment after
segment: segment k owns blocks ``[first_block, first_block + blocks)``. A
block finds its segment by a binary search over ``first_block`` and walks
it in unrolled steps of ``ELEMS_PER_BLOCK`` elements (B1: 128 threads, 4
float4 loads of each operand per thread; B2: 256 threads, 2), striding by
the segment's block count. So the partition of the work, and with it the
order of B1's sums, is fixed by the leaf sizes: the same sizes give the
same plan, and the same inputs at the same alignment the same bits.

A tree of L non-empty leaves takes ``ceil(L / TABLE)`` launches; zero-size
leaves take no segment. Nothing here touches a device, so the CPU tests
reach all of it; each wrapper checks ``TABLE`` and ``ELEMS_PER_BLOCK``
against its CUDA source's constants when it loads the library.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Tuple

# segments per launch: B1's entry is 32 bytes and B2's 40, so a table of 64
# is 2,048 and 2,560 bytes of kernel parameters, under the classic 4 KB
TABLE = 64
# one unrolled step of a block, in elements
ELEMS_PER_BLOCK = 2048
# a segment's grid-stride cap, about four blocks per SM on an H100; a longer
# segment loops
MAX_SEG_BLOCKS = 512


class Launch(NamedTuple):
    """One launch: ``segments`` as (leaf index, first block, blocks), and
    the grid's block count."""
    segments: Tuple[Tuple[int, int, int], ...]
    blocks: int


def segment_blocks(n: int) -> int:
    """Blocks of a segment of ``n`` elements: one per unrolled step, at most
    ``MAX_SEG_BLOCKS``; 0 for an empty leaf."""
    if n <= 0:
        return 0
    return min(MAX_SEG_BLOCKS, -(-n // ELEMS_PER_BLOCK))


@functools.lru_cache(maxsize=256)
def _plan(sizes: Tuple[int, ...]) -> Tuple[Launch, ...]:
    launches = []
    segs, first = [], 0
    for leaf, n in enumerate(sizes):
        blocks = segment_blocks(n)
        if not blocks:
            continue
        segs.append((leaf, first, blocks))
        first += blocks
        if len(segs) == TABLE:
            launches.append(Launch(tuple(segs), first))
            segs, first = [], 0
    if segs:
        launches.append(Launch(tuple(segs), first))
    return tuple(launches)


def segment_plan(sizes: Sequence[int]) -> Tuple[Launch, ...]:
    """The launches for leaves of ``sizes`` elements, in leaf order, at most
    ``TABLE`` segments each; empty leaves are skipped, so an empty tree
    takes no launch."""
    return _plan(tuple(int(n) for n in sizes))
