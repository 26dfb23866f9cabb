"""Front end over the port's kernels: flat and whole-tree forms.

* ``fused_cosine`` / ``cosine_similarity`` / ``optimal_scale`` — kernel B1
  (``kernels.fused_cosine``) on flat views of two tensors.
* ``tree_fused_stats(a, b)`` — ``(a·b, ‖a‖², ‖b‖²)`` over two whole trees,
  differentiable to any order (a ``torch.autograd.Function`` whose backward
  is written in torch ops).
* ``tree_ef_update(u, d, s)`` — the EF residual ``u − s·d`` over whole trees
  through kernel B2 (``kernels.ef_update``), never materializing ``s·d``.
* ``ssd_chunked`` / ``ssd_chunked_ad`` — the Mamba2 SSD scan with its
  intra-chunk step in kernel B4 (``kernels.ssd_chunk``), the contract of
  ``models.ssm.ssd_scan``; the inter-chunk recurrence stays outside.
* ``sign_quant`` — signSGD's int8 signs and mean |x| through kernel B5
  (``kernels.sign_quant``); ``topk_threshold`` + ``topk_mask`` — DGC's
  sampled threshold (``torch.topk`` over a strided sample) and the
  threshold select through kernel B6 (``kernels.topk_mask``). Each is one
  launch per call (``kernels/one_wave.py``: at most one wave of blocks, the
  block that draws the last ticket finishing the sum or the count on the
  device). Both kernels decide signs and thresholds with subnormals
  flushed, as the reference.

On a CUDA device both tree forms hand the raveled f32 leaves to the
kernels' leaf-table entries (``fused_cosine_leaves``, ``ef_update_leaves``;
``kernels/leaf_table.py``): one launch per table of up to 64 leaves, each
leaf read (and B2's output written) where it lies, so a call on the MLP's
6 leaves is one device kernel that moves only the kernel's own bytes. B1's
launches chain their triples inside the kernel; B2 writes every leaf into
one output buffer. On the CPU they keep the reference's route: lockstep
chunks of at most ``TREE_CHUNK_ELEMS`` elements, adjacent small leaves
concatenated (``torch.cat``) into one chunk and larger ones walked by
slices, each chunk one call of the plain version.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core.tree import PyTree, tree_flatten, tree_unflatten
from repro_torch.kernels import ef_update as _ef
from repro_torch.kernels import fused_cosine as _fc
from repro_torch.kernels import sign_quant as _sq
from repro_torch.kernels import ssd_chunk as _ssd
from repro_torch.kernels import topk_mask as _tm
from repro_torch.models import shard

# Per-chunk element budget for the tree-streaming reductions: 4 Mi elements
# = 16 MiB f32 per operand.
TREE_CHUNK_ELEMS = 1 << 22


def _ravel_f32(leaf: torch.Tensor) -> torch.Tensor:
    # each step only where it changes something: the main path's leaves are
    # contiguous f32 already, and every call here is host time per launch
    if leaf.dim() != 1:
        leaf = leaf.reshape(-1)
    if leaf.dtype != torch.float32:
        leaf = leaf.to(torch.float32)
    return leaf if leaf.is_contiguous() else leaf.contiguous()


def _cat(parts: List[torch.Tensor]) -> torch.Tensor:
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _check_lockstep(a_tree: PyTree, b_tree: PyTree) -> Tuple[list, list]:
    """Lockstep streaming would silently mis-pair trees whose structures or
    leaf shapes differ, so reject both loudly. Returns the two leaf lists."""
    a_leaves, a_def = tree_flatten(a_tree)
    b_leaves, b_def = tree_flatten(b_tree)
    if a_def != b_def:
        raise ValueError(
            f"lockstep tree mismatch: treedefs {a_def} vs {b_def}")
    a_shapes = [tuple(l.shape) for l in a_leaves]
    b_shapes = [tuple(l.shape) for l in b_leaves]
    if a_shapes != b_shapes:
        raise ValueError(
            f"lockstep tree mismatch: leaf shapes {a_shapes} vs {b_shapes}")
    return a_leaves, b_leaves


def _chunk_plan(sizes: Sequence[int],
                chunk_elems: int) -> List[List[Tuple[int, int, int]]]:
    """Chunking plan: a list of chunks, each a list of (leaf_idx, off, take).

    Small adjacent leaves are packed into one chunk, leaves larger than
    ``chunk_elems`` are walked by slices. The single source of truth for how
    the tree streamers below pack leaves.
    """
    plan: List[List[Tuple[int, int, int]]] = []
    cur: List[Tuple[int, int, int]] = []
    n = 0
    for i, size in enumerate(sizes):
        off = 0
        while size - off > 0:
            take = min(chunk_elems - n, size - off)
            cur.append((i, off, take))
            n += take
            off += take
            if n == chunk_elems:
                plan.append(cur)
                cur, n = [], 0
    if cur:
        plan.append(cur)
    return plan


def _gather_chunk(leaves_1d: List[torch.Tensor],
                  chunk: List[Tuple[int, int, int]]) -> torch.Tensor:
    parts = []
    for i, off, take in chunk:
        v = leaves_1d[i]
        parts.append(v if (off == 0 and take == v.numel())
                     else v[off:off + take])
    return _cat(parts)


# ---------------------------------------------------------------------------
# fused_cosine (B1)
# ---------------------------------------------------------------------------


def fused_cosine(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(3,) f32 = [x·y, ‖x‖², ‖y‖²] over flat views of x, y."""
    return _fc.fused_cosine(_ravel_f32(x), _ravel_f32(y))


def cosine_similarity(x: torch.Tensor, y: torch.Tensor,
                      eps: float = 1e-12) -> torch.Tensor:
    d, xx, yy = fused_cosine(x, y)
    return d / (torch.sqrt(xx) * torch.sqrt(yy) + eps)


def optimal_scale(target: torch.Tensor, direction: torch.Tensor,
                  eps: float = 1e-12) -> torch.Tensor:
    """3SFC Eq. 8: s = <target, dir> / ‖dir‖² in one pass."""
    d, _, yy = fused_cosine(target, direction)
    return d / (yy + eps)


def _on_card(leaves: Sequence[torch.Tensor]) -> bool:
    return bool(leaves) and leaves[0].device.type == "cuda"


def _stream_stats(a_leaves: Sequence[torch.Tensor],
                  b_leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    ra = [_ravel_f32(l) for l in a_leaves]
    rb = [_ravel_f32(l) for l in b_leaves]
    if _on_card(ra):
        return _fc.fused_cosine_leaves(ra, rb)
    total = None
    for chunk in _chunk_plan([v.numel() for v in ra], TREE_CHUNK_ELEMS):
        part = _fc.fused_cosine(_gather_chunk(ra, chunk),
                                _gather_chunk(rb, chunk))
        total = part if total is None else total + part
    if total is None:                # no elements at all
        device = ra[0].device if ra else torch.device("cpu")
        total = torch.zeros((3,), dtype=torch.float32, device=device)
    return total


class _TreeFusedStats(torch.autograd.Function):
    """Leaves arrive positionally as ``*a_leaves, *b_leaves`` (``apply``
    tracks only positional tensors); ``n_a`` splits them. The backward is
    plain torch ops on the saved inputs, so it is itself differentiable
    (grad-of-grad, as the reference's custom JVP allows)::

        ∂a = ct0·b + 2·ct1·a        ∂b = ct0·a + 2·ct2·b
    """

    @staticmethod
    def forward(ctx, n_a: int, *leaves: torch.Tensor) -> torch.Tensor:
        ctx.n_a = n_a
        ctx.save_for_backward(*leaves)
        return _stream_stats(leaves[:n_a], leaves[n_a:])

    @staticmethod
    def backward(ctx, ct: torch.Tensor):
        leaves = ctx.saved_tensors
        n_a = ctx.n_a
        a, b = leaves[:n_a], leaves[n_a:]
        need = ctx.needs_input_grad[1:]
        ga, gb = [], []
        for i, (ai, bi) in enumerate(zip(a, b)):
            af, bf = ai.to(torch.float32), bi.to(torch.float32)
            ga.append((ct[0] * bf + 2.0 * ct[1] * af).to(ai.dtype)
                      if need[i] else None)
            gb.append((ct[0] * af + 2.0 * ct[2] * bf).to(bi.dtype)
                      if need[n_a + i] else None)
        return (None, *ga, *gb)


def tree_fused_stats(a_tree: PyTree, b_tree: PyTree) -> torch.Tensor:
    """(3,) f32 = [a·b, ‖a‖², ‖b‖²] over whole trees.

    On the card one B1 launch per table of leaves, read in place; on the
    CPU one plain call per chunk of ``_chunk_plan``, the triples summed in
    f32 (see the module docstring). Mixed-dtype trees are cast to f32 leaf
    by leaf; a and b must share structure and leaf shapes (``ValueError``
    otherwise). ``DTensor`` leaves take the sharded route
    (``_sharded_stats``) and give a replicated ``DTensor`` triple.
    """
    a_leaves, b_leaves = _check_lockstep(a_tree, b_tree)
    if any(shard.is_dtensor(l) for l in a_leaves + b_leaves):
        return _sharded_stats(a_leaves, b_leaves)
    return _TreeFusedStats.apply(len(a_leaves), *a_leaves, *b_leaves)


def _sharded_stats(a_leaves: list, b_leaves: list) -> torch.Tensor:
    """The triple of ``DTensor`` leaves on one 1-D mesh: the ``Shard``
    leaves' local triple (the route of plain leaves: one B1 launch per
    table on the card) summed over the mesh by one differentiable
    all-reduce, then the ``Replicate`` leaves' triple added once. Each
    pair of leaves is placed alike."""
    from torch.distributed.tensor import Replicate, Shard
    _check_placed_alike(a_leaves, b_leaves)
    mesh = a_leaves[0].device_mesh
    groups = {True: ([], []), False: ([], [])}
    for a, b in zip(a_leaves, b_leaves):
        la, lb = groups[isinstance(a.placements[0], Shard)]
        la.append(shard.unwrap(a))
        lb.append(shard.unwrap(b))
    total = None
    for sharded in (True, False):
        la, lb = groups[sharded]
        if not la:
            continue
        t = _TreeFusedStats.apply(len(la), *la, *lb)
        t = (shard.reduce_partial(t, mesh) if sharded
             else shard.wrap(t, mesh, Replicate()))
        total = t if total is None else total + t
    return total


def _check_placed_alike(a_leaves: list, b_leaves: list) -> None:
    """Lockstep over shards pairs the right elements only when both trees'
    leaves are ``DTensor``s placed alike: reject anything else loudly."""
    for i, (a, b) in enumerate(zip(a_leaves, b_leaves)):
        if not (shard.is_dtensor(a) and shard.is_dtensor(b)
                and a.placements == b.placements):
            raise ValueError(
                f"sharded lockstep: leaf {i} placed as "
                f"{getattr(a, 'placements', 'plain')} and "
                f"{getattr(b, 'placements', 'plain')}")


# ---------------------------------------------------------------------------
# ef_update (B2)
# ---------------------------------------------------------------------------


def ef_update(u: torch.Tensor, d: torch.Tensor, s) -> torch.Tensor:
    """e' = u − s·d elementwise; returns u's shape, f32. ``s`` may be a
    tensor of one element (kept on the device) or a Python number."""
    uf, df = _ravel_f32(u), _ravel_f32(d)
    s = torch.as_tensor(s, dtype=torch.float32, device=uf.device).reshape(1)
    return _ef.ef_update(uf, df, s).reshape(u.shape)


def tree_ef_update(u_tree: PyTree, d_tree: PyTree, s, *,
                   out: Optional[PyTree] = None) -> PyTree:
    """EF residual e' = u − s·d over whole trees, one streaming pass.

    On the card one B2 launch per table of leaves, read and written in
    place (one output buffer); on the CPU the same lockstep chunks as
    ``tree_fused_stats``, concatenated, through the plain version and
    sliced back into leaves. Output leaves are f32 in u's shapes. Not
    differentiable. ``DTensor`` leaves (``u`` and ``d`` placed alike)
    run on this rank's shards and come back placed as ``u``.

    ``out``, a tree of contiguous f32 leaves in u's shapes (``u_tree``
    itself may be it: each element is read before it is written), takes
    the result instead of a new buffer and is returned; on the card B2
    writes it directly, on the CPU the plain route's result is copied in.
    Not for ``DTensor`` leaves.
    """
    u_leaves, d_leaves = _check_lockstep(u_tree, d_tree)
    _, treedef = tree_flatten(u_tree)
    if any(shard.is_dtensor(l) for l in u_leaves + d_leaves):
        if out is not None:
            raise NotImplementedError("tree_ef_update(out=) on DTensor "
                                      "leaves")
        return tree_unflatten(treedef, _sharded_ef_update(u_leaves, d_leaves,
                                                          s))
    ru = [_ravel_f32(l) for l in u_leaves]
    rd = [_ravel_f32(l) for l in d_leaves]
    if out is not None:
        o_leaves, _ = _check_lockstep(u_tree, out)
        for o in o_leaves:
            if o.dtype != torch.float32 or not o.is_contiguous():
                raise ValueError("tree_ef_update(out=) takes contiguous f32 "
                                 "leaves")
    if _on_card(ru):
        s = torch.as_tensor(s, dtype=torch.float32, device=ru[0].device)
        if out is not None:
            _ef.ef_update_leaves(ru, rd, s,
                                 out=[o.reshape(-1) for o in o_leaves])
            return out
        outs = _ef.ef_update_leaves(ru, rd, s)
        return tree_unflatten(treedef, [o.reshape(l.shape)
                                        for o, l in zip(outs, u_leaves)])
    pieces: List[List[torch.Tensor]] = [[] for _ in u_leaves]
    for chunk in _chunk_plan([v.numel() for v in ru], TREE_CHUNK_ELEMS):
        res = ef_update(_gather_chunk(ru, chunk), _gather_chunk(rd, chunk), s)
        pos = 0
        for i, off, take in chunk:
            pieces[i].append(res[pos:pos + take])
            pos += take
    new_leaves = [
        (_cat(ps) if ps else torch.zeros((0,), dtype=torch.float32,
                                         device=l.device)).reshape(l.shape)
        for ps, l in zip(pieces, u_leaves)
    ]
    if out is not None:
        for o, n in zip(o_leaves, new_leaves):
            o.copy_(n)
        return out
    return tree_unflatten(treedef, new_leaves)


def _sharded_ef_update(u_leaves: list, d_leaves: list, s) -> list:
    """``tree_ef_update`` on this rank's shards (one B2 launch per table
    on the card), each new leaf placed as its ``u`` leaf."""
    from torch.distributed.tensor import DTensor
    _check_placed_alike(u_leaves, d_leaves)
    new = tree_ef_update([u.to_local() for u in u_leaves],
                         [d.to_local() for d in d_leaves], shard.local(s))
    return [DTensor.from_local(n, u.device_mesh, u.placements,
                               run_check=False)
            for n, u in zip(new, u_leaves)]


# ---------------------------------------------------------------------------
# sign_quant (B5)
# ---------------------------------------------------------------------------


def sign_quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 signs of x's shape, scale = mean |x|), one B5 launch."""
    signs, scale = _sq.sign_quant(_ravel_f32(x))
    return signs.reshape(x.shape), scale


# ---------------------------------------------------------------------------
# topk_mask (B6, threshold select)
# ---------------------------------------------------------------------------


def topk_threshold(x: torch.Tensor, k: int, sample: int = 65536
                   ) -> torch.Tensor:
    """Sampled threshold estimate: |x| of the ~k-th largest (DGC-style), a
    0-d tensor on x's device. Exact for ``x.numel() <= sample``; else the
    top ``round(k·m/n)`` of every ``n // sample``-th element (m of them)."""
    v = torch.abs(x.reshape(-1))
    n = v.numel()
    if n <= sample:
        kk = max(1, min(k, n))
        return torch.topk(v, kk).values[-1]
    sub = v[:: n // sample][:sample]
    kk = max(1, min(int(round(k * sub.numel() / n)), sub.numel()))
    return torch.topk(sub, kk).values[-1]


def topk_mask(x: torch.Tensor, threshold) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """(masked f32 of x's shape, kept count), one B6 launch. ``threshold``
    may be a tensor of one element (kept on the device) or a Python
    number. The kernel floors τ at the reference's 1e-38 itself (see
    ``kernels.topk_mask``)."""
    xf = _ravel_f32(x)
    tau = torch.as_tensor(threshold, dtype=torch.float32, device=xf.device)
    out, cnt = _tm.topk_mask(xf, tau)
    return out.reshape(x.shape), cnt


# ---------------------------------------------------------------------------
# ssd_chunk (B4; used by models.ssm when use_pallas_ssd, oracle ssd_scan)
# ---------------------------------------------------------------------------


def ssd_chunked(xdt: torch.Tensor, dA: torch.Tensor, Bc: torch.Tensor,
                Cc: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same contract as ``models.ssm.ssd_scan``, with the intra-chunk math in
    kernel B4. xdt (b,s,h,p); dA (b,s,h); B, C (b,s,n); ``s`` must divide
    by ``min(chunk, s)``. Returns (y (b,s,h,p), final state (b,h,p,n)) in
    xdt's dtype; the kernel and the recurrence run in f32. ``DTensor``
    inputs run replicated, every head on every rank (``sharded_ssd``)."""
    if any(shard.is_dtensor(t) for t in (xdt, dA, Bc, Cc, h0)):
        return sharded_ssd(ssd_chunked, xdt, dA, Bc, Cc, chunk, h0)
    b, s, h, pdim = xdt.shape
    n = Bc.shape[-1]
    Q = min(chunk, s)
    if s % Q:
        raise ValueError(f"ssd_chunked needs the sequence ({s}) to divide by "
                         f"min(chunk, s) = {Q}; ssd_scan pads, this does not")
    nc = s // Q
    f32 = torch.float32
    # kernel layout: (b, h, nc, Q, ...)
    xk = torch.movedim(xdt.reshape(b, nc, Q, h, pdim), 3, 1)     # (b,h,nc,Q,P)
    dAk = torch.movedim(dA.reshape(b, nc, Q, h), 3, 1)           # (b,h,nc,Q)
    Bk = Bc.reshape(b, nc, Q, n).to(f32).contiguous()
    Ck = Cc.reshape(b, nc, Q, n).to(f32).contiguous()
    y_diag, states, decay = _ssd.ssd_chunk(
        xk.to(f32).contiguous(), dAk.to(f32).contiguous(), Bk, Ck)
    # inter-chunk recurrence (short and sequential): the state entering
    # chunk c is prev[:, :, c]
    chunk_decay = decay[..., -1]                                 # (b,h,nc)
    carry = (torch.zeros((b, h, pdim, n), dtype=f32, device=xdt.device)
             if h0 is None else h0.to(f32))
    prev = torch.empty_like(states)                              # (b,h,nc,P,N)
    for c in range(nc):
        prev[:, :, c] = carry
        carry = states[:, :, c] + chunk_decay[:, :, c, None, None] * carry
    y_off = torch.einsum("bcqn,bhcpn->bhcqp", Ck, prev) * decay[..., None]
    y = y_diag + y_off                                           # (b,h,nc,Q,P)
    y = torch.movedim(y, 1, 3).reshape(b, s, h, pdim)
    return y.to(xdt.dtype), carry.to(xdt.dtype)


def sharded_ssd(fn, xdt, dA, Bc, Cc, chunk: int, h0):
    """An SSD scan ``fn`` (``ssd_chunked``, or ``models.ssm.ssd_scan``) on
    ``DTensor`` inputs: every input replicated and every rank scanning
    every head on its local copy, the outputs replicated. The scan's
    inputs arrive replicated anyway: ``in_proj``'s (z, xBC, dt) split
    crosses its sharded axis. Differentiable to any order where ``fn``
    is."""
    from torch.distributed.tensor import Replicate
    mesh = next(t.device_mesh for t in (xdt, dA, Bc, Cc, h0)
                if shard.is_dtensor(t))

    def lay(t):
        return None if t is None else shard.local_shard(shard.replicate(t))

    xdt, dA, Bc, Cc, h0 = shard.enter((xdt, dA, Bc, Cc, h0), mesh)
    y, final = fn(lay(xdt), lay(dA), lay(Bc), lay(Cc), chunk, lay(h0))
    return shard.wrap(y, mesh, Replicate()), shard.wrap(final, mesh,
                                                        Replicate())


class _SSDChunkedAD(torch.autograd.Function):
    """Forward through kernel B4 (``ssd_chunked``); backward through autograd
    of the plain ``models.ssm.ssd_scan``, the reference's VJP (the JAX
    package has no backward kernel for B4, so neither has the port).

    Differentiable once, as the reference's ``custom_vjp`` is: its backward
    raises when it runs under ``create_graph`` (the first half of a second
    derivative, as the 3SFC encoder takes it), where it would otherwise
    hand back gradients with no graph and so drop the scan's second-order
    terms without a word. (``once_differentiable`` is not enough: autograd
    prunes its error node from a second backward to the mixer's input.)"""

    @staticmethod
    def forward(ctx, xdt, dA, Bc, Cc, h0, chunk):
        ctx.chunk = chunk
        ctx.save_for_backward(xdt, dA, Bc, Cc, h0)
        return ssd_chunked(xdt, dA, Bc, Cc, chunk, h0)

    @staticmethod
    def backward(ctx, gy, gfinal):
        from repro_torch.models.ssm import ssd_scan
        if torch.is_grad_enabled():
            raise RuntimeError(
                "the B4 route (use_pallas_ssd=True) is differentiable once, "
                "as the reference's custom_vjp: a backward with "
                "create_graph=True (a second derivative, such as the 3SFC "
                "encoder's) cannot run through it; use the ssd_scan route")
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(bool(nd))
                      for t, nd in zip(saved, need)]
            y, final = ssd_scan(*inputs[:4], ctx.chunk, inputs[4])
            wrt = [t for t, nd in zip(inputs, need) if nd]
            grads = iter(torch.autograd.grad((y, final), wrt, (gy, gfinal)))
        return (*[next(grads) if nd else None for nd in need], None)


def ssd_chunked_ad(xdt: torch.Tensor, dA: torch.Tensor, Bc: torch.Tensor,
                   Cc: torch.Tensor, chunk: int, h0: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable ``ssd_chunked``: forward through the kernel, backward
    through autograd of ``ssd_scan`` (forward parity is held in
    tests/test_torch_ssm.py, so the gradients are consistent). ``h0`` is a
    tensor, as in the reference's ``custom_vjp``."""
    return _SSDChunkedAD.apply(xdt, dA, Bc, Cc, h0, chunk)
