"""Parameter init, dtype and sharding-rule helpers.

Params are nested dicts of tensors in the JAX package's layout (dense
weights ``(in, out)``; layer stacks with a leading layer axis), so the
reference's arrays load without transposes. Every draw comes from an
explicit ``torch.Generator``.

The tensor-parallel rules (``make_sharding_rules``, ``sharding_specs``)
are the JAX package's, rule for rule; ``model_placement`` turns a spec
into the placement of the leaf on the ``model`` sub-mesh.
"""
from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core.tree import (tree_flatten, tree_leaves_with_path,
                                   tree_map, tree_unflatten)

PyTree = Any

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def dense_init(gen: torch.Generator, in_dim: int, shape: Tuple[int, ...],
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Truncated-normal fan-in init (1/sqrt(in_dim)), truncated to ±2,
    drawn by inverting the normal CDF on the generator's device."""
    lo, hi = (0.5 * (1.0 + math.erf(z / math.sqrt(2.0))) for z in (-2.0, 2.0))
    u = torch.rand(shape, generator=gen, device=gen.device,
                   dtype=torch.float32) * (hi - lo) + lo
    z = torch.clamp(math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0), -2.0, 2.0)
    return (z / math.sqrt(max(in_dim, 1))).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (torch.randn((vocab, d), generator=gen, device=gen.device)
            * 0.02).to(dtype)


def stack_init(init_fn: Callable[[torch.Generator], PyTree],
               gen: torch.Generator, n: int) -> PyTree:
    """``init_fn`` for each of ``n`` layers, drawing from ``gen`` in turn,
    stacked leaf by leaf on a leading axis of size ``n``."""
    return stack_trees([init_fn(gen) for _ in range(n)])


def stack_trees(trees) -> PyTree:
    """Trees of one structure -> one tree, each leaf stacked on a new
    leading axis."""
    flats = [tree_flatten(t) for t in trees]
    return tree_unflatten(flats[0][1], [torch.stack(leaves) for leaves in
                                        zip(*(f[0] for f in flats))])


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------
#
# Sharding is path based, as in the JAX package: ``make_sharding_rules``
# maps a param path (dict keys joined by "/") to a partition spec through
# regex rules, applied leaf by leaf. Rules are mesh-shape aware: an axis is
# sharded only when its size divides by the mesh axis, otherwise the rule
# falls through to the next candidate (e.g. kv-heads -> head_dim ->
# replicate).


class PartitionSpec:
    """The port's ``jax.sharding.PartitionSpec``: one entry per tensor
    dimension, each a mesh axis name, ``None`` (not sharded) or a tuple of
    names. A one-name tuple is stored as the name, as JAX stores it, so a
    spec equals ``tuple()`` of the reference's. Not a ``tuple`` itself, so
    a tree walk takes a spec as one leaf."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(e[0] if isinstance(e, tuple) and len(e) == 1
                             else e for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            other = other.entries
        return isinstance(other, tuple) and self.entries == other

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"P{self.entries!r}"


P = PartitionSpec

# Each rule: (regex, spec_fn(leaf_shape, mesh_axis_sizes) -> PartitionSpec).
Rule = Tuple[str, Callable[[Tuple[int, ...], Dict[str, int]], PartitionSpec]]

STACKED_PATHS = ("layers/", "blocks/", "enc_layers/", "dec_layers/")


def _div(n: int, m: int) -> bool:
    return m > 0 and n % m == 0


# the head_dim fallback of q/k/v (``_heads_then_hd``); on by default
_QK_HD_FALLBACK = True


def set_qk_hd_fallback(value: bool) -> None:
    global _QK_HD_FALLBACK
    _QK_HD_FALLBACK = value


def make_sharding_rules(model_axis: str = "model") -> Sequence[Rule]:
    """Default tensor-parallel rules for the LM families: weights are
    stored so that the sharded logical axis is recognizable by name; the
    stacked leading layer axis is never sharded."""
    m = model_axis

    def _shard_last(shape, sizes):
        return (P(*([None] * (len(shape) - 1) + [m]))
                if _div(shape[-1], sizes[m]) else P())

    def _shard_dim(i):
        def f(shape, sizes):
            j = i if i >= 0 else len(shape) + i
            if 0 <= j < len(shape) and _div(shape[j], sizes[m]):
                spec = [None] * len(shape)
                spec[j] = m
                return P(*spec)
            return P()
        return f

    def _heads_then_hd(shape, sizes):
        # (..., H, hd): prefer heads, fall back to head_dim, else
        # replicate. hd is the QK^T contraction dim, so sharding it
        # all-reduces the (S, S) logits; set_qk_hd_fallback(False)
        # replicates q/k instead.
        if len(shape) >= 2 and _div(shape[-2], sizes[m]):
            return P(*([None] * (len(shape) - 2) + [m, None]))
        if _QK_HD_FALLBACK and _div(shape[-1], sizes[m]):
            return P(*([None] * (len(shape) - 1) + [m]))
        return P()

    def _embed_table(shape, sizes):
        # (V, d): shard the vocab rows
        return (P(m, None) if len(shape) == 2 and _div(shape[0], sizes[m])
                else P())

    def _wo(shape, sizes):
        # (H, hd, d): shard heads; fall back to head_dim
        if _div(shape[0], sizes[m]):
            return P(*([m] + [None] * (len(shape) - 1)))
        if len(shape) > 2 and _div(shape[1], sizes[m]):
            return P(*([None, m] + [None] * (len(shape) - 2)))
        return P()

    return [
        # embeddings / logits: shard vocab (dim 0 for embed table, last for
        # head)
        (r"embed/table$", _embed_table),
        (r"lm_head/w$", _shard_last),
        # attention
        (r"attn/wq$", _heads_then_hd),       # (d, H, hd)
        (r"attn/wk$", _heads_then_hd),       # (d, KV, hd)
        (r"attn/wv$", _heads_then_hd),
        (r"attn/wo$", _wo),                  # (H, hd, d)
        (r"attn/bq$", _heads_then_hd),
        (r"attn/bk$", _heads_then_hd),
        (r"attn/bv$", _heads_then_hd),
        # FFN
        (r"ffn/w_in$", _shard_last),          # (d, ff)
        (r"ffn/w_gate$", _shard_last),
        (r"ffn/w_out$", _shard_dim(-2)),      # (ff, d)
        # MoE: shard experts; if E doesn't divide the model axis (16
        # experts on a 64-way axis), shard the per-expert ffn dim instead
        (r"moe/(w_in|w_gate)$", lambda s, z: (
            _shard_dim(0)(s, z) if _div(s[0], z[m]) else _shard_dim(2)(s, z))),
        (r"moe/w_out$", lambda s, z: (
            _shard_dim(0)(s, z) if _div(s[0], z[m]) else _shard_dim(1)(s, z))),
        (r"moe/router$", lambda s, z: P()),
        # SSM (mamba2): shard the inner/heads axis
        (r"ssm/in_proj$", _shard_last),       # (d, inner_total)
        (r"ssm/out_proj$", _shard_dim(-2)),   # (inner, d)
        (r"ssm/(A_log|D|dt_bias)$",
         lambda s, z: P(m) if _div(s[-1], z[m]) else P()),
        (r"ssm/conv_w$", _shard_last),        # (width, conv_dim)
        (r"ssm/conv_b$", _shard_last),
        (r"ssm/norm$", _shard_last),
        # RG-LRU: recurrent width sharded over model
        (r"rglru/(w_in|w_gate_lin|w_gate_in|w_gate_a)$", _shard_last),
        (r"rglru/(a_param|b_gate_in|b_gate_a)$", _shard_last),
        (r"rglru/w_y$", _shard_dim(-2)),
        (r"rglru/conv_w$", _shard_last),
        (r"rglru/conv_b$", _shard_last),
        # norms & everything else: replicate
        (r".*", lambda s, z: P()),
    ]


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``, or of a mapping that
    already is one."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def _spec_for(path: str, shape: Tuple[int, ...], sizes: Dict[str, int],
             rules: Sequence[Rule], stacked_paths: Tuple[str, ...],
             client_axis) -> PartitionSpec:
    """The spec of one leaf at ``path`` (keys joined by "/")."""
    stacked = any(s in path for s in stacked_paths)
    core_shape = shape
    if client_axis:
        core_shape = core_shape[1:]
    if stacked:
        core_shape = core_shape[1:]
    core = P()
    for pat, fn in rules:
        if re.search(pat, path):
            core = fn(core_shape, sizes)
            break
    lead = []
    if client_axis:
        lead.append(client_axis)
    if stacked:
        lead.append(None)
    full = lead + list(core)
    while len(full) < len(shape):
        full.append(None)
    return P(*full[: len(shape)])


def sharding_specs(params: PyTree, mesh, rules: Optional[Sequence[Rule]] = None,
                   stacked_paths: Tuple[str, ...] = STACKED_PATHS,
                   client_axis: Optional[Tuple[str, ...]] = None) -> PyTree:
    """PartitionSpec tree for ``params`` (tensors, or anything with a
    ``shape``) on ``mesh`` (a ``DeviceMesh`` or ``{axis: size}``).

    * stacked layer params get their leading layer axis unsharded;
    * ``client_axis`` (e.g. ``('pod', 'data')``): every leaf has an extra
      leading client axis sharded over those mesh axes (FL client
      stacking).
    """
    rules = rules or make_sharding_rules()
    sizes = axis_sizes(mesh)
    sizes.setdefault("model", 1)
    pairs = tree_leaves_with_path(params)
    specs = [_spec_for(_path_str(p), tuple(leaf.shape), sizes, rules,
                      stacked_paths, client_axis) for p, leaf in pairs]
    return tree_unflatten(tree_flatten(params)[1], specs)


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def model_placement(spec: PartitionSpec, axis: str = "model"):
    """The ``torch.distributed.tensor`` placement of a leaf with ``spec`` on
    the 1-D ``axis`` sub-mesh: ``Shard(dim)`` where the spec names
    ``axis`` at ``dim``, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    for dim, entry in enumerate(spec):
        if axis in _names(entry):
            return Shard(dim)
    return Replicate()


def param_count(params: PyTree) -> int:
    return sum(math.prod(l.shape) for l in tree_flatten(params)[0])


def cast_tree(params: PyTree, dtype: torch.dtype) -> PyTree:
    return tree_map(lambda x: x.to(dtype), params)
