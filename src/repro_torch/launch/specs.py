"""Input specs and entry builders for every (architecture × input shape).

``make_entry(arch, shape_name, mesh, ...)`` returns ``(entry_fn, args)``
where every tensor leaf of ``args`` is a ``TensorSpec``: a shape and a
dtype, the counterpart of the JAX package's ``jax.ShapeDtypeStruct``.
Specs describe; they do not build. ``materialize(args, device)`` turns them
into tensors, and inside a ``FakeTensorMode`` those tensors hold no memory,
so a 100 B-parameter configuration is dry-run on any host
(``repro_torch.launch.dryrun``). ``param_specs`` takes its shapes from the
model's own init run under a fake mode (the counterpart of
``jax.eval_shape``): nothing is drawn, on the host or anywhere.

Entry kinds per input shape (``configs.base.INPUT_SHAPES``):
  train_4k     -> fl_round   (K local steps + 3SFC uplink, clients = pod·data)
  prefill_32k  -> prefill
  decode_32k   -> decode_step (1 token against a seq_len cache)
  long_500k    -> decode_step (sub-quadratic archs; dense/moe use the
                  sliding-window serving variant, ``serving_config``)

Where the port differs from the reference:

* The data and pod axes hold plain local tensors: each rank holds its own
  rows. A prefill or decode entry on a mesh with ``data · pod > 1`` takes
  this rank's ``B / (data · pod)`` rows when they divide (the reference's
  ``_bspec``), else the whole batch. In ``client_parallel='vmap'`` the
  port's round loops over all ``num_clients_for(mesh)`` clients in one
  process, where the reference's GSPMD program splits them across the
  devices; under ``'shard_map'`` each rank holds its own clients' EF rows
  and batches, as in the reference. The specs are rank 0's.
* The ``model`` axis: on a mesh whose ``model`` axis is larger than 1 every
  parameter, EF and cache leaf is a ``DTensor`` on the 1-D ``model``
  sub-mesh, placed by the reference's rules (``models.params``, and
  ``cache_specs`` for the caches); a spec's ``shape`` is the whole leaf's
  and ``materialize`` builds this rank's shard. Activations enter an entry
  replicated on ``model`` and its outputs leave as plain tensors, except
  the decode cache, which stays placed for the next step. The variants
  ``act_shard`` (``models.shard``'s pins) and ``no_qk_hd_shard`` (q/k/v
  replicated where their heads do not divide) are the reference's.
* The round takes its key as an integer seed and the decode step its
  position as an integer (the port's serving loop computes the ring
  buffer's slot on the host); both are plain ``int`` arguments.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Shard

from repro_torch.configs.base import (CompressorConfig, FLConfig, INPUT_SHAPES,
                                      ModelConfig, ShapeConfig, get_config)
from repro_torch.configs.run import RunConfig
from repro_torch.core.strategy import make_strategy
from repro_torch.core.tree import (tree_flatten, tree_leaves_with_path,
                                   tree_map, tree_unflatten)
from repro_torch.fl.round import FLState, build_fl_round
from repro_torch.fl.sharding import param_placements, tp_mesh
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.train import num_micro_for
from repro_torch.models.build import build_model, syn_loss_fn, syn_spec_for
from repro_torch.models import params as params_lib
from repro_torch.models import shard
from repro_torch.models.encdec import EncDec

PyTree = Any

# serving window for long_500k on full-attention archs
LONG_CTX_WINDOW = 8192
# archs whose defining op is full cross-attention at short length: skip 500k
LONG_CTX_SKIP = ("seamless-m4t-medium",)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class TensorSpec:
    """A tensor's shape and dtype, nothing allocated. With ``mesh`` (a 1-D
    ``model`` sub-mesh) the tensor is a ``DTensor`` placed on it as
    ``placement``, and ``shape`` is the whole tensor's."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    placement: Any = None
    mesh: Any = dataclasses.field(default=None, compare=False)

    @property
    def local_shape(self) -> Tuple[int, ...]:
        """This rank's shard's shape."""
        shape = list(self.shape)
        if isinstance(self.placement, Shard):
            shape[self.placement.dim] //= self.mesh.size()
        return tuple(shape)


def spec_of(t: torch.Tensor, placement=None, mesh=None) -> TensorSpec:
    return TensorSpec(tuple(t.shape), t.dtype, placement if mesh is not None
                      else None, mesh)


def _build(s: TensorSpec, device) -> torch.Tensor:
    local = torch.empty(s.local_shape, dtype=s.dtype, device=device)
    if s.mesh is None:
        return local
    # shards are even (the rules shard only dimensions that divide)
    return DTensor.from_local(local, s.mesh, [s.placement], run_check=False)


def materialize(tree: PyTree, device) -> PyTree:
    """The tensors ``tree``'s specs describe, uninitialized on ``device``
    (inside a ``FakeTensorMode``: fake, holding no memory), each placed
    spec this rank's shard wrapped as a ``DTensor``; other leaves as they
    are."""
    return tree_map(lambda s: _build(s, device)
                    if isinstance(s, TensorSpec) else s, tree)


def param_specs(model, mesh, client_axis=None) -> PyTree:
    """Specs of ``model``'s params, from its init run under a fake mode,
    placed on the ``model`` sub-mesh by the rules."""
    with FakeTensorMode():
        params = model.init(torch.Generator().manual_seed(0))
    mm = tp_mesh(mesh)
    return tree_map(lambda t, p: spec_of(t, p, mm), params,
                    param_placements(params, mesh, client_axis))


# ---------------------------------------------------------------------------
# cache sharding rules (path-based, mirrors the models' init_cache structures)
# ---------------------------------------------------------------------------


def _cache_spec(name: str, shape: Tuple[int, ...], msize: int
                ) -> params_lib.PartitionSpec:
    """The reference's ``model`` entries of a cache leaf's spec, by its
    field name: kv heads (else head_dim) of ``k``/``v``; the channels of
    ``conv_buf``; the heads of an SSM ``state``; the width of an RG-LRU
    ``h``. The batch axis is this rank's rows (module docstring)."""
    spec = [None] * len(shape)
    if name in ("k", "v"):                 # (L, B, len, KV, hd)
        off = len(shape) - 4
        if _div(shape[off + 2], msize):
            spec[off + 2] = "model"
        elif _div(shape[off + 3], msize):
            spec[off + 3] = "model"
    elif name in ("conv_buf", "h"):        # (..., B, width-1, C), (..., B, W)
        if _div(shape[-1], msize):
            spec[-1] = "model"
    elif name == "state":                  # (..., B, H, P, N)
        off = len(shape) - 4
        if _div(shape[off + 1], msize):
            spec[off + 1] = "model"
    return params_lib.PartitionSpec(*spec)


def cache_placements(cache: PyTree, msize: int) -> PyTree:
    """Each cache leaf's placement on a ``model`` sub-mesh of ``msize``."""
    pairs = tree_leaves_with_path(cache)
    out = [params_lib.model_placement(_cache_spec(
        str(path[-1]) if path else "", tuple(t.shape), msize))
        for path, t in pairs]
    return tree_unflatten(tree_flatten(cache)[1], out)


def cache_specs(cfg: ModelConfig, cache_shapes: PyTree, mesh) -> PyTree:
    """Specs of a decode cache: the batch axis is this rank's rows; heads or
    width placed on the ``model`` sub-mesh by the reference's cache
    rules."""
    mm = tp_mesh(mesh)
    return tree_map(lambda t, p: spec_of(t, p, mm), cache_shapes,
                    cache_placements(cache_shapes,
                                     mesh_lib.axis_size(mesh, "model")))


def place_cache(cache: PyTree, mm) -> PyTree:
    """A cache an entry made, redistributed on the ``model`` sub-mesh
    ``mm`` to its ``cache_placements`` (as it is without one)."""
    if mm is None:
        return cache
    return tree_map(lambda t, p: t.redistribute(mm, [p])
                    if isinstance(t, DTensor) else shard.place(t, mm, p),
                    cache, cache_placements(cache, mm.size()))


def _div(n: int, m: int) -> bool:
    return m > 0 and n % m == 0


def _rows(mesh, n: int) -> int:
    """This rank's rows of a batch of ``n`` split over 'data' (+'pod'):
    ``n / (data · pod)`` when they divide, else all ``n``."""
    dsize = mesh_lib.axis_size(mesh, "data") * mesh_lib.axis_size(mesh, "pod")
    return n // dsize if _div(n, dsize) else n


def _serve(mesh, fn: Callable) -> Callable:
    """A serving entry on ``mesh``: activations enter replicated on the
    ``model`` sub-mesh, the logits leave plain and the cache leaves placed
    by ``cache_placements`` (all as they are without tensor
    parallelism). The sub-mesh is taken here, not in the entry: slicing a
    mesh runs ops a dry run would trace."""
    mm = tp_mesh(mesh)

    def entry(params, *args):
        with shard.context(mm):
            logits, cache, *rest = fn(params, *shard.enter(args, mm))
        return (shard.leave(logits), place_cache(cache, mm), *rest)

    return entry


# ---------------------------------------------------------------------------
# per-arch shape adjustments
# ---------------------------------------------------------------------------


def serving_config(cfg: ModelConfig, shape: ShapeConfig) -> Optional[ModelConfig]:
    """Arch variant used for this input shape; None => skipped pair."""
    if shape.name == "long_500k":
        if cfg.name in LONG_CTX_SKIP:
            return None
        if cfg.family in ("ssm",):
            return cfg                       # natively O(1) state
        if cfg.attn_window:
            return cfg                       # hybrid local attention
        return cfg.replace(attn_window=LONG_CTX_WINDOW)   # SWA serving variant
    return cfg


def _extras(model, cfg: ModelConfig, lead: Tuple[int, ...]
            ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """The multimodal stubs an entry takes besides tokens, in bf16 as the
    reference's specs: an enc-dec's frames or a VLM's prefix embeddings."""
    shape = (*lead, cfg.num_mm_tokens, cfg.d_model)
    if isinstance(model, EncDec):
        return {"frames": (shape, torch.bfloat16)}
    if cfg.num_mm_tokens:
        return {"prefix_embeds": (shape, torch.bfloat16)}
    return {}


# ---------------------------------------------------------------------------
# entry builders
# ---------------------------------------------------------------------------


def make_train_entry(cfg: ModelConfig, shape: ShapeConfig, mesh,
                     fl: Optional[FLConfig] = None, *,
                     fused_decode: bool = False,
                     ef_dtype: torch.dtype = torch.float32,
                     client_parallel: str = "vmap"
                     ) -> Tuple[Callable, Tuple]:
    """fl_round over clients = pod·data. Returns (fn, args).

    Variants: ``fused_decode`` gathers the tiny 3SFC payloads in place of
    the reconstructed trees (one backward at the server); ``ef_dtype``
    stores each client's EF residual in reduced precision;
    ``client_parallel='shard_map'`` runs this rank's clients and one
    gather (``repro_torch.fl.sharding``). The microbatch rule is
    ``launch.train.num_micro_for``; the defaults are the reference's: K =
    1, local lr 0.01, 3SFC with 16 synthetic positions and rank-8 labels.
    The round is called directly, without donation, as the reference's dry
    run lowers it; ``entry(state, batch, key, syn0=None)`` passes the
    round's ``syn0`` seam through. With tensor parallelism the params and the EF are
    placed on the ``model`` sub-mesh (``fl.sharding``) and the round runs
    its clients' math on the shards.
    """
    num_clients = mesh_lib.num_clients_for(mesh)
    per_client = max(1, shape.global_batch // num_clients)
    fl = fl or FLConfig(num_clients=num_clients, local_steps=1, local_lr=0.01,
                        compressor=CompressorConfig(kind="threesfc", syn_seq=16,
                                                    soft_label_rank=8))
    fl = dataclasses.replace(fl, num_clients=num_clients)
    model = build_model(cfg)
    strategy = make_strategy(fl.compressor, loss_fn=syn_loss_fn(model),
                             syn_spec=syn_spec_for(cfg, fl.compressor),
                             local_lr=fl.local_lr)
    run = RunConfig(fl=fl, client_parallel=client_parallel,
                    fused_decode=fused_decode,
                    num_micro=num_micro_for(per_client, shape.seq_len),
                    mesh=mesh)
    round_fn = build_fl_round(model.loss, strategy, run)

    # the clients this process holds: every one in one process, one per
    # rank under shard_map
    rows = num_clients if client_parallel == "vmap" else 1
    K, B, S = fl.local_steps, per_client, shape.seq_len
    pspecs = param_specs(model, mesh)
    ef = tree_map(lambda s: TensorSpec(
        (rows, *s.shape), ef_dtype, None if s.placement is None
        else Shard(s.placement.dim + 1) if isinstance(s.placement, Shard)
        else s.placement, s.mesh), pspecs)
    state = FLState(params=pspecs, ef=ef, round=0)
    batch = {"tokens": TensorSpec((rows, K, B, S), torch.int32)}
    for k, (shp, dt) in _extras(model, cfg, (rows, K, B)).items():
        batch[k] = TensorSpec(shp, dt)
    key = 0

    def entry(state, batch, key, syn0=None):
        return round_fn(state, batch, key, syn0=syn0)

    return entry, (state, batch, key)


def make_prefill_entry(cfg: ModelConfig, shape: ShapeConfig, mesh
                       ) -> Tuple[Callable, Tuple]:
    model = build_model(cfg)
    B, S = _rows(mesh, shape.global_batch), shape.seq_len
    tokens = TensorSpec((B, S), torch.int32)
    pspecs = param_specs(model, mesh)
    extras = _extras(model, cfg, (B,))

    if isinstance(model, EncDec):
        frames = TensorSpec(*extras["frames"])
        entry = _serve(mesh, lambda params, frames, tokens: model.prefill(
            params, frames, tokens, cache_len=S))
        return entry, (pspecs, frames, tokens)

    if extras:
        prefix = TensorSpec(*extras["prefix_embeds"])
        entry = _serve(mesh, lambda params, prefix, tokens: model.prefill(
            params, tokens, cache_len=S, prefix_embeds=prefix))
        return entry, (pspecs, prefix, tokens)

    entry = _serve(mesh, lambda params, tokens: model.prefill(
        params, tokens, cache_len=S))
    return entry, (pspecs, tokens)


def make_decode_entry(cfg: ModelConfig, shape: ShapeConfig, mesh
                      ) -> Tuple[Callable, Tuple]:
    """One-token decode against a seq_len-deep cache, at its last
    position."""
    model = build_model(cfg)
    B, S = _rows(mesh, shape.global_batch), shape.seq_len
    pspecs = param_specs(model, mesh)
    with FakeTensorMode():
        if isinstance(model, EncDec):
            cache = model.init_cache(B, S, cfg.num_mm_tokens)
        else:
            cache = model.init_cache(B, S)
    cspecs = cache_specs(cfg, cache, mesh)
    token = TensorSpec((B,), torch.int32)
    t = S - 1
    entry = _serve(mesh, lambda params, cache, token, t: model.decode_step(
        params, cache, token, t))
    return entry, (pspecs, cspecs, token, t)


def make_entry(arch: str, shape_name: str, mesh, fl: Optional[FLConfig] = None,
               *, variant: Optional[Dict] = None
               ) -> Optional[Tuple[Callable, Tuple]]:
    """(entry_fn, args) for one (arch x input-shape) pair; None if skipped.

    ``variant``: {"fused_decode": bool, "ef_dtype": "bfloat16",
    "param_dtype": "bfloat16", "act_shard": bool, "no_qk_hd_shard": bool,
    "local_steps": int, "client_parallel": "vmap" | "shard_map"}.
    ``act_shard`` turns ``models.shard``'s pins on for ``mesh`` and
    ``no_qk_hd_shard`` turns the q/k/v head_dim fallback off, both
    process-wide as in the reference (``shard.enable(False)`` and
    ``params.set_qk_hd_fallback(True)`` undo them).
    """
    variant = variant or {}
    shape = INPUT_SHAPES[shape_name]
    cfg = serving_config(get_config(arch), shape)
    if cfg is None:
        return None
    if variant.get("param_dtype"):
        cfg = cfg.replace(param_dtype=variant["param_dtype"])
    if variant.get("act_shard"):
        shard.enable(True, mesh)
    if variant.get("no_qk_hd_shard"):
        params_lib.set_qk_hd_fallback(False)
    if shape.mode == "train":
        fl2 = fl
        if variant.get("local_steps"):
            fl2 = dataclasses.replace(
                fl or FLConfig(local_steps=1,
                               compressor=CompressorConfig(
                                   kind="threesfc", syn_seq=16,
                                   soft_label_rank=8)),
                local_steps=variant["local_steps"])
        return make_train_entry(
            cfg, shape, mesh, fl2,
            fused_decode=variant.get("fused_decode", False),
            ef_dtype=_DTYPES[variant.get("ef_dtype", "float32")],
            client_parallel=variant.get("client_parallel", "vmap"))
    if shape.mode == "prefill":
        return make_prefill_entry(cfg, shape, mesh)
    return make_decode_entry(cfg, shape, mesh)
