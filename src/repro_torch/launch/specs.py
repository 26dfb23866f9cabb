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

* In ``client_parallel='vmap'`` the port's round loops over all
  ``num_clients_for(mesh)`` clients in one process, where the reference's
  GSPMD program splits them across the devices; a prefill or decode runs
  its whole batch in one process too. So an entry's per-device figures are
  that one process's, and on an (n, 1) mesh they are the work of n
  reference devices. Under ``'shard_map'`` each rank holds its own
  clients' EF rows and batches, as in the reference, and the specs are
  rank 0's.
* The round takes its key as an integer seed and the decode step its
  position as an integer (the port's serving loop computes the ring
  buffer's slot on the host); both are plain ``int`` arguments.
* A mesh whose ``model`` axis is larger than 1 (the production meshes
  included) and the variants ``act_shard`` and ``no_qk_hd_shard`` need the
  parameter sharding rules with tensor parallelism, which the port does not
  have yet (``ROADMAP.md`` Queue A item 2): they raise
  ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import (CompressorConfig, FLConfig, INPUT_SHAPES,
                                      ModelConfig, ShapeConfig, get_config)
from repro_torch.configs.run import RunConfig
from repro_torch.core.strategy import make_strategy
from repro_torch.core.tree import tree_map
from repro_torch.fl.round import FLState, build_fl_round
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.train import num_micro_for
from repro_torch.models.build import build_model, syn_loss_fn, syn_spec_for
from repro_torch.models.encdec import EncDec

PyTree = Any

# serving window for long_500k on full-attention archs
LONG_CTX_WINDOW = 8192
# archs whose defining op is full cross-attention at short length: skip 500k
LONG_CTX_SKIP = ("seamless-m4t-medium",)

# what the port cannot mean yet, and where the work to lift it is queued
TP_PENDING = ("needs the parameter sharding rules with tensor parallelism "
              "(ROADMAP.md Queue A item 2)")

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class TensorSpec:
    """A tensor's shape and dtype, nothing allocated."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def spec_of(t: torch.Tensor) -> TensorSpec:
    return TensorSpec(tuple(t.shape), t.dtype)


def materialize(tree: PyTree, device) -> PyTree:
    """The tensors ``tree``'s specs describe, uninitialized on ``device``
    (inside a ``FakeTensorMode``: fake, holding no memory); other leaves
    as they are."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device=device)
                    if isinstance(s, TensorSpec) else s, tree)


def check_mesh(mesh) -> None:
    """Raises ``NotImplementedError`` for a mesh with a ``model`` axis
    larger than 1."""
    model = mesh_lib.axis_size(mesh, "model")
    if model > 1:
        raise NotImplementedError(
            f"a mesh with a model axis of {model} {TP_PENDING}")


def param_specs(model, mesh) -> PyTree:
    """Specs of ``model``'s params, from its init run under a fake mode."""
    check_mesh(mesh)
    with FakeTensorMode():
        params = model.init(torch.Generator().manual_seed(0))
    return tree_map(spec_of, params)


def cache_specs(cfg: ModelConfig, cache_shapes: PyTree, mesh) -> PyTree:
    """Specs of a decode cache: a batch axis split over 'data' (+'pod') is
    this process's whole batch (see the module docstring), and heads or
    width over 'model' are not supported yet."""
    check_mesh(mesh)
    return tree_map(spec_of, cache_shapes)


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


def _batch_specs(cfg: ModelConfig, mesh, shapes: Dict[str, Tuple],
                 dtypes) -> Dict[str, TensorSpec]:
    """Specs of batch inputs: ``shapes[k]`` in ``dtypes[k]``."""
    check_mesh(mesh)
    return {k: TensorSpec(tuple(shp), dtypes[k]) for k, shp in shapes.items()}


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
    run lowers it.
    """
    check_mesh(mesh)
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
    ef = tree_map(lambda s: TensorSpec((rows, *s.shape), ef_dtype), pspecs)
    state = FLState(params=pspecs, ef=ef, round=0)
    batch = {"tokens": TensorSpec((rows, K, B, S), torch.int32)}
    for k, (shp, dt) in _extras(model, cfg, (rows, K, B)).items():
        batch[k] = TensorSpec(shp, dt)
    key = 0

    def entry(state, batch, key):
        return round_fn(state, batch, key)

    return entry, (state, batch, key)


def make_prefill_entry(cfg: ModelConfig, shape: ShapeConfig, mesh
                       ) -> Tuple[Callable, Tuple]:
    model = build_model(cfg)
    B, S = shape.global_batch, shape.seq_len
    tokens = TensorSpec((B, S), torch.int32)
    pspecs = param_specs(model, mesh)
    extras = _extras(model, cfg, (B,))

    if isinstance(model, EncDec):
        frames = TensorSpec(*extras["frames"])

        def entry(params, frames, tokens):
            return model.prefill(params, frames, tokens, cache_len=S)

        return entry, (pspecs, frames, tokens)

    if extras:
        prefix = TensorSpec(*extras["prefix_embeds"])

        def entry(params, prefix, tokens):
            return model.prefill(params, tokens, cache_len=S,
                                 prefix_embeds=prefix)

        return entry, (pspecs, prefix, tokens)

    def entry(params, tokens):
        return model.prefill(params, tokens, cache_len=S)

    return entry, (pspecs, tokens)


def make_decode_entry(cfg: ModelConfig, shape: ShapeConfig, mesh
                      ) -> Tuple[Callable, Tuple]:
    """One-token decode against a seq_len-deep cache, at its last
    position."""
    model = build_model(cfg)
    B, S = shape.global_batch, shape.seq_len
    pspecs = param_specs(model, mesh)
    with FakeTensorMode():
        if isinstance(model, EncDec):
            cache = model.init_cache(B, S, cfg.num_mm_tokens)
        else:
            cache = model.init_cache(B, S)
    cspecs = cache_specs(cfg, cache, mesh)
    token = TensorSpec((B,), torch.int32)
    t = S - 1

    def entry(params, cache, token, t):
        return model.decode_step(params, cache, token, t)

    return entry, (pspecs, cspecs, token, t)


def make_entry(arch: str, shape_name: str, mesh, fl: Optional[FLConfig] = None,
               *, variant: Optional[Dict] = None
               ) -> Optional[Tuple[Callable, Tuple]]:
    """(entry_fn, args) for one (arch x input-shape) pair; None if skipped.

    ``variant``: {"fused_decode": bool, "ef_dtype": "bfloat16",
    "param_dtype": "bfloat16", "local_steps": int,
    "client_parallel": "vmap" | "shard_map"}; "act_shard" and
    "no_qk_hd_shard" raise ``NotImplementedError`` (module docstring).
    """
    variant = variant or {}
    for knob in ("act_shard", "no_qk_hd_shard"):
        if variant.get(knob):
            raise NotImplementedError(f"the {knob!r} variant {TP_PENDING}")
    check_mesh(mesh)
    shape = INPUT_SHAPES[shape_name]
    cfg = serving_config(get_config(arch), shape)
    if cfg is None:
        return None
    if variant.get("param_dtype"):
        cfg = cfg.replace(param_dtype=variant["param_dtype"])
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
