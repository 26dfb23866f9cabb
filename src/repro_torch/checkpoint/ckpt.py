"""Durable tree checkpointing: atomic files, typed errors, a versioned
step index, and full-``FLState`` helpers.

The port of the JAX package's ``checkpoint/ckpt.py``, with its on-disk
format: a checkpoint is a directory of two files — ``arrays.npz`` (flat
payload, keys are the '/'-joined leaf paths) and ``manifest.json``
(shapes, dtypes, format version, free-form meta). Both are written
atomically (tmp + fsync + rename + directory fsync) with the manifest
LAST, so the manifest's existence is the commit record: a crash mid-write
leaves either a complete checkpoint or a directory ``load_checkpoint``
rejects with a typed error, never a silently-corrupt one. A checkpoint
either package writes loads in the other.

``CheckpointManager`` layers a retention-managed step index on top::

    root/
      MANIFEST.json          # {"version", "steps": [...], "latest": s}
      step_00000004/         # one save_checkpoint dir per step
      step_00000008/

The root ``MANIFEST.json`` is itself renamed into place, so it is the
commit point for a step: a step directory that crashed mid-write is never
listed, and ``latest()`` always names a loadable checkpoint.

Leaves: tensors go to the host at save time and back to the target leaf's
device at load time. Storage dtypes are the reference's: bf16 (and any
dtype numpy lacks) is stored as f32, exact, and cast back on load. A
Python ``int`` leaf (``FLState.round``) is stored as the 0-d int32 array
the reference writes for its device counter, and loads back as an int.

``save_fl_checkpoint``/``load_fl_checkpoint`` fix the schema of a full
recovery point of a federated run: the complete ``FLState`` (params, the
N×d EF tree, the staleness ring buffer, the round counter), the
``RunConfig`` JSON (which carries the seeds), the ``LinkStats`` byte
ledger, the live loop's round history and — for the socket transport —
the server's per-client EF bank, which is what a rejoining worker is
re-synced from.

Error taxonomy: everything raises ``CheckpointError`` subclasses —
``CheckpointMissingError`` (no such checkpoint / file),
``CheckpointKeyError`` (a leaf the target structure wants is absent),
``CheckpointShapeError`` (shape or dtype mismatch between payload,
manifest and target) and ``CheckpointVersionError`` (a manifest written
by a future format version).
"""
from __future__ import annotations

import io
import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.tree import (tree_flatten, tree_leaves_with_path,
                                   tree_unflatten)
from repro_torch.obs import get_tracer

PyTree = Any

MANIFEST_VERSION = 1

# dtypes stored as-is; anything else (bf16, fp8, ...) is widened to f32 on
# save (exact for bf16) and cast back to the target leaf's dtype on load
_STORED_DTYPES = (np.float32, np.float64, np.int32, np.int64, np.uint32,
                  np.uint8, np.int8, np.bool_, np.float16, np.uint16,
                  np.int16, np.uint64)

# torch dtypes numpy holds as-is; the rest are stored as f32
_TORCH_TO_NP = {torch.float32: np.float32, torch.float64: np.float64,
                torch.float16: np.float16, torch.int32: np.int32,
                torch.int64: np.int64, torch.int16: np.int16,
                torch.int8: np.int8, torch.uint8: np.uint8,
                torch.bool: np.bool_}


class CheckpointError(Exception):
    """Base of every checkpoint failure mode."""


class CheckpointMissingError(CheckpointError, FileNotFoundError):
    """No checkpoint where one was expected (missing dir/manifest/payload)."""


class CheckpointKeyError(CheckpointError, KeyError):
    """The payload lacks a leaf the target structure requires."""


class CheckpointShapeError(CheckpointError, ValueError):
    """Shape or dtype mismatch between payload, manifest, and target."""


class CheckpointVersionError(CheckpointError, ValueError):
    """Manifest written by a future format version — refuse to guess."""


# ---------------------------------------------------------------------------
# flat payload <-> tree
# ---------------------------------------------------------------------------


def _leaf_key(path) -> str:
    return "/".join(str(p) for p in path) or "_root"


def _storage_dtype(dtype) -> np.dtype:
    if isinstance(dtype, torch.dtype):
        return np.dtype(_TORCH_TO_NP.get(dtype, np.float32))
    try:
        d = np.dtype(dtype)
    except TypeError:
        return np.dtype(np.float32)
    return d if d.type in _STORED_DTYPES else np.dtype(np.float32)


def _leaf_dtype(leaf):
    """The dtype a leaf is stored from: a tensor's, a Python int's int32
    (the reference's round counter), else numpy's (``np.float64(x)`` is a
    float, not an int, so it keeps its f64)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype
    if isinstance(leaf, int):
        return np.dtype(np.int32)
    return np.asarray(leaf).dtype


def _to_host(leaf) -> np.ndarray:
    store = _storage_dtype(_leaf_dtype(leaf))
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype not in _TORCH_TO_NP:
            t = t.to(torch.float32)
        return t.cpu().numpy().astype(store, copy=False)
    return np.asarray(leaf).astype(store)


def _flatten_with_paths(tree: PyTree) -> Dict[str, np.ndarray]:
    return {_leaf_key(path): _to_host(leaf)
            for path, leaf in tree_leaves_with_path(tree)}


# ---------------------------------------------------------------------------
# atomic file primitives
# ---------------------------------------------------------------------------


def _fsync_dir(dirname: str) -> None:
    fd = os.open(dirname or ".", os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _atomic_write(path: str, data: bytes) -> None:
    """tmp + fsync + rename + directory fsync: after this returns, ``path``
    holds either its previous content or ``data`` in full — never a prefix."""
    tracer = get_tracer()
    with tracer.span("ckpt.write", file=os.path.basename(path),
                     bytes=len(data)):
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            with tracer.span("ckpt.fsync", file=os.path.basename(path)):
                os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(os.path.dirname(path))


# ---------------------------------------------------------------------------
# single-checkpoint save / load
# ---------------------------------------------------------------------------


def save_checkpoint(path: str, tree: PyTree,
                    meta: Optional[Dict] = None) -> str:
    """Write one checkpoint directory atomically; returns ``path``.

    File order is the durability contract: the payload lands first, the
    manifest (the commit record) last — a crash between the two leaves a
    directory ``load_checkpoint`` rejects with ``CheckpointMissingError``.
    """
    with get_tracer().span("ckpt.save", path=os.path.basename(path)):
        os.makedirs(path, exist_ok=True)
        flat = _flatten_with_paths(tree)
        buf = io.BytesIO()
        np.savez(buf, **flat)
        _atomic_write(os.path.join(path, "arrays.npz"), buf.getvalue())
        manifest = {
            "version": MANIFEST_VERSION,
            "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                       for k, v in flat.items()},
            "meta": meta or {},
        }
        _atomic_write(os.path.join(path, "manifest.json"),
                      json.dumps(manifest, indent=2).encode("utf-8"))
    return path


def load_manifest(path: str) -> Dict:
    """Read + validate a checkpoint's manifest (the commit record)."""
    mpath = os.path.join(path, "manifest.json")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except FileNotFoundError:
        raise CheckpointMissingError(
            f"no checkpoint at {path!r}: missing manifest.json (either never "
            f"written or a save crashed before its commit record)") from None
    except json.JSONDecodeError as e:
        raise CheckpointMissingError(
            f"checkpoint manifest {mpath!r} is not valid JSON: {e}") from None
    version = manifest.get("version", 0)
    if version > MANIFEST_VERSION:
        raise CheckpointVersionError(
            f"checkpoint at {path!r} has manifest version {version}, this "
            f"build reads <= {MANIFEST_VERSION} — refusing to guess at a "
            f"future format")
    return manifest


def load_arrays(path: str) -> Tuple[Dict[str, np.ndarray], Dict]:
    """Load a checkpoint's raw flat payload -> (``{leaf key: array}``,
    manifest). Every array is validated against the manifest's recorded
    shape/dtype; no target structure is required (the EF bank's key set
    is data, not schema)."""
    manifest = load_manifest(path)
    apath = os.path.join(path, "arrays.npz")
    try:
        with get_tracer().span("ckpt.load", path=os.path.basename(path)), \
                np.load(apath) as data:
            flat = {k: data[k] for k in data.files}
    except FileNotFoundError:
        raise CheckpointMissingError(
            f"checkpoint at {path!r} has a manifest but no arrays.npz"
        ) from None
    for key, want in manifest["leaves"].items():
        if key not in flat:
            raise CheckpointKeyError(
                f"checkpoint payload at {path!r} is missing leaf {key!r} "
                f"that its manifest records")
        arr = flat[key]
        if (list(arr.shape) != list(want["shape"])
                or str(arr.dtype) != want["dtype"]):
            raise CheckpointShapeError(
                f"leaf {key!r} at {path!r}: payload "
                f"{arr.dtype}{list(arr.shape)} != manifest "
                f"{want['dtype']}{want['shape']}")
    return flat, manifest


def _restore_leaf(arr: np.ndarray, leaf):
    """``arr`` as ``leaf``'s type: a tensor of its dtype on its device, a
    Python int, or a numpy array of its dtype."""
    if isinstance(leaf, torch.Tensor):
        return torch.as_tensor(np.array(arr)).to(device=leaf.device,
                                                  dtype=leaf.dtype)
    if isinstance(leaf, int):
        return int(arr)
    return np.asarray(arr, dtype=np.asarray(leaf).dtype)


def load_checkpoint(path: str, like: PyTree) -> PyTree:
    """Load into the structure of ``like``, with typed validation: a leaf
    of ``like`` absent from the payload is ``CheckpointKeyError``; a shape
    or stored-dtype mismatch is ``CheckpointShapeError``. Leaves come back
    in ``like``'s dtype on ``like``'s device (bf16 round-trips through its
    exact f32 storage)."""
    flat, _ = load_arrays(path)
    _, treedef = tree_flatten(like)
    out = []
    for p, leaf in tree_leaves_with_path(like):
        key = _leaf_key(p)
        if key not in flat:
            raise CheckpointKeyError(
                f"checkpoint at {path!r} has no leaf {key!r} (target "
                f"structure wants it; payload has {len(flat)} leaves)")
        arr = flat[key]
        want_shape = (tuple(leaf.shape) if isinstance(leaf, torch.Tensor)
                      else np.shape(leaf))
        if tuple(arr.shape) != tuple(want_shape):
            raise CheckpointShapeError(
                f"leaf {key!r}: checkpoint shape {tuple(arr.shape)} != "
                f"target shape {tuple(want_shape)}")
        want_store = _storage_dtype(_leaf_dtype(leaf))
        if arr.dtype != want_store:
            raise CheckpointShapeError(
                f"leaf {key!r}: checkpoint stored dtype {arr.dtype} != "
                f"{want_store} expected for target dtype "
                f"{_leaf_dtype(leaf)}")
        out.append(_restore_leaf(arr, leaf))
    return tree_unflatten(treedef, out)


# ---------------------------------------------------------------------------
# versioned step index
# ---------------------------------------------------------------------------


class CheckpointManager:
    """Retention-managed step index over ``save_checkpoint`` directories.

    The root ``MANIFEST.json`` (atomically renamed into place) is the
    commit point: ``save`` writes the step directory first and registers it
    last, so a crash at any point leaves ``latest()`` naming the previous,
    fully-written checkpoint. ``keep`` bounds retained steps (oldest pruned
    after a successful commit; ``keep=0`` retains everything).
    """

    def __init__(self, root: str, *, keep: int = 3):
        if keep < 0:
            raise ValueError(f"keep must be >= 0 (0 = keep all), got {keep}")
        self.root = root
        self.keep = keep

    # -- index -------------------------------------------------------------
    def _index_path(self) -> str:
        return os.path.join(self.root, "MANIFEST.json")

    def _read_index(self) -> Dict:
        try:
            with open(self._index_path()) as f:
                idx = json.load(f)
        except FileNotFoundError:
            return {"version": MANIFEST_VERSION, "steps": [], "latest": None}
        except json.JSONDecodeError as e:
            raise CheckpointMissingError(
                f"checkpoint index {self._index_path()!r} is not valid "
                f"JSON: {e}") from None
        version = idx.get("version", 0)
        if version > MANIFEST_VERSION:
            raise CheckpointVersionError(
                f"checkpoint index at {self.root!r} has version {version}, "
                f"this build reads <= {MANIFEST_VERSION}")
        return idx

    def steps(self) -> List[int]:
        return sorted(int(s) for s in self._read_index()["steps"])

    def latest(self) -> Optional[int]:
        latest = self._read_index()["latest"]
        return None if latest is None else int(latest)

    def path(self, step: int) -> str:
        return os.path.join(self.root, f"step_{int(step):08d}")

    # -- save / load -------------------------------------------------------
    def save(self, step: int, tree: PyTree,
             meta: Optional[Dict] = None) -> str:
        os.makedirs(self.root, exist_ok=True)
        idx = self._read_index()
        known = {int(s) for s in idx["steps"]}
        p = self.path(step)
        if os.path.isdir(p) and int(step) not in known:
            shutil.rmtree(p)        # debris of a save that crashed mid-write
        save_checkpoint(p, tree, meta)
        steps = sorted(known | {int(step)})
        drop = (steps[:-self.keep]
                if self.keep and len(steps) > self.keep else [])
        steps = [s for s in steps if s not in drop]
        _atomic_write(self._index_path(), json.dumps(
            {"version": MANIFEST_VERSION, "steps": steps,
             "latest": max(steps)}).encode("utf-8"))
        for s in drop:              # prune only after the commit point
            shutil.rmtree(self.path(s), ignore_errors=True)
        return p

    def _resolve(self, step: Optional[int]) -> int:
        idx = self._read_index()
        if step is None:
            if idx["latest"] is None:
                raise CheckpointMissingError(
                    f"no checkpoints committed under {self.root!r}")
            return int(idx["latest"])
        if int(step) not in {int(s) for s in idx["steps"]}:
            raise CheckpointMissingError(
                f"step {step} is not committed under {self.root!r} "
                f"(have: {sorted(int(s) for s in idx['steps'])})")
        return int(step)

    def load(self, like: Optional[PyTree] = None,
             step: Optional[int] = None) -> Tuple[Any, Dict]:
        """Load ``step`` (default: latest committed) -> (tree, meta).
        With ``like`` the payload is validated into that structure; with
        ``like=None`` the raw flat ``{leaf key: array}`` dict comes back."""
        step = self._resolve(step)
        p = self.path(step)
        if like is None:
            flat, manifest = load_arrays(p)
            return flat, manifest["meta"]
        tree = load_checkpoint(p, like)
        return tree, load_manifest(p)["meta"]


# ---------------------------------------------------------------------------
# full-FLState recovery points
# ---------------------------------------------------------------------------


def save_fl_checkpoint(mgr: CheckpointManager, step: int, state: PyTree, *,
                       run=None, ledger: Optional[Dict] = None,
                       history: Optional[List[Dict]] = None,
                       ef_bank: Optional[Dict[int, Tuple[int, np.ndarray]]]
                       = None,
                       extra: Optional[Dict] = None) -> str:
    """One durable recovery point of a federated run at round ``step``.

    ``state`` is the complete ``FLState`` (params + N×d EF tree + staleness
    ring buffer + round counter) for the in-process path, or the bare
    params tree for the socket path. ``run`` (a ``RunConfig``) serializes
    the configuration including its seeds; ``ledger`` is the transport's
    byte ledger; ``history`` the live loop's per-round records; ``ef_bank``
    maps client id -> (last committed round, flat f32 EF stream) — the
    slice a rejoining worker is re-synced from."""
    tree: Dict[str, Any] = {"state": state}
    meta: Dict[str, Any] = {"kind": "fl_state", "round": int(step)}
    if run is not None:
        meta["run"] = run.to_json()
    if ledger is not None:
        meta["ledger"] = ledger
    if history is not None:
        meta["history"] = history
    if ef_bank:
        tree["ef_bank"] = {str(c): np.asarray(v, np.float32)
                           for c, (_, v) in ef_bank.items()}
        meta["ef_bank_rounds"] = {str(c): int(r)
                                  for c, (r, _) in ef_bank.items()}
    if extra:
        meta.update(extra)
    return mgr.save(step, tree, meta)


def load_fl_checkpoint(mgr: CheckpointManager, like_state: PyTree,
                       step: Optional[int] = None,
                       ) -> Tuple[PyTree, Dict[int, Tuple[int, np.ndarray]],
                                  Dict]:
    """Load a recovery point -> (state, ef_bank, meta). ``like_state``
    fixes the state structure (validated, typed errors); the EF bank is
    read structure-free (its client-id key set is data, not schema)."""
    step = mgr._resolve(step)
    p = mgr.path(step)
    state = load_checkpoint(p, {"state": like_state})["state"]
    flat, manifest = load_arrays(p)
    meta = manifest["meta"]
    bank_rounds = meta.get("ef_bank_rounds", {})
    ef_bank = {int(c): (int(r), np.asarray(flat[f"ef_bank/{c}"], np.float32))
               for c, r in bank_rounds.items()}
    return state, ef_bank, meta
