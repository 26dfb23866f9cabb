"""The client's 3SFC encode as one CUDA graph per client row.

The encode has a fixed shape and never reads a value on the host, but
launched op by op it costs the host some 50,000 launches a client on an
LM, ten times the device's work. ``EncodeGraphs`` captures each row's
encode once and replays it every round after.

What a row's graph holds: ``CompressionStrategy.encode_update`` from the
accumulated update u through the new residual (the S grad-of-grad steps,
the final objective, every B1 launch, Eq. 8's scale and the cosine, the
reconstruction and B2), then the copy of the message into row j of the
round's (N, ...) message tree. The same kernels in the same order as the
eager encode, the hand-written B1 and B2 among them.

Fixed addresses without new memory: every tensor a graph reads or writes
between replays is one the donated round holds anyway.

* u = g + e is accumulated in place into the donated EF row j (bitwise
  g + e), the graph reads it there, and B2 writes e' back over it;
* the params: the round writes w^{t+1} into w^t's tensors
  (``server_update(out=)``), bitwise the out-of-place values;
* the (N, ...) message tree is kept across rounds (``EncodeGraphs.msgs``):
  it is alive from client 0's encode to the server phase anyway;
* the initial D_syn: the client's generator draws it eagerly, as always,
  into one static tree of a few MB that every row's graph reads.

Schedule per row: its first encode runs eagerly on the stream the graphs
are captured on (B1 makes its per-stream scratch there, the cuBLAS
workspaces and autograd's threads warm up, as in
``profiling.graph_ms``); its second captures the graph, then replays it;
later ones only replay. A row is captured again only when its key
changes: the row, the shape, dtype and address of every tensor the graph
reads or writes, the ``SynSpec`` and the mode. A capture that raises
leaves that key eager. All rows share one memory pool and replay one
after another on one stream.

``fused_cosine.LAUNCHES`` and ``ef_update.LAUNCHES`` count launches that
reach the device: a capture adds nothing, a replay the B1 and B2 launches
its graph holds.

``eager_reason`` decides where the path engages: CUDA params that are
plain tensors, a single-process donated round without faults or codec,
the ``threesfc`` kind with error feedback, and no ``SCOPE_HOOKS`` active.
Everywhere else the round runs its eager encode, unchanged.

The seam: ``backend`` supplies the graphs (``CudaGraphBackend``). A test
hands in one whose graphs rerun their body, so the whole path runs on the
CPU. With tracing on, the meter registry counts
``client.encode.graph_captures``, ``client.encode.graph_replays`` and
``client.encode.eager`` (also ``client.encode.eager.<reason>``).
"""
from __future__ import annotations

import contextlib
import warnings
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import flat
from repro_torch.core.threesfc import SynData, init_syn
from repro_torch.kernels import ef_update as _ef
from repro_torch.kernels import fused_cosine as _fc
from repro_torch.models import shard
from repro_torch.obs import get_registry, get_tracer

PyTree = Any

# the strategy kinds whose encode the path captures (a subclass such as
# fedsynth is another kind)
GRAPH_KINDS = ("threesfc",)


def eager_reason(params: PyTree, strategy, backend, *, donate: bool,
                 shardings, faulted: bool, wired: bool,
                 hooks: bool) -> Optional[str]:
    """Why a round's encode runs eagerly, or None where the graph path
    applies."""
    leaves = flat.tree_leaves(params)
    if any(shard.is_dtensor(l) for l in leaves):
        return "dtensor"
    device = leaves[0].device
    if not backend.supports(device):
        return "cpu" if device.type == "cpu" else "device"
    if shardings is not None:
        return "shard_map"
    if not donate:
        return "undonated"
    if faulted:
        return "faults"
    if wired:
        return "codec"
    if strategy.cfg.kind not in GRAPH_KINDS:
        return "kind"
    if not strategy.cfg.error_feedback:
        return "no_ef"
    if hooks:
        return "scope_hooks"
    return None


class CudaGraphBackend:
    """CUDA graphs captured on one side stream per device, into one
    memory pool, replayed on the current stream."""

    def __init__(self):
        self._streams: Dict[Any, torch.cuda.Stream] = {}
        self._pool = None

    @staticmethod
    def supports(device: torch.device) -> bool:
        return device.type == "cuda"

    def _stream(self, device: torch.device) -> torch.cuda.Stream:
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        return self._streams[device]

    @contextlib.contextmanager
    def side(self, device: torch.device):
        """Eager work on the capture stream, ordered after and before the
        current stream's."""
        side, cur = self._stream(device), torch.cuda.current_stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            yield
        cur.wait_stream(side)

    def capture(self, device: torch.device, body):
        """(graph, body's outputs): ``body()`` captured, not run."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool,
                              stream=self._stream(device)):
            outputs = body()
        if self._pool is None:
            self._pool = graph.pool()
        return graph, outputs


class _Row(NamedTuple):
    key: Tuple
    graph: Any
    outputs: Any                      # the encode's CompressMetrics
    launches: Tuple[int, int]         # B1, B2 launches the graph holds


def _sig(tree: PyTree) -> Tuple:
    return tuple((tuple(t.shape), t.dtype, t.data_ptr())
                 for t in flat.tree_leaves(tree))


def _copy_into(dst: PyTree, src: PyTree) -> None:
    flat.tree_map(lambda d, s: d.copy_(s), dst, src)


class EncodeGraphs:
    """The rows' encode graphs of one round function (module docstring).
    ``encode`` stands in for the client step's encode on the graph path;
    ``msgs`` is the kept (N, ...) message tree the rows write."""

    def __init__(self, strategy, num_rows: int, *, fused: bool = False,
                 backend=None):
        self.strategy = strategy
        self.num_rows = num_rows
        self.fused = fused
        self.backend = CudaGraphBackend() if backend is None else backend
        self.msgs: PyTree = None
        self._syn: Optional[SynData] = None
        self._warm: set = set()
        self._rows: Dict[int, _Row] = {}
        self._failed: Dict[int, Tuple] = {}

    # -- counters ------------------------------------------------------------
    @staticmethod
    def _count(name: str, n: int = 1) -> None:
        if get_tracer().enabled:
            get_registry().counter(f"client.encode.{name}").inc(n)

    def count_eager(self, reason: str, n: int = 1) -> None:
        """``n`` encodes that ran eagerly, and why."""
        self._count("eager", n)
        self._count(f"eager.{reason}", n)

    # -- the path --------------------------------------------------------------
    def _core(self, ef_row: PyTree, params: PyTree):
        msg, _, m = self.strategy.encode_update(
            self._syn, ef_row, ef_row, params, wire=self.fused,
            ef_out=ef_row)
        return msg, m

    def _row(self, j: int) -> PyTree:
        return flat.tree_map(lambda m: m[j], self.msgs)

    def _stage_syn(self, syn0: SynData) -> None:
        if self._syn is None:
            self._syn = SynData(*[torch.empty_like(t) for t in syn0])
        _copy_into(self._syn, syn0)

    def _key(self, j: int, ef_row: PyTree, params: PyTree) -> Tuple:
        return (j, self.fused, self.strategy.syn_spec, _sig(params),
                _sig(ef_row), _sig(self._row(j)), _sig(self._syn))

    def _capture(self, j: int, key: Tuple, ef_row: PyTree,
                 params: PyTree) -> Optional[_Row]:
        out_row = self._row(j)

        def body():
            msg, m = self._core(ef_row, params)
            _copy_into(out_row, msg)
            return m

        before = (_fc.LAUNCHES, _ef.LAUNCHES)
        try:
            graph, outputs = self.backend.capture(
                flat.tree_leaves(params)[0].device, body)
        except Exception as exc:  # noqa: BLE001 — the key falls back to eager
            warnings.warn(f"the encode graph of row {j} failed to capture "
                          f"({type(exc).__name__}: {exc}); that row runs "
                          f"eagerly until its key changes", RuntimeWarning)
            self._failed[j] = key
            return None
        finally:
            held = (_fc.LAUNCHES - before[0], _ef.LAUNCHES - before[1])
            _fc.LAUNCHES, _ef.LAUNCHES = before
        self._count("graph_captures")
        row = _Row(key, graph, outputs, held)
        self._rows[j] = row
        return row

    def encode(self, j: int, key, g: PyTree, ef_row: PyTree,
               params: PyTree, *_client_round):
        """Row ``j``'s encode, in the place and form of
        ``make_client_step``'s encode: (its message, its residual,
        CompressMetrics). The residual is ``ef_row`` and the message row j
        of ``msgs``, both written in place; the metrics are the graph's
        outputs, valid until the row's next encode."""
        # u = g + e in the donated row: e + g is bitwise g + e
        flat.tree_map(lambda e, gi: e.add_(gi), ef_row, g)
        syn0 = key if isinstance(key, SynData) \
            else init_syn(key, self.strategy.syn_spec)
        self._stage_syn(syn0)
        device = flat.tree_leaves(params)[0].device
        if j not in self._warm:
            with self.backend.side(device):
                msg, m = self._core(ef_row, params)
            if self.msgs is None:
                self.msgs = flat.tree_map(
                    lambda x: x.new_empty((self.num_rows, *x.shape)), msg)
            _copy_into(self._row(j), msg)
            self._warm.add(j)
            self.count_eager("warmup")
            return self._row(j), ef_row, m
        gkey = self._key(j, ef_row, params)
        row = self._rows.get(j)
        if row is None or row.key != gkey:
            self._rows.pop(j, None)
            row = (None if self._failed.get(j) == gkey
                   else self._capture(j, gkey, ef_row, params))
            if row is None:
                msg, m = self._core(ef_row, params)
                _copy_into(self._row(j), msg)
                self.count_eager("capture_failed")
                return self._row(j), ef_row, m
        row.graph.replay()
        _fc.LAUNCHES += row.launches[0]
        _ef.LAUNCHES += row.launches[1]
        self._count("graph_replays")
        return self._row(j), ef_row, row.outputs
