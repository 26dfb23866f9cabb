"""Op-trace cost analyzer: FLOPs, bytes, collectives and peak memory of one
eager run.

The JAX package re-derives its roofline inputs from the optimized HLO text
of a compiled program, with loop trip counts applied. Eager PyTorch
compiles no module, so the port reads an **op trace** instead (the file
keeps the reference's name): ``record(fn, *args)`` runs ``fn`` once under
a ``TorchDispatchMode`` that sees every ATen op the run dispatches, the
autograd engine's included, and keeps per op what the cost model needs,
never the tensors. Run inside a ``FakeTensorMode`` on fake arguments
(``repro_torch.launch.dryrun``), the run allocates nothing, so a
configuration far larger than the card is traced on any host; on real
tensors it records the same ops.

* **flops** — products only, the reference's rule (``_dot_flops``,
  ``_conv_flops``): 2 · result elements · contracted size, for ``mm``,
  ``addmm``, ``bmm``, ``baddbmm`` and the convolutions forward and
  backward (``torch.utils.flop_counter``'s formulas), and for ``dot`` and
  ``mv``, the same rule at rank 1. Elementwise ops count 0. Each product
  keeps its class for the roofline: ``"bf16"`` (bf16 or f16), ``"tf32"``
  (f32 while TF32 was allowed for it) or ``"f32"``.
* **bytes** — operand plus result bytes per op (the reference's
  ``_instr_bytes``), skipping ops that move no data: views and other
  aliases, ``detach``, the ``empty`` family (``SKIP_BYTES_OPS``, the
  counterpart of ``_SKIP_BYTES_OPS``) and ops that return no tensor
  (metadata queries such as ``prim.device``). Eager PyTorch fuses nothing, so
  every op's operands and results really cross HBM: on the same program
  these bytes are at least the reference's, which skips what XLA fuses.
* **kernels** — a hand-written kernel's meta branch (``kernels/meta.py``)
  adds one record per launch it stands in for, named after the kernel:
  operand plus result bytes, as the reference counts a Pallas custom call,
  and the products' FLOPs the branch reports (bf16; B7's over the causal
  half of its logits, which the einsums it replaces counted), 0 for the
  kernels that run no products.
* **collectives** — each call of a ``torch.distributed`` collective,
  through ``collective_hook``: the hook the round contracts' recorder
  (``repro_torch.analysis.contracts.RoundRecorder``) installs too, so the
  two accountings cannot drift; and each functional collective
  (``torch.ops._c10d_functional``, ``functional_collective``), the ones
  DTensor issues on the ``model`` axis under tensor parallelism, by the
  same kinds. ``bytes`` is what this rank puts in (the reference's
  ``_collective_of``: operand bytes).

**Tensor parallelism.** A ``DTensor`` program is counted by its **local**
ops: the mode sees each DTensor-level op (at global shapes) first and
returns ``NotImplemented`` for it, so DTensor's dispatch runs it as this
rank's local ops and collectives, which come back to the mode and are
counted. Arguments and results count by their local shards, so every
figure is rank 0's, per device.

**Loops.** A Python loop runs once per trip and every trip is recorded,
which gives the reference's trip-count rule without parsing; ``trip``
stays a field and is 1 on each recorded op.

**Scopes.** ``torch.profiler.record_function`` reaches the dispatcher as
``profiler._record_function_enter_new`` / ``_record_function_exit``; the
mode keeps the stack of open names and an op's ``op_name`` is that stack
joined by ``/``, so ``collectives_in_scope(trace, CLIENT_SCOPE)`` means
what the reference's does.

**Memory.** The live bytes of the run as the CUDA caching allocator counts
them: each storage an op creates counts from when it is made, rounded up
to the allocator's 512-byte block, until its last reference dies (a
``weakref.finalize`` on the storage); the arguments' storages are live
throughout. ``Trace.memory`` holds the reference's keys:
``argument_bytes``, ``output_bytes`` (storages the result holds that the
run made), ``temp_bytes`` (the peak's rest) and ``peak_bytes``. The
garbage collector is off during the trace, so reference cycles (the
encoder's double-backward graphs) are freed when the trace ends, not when
a collection happens to run.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import inspect
import pickle
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.distributed.distributed_c10d as c10d
from torch._subclasses.fake_tensor import unset_fake_temporarily
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.kernels import meta
from repro_torch.models import shard

aten = torch.ops.aten

# the reference's collective kinds, in its order
_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

# the collective entry points of torch.distributed and the parameter holding
# what this rank sends (None: it sends no payload); object variants are
# pickled to count
COLLECTIVES: Dict[str, Optional[str]] = {
    "all_gather": "tensor",
    "all_gather_into_tensor": "input_tensor",
    "_all_gather_base": "input_tensor",
    "all_gather_coalesced": "input_tensor_list",
    "all_gather_object": "obj",
    "all_reduce": "tensor",
    "all_reduce_coalesced": "tensors",
    "reduce": "tensor",
    "broadcast": "tensor",
    "broadcast_object_list": "object_list",
    "reduce_scatter": "input_list",
    "reduce_scatter_tensor": "input",
    "_reduce_scatter_base": "input",
    "all_to_all": "input_tensor_list",
    "all_to_all_single": "input",
    "scatter": "scatter_list",
    "scatter_object_list": "scatter_object_input_list",
    "gather": "tensor",
    "gather_object": "obj",
    "send": "tensor",
    "recv": "tensor",
    "isend": "tensor",
    "irecv": "tensor",
    "send_object_list": "object_list",
    "recv_object_list": "object_list",
    "batch_isend_irecv": "p2p_op_list",
    "barrier": None,
    "monitored_barrier": None,
}


def collective_kind(entry: str) -> str:
    """The reference's kind of a collective entry point (``all-gather``,
    ``all-reduce``, ``reduce-scatter``, ``all-to-all``, point-to-point as
    ``collective-permute``); the rest by their own names. A functional
    collective's entry is ``_c10d_functional.<op>``."""
    base = entry.rsplit(".", 1)[-1].lstrip("_")
    for prefix, kind in (("all_gather", "all-gather"),
                         ("all_reduce", "all-reduce"),
                         ("reduce_scatter", "reduce-scatter"),
                         ("all_to_all", "all-to-all")):
        if base.startswith(prefix):
            return kind
    if base.startswith(("send", "recv", "isend", "irecv", "batch_isend")):
        return "collective-permute"
    return base.split("_")[0]


def collective_operands(value) -> List[Tuple[str, int]]:
    """(dtype, bytes) of each tensor a collective's argument carries; an
    object variant's object as ``("object", its pickled size)``."""
    if isinstance(value, torch.Tensor):
        return [(str(value.dtype), value.numel() * value.element_size())]
    if isinstance(value, (list, tuple)):
        return [op for v in value for op in collective_operands(v)]
    if isinstance(value, dist.P2POp):
        return collective_operands(value.tensor)
    if value is None:
        return []
    return [("object", len(pickle.dumps(value)))]


# the functional collectives (``torch.ops._c10d_functional``) DTensor's
# redistributions issue on the ``model`` axis; ``wait_tensor`` only waits
FUNCTIONAL_NAMESPACE = "_c10d_functional"


def functional_collective(func, args) -> Optional[Tuple[str, list]]:
    """``(entry, operands)`` when ``func`` is a functional collective (the
    ops tensor parallelism's collectives run as), else ``None``: the entry
    ``_c10d_functional.<op>`` and ``collective_operands`` of its input."""
    if func.namespace != FUNCTIONAL_NAMESPACE:
        return None
    name = func._schema.name.split("::")[-1]
    if name.startswith("wait"):
        return None
    return f"{FUNCTIONAL_NAMESPACE}.{name}", collective_operands(args[0])


class _CollectiveHook:
    """Wraps every entry point of ``COLLECTIVES`` in ``torch.distributed``
    and ``torch.distributed.distributed_c10d`` while open; ``on_call(entry,
    operands)`` runs before each outermost call (an object variant calls
    the tensor ones, which are not reported again)."""

    def __init__(self, on_call: Callable[[str, List[Tuple[str, int]]],
                                         None]):
        self.on_call = on_call
        self._inside = 0

    def _wrap(self, entry: str, fn: Callable) -> Callable:
        param = COLLECTIVES[entry]
        try:
            sig = inspect.signature(fn)
        except (TypeError, ValueError):
            sig = None
        hook = self

        def wrapper(*args, **kwargs):
            if hook._inside:
                return fn(*args, **kwargs)
            value = None
            if param is not None and sig is not None:
                try:
                    value = sig.bind_partial(*args, **kwargs).arguments.get(
                        param)
                except TypeError:
                    value = None
                if value is None and param not in sig.parameters:
                    value = list(args) + list(kwargs.values())
            hook.on_call(entry, collective_operands(value))
            hook._inside += 1
            try:
                return fn(*args, **kwargs)
            finally:
                hook._inside -= 1

        return wrapper

    @contextlib.contextmanager
    def installed(self) -> Iterator[None]:
        undo: List[Callable[[], None]] = []
        try:
            for entry in COLLECTIVES:
                for owner in (dist, c10d):
                    fn = getattr(owner, entry, None)
                    if fn is not None:
                        setattr(owner, entry, self._wrap(entry, fn))
                        undo.append(functools.partial(setattr, owner, entry,
                                                      fn))
            yield
        finally:
            while undo:
                undo.pop()()


def collective_hook(on_call: Callable[[str, List[Tuple[str, int]]], None]):
    """Context manager: ``on_call(entry, operands)`` for each outermost call
    of a ``torch.distributed`` collective while it is open, with the entry
    point's name and ``collective_operands`` of what this rank sends. The
    one detection rule of the analyzer and of the round contracts."""
    return _CollectiveHook(on_call).installed()


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------


@dataclass
class OpRecord:
    """One recorded op: an ATen op (``aten.mm.default``) or a kernel's
    launch (its name), with its product FLOPs and their class, operand plus
    result bytes, and the scope stack it ran in."""

    op: str
    flops: float
    bytes: float
    op_name: str
    flop_class: str = ""
    kernel: bool = False
    trip: int = 1


@dataclass
class CollectiveInstr:
    """One collective call, with its scope.

    ``bytes`` is the operand footprint this rank puts in (the accounting
    ``CostTotals.coll_bytes`` uses); ``trip`` is 1 (each call of a loop is
    its own record), so ``bytes * trip`` is the call's wire bill.
    ``op_name`` is the scope stack, matched by substring. ``operands`` are
    ``(dtype, bytes)`` pairs in operand order."""

    kind: str
    bytes: float
    trip: float
    op_name: str
    operands: Tuple[Tuple[str, float], ...] = ()
    entry: str = ""

    @property
    def total_bytes(self) -> float:
        return self.bytes * self.trip

    @property
    def dtypes(self) -> Tuple[str, ...]:
        return tuple(dt for dt, _ in self.operands)


@dataclass
class Trace:
    """What ``record`` keeps of one run: its ops, its collectives, the live
    bytes' summary (``memory``), the ops dispatched in all, the wall time,
    and ``fn``'s result."""

    ops: List[OpRecord] = field(default_factory=list)
    collectives: List[CollectiveInstr] = field(default_factory=list)
    memory: Dict[str, int] = field(default_factory=lambda: {
        "argument_bytes": 0, "output_bytes": 0, "temp_bytes": 0,
        "peak_bytes": 0})
    dispatched: int = 0
    seconds: float = 0.0
    result: Any = None


@dataclass
class CostTotals:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: Dict[str, float] = field(
        default_factory=lambda: {k: 0.0 for k in _COLLECTIVES})
    flops_by_class: Dict[str, float] = field(default_factory=dict)


# ops that move no data: their operands and results are not counted
SKIP_BYTES_OPS = {
    aten.empty.memory_format, aten.empty_strided.default,
    aten.empty_like.default, aten.new_empty.default,
    aten.new_empty_strided.default, aten.detach.default,
    aten.alias.default, aten.lift_fresh.default,
    aten._unsafe_view.default, aten.sym_size.int, aten.sym_stride.int,
    aten.sym_numel.default, aten.sym_storage_offset.default,
}

_PRODUCTS = {aten.mm, aten.addmm, aten.bmm, aten.baddbmm, aten.convolution,
             aten._convolution, aten.convolution_backward}
_CONVOLUTIONS = {aten.convolution, aten._convolution,
                 aten.convolution_backward}
_RF_ENTER = {torch.ops.profiler._record_function_enter_new.default}
_RF_EXIT = {torch.ops.profiler._record_function_exit._RecordFunction}

# the caching allocator's block: every allocation is a multiple of it
BLOCK_BYTES = 512


def _round_block(n: int) -> int:
    return -(-n // BLOCK_BYTES) * BLOCK_BYTES


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of ``tree``, a ``DTensor`` as this rank's shard."""
    with torch.no_grad():
        return [shard.local(t) for t in tree_leaves(tree)
                if isinstance(t, torch.Tensor)]


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _product_flops(func, args, kwargs, out) -> float:
    packet = func.overloadpacket
    if packet in _PRODUCTS:
        return float(flop_counter.flop_registry[packet](
            *args, **kwargs, out_val=out))
    if packet is aten.dot or packet is aten.vdot:
        return 2.0 * args[0].numel()
    if packet is aten.mv:
        return 2.0 * args[0].numel()
    if packet is aten.addmv:
        return 2.0 * args[1].numel()
    return 0.0


def _flop_class(func, out) -> str:
    t = _tensors(out)[0]
    if t.dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    tf32 = (torch.backends.cudnn.allow_tf32
            if func.overloadpacket in _CONVOLUTIONS
            else torch.backends.cuda.matmul.allow_tf32)
    return "tf32" if t.dtype == torch.float32 and tf32 else "f32"


@functools.lru_cache(maxsize=None)
def _op_kind(func) -> Tuple[bool, bool]:
    """(moves no data, makes its results' storages) of an op: a view or
    other alias of an input that writes nothing moves no data (as does
    ``SKIP_BYTES_OPS``); an op makes new storages unless a result aliases
    an input (a view, an in-place or ``out=`` op)."""
    rets = func._schema.returns
    aliases = bool(rets) and all(r.alias_info is not None
                                 and not r.alias_info.is_write for r in rets)
    fresh = all(r.alias_info is None for r in rets)
    return func in SKIP_BYTES_OPS or aliases, fresh


class _LiveBytes:
    """Live storages of a run, rounded to the allocator's block: counted
    when first seen as an op's new result, released by a finalizer when the
    storage dies."""

    def __init__(self):
        self._lock = threading.Lock()
        self._live: Dict[int, int] = {}
        self.args: set = set()
        self.live = 0
        self.peak = 0
        self.closed = False

    def _free(self, key: int, n: int) -> None:
        with self._lock:
            if self._live.pop(key, None) is not None and not self.closed:
                self.live -= n

    def add(self, t: torch.Tensor, *, argument: bool = False) -> None:
        with unset_fake_temporarily():
            s = t.untyped_storage()
            key, n = id(s), _round_block(s.nbytes())
            with self._lock:
                if key in self._live:
                    return
                self._live[key] = n
                if argument:
                    self.args.add(key)
                self.live += n
                self.peak = max(self.peak, self.live)
            weakref.finalize(s, self._free, key, n)

    def storages(self, tensors) -> Dict[int, int]:
        out = {}
        with unset_fake_temporarily():
            for t in tensors:
                key = id(t.untyped_storage())
                if key in self._live:
                    out[key] = self._live[key]
        return out


class _Recorder(TorchDispatchMode):
    """The dispatch mode behind ``record``."""

    def __init__(self, trace: Trace, live: _LiveBytes):
        super().__init__()
        self.trace = trace
        self.live = live
        self.scopes: List[str] = []

    @property
    def op_name(self) -> str:
        return "/".join(self.scopes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(shard.is_dtensor(t) for t in tree_leaves((args, kwargs))):
            # a DTensor op, at global shapes: DTensor's own dispatch runs
            # it as local ops and functional collectives, which come back
            # here
            return NotImplemented
        coll = functional_collective(func, args)
        if coll is not None:
            self.on_collective(*coll)
        out = func(*args, **kwargs)
        self.trace.dispatched += 1
        if func in _RF_ENTER:
            self.scopes.append(args[0])
            return out
        if func in _RF_EXIT:
            # ranges close in the reverse order of opening (``with``)
            if self.scopes:
                self.scopes.pop()
            return out
        results = _tensors(out)
        skip, fresh = _op_kind(func)
        if fresh:
            for t in results:
                self.live.add(t)
        if skip or not results or coll is not None:
            return out
        flops = _product_flops(func, args, kwargs, out)
        nbytes = _nbytes(_tensors((args, kwargs))) + _nbytes(results)
        if flops or nbytes:
            self.trace.ops.append(OpRecord(
                str(func), flops, float(nbytes), self.op_name,
                _flop_class(func, out) if flops else ""))
        return out

    def on_kernel(self, kernel: str, operands, results,
                  flops: float) -> None:
        # a kernel's products run on bf16 tensor cores (B7's); the others
        # run none
        self.trace.ops.append(OpRecord(
            kernel, flops, float(_nbytes(operands) + _nbytes(results)),
            self.op_name, "bf16" if flops else "", kernel=True))

    def on_collective(self, entry: str, operands) -> None:
        self.trace.collectives.append(CollectiveInstr(
            collective_kind(entry), float(sum(b for _, b in operands)), 1,
            self.op_name, tuple((dt, float(b)) for dt, b in operands),
            entry))


def record(fn: Callable, *args, **kwargs) -> Trace:
    """Runs ``fn(*args, **kwargs)`` once and returns its op trace (see the
    module docstring); the result is ``Trace.result``. For a dry run, call
    it inside a ``FakeTensorMode`` with fake arguments."""
    trace = Trace()
    live = _LiveBytes()
    inputs = _tensors((args, kwargs))
    for t in inputs:
        live.add(t, argument=True)
    arg_bytes = live.live
    rec = _Recorder(trace, live)
    collecting = gc.isenabled()
    gc.disable()
    t0 = time.perf_counter()
    try:
        meta.HOOKS.append(rec.on_kernel)
        with collective_hook(rec.on_collective), rec:
            trace.result = fn(*args, **kwargs)
        trace.seconds = time.perf_counter() - t0
        out = live.storages(_tensors(trace.result))
        out_bytes = sum(n for k, n in out.items() if k not in live.args)
    finally:
        meta.HOOKS.remove(rec.on_kernel)
        live.closed = True
        if collecting:
            gc.enable()
    trace.memory = {
        "argument_bytes": arg_bytes, "output_bytes": out_bytes,
        "temp_bytes": max(0, live.peak - arg_bytes - out_bytes),
        "peak_bytes": live.peak}
    return trace


def analyze(trace: Trace) -> CostTotals:
    """Totals of a trace: product FLOPs (also by class), bytes, and
    collective bytes by kind."""
    tot = CostTotals()
    for op in trace.ops:
        tot.flops += op.flops * op.trip
        tot.bytes += op.bytes * op.trip
        if op.flops:
            tot.flops_by_class[op.flop_class] = (
                tot.flops_by_class.get(op.flop_class, 0.0)
                + op.flops * op.trip)
    for c in trace.collectives:
        tot.coll_bytes[c.kind] = tot.coll_bytes.get(c.kind, 0.0) \
            + c.total_bytes
    return tot


def top_ops(trace: Trace, n: int = 20) -> List[Dict[str, Any]]:
    """The ``n`` ops (by name; each kernel by its own) with the most bytes:
    their calls, bytes and FLOPs."""
    by: Dict[str, Dict[str, Any]] = {}
    for op in trace.ops:
        row = by.setdefault(op.op, {"op": op.op, "calls": 0, "bytes": 0.0,
                                    "flops": 0.0})
        row["calls"] += op.trip
        row["bytes"] += op.bytes * op.trip
        row["flops"] += op.flops * op.trip
    return sorted(by.values(), key=lambda r: -r["bytes"])[:n]


# ---------------------------------------------------------------------------
# per-collective extraction (wire-bytes accounting)
# ---------------------------------------------------------------------------


def collectives(trace: Trace) -> List[CollectiveInstr]:
    """Every collective of the run, in call order."""
    return list(trace.collectives)


def collective_bytes(trace: Trace) -> float:
    """Total collective operand bytes of the run."""
    return sum(c.total_bytes for c in trace.collectives)


def collectives_in_scope(trace: Trace, scope: str) -> List[CollectiveInstr]:
    """Collectives whose scope stack mentions ``scope`` — the gate for 'the
    per-client encode region contains zero collectives'."""
    return [c for c in trace.collectives if scope in c.op_name]
