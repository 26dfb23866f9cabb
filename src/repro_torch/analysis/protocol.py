"""Static transport-protocol analysis of the port's socket layer.

The JAX package's ``analysis/protocol.py`` pointed at the port's files
(``src/repro_torch/comm/transport.py``, ``launch/worker.py`` and
``fl/engine.py``). It reads source files only. Two analyses over the
socket layer's *source* (no process is started):

**Message grammar.** The ``MSG_*`` constants in ``comm/transport.py`` are
the wire vocabulary. This module rebuilds the transition table from the
AST: a ``MSG_X`` reference inside a comparison (``mtype == MSG_X``) is a
*handler* for that message on that side; any other reference (an argument
to ``send_msg``, a tuple element in a send list) is a *send*. Sides are
classes: ``SocketServer`` is the server, ``ServerLink`` and everything in
``launch/worker.py`` is the worker. Three rules:

* every message is sent by at least one side (no dead vocabulary);
* every sent message has a handler on the peer side (no black-hole
  sends — the bug class where a new message type lands in the peer's
  ``else: raise ProtocolError`` arm);
* every handler corresponds to a message its peer actually sends (no
  unreachable transitions rotting in the dispatch chain).

**Race-detector-lite.** ``SocketServer`` mutates shared dicts/counters
from the accept thread, the per-client recv threads, and the main round
thread. The analyzer extracts the thread entry points
(``threading.Thread(target=self._x)``), assigns each method its execution
contexts (main, and each entry's transitive ``self.*()`` closure), and
requires every write to an attribute touched from ≥2 contexts to sit
under a ``with self._lock``-style guard. Attributes that are themselves
locks, are only written in ``__init__``, or are thread-safe by type
(``queue.Queue``, ``threading.Event``/``Lock``/``Condition`` inferred
from the ``__init__`` RHS) are exempt. ``LiveRoundLoop`` is analyzed too
— it spawns no threads today, so it passes trivially, but the gate is
what keeps that true.
"""
from __future__ import annotations

import ast
import os
from typing import Any, Dict, List, Optional, Set, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))

TRANSPORT_PATH = os.path.join(REPO, "src", "repro_torch", "comm", "transport.py")
WORKER_PATH = os.path.join(REPO, "src", "repro_torch", "launch", "worker.py")
ENGINE_PATH = os.path.join(REPO, "src", "repro_torch", "fl", "engine.py")

# transport.py class -> protocol side
_TRANSPORT_SIDES = {"SocketServer": "server", "ServerLink": "worker"}

# method calls that mutate their receiver in place
MUTATORS = {"append", "extend", "insert", "add", "discard", "remove",
            "pop", "popitem", "clear", "update", "setdefault"}
# constructors whose instances are internally synchronized
THREADSAFE_CTORS = {"Queue", "LifoQueue", "PriorityQueue", "SimpleQueue",
                    "Lock", "RLock", "Condition", "Event", "Semaphore",
                    "BoundedSemaphore", "Barrier"}
LOCK_CTORS = {"Lock", "RLock", "Condition"}


def _read(path: str) -> str:
    with open(path, "r") as f:
        return f.read()


# ---------------------------------------------------------------------------
# message grammar
# ---------------------------------------------------------------------------


def message_table(transport_src: Optional[str] = None) -> Dict[str, int]:
    """``MSG_*`` name -> wire id, from transport.py's module constants."""
    tree = ast.parse(transport_src if transport_src is not None
                     else _read(TRANSPORT_PATH))
    out: Dict[str, int] = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id.startswith("MSG_")
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, int)):
            out[node.targets[0].id] = node.value.value
    return out


def _msg_refs(node: ast.AST, messages: Set[str]
              ) -> Tuple[Set[str], Set[str]]:
    """(handled, sent) message names referenced under ``node``.

    A reference inside any ``ast.Compare`` is a handler-side use; every
    other ``Name`` load of a MSG constant is a send-side use.
    """
    compared: Set[str] = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Compare):
            for m in ast.walk(n):
                if isinstance(m, ast.Name) and m.id in messages:
                    compared.add(m.id)
    all_refs: Set[str] = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and n.id in messages:
            all_refs.add(n.id)
    return compared, all_refs - compared


def build_transitions(transport_src: Optional[str] = None,
                      worker_src: Optional[str] = None) -> Dict[str, Any]:
    """The explicit transition table: per side, which messages it sends
    and which it handles."""
    t_src = transport_src if transport_src is not None \
        else _read(TRANSPORT_PATH)
    w_src = worker_src if worker_src is not None else _read(WORKER_PATH)
    msgs = set(message_table(t_src))
    sends: Dict[str, Set[str]] = {"server": set(), "worker": set()}
    handles: Dict[str, Set[str]] = {"server": set(), "worker": set()}

    for node in ast.parse(t_src).body:
        if isinstance(node, ast.ClassDef) and node.name in _TRANSPORT_SIDES:
            side = _TRANSPORT_SIDES[node.name]
            h, s = _msg_refs(node, msgs)
            handles[side] |= h
            sends[side] |= s
    h, s = _msg_refs(ast.parse(w_src), msgs)
    handles["worker"] |= h
    sends["worker"] |= s
    return {"messages": message_table(t_src),
            "sends": {k: sorted(v) for k, v in sends.items()},
            "handles": {k: sorted(v) for k, v in handles.items()}}


def check_protocol(transport_src: Optional[str] = None,
                   worker_src: Optional[str] = None) -> Tuple[int, List[str]]:
    """The three grammar rules over the transition table."""
    table = build_transitions(transport_src, worker_src)
    msgs = table["messages"]
    sends = {k: set(v) for k, v in table["sends"].items()}
    handles = {k: set(v) for k, v in table["handles"].items()}
    peer = {"server": "worker", "worker": "server"}
    viol: List[str] = []
    for name in sorted(msgs):
        if not any(name in sends[s] for s in sends):
            viol.append(f"{name} (id {msgs[name]}): dead vocabulary — "
                        f"no side ever sends it")
    for side in ("server", "worker"):
        for name in sorted(sends[side]):
            if name not in handles[peer[side]]:
                viol.append(f"{name}: sent by {side} but {peer[side]} has "
                            f"no handler (black-hole send)")
        for name in sorted(handles[side]):
            if name not in sends[peer[side]]:
                viol.append(f"{name}: handled by {side} but {peer[side]} "
                            f"never sends it (unreachable transition)")
    evaluated = len(msgs) + sum(len(v) for v in sends.values()) \
        + sum(len(v) for v in handles.values())
    return evaluated, viol


# ---------------------------------------------------------------------------
# race-detector-lite
# ---------------------------------------------------------------------------


def _ctor_name(call: ast.expr) -> Optional[str]:
    if not isinstance(call, ast.Call):
        return None
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def _self_attr(node: ast.expr) -> Optional[str]:
    """'X' if node is ``self.X`` (possibly through a subscript)."""
    if isinstance(node, ast.Subscript):
        node = node.value
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


class _MethodScan(ast.NodeVisitor):
    """Accesses to ``self.*`` in one method, with lock-guard tracking."""

    def __init__(self, lock_attrs: Set[str]):
        self.lock_attrs = lock_attrs
        self.depth = 0
        self.reads: Set[str] = set()
        self.writes: List[Tuple[str, int, bool]] = []   # attr, line, guarded
        self.self_calls: Set[str] = set()
        self.thread_targets: Set[str] = set()

    def visit_With(self, node: ast.With) -> None:
        locked = any(_self_attr(item.context_expr) in self.lock_attrs
                     or (_ctor_name(item.context_expr) or "") in LOCK_CTORS
                     for item in node.items)
        for item in node.items:
            self.visit(item)
        self.depth += 1 if locked else 0
        for stmt in node.body:
            self.visit(stmt)
        self.depth -= 1 if locked else 0

    def _write(self, target: ast.expr) -> None:
        attr = _self_attr(target)
        if attr is not None:
            self.writes.append((attr, target.lineno, self.depth > 0))

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._write(t)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        self._write(node.target)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._write(node.target)
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            self._write(t)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        if isinstance(f, ast.Attribute):
            recv = _self_attr(f.value)
            if recv is not None and f.attr in MUTATORS:
                self.writes.append((recv, node.lineno, self.depth > 0))
            if isinstance(f.value, ast.Name) and f.value.id == "self":
                self.self_calls.add(f.attr)
        if _ctor_name(node) == "Thread":
            for kw in node.keywords:
                if kw.arg == "target":
                    t = _self_attr(kw.value)
                    if t is not None:
                        self.thread_targets.add(t)
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        attr = _self_attr(node)
        if attr is not None:
            self.reads.add(attr)
        self.generic_visit(node)


def analyze_class_races(tree: ast.Module, class_name: str
                        ) -> Tuple[int, List[str]]:
    """Race rules for one class; returns (attributes examined, violations).

    Raises ``ValueError`` if the class is missing — a silently-skipped
    class would green-light exactly the code this layer exists to check.
    """
    cls = next((n for n in ast.walk(tree)
                if isinstance(n, ast.ClassDef) and n.name == class_name),
               None)
    if cls is None:
        raise ValueError(f"class {class_name} not found")
    methods = {n.name: n for n in cls.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}

    # pass 1: find lock attributes + thread-safe-by-type attributes
    lock_attrs: Set[str] = set()
    safe_attrs: Set[str] = set()
    init = methods.get("__init__")
    if init is not None:
        for n in ast.walk(init):
            if isinstance(n, ast.Assign) and len(n.targets) == 1:
                attr = _self_attr(n.targets[0])
                ctor = _ctor_name(n.value)
                if attr and ctor:
                    if ctor in LOCK_CTORS:
                        lock_attrs.add(attr)
                    if ctor in THREADSAFE_CTORS:
                        safe_attrs.add(attr)

    # pass 2: per-method access scan
    scans: Dict[str, _MethodScan] = {}
    for name, node in methods.items():
        s = _MethodScan(lock_attrs)
        for stmt in node.body:
            s.visit(stmt)
        scans[name] = s

    # pass 3: execution contexts (main + one per thread entry)
    entries = sorted({t for s in scans.values() for t in s.thread_targets
                      if t in methods})

    def closure(roots: Set[str]) -> Set[str]:
        seen: Set[str] = set()
        stack = [r for r in roots if r in methods]
        while stack:
            m = stack.pop()
            if m in seen:
                continue
            seen.add(m)
            stack.extend(c for c in scans[m].self_calls if c in methods)
        return seen

    main_roots = {m for m in methods
                  if m not in entries and not m.startswith("__")}
    contexts: Dict[str, Set[str]] = {m: set() for m in methods}
    for m in closure(main_roots):
        contexts[m].add("main")
    for e in entries:
        for m in closure({e}):
            contexts[m].add(f"thread:{e}")

    # pass 4: the rule
    attrs: Dict[str, Dict[str, Any]] = {}
    for mname, s in scans.items():
        ctxs = contexts.get(mname, set())
        for a in s.reads | {w[0] for w in s.writes}:
            rec = attrs.setdefault(a, {"ctxs": set(), "writes": []})
            if mname != "__init__":
                rec["ctxs"] |= ctxs
                rec["writes"] += [(mname, ln, g) for w, ln, g in s.writes
                                  if w == a]
    viol: List[str] = []
    for a, rec in sorted(attrs.items()):
        if a in lock_attrs or a in safe_attrs:
            continue
        if len(rec["ctxs"]) < 2 or not rec["writes"]:
            continue
        for mname, ln, guarded in rec["writes"]:
            if not guarded:
                viol.append(
                    f"{class_name}.{a}: written in {mname}():{ln} without "
                    f"holding the lock, but touched from "
                    f"{sorted(rec['ctxs'])}")
    return len(attrs), viol


def check_races(transport_src: Optional[str] = None,
                engine_src: Optional[str] = None) -> Tuple[int, List[str]]:
    t_tree = ast.parse(transport_src if transport_src is not None
                       else _read(TRANSPORT_PATH))
    e_tree = ast.parse(engine_src if engine_src is not None
                       else _read(ENGINE_PATH))
    n1, v1 = analyze_class_races(t_tree, "SocketServer")
    n2, v2 = analyze_class_races(e_tree, "LiveRoundLoop")
    return n1 + n2, v1 + v2


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def run_protocol(transport_src: Optional[str] = None,
                 worker_src: Optional[str] = None,
                 engine_src: Optional[str] = None) -> Dict[str, Any]:
    """Both analyses: the transition table, each rule's evaluated count
    and violations, and the total."""
    g_eval, g_viol = check_protocol(transport_src, worker_src)
    r_eval, r_viol = check_races(transport_src, engine_src)
    table = build_transitions(transport_src, worker_src)
    return {
        "transitions": table,
        "rules": {
            "message-grammar": {"evaluated": g_eval, "violations": g_viol},
            "shared-state-locking": {"evaluated": r_eval,
                                     "violations": r_viol},
        },
        "rules_evaluated": g_eval + r_eval,
        "violations": len(g_viol) + len(r_viol),
    }
