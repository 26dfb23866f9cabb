"""Socket transport: framed rounds between a server and N worker processes.

The port of the JAX package's ``comm/transport.py``: the same message
numbers, the same ``<IB`` length prefix and bodies, so a message encodes
to the same bytes in both packages; the same deadline, backoff, liveness
and EF-bank semantics. Its workers (``repro_torch.launch.worker``) compute
on the card unless they are asked for the CPU.

This is the ``Channel`` interface over real sockets — the same
``comm/frame.py`` frames that ``InProcessChannel`` hands between two Python
halves here cross a TCP connection between a server process and N client
worker processes. Workers are spawned locally by ``spawn_local_workers``,
but every connection is address-based: pointing a worker at another
host's ``host:port`` is a config change, not a code change.

Message protocol
----------------
Every message is length-prefixed::

    [ u32 LE body length | u8 type | body ... ]

Codec frames travel as ``MSG_FRAME`` bodies unchanged — the frame's own
header (``comm.frame``) still carries kind/round/client, so the transport
layer never interprets payloads. Control messages (HELLO, ROUND, ACK,
RESEND, heartbeats, metrics, EF dumps) are protocol overhead, billed into
``overhead_up``/``overhead_down`` counters; only data-frame bytes land in
the ``LinkStats`` buckets, so "uplink bytes per round" means exactly what
it means on the in-process channel: serialized codec frames.

Round lifecycle (server side, driven by ``repro_torch.fl.engine.LiveRoundLoop``)
--------------------------------------------------------------------------
1. ``broadcast_round``: ROUND(round, participate flag, params frame) to
   every live worker.
2. ``collect``: drain uplink frames under a per-round deadline. Each
   expected client has a receive timer with exponential backoff
   (``RetryPolicy.timeout(attempt)``); a timeout or a corrupt frame
   (typed ``FrameError``, wrong client id) triggers a RESEND, up to
   ``max_retries`` times — re-sent frames are billed again (retransmission
   is not free). A client whose retries are exhausted, whose process died
   (EOF on its connection), or who stayed silent past the liveness window
   is marked undelivered — exactly the ``delivered=False`` branch of the
   in-round fault model (``repro_torch.fl.faults``). Stale frames (header round != current) are discarded.
3. ``send_acks``: ACK(round, delivered bit) tells each worker which EF
   branch to commit (``e' = u - r`` on delivery, ``e' = u`` on drop), so
   EF residual-mass conservation holds verbatim over the wire.

Liveness: workers heartbeat from a daemon thread even while computing, so
a *slow* worker (straggler) is alive-but-late (timeout/backoff path) while
a *dead* one (killed process) is EOF — detected immediately, excluded,
never hung on. A silent-but-connected worker (e.g. SIGSTOP) trips the
``liveness_timeout_s`` window instead.

Elastic membership (JOIN / REJOIN)
----------------------------------
The worker set is no longer frozen at HELLO time. After each EF commit a
worker pushes its residual, tagged with the committed round (MSG_EF_PUSH),
and the server banks the latest push per client (``ef_bank``) — so the
server always holds every client's last-committed EF slice, which is the
ONLY state a worker process owns. A worker that connects after SETUP was
broadcast (a fresh joiner, or one whose process was killed and restarted)
receives SETUP + MSG_EF_SYNC(its banked slice) back-to-back under one send
lock, rebuilds its computation, installs the residual, and re-enters the
round set at the next broadcast. Its missed rounds were ordinary
``delivered=False`` rounds on the server (dead workers are excluded, EF
frozen in the bank), so residual-mass conservation holds bitwise across
the death. The same
bank, snapshotted into full-state checkpoints (``seed_ef_bank`` on
restore), is what makes a *server* restart bitwise-resumable: re-synced
workers restart from exactly the residual the checkpointed round left
them with.
"""
from __future__ import annotations

import json
import os
import queue
import socket
import struct
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.comm.channel import Channel
from repro_torch.comm.frame import FrameError, parse_header
from repro_torch.obs import get_registry, get_tracer, now_ns

# message types (u8 on the wire; append only, never renumber)
MSG_HELLO = 0        # worker -> server: u32 client id
MSG_SETUP = 1        # server -> worker: JSON setup blob
MSG_ROUND = 2        # server -> worker: u32 round | u8 flags | params frame
MSG_FRAME = 3        # worker -> server: one codec frame
MSG_HEARTBEAT = 4    # worker -> server: liveness tick; body is empty (legacy)
#                      or u64 LE worker clock ns, obs.now_ns (clock-offset
#                      estimation)
MSG_RESEND = 5       # server -> worker: u32 round — re-send that frame
MSG_ACK = 6          # server -> worker: u32 round | u8 delivered
MSG_EF_REQ = 7       # server -> worker: dump your EF residual (empty body)
MSG_EF_DUMP = 8      # worker -> server: raw f32 EF leaf stream
MSG_METRIC = 9       # worker -> server: u32 round | f32 local loss, then
#                      optionally a JSON span batch (see repro_torch.obs.trace)
MSG_STOP = 10        # server -> worker: shut down (empty body)
MSG_EF_PUSH = 11     # worker -> server: u32 committed round | f32 EF stream
MSG_EF_SYNC = 12     # server -> worker: u32 banked round | f32 EF stream

FLAG_PARTICIPATE = 1  # ROUND flags bit 0: train this round (vs. sit out)

_HDR = struct.Struct("<IB")          # body length, message type
MAX_MSG = 1 << 30                    # sanity bound on any single message


class ProtocolError(ConnectionError):
    """A peer that is not speaking this protocol (oversized length prefix,
    malformed control message). A ``ConnectionError`` subclass so transport
    loops handle 'broken peer' and 'dead peer' with one except clause."""


# ---------------------------------------------------------------------------
# framing primitives
# ---------------------------------------------------------------------------


def send_msg(sock: socket.socket, mtype: int, body: bytes = b"") -> int:
    """Write one length-prefixed message; returns total bytes written."""
    if not isinstance(body, (bytes, bytearray, memoryview)):
        body = np.asarray(body, np.uint8).tobytes()
    if len(body) > MAX_MSG:
        raise ProtocolError(f"message body {len(body)} B exceeds {MAX_MSG}")
    msg = _HDR.pack(len(body), mtype) + bytes(body)
    sock.sendall(msg)
    return len(msg)


def recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly ``n`` bytes or raise ``ConnectionError`` — a peer that
    closes mid-message (killed worker) surfaces here, including a partial
    read at the length-prefix boundary itself."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError(
                f"peer closed after {len(buf)}/{n} bytes of a message")
        buf += chunk
    return bytes(buf)


def recv_msg(sock: socket.socket) -> Tuple[int, bytes]:
    """Read one message -> (type, body). Typed errors only: short reads are
    ``ConnectionError``, an insane length prefix is ``ProtocolError``."""
    length, mtype = _HDR.unpack(recv_exact(sock, _HDR.size))
    if length > MAX_MSG:
        raise ProtocolError(f"length prefix {length} exceeds {MAX_MSG}")
    return mtype, recv_exact(sock, length)


# ---------------------------------------------------------------------------
# server half
# ---------------------------------------------------------------------------


class SocketServer(Channel):
    """Accepts N workers and runs framed rounds with deadline / backoff /
    liveness semantics (module docstring). ``rx_filter(cid, round, buf) ->
    buf | None`` is the deterministic fault-injection seam the transport
    tests use: it sees every *billed* uplink frame and may
    corrupt it or eat it (None), exactly like a lossy wire."""

    def __init__(self, num_clients: int, *,
                 address: Tuple[str, int] = ("127.0.0.1", 0),
                 heartbeat_s: float = 0.5, liveness_timeout_s: float = 5.0,
                 rx_filter: Optional[Callable] = None):
        super().__init__()
        self.num_clients = num_clients
        self.heartbeat_s = heartbeat_s
        self.liveness_timeout_s = liveness_timeout_s
        self.rx_filter = rx_filter
        # overhead_up/overhead_down (control-message bytes, never LinkStats)
        # live on the Channel base so they ride in ledger() with the rest
        self._lsock = socket.create_server(address)
        self._conns: Dict[int, socket.socket] = {}
        self._send_locks: Dict[int, threading.Lock] = {}
        self._last_seen: Dict[int, float] = {}
        self._dead: set = set()
        self._rx: "queue.Queue" = queue.Queue()
        self._ef: Dict[int, bytes] = {}
        self._ef_evt: Dict[int, threading.Event] = {}
        # cid -> (last committed round, flat f32 EF stream): the newest
        # MSG_EF_PUSH per client — the recovery source for worker rejoin
        # and the slice full-state checkpoints carry
        self._ef_bank: Dict[int, Tuple[int, bytes]] = {}
        self._setup: Optional[bytes] = None
        self._metrics: Dict[Tuple[int, int], float] = {}
        # spans piggybacked on MSG_METRIC, still on each worker's own clock
        self._worker_spans: Dict[int, List[dict]] = {}
        # cid -> min(server_now_ns_at_recv - worker_heartbeat_ts): the
        # tightest heartbeat bounds offset + one-way latency from above,
        # so min over samples ≈ the clock offset (latency inflates, never
        # deflates, the estimate)
        self._clock_offset_ns: Dict[int, int] = {}
        self._hb_prev: Dict[int, float] = {}
        self._meters = get_registry()
        self._meters.register_source("transport.ledger", self.ledger)
        self._lock = threading.Lock()
        self._bank_cv = threading.Condition(self._lock)
        self._stopping = False
        self._threads: List[threading.Thread] = []
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)

    @property
    def address(self) -> Tuple[str, int]:
        return self._lsock.getsockname()[:2]

    # -- liveness ----------------------------------------------------------
    def _is_dead(self, cid: int) -> bool:
        with self._lock:
            if cid in self._dead:
                return True
            seen = self._last_seen.get(cid)
        if seen is None:
            return True              # never connected
        return time.monotonic() - seen > self.liveness_timeout_s

    def _mark_dead(self, cid: int):
        with self._lock:
            was_dead = cid in self._dead
            self._dead.add(cid)
        if not was_dead:
            self._meters.counter("transport.liveness.dead").inc()
            get_tracer().event("liveness.dead", client=cid)

    def live_workers(self) -> List[int]:
        """Clients currently connected, not EOF'd, and heartbeating within
        the liveness window."""
        return [cid for cid in sorted(self._conns)
                if not self._is_dead(cid)]

    # -- connection plumbing ----------------------------------------------
    def _accept_loop(self):
        while not self._stopping:
            try:
                conn, _ = self._lsock.accept()
            except OSError:
                return               # listener closed by stop()
            try:
                mtype, body = recv_msg(conn)
                if mtype != MSG_HELLO or len(body) != 4:
                    raise ProtocolError("expected HELLO")
                cid = struct.unpack("<I", body)[0]
            except (ConnectionError, OSError):
                conn.close()
                continue
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(target=self._recv_loop, args=(cid, conn),
                                 daemon=True)
            with self._lock:
                self.overhead_up += _HDR.size + 4
                self._conns[cid] = conn
                self._send_locks[cid] = threading.Lock()
                self._last_seen[cid] = time.monotonic()
                self._dead.discard(cid)
                self._threads.append(t)
                # decided under the lock send_setup takes: a connection
                # gets its join state from exactly one of the two (the
                # reference checks after the lock, and a worker that
                # connects as SETUP goes out can get it twice)
                joiner = self._setup is not None
            t.start()
            if joiner:
                # mid-run joiner (fresh, or a killed worker's restarted
                # process): hand it the session state it missed — SETUP plus
                # its banked EF slice — and it re-enters at the next round
                self._send_join_state(cid)

    def _recv_loop(self, cid: int, conn: socket.socket):
        try:
            while True:
                mtype, body = recv_msg(conn)
                with self._lock:
                    self._last_seen[cid] = time.monotonic()
                if mtype == MSG_HEARTBEAT:
                    with self._lock:
                        self.overhead_up += _HDR.size + len(body)
                    now_mono = time.monotonic()
                    if len(body) >= 8:
                        # timestamped heartbeat: tighten the clock-offset
                        # estimate (min over samples, see _clock_offset_ns)
                        (wts,) = struct.unpack_from("<Q", body)
                        off = now_ns() - wts
                        with self._lock:
                            prev = self._clock_offset_ns.get(cid)
                            if prev is None or off < prev:
                                self._clock_offset_ns[cid] = off
                    prev_beat = self._hb_prev.get(cid)
                    self._hb_prev[cid] = now_mono
                    if prev_beat is not None:
                        self._meters.histogram(
                            "transport.heartbeat_interval_s").observe(
                                now_mono - prev_beat)
                elif mtype == MSG_EF_DUMP:
                    with self._lock:
                        self.overhead_up += _HDR.size + len(body)
                        self._ef[cid] = body
                        evt = self._ef_evt.get(cid)
                    if evt is not None:
                        evt.set()
                elif mtype == MSG_EF_PUSH and len(body) >= 4:
                    with self._lock:
                        self.overhead_up += _HDR.size + len(body)
                    (rnd,) = struct.unpack_from("<I", body)
                    with self._bank_cv:
                        self._ef_bank[cid] = (rnd, body[4:])
                        self._bank_cv.notify_all()
                elif mtype == MSG_METRIC and len(body) >= 8:
                    with self._lock:
                        self.overhead_up += _HDR.size + len(body)
                    rnd, loss = struct.unpack_from("<If", body)
                    spans: List[dict] = []
                    if len(body) > 8:
                        # piggybacked span batch (worker-local clock); a
                        # malformed batch loses spans, never the metric
                        try:
                            spans = json.loads(body[8:].decode("utf-8"))
                        except (UnicodeDecodeError, ValueError):
                            spans = []
                    with self._lock:
                        self._metrics[(rnd, cid)] = loss
                        if spans:
                            self._worker_spans.setdefault(
                                cid, []).extend(spans)
                elif mtype == MSG_FRAME:
                    with self._lock:
                        self.overhead_up += _HDR.size
                    self._rx.put((cid, body))
                else:
                    raise ProtocolError(
                        f"unexpected message type {mtype} from client {cid}")
        except (ConnectionError, OSError):
            pass
        finally:
            self._mark_dead(cid)
            self._rx.put((cid, None))        # wake collect(): peer is gone
            try:
                conn.close()
            except OSError:
                pass

    def _send(self, cid: int, mtype: int, body: bytes = b"") -> int:
        conn = self._conns.get(cid)
        if conn is None:
            raise ConnectionError(f"client {cid} never connected")
        with self._send_locks[cid]:
            return send_msg(conn, mtype, body)

    def _send_or_bury(self, cid: int, mtype: int, body: bytes = b"") -> int:
        """Send, mapping any transport failure onto worker death (the
        graceful-degradation contract: a broken pipe is a dead peer, not an
        exception up the round loop). Returns bytes written (0 if dead)."""
        try:
            return self._send(cid, mtype, body)
        except (ConnectionError, OSError):
            self._mark_dead(cid)
            return 0

    # -- session setup -----------------------------------------------------
    def wait_ready(self, timeout: float = 60.0) -> None:
        """Block until all N workers have said HELLO (or raise)."""
        end = time.monotonic() + timeout
        while time.monotonic() < end:
            with self._lock:
                if len(self._conns) >= self.num_clients:
                    return
            time.sleep(0.01)
        with self._lock:
            got = sorted(self._conns)
        raise TimeoutError(
            f"only {len(got)}/{self.num_clients} workers connected within "
            f"{timeout}s (have: {got})")

    def send_setup(self, setup: Dict) -> None:
        """Broadcast the JSON setup blob every worker rebuilds its model /
        data / strategy from (see ``repro_torch.launch.worker``). The blob is
        retained so late joiners get it too (``_send_join_state``); any
        pre-seeded EF bank entry (a resumed server) rides along."""
        with self._lock:
            self._setup = json.dumps(setup).encode("utf-8")
            cids = sorted(self._conns)
        for cid in cids:
            self._send_join_state(cid)

    def _send_join_state(self, cid: int) -> None:
        """SETUP + (banked) EF_SYNC to one worker, back-to-back under one
        send lock — a concurrently-broadcast ROUND can never interleave
        between them, so the worker always installs its residual BEFORE it
        computes anything."""
        conn = self._conns.get(cid)
        if conn is None or self._setup is None:
            return
        msgs = [(MSG_SETUP, self._setup)]
        with self._lock:
            bank = self._ef_bank.get(cid)
        if bank is not None:
            rnd, stream = bank
            msgs.append((MSG_EF_SYNC, struct.pack("<I", rnd) + stream))
        try:
            with self._send_locks[cid]:
                for mtype, body in msgs:
                    n = send_msg(conn, mtype, body)
                    with self._lock:
                        self.overhead_down += n
        except (ConnectionError, OSError):
            self._mark_dead(cid)

    # -- EF bank (elastic membership / recovery) ---------------------------
    def ef_bank(self) -> Dict[int, Tuple[int, np.ndarray]]:
        """Every client's last pushed EF slice: cid -> (committed round,
        flat f32 stream) — what full-state checkpoints carry."""
        with self._lock:
            items = dict(self._ef_bank)
        return {cid: (rnd, np.frombuffer(b, np.float32).copy())
                for cid, (rnd, b) in items.items()}

    def seed_ef_bank(self, bank: Dict[int, Tuple[int, np.ndarray]]) -> None:
        """Pre-load the bank (a resumed server, from its checkpoint) so
        every worker — they all rejoin a restarted server — is re-synced to
        exactly the residual the checkpointed round left it with."""
        with self._bank_cv:
            for cid, (rnd, arr) in bank.items():
                self._ef_bank[int(cid)] = (
                    int(rnd), np.asarray(arr, np.float32).tobytes())
            self._bank_cv.notify_all()

    def wait_ef_bank(self, round_idx: int, cids, timeout: float = 30.0) -> bool:
        """Block until every listed client's banked EF is tagged with a
        commit >= ``round_idx`` (False on timeout). The checkpoint hook
        calls this before snapshotting so the banked slices are exactly the
        post-round residuals — the settle point that makes a resumed run
        bitwise."""
        end = time.monotonic() + timeout
        with self._bank_cv:
            while True:
                if all(self._ef_bank.get(c, (-1, b""))[0] >= round_idx
                       for c in cids):
                    return True
                left = end - time.monotonic()
                if left <= 0:
                    return False
                self._bank_cv.wait(left)

    # -- the round ---------------------------------------------------------
    def broadcast_round(self, round_idx: int, down_frame,
                        participate=None) -> np.ndarray:
        """ROUND to every live worker: the framed params broadcast plus the
        per-client participate flag. Params-frame bytes are downlink data
        (``LinkStats``); the 5-byte round prefix is overhead."""
        b = np.asarray(down_frame, np.uint8).tobytes()
        if participate is None:
            participate = np.ones((self.num_clients,), bool)
        participate = np.asarray(participate, bool)
        for cid in range(self.num_clients):
            if cid not in self._conns or self._is_dead(cid):
                continue
            flags = FLAG_PARTICIPATE if participate[cid] else 0
            n = self._send_or_bury(
                cid, MSG_ROUND, struct.pack("<IB", round_idx, flags) + b)
            if n:
                self.downlink._record(len(b))
                with self._lock:
                    self.overhead_down += n - len(b)
                get_tracer().event("tx_frame", round=round_idx, client=cid,
                                   bytes=len(b))
        return participate

    def collect(self, round_idx: int, expected, *, policy,
                deadline_s: float):
        """Drain this round's uplink under the deadline; returns the same
        ``DeliveryReport`` shape as ``RoundEngine.deliver`` so the live
        round loop and the in-process oracle consume one structure.

        ``expected`` is the (N,) bool mask of clients a frame is owed from
        (participating AND live at broadcast time). Timer/corruption/death
        handling per the module docstring; every received frame is billed
        on receipt, before filtering or validation — the bytes crossed the
        wire even when they turn out to be garbage.
        """
        from repro_torch.fl.engine import DeliveryReport  # lazy: fl sits above comm

        N = self.num_clients
        expected = np.asarray(expected, bool)
        frames: List[Optional[np.ndarray]] = [None] * N
        delivered = np.zeros((N,), bool)
        retries = 0
        start = time.monotonic()
        deadline = start + deadline_s
        # cid -> [attempt, due]; resolved clients leave the dict
        pending = {i: [0, start + policy.timeout(0)]
                   for i in range(N) if expected[i] and not self._is_dead(i)}

        tracer = get_tracer()

        def bump(cid: int, now: float):
            nonlocal retries
            attempt = pending[cid][0]
            if attempt >= policy.max_retries:
                del pending[cid]                     # give up: undelivered
                self._meters.counter("transport.give_up").inc()
                tracer.event("retry.give_up", round=round_idx, client=cid,
                             attempts=attempt)
                return
            retries += 1
            self._meters.counter("transport.resend").inc()
            tracer.event("retry.resend", round=round_idx, client=cid,
                         attempt=attempt + 1)
            self._send_or_bury(cid, MSG_RESEND, struct.pack("<I", round_idx))
            with self._lock:
                self.overhead_down += _HDR.size + 4
            pending[cid] = [attempt + 1, now + policy.timeout(attempt + 1)]

        while pending:
            now = time.monotonic()
            if now >= deadline:
                break
            for cid in [c for c in pending if self._is_dead(c)]:
                del pending[cid]                     # dead: never hang on it
            for cid in [c for c, (_, d) in pending.items() if d <= now]:
                bump(cid, now)                       # timer expired: retry
            if not pending:
                break
            due = min(d for _, d in pending.values())
            wait = max(min(due, deadline) - now, 0.001)
            try:
                cid, body = self._rx.get(timeout=wait)
            except queue.Empty:
                continue
            now = time.monotonic()
            if body is None:
                continue                             # death sentinel
            # bill on receipt, then trace with the final outcome tag: every
            # uplink._record has exactly one rx_frame event carrying the
            # billed byte count, so trace sums reconcile with the ledger
            self.uplink._record(len(body))
            nbytes = len(body)
            buf = np.frombuffer(body, np.uint8)
            if self.rx_filter is not None:
                buf = self.rx_filter(cid, round_idx, buf)
                if buf is None:
                    tracer.event("rx_frame", round=round_idx, client=cid,
                                 bytes=nbytes, outcome="filtered")
                    continue                         # eaten: timer will fire
            ok, stale = False, False
            try:
                hdr = parse_header(buf)
                stale = hdr["round"] != round_idx
                ok = not stale and hdr["client"] == cid
            except FrameError:
                ok = False
            if stale or cid not in pending:
                tracer.event("rx_frame", round=round_idx, client=cid,
                             bytes=nbytes,
                             outcome="stale" if stale else "late")
                continue                 # late/duplicate: billed, discarded
            if ok:
                frames[cid] = np.array(buf, np.uint8)
                delivered[cid] = True
                del pending[cid]
                tracer.event("rx_frame", round=round_idx, client=cid,
                             bytes=nbytes, outcome="ok")
            else:
                tracer.event("rx_frame", round=round_idx, client=cid,
                             bytes=nbytes, outcome="corrupt")
                bump(cid, now)                       # corrupt: retry now
        return DeliveryReport(frames, delivered, retries)

    def send_acks(self, round_idx: int, delivered) -> None:
        """ACK each live worker its delivered verdict — the signal that
        commits the worker's EF branch (``e' = u - r`` vs ``e' = u``)."""
        delivered = np.asarray(delivered, bool)
        for cid in range(self.num_clients):
            if cid not in self._conns or self._is_dead(cid):
                continue
            n = self._send_or_bury(
                cid, MSG_ACK,
                struct.pack("<IB", round_idx, int(delivered[cid])))
            with self._lock:
                self.overhead_down += n

    # -- diagnostics -------------------------------------------------------
    def pop_metrics(self, round_idx: int) -> Dict[int, float]:
        with self._lock:
            keys = [k for k in self._metrics if k[0] == round_idx]
            return {cid: self._metrics.pop((rnd, cid)) for rnd, cid in keys}

    def clock_offsets(self) -> Dict[str, int]:
        """Per-worker ``server_clock - worker_clock`` estimates (ns), keyed
        by the worker's trace proc label — feed :func:`~repro_torch.obs.merge_traces`
        together with :meth:`pop_worker_spans`."""
        with self._lock:
            return {f"client-{cid}": off
                    for cid, off in self._clock_offset_ns.items()}

    def pop_worker_spans(self) -> Dict[str, List[dict]]:
        """Drain the spans workers piggybacked on MSG_METRIC, keyed by
        trace proc label, still on each worker's own clock."""
        with self._lock:
            out = {f"client-{cid}": spans
                   for cid, spans in self._worker_spans.items()}
            self._worker_spans = {}
        return out

    def request_ef(self, cid: int, timeout: float = 30.0) -> Optional[np.ndarray]:
        """Ask one worker for its committed EF residual (flat f32 leaf
        stream) — the observability hook the conservation gates read. None
        for a dead/silent worker."""
        if cid not in self._conns or self._is_dead(cid):
            return None
        evt = threading.Event()
        with self._lock:
            self._ef.pop(cid, None)
            self._ef_evt[cid] = evt
        n = self._send_or_bury(cid, MSG_EF_REQ)
        with self._lock:
            self.overhead_down += n
        if not evt.wait(timeout):
            return None
        with self._lock:
            body = self._ef.pop(cid, None)
            self._ef_evt.pop(cid, None)
        if body is None:
            return None
        return np.frombuffer(body, np.float32).copy()

    def stop(self) -> None:
        """STOP every worker and tear the sockets down (idempotent)."""
        with self._lock:
            if self._stopping:
                return
            self._stopping = True
        self._meters.unregister_source("transport.ledger")
        for cid in list(self._conns):
            self._send_or_bury(cid, MSG_STOP)
        try:
            self._lsock.close()
        except OSError:
            pass
        for conn in list(self._conns.values()):
            try:
                conn.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=2.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


# ---------------------------------------------------------------------------
# worker half (the socket side; the FL compute lives in repro_torch.launch.worker)
# ---------------------------------------------------------------------------


class ServerLink:
    """A worker's connection to the server: HELLO handshake, a heartbeat
    daemon that ticks even while the main thread computes (so a busy or
    sleeping worker stays *alive*, just late), and lock-serialized sends."""

    def __init__(self, sock: socket.socket, client_id: int):
        self.sock = sock
        self.client_id = client_id
        self._send_lock = threading.Lock()
        self._closed = False

    @classmethod
    def connect(cls, address: Tuple[str, int], client_id: int, *,
                timeout: float = 30.0) -> "ServerLink":
        end = time.monotonic() + timeout
        last: Exception = None
        while time.monotonic() < end:
            try:
                sock = socket.create_connection(address, timeout=timeout)
                sock.settimeout(None)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                link = cls(sock, client_id)
                link.send(MSG_HELLO, struct.pack("<I", client_id))
                return link
            except OSError as e:
                last = e
                time.sleep(0.1)
        raise ConnectionError(
            f"could not reach server at {address}: {last}")

    def start_heartbeat(self, heartbeat_s: float) -> None:
        def beat():
            while not self._closed:
                time.sleep(heartbeat_s)
                try:
                    # timestamped tick: the server turns these into a
                    # clock-offset estimate for cross-process trace merge
                    self.send(MSG_HEARTBEAT,
                              struct.pack("<Q", now_ns()))
                except (ConnectionError, OSError):
                    return
        threading.Thread(target=beat, daemon=True).start()

    def send(self, mtype: int, body: bytes = b"") -> None:
        with self._send_lock:
            send_msg(self.sock, mtype, body)

    def recv(self) -> Tuple[int, bytes]:
        return recv_msg(self.sock)

    def close(self) -> None:
        self._closed = True
        try:
            self.sock.close()
        except OSError:
            pass


def spawn_local_workers(address: Tuple[str, int],
                        client_ids: Sequence[int], *,
                        device: str = "cuda",
                        env: Optional[Dict[str, str]] = None,
                        log_dir: Optional[str] = None,
                        cpu_threads: int = 1,
                        ) -> List[subprocess.Popen]:
    """Spawn one ``repro_torch.launch.worker`` process per client id,
    pointed at ``address``, each computing on ``device`` (the card unless
    the caller asks for the CPU; a worker raises when CUDA is asked for
    and absent). Local spawning is a convenience — the workers only know
    a ``host:port``, so running them on other hosts is a config change.

    The child env gets ``src/`` on PYTHONPATH (derived from this package's
    location) and nothing else. CPU workers run ``cpu_threads`` threads
    each (``torch.set_num_threads``), so N of them beside other processes
    do not oversubscribe the host. With ``log_dir``, each worker's output
    is appended to ``<log_dir>/worker-<cid>.log`` (a restarted worker
    appends to its predecessor's file)."""
    host, port = address
    src_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    e = dict(os.environ if env is None else env)
    old = e.get("PYTHONPATH")
    e["PYTHONPATH"] = src_root + ((os.pathsep + old) if old else "")
    procs = []
    for cid in client_ids:
        cmd = [sys.executable, "-m", "repro_torch.launch.worker",
               "--connect", f"{host}:{port}", "--client-id", str(cid),
               "--device", device]
        if str(device).split(":", 1)[0] == "cpu":
            cmd += ["--threads", str(cpu_threads)]
        out = None
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            out = open(os.path.join(log_dir, f"worker-{cid}.log"), "ab")
        try:
            procs.append(subprocess.Popen(
                cmd, env=e, stdout=out,
                stderr=None if out is None else subprocess.STDOUT))
        finally:
            if out is not None:
                out.close()          # the child holds its own descriptor
    return procs
