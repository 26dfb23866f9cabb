"""The port's socket transport: the mirror of tests/test_transport.py
(framing primitives, deadline/retry/liveness semantics against fake
raw-socket workers, a seeded round over real worker processes) for
``repro_torch.comm.transport``, the byte identity of every message with
the reference's, and the port's live server step against the reference's
``LiveRoundLoop._step``.

The live rounds spawn 2 CPU workers of the port with the tiny (6, 6, 1)
spec and hold them bitwise to the port's in-process codec round (itself
held to the reference's round in tests/test_torch_round.py and
tests/test_torch_faults.py). CPU results depend on the thread count, so
the in-process oracle runs on the workers' one thread.

Everything that opens real sockets or subprocesses carries
``@pytest.mark.transport``: conftest arms those tests with a hard SIGALRM
ceiling, so a hang fails the test instead of stalling the suite.
"""
import json
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from repro.comm import transport as jtransport
from repro_torch.comm import transport
from repro_torch.comm.frame import FrameSpec, encode_header
from repro_torch.comm.transport import (MAX_MSG, MSG_FRAME, MSG_HEARTBEAT,
                                        MSG_HELLO, MSG_RESEND, MSG_ROUND,
                                        ProtocolError, SocketServer,
                                        recv_msg, send_msg,
                                        spawn_local_workers)
from repro_torch.configs.base import FLConfig
from repro_torch.configs.run import RunConfig
from repro_torch.core.tree import tree_leaves
from repro_torch.fl.engine import LiveRoundLoop, RetryPolicy
from repro_torch.launch.worker import vision_setup
from _torch_live import (TINY, TRAIN_N, WARM, ef_row, inproc_oracle,
                         stop_all, tiny_world)

_SPEC = FrameSpec("identity", "fp32", (8,))

torch.set_num_threads(2)


def _codec_frame(round_idx=0, client_idx=0) -> np.ndarray:
    head = encode_header(_SPEC, round_idx, client_idx).numpy()
    return np.concatenate([head, np.arange(8, dtype=np.uint8)])


# ---------------------------------------------------------------------------
# framing primitives (socketpair: no listener, cannot hang)
# ---------------------------------------------------------------------------


def test_msg_roundtrip_including_zero_length_body():
    a, b = socket.socketpair()
    try:
        n = send_msg(a, MSG_HEARTBEAT)
        assert n == 5
        assert recv_msg(b) == (MSG_HEARTBEAT, b"")
        payload = np.arange(32, dtype=np.uint8)
        n = send_msg(a, MSG_FRAME, payload)
        assert n == 5 + 32
        mtype, body = recv_msg(b)
        assert mtype == MSG_FRAME
        np.testing.assert_array_equal(np.frombuffer(body, np.uint8), payload)
        send_msg(a, MSG_FRAME, b"")
        assert recv_msg(b) == (MSG_FRAME, b"")
    finally:
        a.close()
        b.close()


def test_partial_read_at_length_prefix_boundary_is_connection_error():
    a, b = socket.socketpair()
    a.sendall(struct.pack("<IB", 100, MSG_FRAME)[:3])
    a.close()
    with pytest.raises(ConnectionError):
        recv_msg(b)
    b.close()
    a, b = socket.socketpair()
    a.sendall(struct.pack("<IB", 100, MSG_FRAME) + b"x" * 10)
    a.close()
    with pytest.raises(ConnectionError):
        recv_msg(b)
    b.close()


def test_insane_length_prefix_is_protocol_error():
    a, b = socket.socketpair()
    a.sendall(struct.pack("<IB", MAX_MSG + 1, MSG_FRAME))
    with pytest.raises(ProtocolError):
        recv_msg(b)
    a.close()
    b.close()


def test_retry_policy_backoff_schedule():
    from repro.fl.engine import RetryPolicy as JRetryPolicy

    pol = RetryPolicy(max_retries=3, recv_timeout_s=1.0, recv_backoff=2.0,
                      max_timeout_s=5.0)
    assert [pol.timeout(a) for a in range(4)] == [1.0, 2.0, 4.0, 5.0]
    flat = RetryPolicy(max_retries=2, recv_timeout_s=0.5, recv_backoff=1.0,
                       max_timeout_s=10.0)
    assert [flat.timeout(a) for a in range(3)] == [0.5, 0.5, 0.5]
    # the reference's schedule, attempt for attempt, and its refusals
    for kw in ({"max_retries": 5, "recv_timeout_s": 0.3,
                "recv_backoff": 1.7, "max_timeout_s": 4.1},
               {"max_retries": 2, "recv_timeout_s": 2.0}, {}):
        assert [RetryPolicy(**kw).timeout(a) for a in range(8)] == \
            [JRetryPolicy(**kw).timeout(a) for a in range(8)]
    for bad in ({"max_retries": -1}, {"recv_timeout_s": 0.0},
                {"recv_backoff": 0.9},
                {"recv_timeout_s": 3.0, "max_timeout_s": 2.0}):
        with pytest.raises(ValueError):
            RetryPolicy(**bad)
        with pytest.raises(ValueError):
            JRetryPolicy(**bad)
    run = RunConfig(fl=FLConfig(), transport="socket", wire="codec",
                    round_deadline_s=7.0, recv_timeout_s=0.5)
    assert run.retry_policy() == RetryPolicy(
        max_retries=2, recv_timeout_s=0.5, recv_backoff=2.0,
        max_timeout_s=7.0)


# ---------------------------------------------------------------------------
# the same messages, byte for byte, in both packages
# ---------------------------------------------------------------------------


def test_message_vocabulary_and_header_match_the_reference():
    def vocab(mod):
        return {k: getattr(mod, k) for k in dir(mod)
                if k.startswith("MSG_") or k.startswith("FLAG_")}

    assert vocab(transport) == vocab(jtransport)
    assert len([k for k in vocab(transport) if k.startswith("MSG_")]) == 13
    assert transport._HDR.format == jtransport._HDR.format == "<IB"
    assert transport.MAX_MSG == jtransport.MAX_MSG


def _fake_worker(server, cid):
    sock = socket.create_connection(server.address, timeout=10)
    send_msg(sock, MSG_HELLO, struct.pack("<I", cid))
    return sock


def _drain(sock, until: int):
    """Raw bytes read from ``sock`` until a message of type ``until``."""
    raw = bytearray()
    while True:
        head = transport.recv_exact(sock, 5)
        length, mtype = struct.unpack("<IB", head)
        body = transport.recv_exact(sock, length)
        raw += head + body
        if mtype == until:
            return bytes(raw), body


def _server_stream(mod, frame: np.ndarray) -> tuple:
    """Every server -> worker message one package's server sends a fake
    worker — SETUP with a banked EF slice (EF_SYNC), ROUND, RESEND, ACK,
    EF_REQ, STOP — as raw bytes; and the server's byte ledger."""
    server = mod.SocketServer(1, heartbeat_s=0.5, liveness_timeout_s=60.0)
    try:
        server.seed_ef_bank({0: (3, np.linspace(-1, 1, 6, dtype=np.float32))})
        # SETUP first, so the worker gets it from the accept loop alone
        # (the reference may send it twice to a worker connecting as it
        # goes out; the port's test below holds it to once)
        server.send_setup({"kind": "vision", "run": {"x": 1}})
        sock = _fake_worker(server, 0)
        server.wait_ready(10)
        raw, _ = _drain(sock, mod.MSG_EF_SYNC)
        r = server.begin_round()
        server.broadcast_round(r, frame, np.array([True]))
        raw2, _ = _drain(sock, mod.MSG_ROUND)
        # one RESEND (the timer), then the worker answers; then the ACK
        pol = RetryPolicy(max_retries=1, recv_timeout_s=0.2,
                          recv_backoff=50.0, max_timeout_s=10.0)

        raw3 = []

        def answer():
            raw3.append(_drain(sock, mod.MSG_RESEND)[0])
            send_msg(sock, MSG_FRAME, _codec_frame(r, 0))

        t = threading.Thread(target=answer)
        t.start()
        rep = server.collect(r, [True], policy=pol, deadline_s=10.0)
        t.join(10)
        assert rep.delivered[0] and rep.retries == 1
        server.send_acks(r, rep.delivered)
        raw4, _ = _drain(sock, mod.MSG_ACK)

        def dump():
            _drain(sock, mod.MSG_EF_REQ)
            send_msg(sock, mod.MSG_EF_DUMP, np.ones(4, np.float32).tobytes())

        t = threading.Thread(target=dump)
        t.start()
        ef = server.request_ef(0, timeout=10)
        t.join(10)
        np.testing.assert_array_equal(ef, np.ones(4, np.float32))
        raw5 = []

        def hang_up():
            # read STOP, then close: the server's reader thread sees EOF
            raw5.append(_drain(sock, mod.MSG_STOP)[0])
            sock.close()

        t = threading.Thread(target=hang_up)
        t.start()
        server.stop()
        t.join(10)
        return raw + raw2 + raw3[0] + raw4 + raw5[0], server.ledger()
    finally:
        server.stop()


@pytest.mark.transport
def test_every_server_message_is_byte_identical_to_the_reference():
    frame = np.arange(37, dtype=np.uint8)
    port_raw, port_ledger = _server_stream(transport, frame)
    ref_raw, ref_ledger = _server_stream(jtransport, frame)
    assert port_raw == ref_raw
    assert port_ledger == ref_ledger
    # worker -> server: the same helper frames both packages' messages
    for mtype in range(13):
        body = struct.pack("<If", 7, 0.25) + b'[{"k": 1}]'
        a, b = socket.socketpair()
        send_msg(a, mtype, body)
        jtransport.send_msg(a, mtype, body)
        x, y = transport.recv_exact(b, 5 + len(body)), \
            transport.recv_exact(b, 5 + len(body))
        assert x == y
        a.close()
        b.close()


@pytest.mark.transport
def test_a_worker_connecting_as_setup_goes_out_gets_it_once():
    """The join state (SETUP, then the banked EF) reaches each worker
    exactly once, whether it connected before ``send_setup`` or while it
    ran."""
    for attempt in range(4):
        server = SocketServer(1, heartbeat_s=0.5, liveness_timeout_s=60.0)
        try:
            server.seed_ef_bank({0: (1, np.zeros(3, np.float32))})
            sock = _fake_worker(server, 0)
            if attempt % 2:
                server.wait_ready(10)
            server.send_setup({"n": attempt})
            got = [recv_msg(sock)[0], recv_msg(sock)[0]]
            assert got == [transport.MSG_SETUP, transport.MSG_EF_SYNC]
            sock.settimeout(0.3)
            with pytest.raises(socket.timeout):
                recv_msg(sock)                  # nothing more
        finally:
            sock.close()
            server.stop()


# ---------------------------------------------------------------------------
# server semantics against fake raw-socket workers
# ---------------------------------------------------------------------------


@pytest.mark.transport
def test_corrupt_frames_exhaust_retries_then_dropped():
    server = SocketServer(1, heartbeat_s=0.5, liveness_timeout_s=60.0)
    sock = _fake_worker(server, 0)
    stop = threading.Event()
    resends = []

    def worker():
        while not stop.is_set():
            try:
                mtype, body = recv_msg(sock)
            except (ConnectionError, OSError):
                return
            if mtype == MSG_RESEND:
                resends.append(struct.unpack("<I", body)[0])
            if mtype in (MSG_ROUND, MSG_RESEND):
                send_msg(sock, MSG_FRAME, b"\x00" * 64)   # never parses

    t = threading.Thread(target=worker, daemon=True)
    try:
        server.wait_ready(10)
        t.start()
        r = server.begin_round()
        server.broadcast_round(r, np.zeros((16,), np.uint8))
        pol = RetryPolicy(max_retries=2, recv_timeout_s=0.5,
                          recv_backoff=1.0, max_timeout_s=1.0)
        t0 = time.monotonic()
        rep = server.collect(r, [True], policy=pol, deadline_s=20.0)
        wall = time.monotonic() - t0
        assert not rep.delivered[0] and rep.frames[0] is None
        assert rep.retries == 2 and resends == [r, r]
        assert wall < 10.0
        assert server.uplink.per_round[-1] >= 64
    finally:
        stop.set()
        server.stop()
        sock.close()


@pytest.mark.transport
def test_worker_killed_mid_frame_maps_to_dropped_never_hangs():
    server = SocketServer(1, heartbeat_s=0.5, liveness_timeout_s=60.0)
    sock = _fake_worker(server, 0)

    def worker():
        try:
            mtype, _ = recv_msg(sock)
            assert mtype == MSG_ROUND
            sock.sendall(struct.pack("<IB", 4096, MSG_FRAME) + b"y" * 100)
            sock.close()                       # SIGKILL from the wire's view
        except (ConnectionError, OSError):
            pass

    t = threading.Thread(target=worker, daemon=True)
    try:
        server.wait_ready(10)
        t.start()
        r = server.begin_round()
        server.broadcast_round(r, np.zeros((16,), np.uint8))
        pol = RetryPolicy(max_retries=5, recv_timeout_s=10.0,
                          max_timeout_s=10.0)
        t0 = time.monotonic()
        rep = server.collect(r, [True], policy=pol, deadline_s=60.0)
        wall = time.monotonic() - t0
        assert not rep.delivered[0]
        assert wall < 10.0                     # death sentinel, not deadline
        assert server.live_workers() == []
    finally:
        server.stop()


@pytest.mark.transport
def test_stale_frame_is_billed_then_discarded():
    server = SocketServer(1, heartbeat_s=0.5, liveness_timeout_s=60.0)
    sock = _fake_worker(server, 0)
    stale = _codec_frame(round_idx=0, client_idx=0)
    sent = {"n": 0}

    def worker():
        while True:
            try:
                mtype, _ = recv_msg(sock)
            except (ConnectionError, OSError):
                return
            if mtype == MSG_ROUND:
                sent["n"] += 1
                send_msg(sock, MSG_FRAME, stale)          # wrong round
            elif mtype == MSG_RESEND:
                sent["n"] += 1
                send_msg(sock, MSG_FRAME, _codec_frame(1, 0))

    t = threading.Thread(target=worker, daemon=True)
    try:
        server.wait_ready(10)
        t.start()
        assert server.begin_round() == 0
        r = server.begin_round()
        assert r == 1
        server.broadcast_round(r, np.zeros((16,), np.uint8))
        pol = RetryPolicy(max_retries=2, recv_timeout_s=0.5,
                          recv_backoff=1.0, max_timeout_s=1.0)
        rep = server.collect(r, [True], policy=pol, deadline_s=20.0)
        assert rep.delivered[0] and rep.retries == 1 and sent["n"] == 2
        assert server.uplink.per_round[-1] == 2 * stale.nbytes
    finally:
        server.stop()
        sock.close()


# ---------------------------------------------------------------------------
# the live server step against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["stc", "signsgd", "threesfc"])
def test_live_server_step_matches_the_reference(kind):
    """The port's ``LiveRoundLoop`` step on 3 frames (one undelivered,
    its row a zero placeholder) against the reference's jitted
    ``LiveRoundLoop._step`` on the same frames, mask and params, within
    the round's declared tolerance."""
    import jax.numpy as jnp

    from repro.configs.base import CompressorConfig as JComp
    from repro.configs.base import FLConfig as JFL
    from repro.configs.run import RunConfig as JRun
    from repro.core.strategy import make_strategy as jmake_strategy
    from repro.fl.engine import LiveRoundLoop as JLive
    from repro.models.build import vision_syn_spec as jsyn_spec
    from repro.models.cnn import VisionSpec as JSpec
    from repro.models.cnn import make_paper_model as jmodel

    n = 3
    run, model, params, strategy, codec = tiny_world(kind, n)
    g = torch.Generator().manual_seed(4)
    frames = []
    for i in range(n):
        u = {k: v + 0.01 * torch.randn(v.shape, generator=g)
             for k, v in _leafwise(params).items()}
        ef = strategy.init_ef_state(params)
        msg, _, _ = strategy.wire_step(torch.Generator().manual_seed(i),
                                       _unleaf(u, params), ef, params,
                                       codec=codec, round_idx=0,
                                       client_idx=i)
        frames.append(msg.numpy())
    delivered = np.array([True, False, True])
    frames[1] = np.zeros_like(frames[1])          # the placeholder row
    loop = LiveRoundLoop(None, strategy, codec, run, params)
    loop._step(np.stack(frames), delivered)

    jspec = JSpec(*TINY)
    jcomp = JComp(kind=kind, keep_ratio=0.1, syn_steps=2)
    jrun = JRun(fl=JFL(num_clients=n, local_steps=2, local_lr=0.05,
                       local_batch=4, compressor=jcomp, seed=0),
                wire="codec", transport="socket", transport_retries=0)
    jm = jmodel("mlp", jspec)
    jparams = {k: {kk: jnp.asarray(vv.numpy()) for kk, vv in v.items()}
               for k, v in params.items()}
    jstrategy = jmake_strategy(jcomp, loss_fn=jm.syn_loss,
                               syn_spec=jsyn_spec(jspec, jcomp),
                               local_lr=0.05)
    jcodec = jstrategy.wire_codec(jparams, policy=jrun.wire_policy)
    assert jcodec.nbytes == codec.nbytes
    jloop = JLive(None, jstrategy, jcodec, jrun, jparams)
    want = jloop._step(jparams, jnp.asarray(np.stack(frames)),
                       jnp.asarray(delivered))
    for k, v in loop.params.items():
        for kk, vv in v.items():
            np.testing.assert_allclose(vv.numpy(), np.asarray(want[k][kk]),
                                       rtol=1e-4, atol=1e-6)


def _leafwise(params):
    return {f"{k}/{kk}": vv for k, v in params.items()
            for kk, vv in v.items()}


def _unleaf(flat_, params):
    return {k: {kk: flat_[f"{k}/{kk}"] for kk in v}
            for k, v in params.items()}


# ---------------------------------------------------------------------------
# seeded end-to-end: real worker processes vs the in-process round
# ---------------------------------------------------------------------------


@pytest.mark.transport(timeout=240)
@pytest.mark.parametrize("kind", ["stc", "threesfc", "signsgd"])
def test_live_socket_round_bitwise_equals_inprocess_round(kind, tmp_path):
    """Two worker processes drive rounds over the socket; params,
    per-client EF and per-round billing are bitwise what the port's
    in-process codec round computes from the same seed."""
    N, R = 2, 2
    run, model, params, strategy, codec = tiny_world(kind, N)
    want_params, want_ef = inproc_oracle(kind, N, R)
    server = SocketServer(N, heartbeat_s=run.heartbeat_s,
                          liveness_timeout_s=run.liveness_timeout_s)
    procs = spawn_local_workers(server.address, range(N), device="cpu",
                                log_dir=str(tmp_path))
    try:
        server.wait_ready(60)
        server.send_setup(vision_setup(run, model="mlp", spec=TINY,
                                       train_size=TRAIN_N, device="cpu"))
        loop = LiveRoundLoop(server, strategy, codec, run, params)
        loop.run(1, deadline_s=90.0, policy=WARM)
        live_params = loop.run(R - 1)
        efs = [server.request_ef(i, timeout=30) for i in range(N)]
    finally:
        stop_all(server, procs)
    assert all(rec["delivered"].all() for rec in loop.history)
    for a, b in zip(tree_leaves(want_params), tree_leaves(live_params)):
        assert torch.equal(a, b)
    for i in range(N):
        np.testing.assert_array_equal(efs[i], ef_row(want_ef, i))
    # the data plane billed exactly the codec bytes; headers, ACKs and
    # heartbeats live in the overhead buckets
    assert loop.history[1]["bytes_up"] == N * codec.nbytes
    assert server.overhead_up > 0 and server.overhead_down > 0
    # each worker logged its kernel launches at STOP (none on the CPU)
    for i in range(N):
        log = (tmp_path / f"worker-{i}.log").read_text()
        line = [l for l in log.splitlines() if "launches" in l][-1]
        counts = json.loads(line.split("launches ", 1)[1])
        assert set(counts) >= {"fused_cosine", "ef_update", "pack_signs"}
