"""Client worker process: the other end of the socket transport.

``python -m repro_torch.launch.worker --connect host:port --client-id i``
dials the ``repro_torch.comm.transport.SocketServer`` at ``host:port``,
introduces itself (HELLO), rebuilds the client's whole computation from
the server's SETUP blob — model, synthetic dataset, Dirichlet partition,
strategy, codec, seeds, device — and then serves rounds until STOP. It
computes on the card unless the SETUP blob (or ``--device cpu``) asks for
the CPU, and raises when CUDA is asked for and absent.

Determinism (the live round is bitwise the in-process codec round)
------------------------------------------------------------------
The worker computes exactly what the in-process round computes for client
``i``, from nothing but the SETUP blob and its client id:

* the round's global params are the server's ROUND broadcast
  (identity-codec framed, lossless f32);
* the data, partition and pools come from ``launch.train.vision_data``,
  the trainer's own construction, and the batch of (round r, client i)
  from the engine's batcher seeded with ``fold_in(data_seed, r, i)``
  (``repro_torch.fl.engine``);
* the encoder draws from ``client_generator(fold_in(round_seed, r), i)``;
* the client step is the round's own (``fl.round.make_client_step``:
  local training, then ``strategy.wire_step``), and a message that does
  not count leaves ``fl.round.missed_ef``'s residual.

EF commit protocol
------------------
The worker holds its EF residual and defers the commit until the server's
ACK for the round: ACK(delivered=1) commits the strategy's residual
(``e' = u - r``), ACK(delivered=0) the whole update (``e' = u = g + e``).
A round still un-acked when the next ROUND arrives is committed as
undelivered (the server has moved on without its frame). MSG_EF_REQ dumps
the committed residual as a flat f32 stream in tree-leaf order (the
reference's sorted-key order).

Every commit is also pushed to the server (MSG_EF_PUSH, tagged with the
committed round), so the server's EF bank holds this client's last
residual — the only state the worker owns. A replacement process for a
killed worker is re-synced from that bank (MSG_EF_SYNC, ``install_ef``)
and continues bitwise from where its predecessor committed.

A non-participating round (ROUND flags bit 0 clear) is sat out: no
compute, no frame, EF frozen. The SETUP blob may carry ``straggle[cid] =
seconds``, slept between computing and sending (the heartbeat keeps
ticking, so a straggler is alive, just late). At STOP the worker logs one
line ``launches {...}`` with its kernels' launch counts.
"""
from __future__ import annotations

import argparse
import json
import struct
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.comm.codec import make_codec
from repro_torch.comm.transport import (FLAG_PARTICIPATE, MSG_ACK,
                                        MSG_EF_DUMP, MSG_EF_PUSH, MSG_EF_REQ,
                                        MSG_EF_SYNC, MSG_FRAME, MSG_METRIC,
                                        MSG_RESEND, MSG_ROUND, MSG_SETUP,
                                        MSG_STOP, ServerLink)
from repro_torch.configs.base import CompressorConfig
from repro_torch.configs.run import RunConfig
from repro_torch.core import flat
from repro_torch.core.tree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.fl.engine import (_DATA_FOLD, _ROUND_FOLD, ClientPools,
                                   vision_batcher)
from repro_torch.fl.round import (client_generator, fold_in,
                                  make_client_step, missed_ef)
from repro_torch.kernels import bitpack, causal_attention, ef_update
from repro_torch.kernels import fused_cosine, sign_quant, ssd_chunk, topk_mask
from repro_torch.launch.train import (resolve_device, vision_data,
                                      vision_model, vision_strategy)
from repro_torch.models.cnn import VisionSpec
from repro_torch.obs import configure_tracer, get_logger, get_tracer

PyTree = Any

# pre-SETUP heartbeat period: the worker must look alive from the moment it
# connects (rebuilding the computation takes seconds), before it knows the
# configured heartbeat_s
_BOOT_HEARTBEAT_S = 0.2


def launch_counts() -> Dict[str, int]:
    """This process's kernel launches so far, by kernel."""
    return {"fused_cosine": fused_cosine.LAUNCHES,
            "ef_update": ef_update.LAUNCHES, **bitpack.LAUNCHES,
            "ssd_chunk": ssd_chunk.LAUNCHES,
            "sign_quant": sign_quant.LAUNCHES,
            "topk_mask": topk_mask.LAUNCHES,
            "causal_attention": causal_attention.LAUNCHES}


def vision_setup(run: RunConfig, *, model: str, spec: VisionSpec,
                 train_size: int,
                 straggle: Optional[Dict[int, float]] = None,
                 trace: bool = False, device: str = "cuda") -> Dict:
    """The SETUP blob of a vision run — everything a worker needs to
    rebuild the client computation, JSON-serializable, the reference's
    keys plus the workers' ``device``. ``trace=True`` turns on the
    worker-side span recorder (spans ride back on MSG_METRIC)."""
    return {
        "kind": "vision",
        "model": model,
        "spec": [spec.name, list(spec.input_shape), int(spec.num_classes)],
        "train_size": int(train_size),
        "run": run.to_json(),
        "straggle": {str(k): float(v) for k, v in (straggle or {}).items()},
        "trace": bool(trace),
        "device": str(device),
    }


class VisionClientCompute:
    """Client ``i``'s half of the vision round, rebuilt from a SETUP blob,
    on ``device`` (default: the blob's). Holds the client's EF residual and
    the round staged for the deferred ACK commit."""

    def __init__(self, setup: Dict, client_id: int,
                 device: Optional[str] = None):
        run = RunConfig.from_json(setup["run"])
        cfg = run.fl
        self.device = resolve_device(device or setup.get("device", "cuda"))
        spec = VisionSpec(setup["spec"][0], tuple(setup["spec"][1]),
                          int(setup["spec"][2]))
        model, params = vision_model(setup["model"], spec, cfg.seed,
                                     self.device)
        self.strategy = vision_strategy(model, spec, cfg)
        codec = self.strategy.wire_codec(params, policy=run.wire_policy)
        train, pools = vision_data(spec, cfg, setup["train_size"],
                                   self.device)
        i = self.client_id = int(client_id)
        # this client's row of the pools, drawn under its global id
        self._batch_fn = vision_batcher(
            train.x, train.y,
            ClientPools(pools.index[i:i + 1], pools.size[i:i + 1]),
            cfg.local_steps, cfg.local_batch, clients=range(i, i + 1))
        self._data_seed = fold_in(cfg.seed, _DATA_FOLD)
        self._round_seed = fold_in(cfg.seed, _ROUND_FOLD)
        self._step = make_client_step(model.loss, self.strategy, run,
                                      codec=codec)
        self.run = run
        self.codec = codec
        self.ef = self.strategy.init_ef_state(params)
        self._pending: Optional[Dict] = None
        # the downlink params frame is identity-coded (lossless f32)
        self._down = make_codec(
            CompressorConfig(kind="identity", error_feedback=False), params)

    def decode_params(self, frame_bytes: bytes) -> PyTree:
        buf = torch.as_tensor(np.frombuffer(frame_bytes, np.uint8).copy())
        # fresh leaves, as the server's params are, not views into the
        # frame at the header's offset
        return flat.tree_map(torch.clone,
                             self._down.decode(buf.to(self.device)))

    def compute(self, params: PyTree, round_idx: int):
        """Run the client's round ``round_idx``; stages it for the
        deferred ACK commit. Returns (frame bytes, loss)."""
        batches = flat.tree_map(lambda x: x[0],
                                self._batch_fn(self._data_seed, round_idx))
        key = client_generator(fold_in(self._round_seed, round_idx),
                               self.client_id, self.device)
        out = self._step(params, batches, self.ef, key, self.client_id,
                         round_idx)
        self._pending = {"round": round_idx, "out": out, "ef_in": self.ef}
        return out.msg.cpu().numpy().tobytes(), float(out.loss)

    def pending_round(self) -> Optional[int]:
        return None if self._pending is None else self._pending["round"]

    def commit(self, delivered: bool) -> None:
        """Resolve the staged round: the strategy's residual on delivery,
        the whole update on drop (``fl.round.missed_ef``), in the carried
        EF dtype, as the in-process round writes its EF rows."""
        if self._pending is None:
            return
        out, ef_in = self._pending["out"], self._pending["ef_in"]
        src = out.ef if delivered else missed_ef(self.strategy, out, ef_in,
                                                 True)
        self.ef = flat.tree_map(lambda n, o: n.to(o.dtype), src, ef_in)
        self._pending = None

    def ef_bytes(self) -> bytes:
        """The committed residual as the flat f32 stream MSG_EF_DUMP and
        MSG_EF_PUSH carry (tree-leaf order)."""
        return torch.cat([l.reshape(-1).to(torch.float32)
                          for l in tree_leaves(self.ef)]).cpu().numpy() \
            .tobytes()

    def install_ef(self, stream: bytes) -> None:
        """Install a server-synced residual (flat f32 stream, the
        MSG_EF_SYNC body) — the rejoin path: a restarted worker lost its
        residual with its life, and the server's EF bank is the recovery
        source. Clears any staged round (it predates the sync)."""
        vec = np.frombuffer(stream, np.float32)
        leaves, treedef = tree_flatten(self.ef)
        total = sum(l.numel() for l in leaves)
        if vec.size != total:
            raise ValueError(
                f"EF sync stream carries {vec.size} floats, this client's "
                f"residual has {total}")
        out, off = [], 0
        for l in leaves:
            n = l.numel()
            out.append(torch.as_tensor(vec[off:off + n].reshape(
                tuple(l.shape))).to(device=l.device, dtype=l.dtype))
            off += n
        self.ef = tree_unflatten(treedef, out)
        self._pending = None


def build_compute(setup: Dict, client_id: int,
                  device: Optional[str] = None) -> VisionClientCompute:
    if setup.get("kind") != "vision":
        raise ValueError(
            f"worker only knows how to rebuild 'vision' runs, got "
            f"{setup.get('kind')!r}")
    return VisionClientCompute(setup, client_id, device)


def _serve(link: ServerLink, compute, client_id: int,
           straggle_s: float, log=None) -> None:
    """The worker's message loop: ROUND -> compute/frame/metric, RESEND ->
    re-send the cached frame, ACK -> commit the EF branch, EF_REQ -> dump,
    EF_SYNC -> install, STOP -> log the launch counts and exit.
    Single-threaded (besides the heartbeat): the protocol is strictly
    ordered per connection.

    When the process tracer is on (SETUP ``trace``), the round's
    decode/compute/straggle spans (and ``worker.compute``'s children, the
    client step's ``client.train`` and ``client.encode``, settled with
    their device times) ride on the MSG_METRIC body, on this worker's own
    clock, for the server's offset-shifted merge."""
    if log is None:
        log = get_logger("worker", client=client_id)
    tracer = get_tracer()
    last_frame: Optional[bytes] = None
    last_round = -1

    def commit_and_push(delivered: bool) -> None:
        # resolve the staged round, then push the committed residual so the
        # server's EF bank tracks this client's last commit
        staged = compute.pending_round()
        if staged is None:
            return
        compute.commit(delivered=delivered)
        stream = compute.ef_bytes()
        link.send(MSG_EF_PUSH, struct.pack("<I", staged) + stream)
        tracer.event("ef_push", round=staged, bytes=len(stream),
                     delivered=delivered)

    while True:
        mtype, body = link.recv()
        if mtype == MSG_STOP:
            log.info("stop received; launches %s",
                     json.dumps(launch_counts()))
            return
        if mtype == MSG_ROUND:
            rnd, flags = struct.unpack_from("<IB", body)
            rlog = log.bind(round=rnd)
            # a still-staged previous round means the server moved on
            # without acking us: it necessarily gave up on our frame
            commit_and_push(delivered=False)
            if not flags & FLAG_PARTICIPATE:
                last_frame, last_round = None, rnd
                rlog.debug("sitting round out")
                continue                     # sit the round out; EF frozen
            with tracer.span("worker.decode", round=rnd, phase="decode",
                             bytes=len(body) - 5):
                params = compute.decode_params(body[5:])
            with tracer.span("worker.compute", round=rnd, phase="compute"):
                frame, loss = compute.compute(params, rnd)
            if tracer.enabled:
                # the frame is on the host: settle the round's device
                # marks (client.train, client.encode) before they drain
                tracer.settle(*tracer.sync_point(compute.device))
            if straggle_s > 0:
                with tracer.span("worker.straggle", round=rnd,
                                 phase="straggle", sleep_s=straggle_s):
                    time.sleep(straggle_s)   # alive (heartbeats), just late
            payload = struct.pack("<If", rnd, loss)
            spans = tracer.drain()
            if spans:
                payload += json.dumps(spans).encode("utf-8")
            link.send(MSG_METRIC, payload)
            with tracer.span("worker.send", round=rnd, phase="send",
                             bytes=len(frame)):
                link.send(MSG_FRAME, frame)
            last_frame, last_round = frame, rnd
            rlog.debug("served: loss=%.4f frame=%dB", loss, len(frame))
        elif mtype == MSG_RESEND:
            (rnd,) = struct.unpack("<I", body)
            if last_frame is not None and rnd == last_round:
                tracer.event("worker.resend", round=rnd,
                             bytes=len(last_frame))
                link.send(MSG_FRAME, last_frame)
                log.bind(round=rnd).info("re-sent frame (%dB)",
                                         len(last_frame))
        elif mtype == MSG_ACK:
            rnd, delivered = struct.unpack("<IB", body)
            if compute.pending_round() == rnd:
                commit_and_push(delivered=bool(delivered))
        elif mtype == MSG_EF_REQ:
            link.send(MSG_EF_DUMP, compute.ef_bytes())
        elif mtype == MSG_EF_SYNC:
            # the server-held residual (rejoin/resume): install it and go
            # on from exactly where the previous incarnation committed
            compute.install_ef(body[4:])
            tracer.event("ef_sync", bytes=len(body) - 4)
            log.info("EF residual re-synced from server (%dB)",
                     len(body) - 4)
        # unknown or duplicate control messages are ignored: the server
        # owns the protocol version


def run_worker(address, client_id: int,
               device: Optional[str] = None) -> None:
    log = get_logger("worker", client=client_id)
    link = ServerLink.connect(tuple(address), client_id)
    log.info("connected to %s:%s", *tuple(address))
    # look alive at once: SETUP parsing and the rebuild happen before the
    # configured heartbeat is known
    link.start_heartbeat(_BOOT_HEARTBEAT_S)
    try:
        setup = None
        while setup is None:
            mtype, body = link.recv()
            if mtype == MSG_STOP:
                return
            if mtype == MSG_SETUP:
                setup = json.loads(body.decode("utf-8"))
        if setup.get("trace"):
            configure_tracer(True, proc=f"client-{client_id}")
        t0 = time.monotonic()
        compute = build_compute(setup, client_id, device)
        log.info("computation rebuilt in %.3fs on %s",
                 time.monotonic() - t0, compute.device)
        hb = compute.run.heartbeat_s
        if hb < _BOOT_HEARTBEAT_S:
            link.start_heartbeat(hb)         # beat faster than configured
        straggle_s = float(setup.get("straggle", {}).get(str(client_id), 0.0))
        if straggle_s > 0:
            log.info("induced straggle: %.2fs per round", straggle_s)
        _serve(link, compute, client_id, straggle_s, log=log)
    except (ConnectionError, OSError):
        log.info("server connection lost, exiting")
    finally:
        link.close()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--connect", required=True, metavar="HOST:PORT")
    ap.add_argument("--client-id", type=int, required=True, dest="client_id")
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default: the SETUP blob's device)")
    ap.add_argument("--threads", type=int, default=None,
                    help="torch.set_num_threads for this process (CPU "
                         "workers beside other processes)")
    args = ap.parse_args(argv)
    if args.threads:
        torch.set_num_threads(args.threads)
    host, port = args.connect.rsplit(":", 1)
    run_worker((host, int(port)), args.client_id, args.device)


if __name__ == "__main__":
    main()
