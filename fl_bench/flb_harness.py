"""One run of one cell: build the program from the cell's files, drive its
first rounds and the timed window, trace it on request, and hold its
first rounds to the plain reference.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file found by name under the benchmark's root: ``configs/<config>
.json``, ``traffic/<traffic>.json``, ``cells/<cell>.json`` (its
configuration, traffic and the limits of its check), ``families/
<family>.py`` (the model family's init, plain reference and FLOP count)
and ``metrics/<metric>.py`` (a ``read(run)`` that returns the metric or
None). ``BENCHMARK.json`` beside the root says which metrics a cell
reports.

The program is the port, ``repro_torch``: the model, strategy and run
configuration from ``launch.train.lm_setup``, a donating
``fl.engine.RoundEngine`` over ``fl.round.build_fl_round``, driven one
round a block as ``train_lm --eval-every 1`` drives it. It is handed the
benchmark's weights and batches (``flb_data``); the reference
(``flb_reference``) recomputes everything else from the same seed.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

import torch

import flb_check
import flb_data
import flb_reference
import flb_trace
from flb_prec import Prec
from flb_reference import leaf_norms

ROOT = Path(__file__).resolve().parent
# the rounds of set-up that the reference follows
CHECK_ROUNDS = 3
# top-level module names that may not be loaded once the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell(NamedTuple):
    name: str
    spec: Dict
    cfg: Dict
    traffic: Dict
    family: object


class Bench:
    """The benchmark's files under ``root`` and its manifest beside it."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        with open(self.root.parent / "BENCHMARK.json") as f:
            self.manifest = json.load(f)
        self._readers: Dict[str, object] = {}

    def _json(self, kind: str, name: str) -> Dict:
        with open(self.root / kind / f"{name}.json") as f:
            return json.load(f)

    def cell(self, name: str) -> Cell:
        spec = self._json("cells", name)
        cfg = self._json("configs", spec["config"])
        traffic = self._json("traffic", spec["traffic"])
        family = load_module(self.root / "families" / f"{cfg['family']}.py",
                             f"flb_family_{cfg['family']}")
        return Cell(name, spec, cfg, traffic, family)

    def metrics(self, cell: str, trace: bool) -> List[Dict]:
        """The manifest's metrics this cell reports in a run of this kind:
        end-to-end without the trace, per-layer with it."""
        group = self.manifest["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        if metric not in self._readers:
            mod = load_module(self.root / "metrics" / f"{metric}.py",
                              "flb_metric_" + metric.replace(".", "_"))
            self._readers[metric] = mod.read
        return self._readers[metric]


# --- the program -------------------------------------------------------------


class Program:
    """The port's round engine for one cell and seed, holding the
    benchmark's weights ``w0`` until the check's rounds are read."""

    def __init__(self, cell: Cell, seed: int, device: torch.device,
                 tokens: torch.Tensor):
        from repro_torch.configs.base import CompressorConfig, ModelConfig
        from repro_torch.fl.engine import RoundEngine
        from repro_torch.fl.round import build_fl_round
        from repro_torch.launch import train

        t = cell.traffic
        mcfg = ModelConfig(name=cell.spec["config"],
                           **cell.family.program_config(cell.cfg))
        comp = CompressorConfig(kind="threesfc", error_feedback=True,
                                syn_batch=t["syn_batch"],
                                syn_seq=t["syn_seq"],
                                syn_steps=t["syn_steps"], syn_lr=t["syn_lr"],
                                soft_label_rank=t["label_rank"])
        args = argparse.Namespace(clients=t["clients"],
                                  local_steps=t["local_steps"], lr=t["lr"],
                                  batch=t["batch"], rounds=1, seed=seed)
        model, strategy, run = train.lm_setup(args, mcfg, comp,
                                              t["seq_len"])
        batcher = flb_data.Batcher(tokens, seed, t["clients"],
                                   t["local_steps"], t["batch"])
        self.engine = RoundEngine(build_fl_round(model.loss, strategy, run),
                                  batcher, seed=seed)
        self.w0 = flb_data.make_weights(cell.family.param_specs(cell.cfg),
                                        seed, device)
        self.state = self.engine.init_state(flb_data.nest(self.w0),
                                            t["clients"], strategy)

    def round(self):
        self.state, m = self.engine.run_block(self.state, 1)
        return m

    def record(self, m, first: bool, last: bool) -> Dict:
        """The round just run, as the check reads it."""
        ef = flb_data.flatten(self.state.ef)
        n = next(iter(ef.values())).shape[0]
        rec = {"loss": float(m.loss[0]),
               "cosine": [float(c) for c in m.cosine[0]],
               "update_norm": float(m.update_norm[0]),
               "payload": float(m.payload_floats[0]),
               "ef": [leaf_norms({k: v[i] for k, v in ef.items()})
                      for i in range(n)]}
        params = flb_data.flatten(self.state.params)
        if first:
            rec["delta"] = leaf_norms({k: self.w0[k] - params[k]
                                   for k in params})
        if last:
            rec["change"] = leaf_norms({k: params[k] - self.w0[k]
                                    for k in params})
        return rec

    def check_rounds(self, rounds: int = CHECK_ROUNDS) -> List[Dict]:
        recs = [self.record(self.round(), r == 0, r == rounds - 1)
                for r in range(rounds)]
        self.w0 = None
        return recs


# --- the reference -----------------------------------------------------------


def reference_records(cell: Cell, seed: int, device: torch.device,
                      tokens: torch.Tensor, rounds: int = CHECK_ROUNDS,
                      prec: Optional[Prec] = None,
                      fault: Optional[str] = None) -> List[Dict]:
    """The reference's first ``rounds`` rounds from the seed's weights and
    the same batches and initial synthetic data as the program's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, t, fam = cell.cfg, cell.traffic, cell.family
    dt = getattr(torch, cfg["assumed"]["compute_dtype"])
    model = fam.Reference(cfg, prec or Prec(dt))
    w0 = flb_data.make_weights(fam.param_specs(cfg), seed, device)
    batcher = flb_data.Batcher(tokens, seed, t["clients"], t["local_steps"],
                               t["batch"])
    dims = fam.dims(cfg)
    N = t["clients"]
    ef = [{k: torch.zeros_like(v) for k, v in w0.items()} for _ in range(N)]
    micro = flb_reference.num_micro(t["batch"], t["seq_len"])
    p, recs = w0, []
    for r in range(rounds):
        syn0s = [flb_data.syn0(seed, r, i, (t["syn_batch"], t["syn_seq"],
                                            dims["d"]),
                               (t["syn_batch"], t["syn_seq"]),
                               t["label_rank"], dims["V"], device)
                 for i in range(N)]
        p_new, ef, rec = flb_reference.run_round(
            model, p, ef, batcher(0, r)["tokens"], syn0s, t, micro, fault)
        if r == 0:
            rec["delta"] = leaf_norms({k: w0[k] - p_new[k] for k in w0})
        if r == rounds - 1:
            rec["change"] = leaf_norms({k: p_new[k] - w0[k] for k in w0})
        p = p_new
        recs.append(rec)
    return recs


def cell_tokens(cell: Cell, seed: int, device: torch.device) -> torch.Tensor:
    t = cell.traffic
    return flb_data.make_tokens(seed, t["num_seqs"], t["seq_len"],
                                cell.cfg["vocab_size"], device)


# --- one run -----------------------------------------------------------------


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(bench: Bench, name: str, seed: int, seconds: float,
             trace: bool, device: torch.device, t_start: float) -> Dict:
    """One run: set-up (the program's import, kernels, weights, tokens,
    state and its first ``CHECK_ROUNDS`` rounds), the window of whole
    rounds until ``seconds`` have passed, with ``trace`` one more round
    under the profiler, then the reference's rounds and the check.
    Returns the result line's fields and the check's rows."""
    marks = [("start_s", time.perf_counter())]
    cell = bench.cell(name)
    cuda = device.type == "cuda"
    from repro_torch.launch import train
    if cuda:
        from repro_torch.kernels import _build
        device = train.resolve_device(str(device))
        marks.append(("import_s", time.perf_counter()))
        _build.build_all(("fused_cosine", "ef_update"))
        marks.append(("build_s", time.perf_counter()))
    tokens = cell_tokens(cell, seed, device)
    prog = Program(cell, seed, device, tokens)
    _sync(device)
    marks.append(("state_s", time.perf_counter()))
    checked = prog.check_rounds()
    _sync(device)
    marks.append(("rounds_s", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    # set-up by part: the interpreter and harness up to this call, the
    # program's import, the kernels' build (nvcc on a checkout's first
    # run, a load after), weights, tokens and state, the checked rounds
    parts, last = {}, t_start
    for part, t in marks:
        parts[part], last = t - last, t

    tracer = None
    if trace:
        from repro_torch.obs import configure_tracer
        tracer = configure_tracer(True)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    rounds = 0
    while True:
        prog.round()
        rounds += 1
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    run = {"cell": cell, "setup_s": setup_s, "window_s": window_s,
           "rounds": rounds, "peak_bytes": peak}
    if trace:
        run["dispatch_s"] = [(r["t1"] - r["t0"]) / 1e9
                             for r in tracer.drain()
                             if r.get("name") == "engine.dispatch"]
        from repro_torch.kernels import ef_update, fused_cosine
        before = (fused_cosine.LAUNCHES, ef_update.LAUNCHES)
        run["trace"] = flb_trace.profile_rounds(prog.round, 1)
        run["launches"] = {"fused_cosine": fused_cosine.LAUNCHES - before[0],
                           "ef_update": ef_update.LAUNCHES - before[1]}
        configure_tracer(False)
    del prog
    if cuda:
        torch.cuda.empty_cache()

    ref = reference_records(cell, seed, device, tokens)
    values = flb_check.gaps(checked, ref)
    correct, rows = flb_check.verdict(values, cell.spec["limits"])
    metrics = {}
    for m in bench.metrics(name, trace):
        v = bench.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": correct, "attempted": rounds, "failed": 0,
           "metrics": metrics,
           "device": {"platform": "gpu" if cuda else device.type,
                      "kind": (torch.cuda.get_device_name(device) if cuda
                               else "cpu"),
                      "count": 1, "memory_peak_bytes": peak}}
    if trace:
        tr = run["trace"]
        out["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    out["setup_parts"] = parts
    out["check"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return {"result": out, "values": values, "rows": rows,
            "program": checked, "reference": ref}

