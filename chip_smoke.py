"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device  — require CUDA; print the card's name and power limit.
2. build   — compile every kernel of the port from ``src/repro_torch/
             kernels/csrc`` (one nvcc per source, all at once).
3. kernels — each kernel against its plain PyTorch version on the card,
             at lengths 0, 1, 3, 1025, 199,210 (the MLP) and 4 Mi + 5; B1
             twice, bitwise. The tree forms (one launch per table of 64
             leaves, read in place) on the MLP's 6-leaf tree and on a ragged
             tree of 85 leaves (sizes 0, 1, 3, 5, 1,027, two tables, an
             unaligned leaf in each operand): B1 within B1_RTOL of the plain
             version on the concatenation and bitwise repeatable, B2 bitwise
             the flat B2 on the concatenation; under torch.profiler one
             ``ops.tree_fused_stats`` and one ``ops.tree_ef_update`` call on
             the MLP tree are one device kernel each (no cat, copy, fill or
             memset). B3 (bitpack) bitwise at lengths 0, 1, 31, 32, 33,
             1025, 199,210 and 4 Mi + 5 with planted 0.0, -0.0, NaN and
             ±inf; B3a's tree entry bitwise its plain version on the MLP
             tree and on a ragged tree of 72 leaves (two tables, the cut
             inside a leaf, an unaligned leaf), into a section at an odd
             byte; B3b's frames entry on 1, 3 and 10 signSGD frames, as a
             list and stacked, and on unaligned frame views; one device
             kernel per tree pack and per batched unpack. One call each of
             B5 and B6 at the MLP's d is one device kernel (here, before
             phase 9: after it torch.profiler drops the device records of
             short sessions in this process).
4. main path — ``repro_torch.launch.train.main`` at the trainer's defaults
             (MLP on MNIST shapes, 3SFC+EF, N=10, K=5, B=32, S=10) for 3
             rounds, with every launch counter set to 0 just before and read
             just after: B1 must launch N·(S+1) and B2 N times per round.
5. fused decode — one round from the trained state with fused decode and
             one without must agree; the same round on the CPU (the plain
             versions) must agree with the card's.
6. codec path — the trainer with ``--wire codec``: signSGD for 3 rounds
             (B3a N times per round, B3b once per round for the round's N
             frames, B1 N times, B2 never), and 3 signSGD codec rounds
             bitwise those that decode frame by frame,
             then 3SFC for 3 rounds (the main path's launches, and the
             float run's params); then every codec's frame of one payload
             at the MLP's shapes, on the card and on the CPU, byte for byte.
7. times   — each kernel at the main path's shape (CUDA events), its plain
             version, a one-call PyTorch yardstick where one exists, its
             bound, and the wall and device time (and device kernel count)
             of one main-path round, of one signSGD codec round (and of
             the same round decoding frame by frame), of one FedSynth
             round, of one faulted main-path round (phase 14's knobs) and
             of one ConvNet and one RegNet 3SFC round; B1's and B2's tree
             forms on the MLP's 6 leaves and on RegNet's 32 (d = 559,924)
             beside the old route rebuilt from the same kernel (cat, then
             one flat call), in turns; B3a's tree entry into a frame beside
             the old route (cat of the leaves, the flat B3a, the frame's
             cat) and B3b's frames entry on N frames beside N flat calls, in
             turns, and both flat at 4 Mi + 5; B4 at the full prefill
             shape; B5 and B6 at n = 199,210 and 4 Mi + 5.
8. B4      — ssd_chunk against its plain version on the card at (b, h, nc,
             Q, P, N) = (2, 8, 2, 8, 32, 16) (the smoke config), (1, 32, 1,
             32, 64, 128) (a prompt shorter than a chunk), (1, 32, 1, 100,
             64, 128) (a 100-token prompt: a chunk no multiple of 16) and
             (4, 32, 16, 128, 64, 128) (the full prefill), with decays that
             underflow and with dA of both signs, and at (2, 3, 2, 5, 8,
             12) (Q, P and N off the kernel's tiles); each case twice,
             bitwise. Tiles off a 16-byte boundary and P, N not multiples
             of 4 must be refused.
9. serve   — ``repro_torch.launch.serve.main`` on mamba2-370m at full width
             (48 layers, d_model 1024), batch 4, prompt 2048, 16 tokens,
             ``--ssd-kernel``, with every counter set to 0 just before and
             read just after: B4 must launch once per layer (48), B1-B3
             never; then one more prefill (48 launches, profiled: wall time
             and device busy share) and decode (0 launches).
10. routes — full width cut to 2 layers, float32: the same params and
             tokens (batch 2, prompt 256) through prefill with B4 on the
             card, through ``ssd_scan`` on the card and on the CPU (the plain
             versions), then 4 teacher-forced decode steps; logits and every
             cache leaf must agree.
11. B5, B6 — sign_quant and topk_mask against their plain versions on the
             card at lengths 0, 1, 31, 1023, 1024, 1025, 199,210 and 4 Mi + 5
             and at ±1 of a thread's step (16), of a block's tile (4,096)
             and of one wave's elements (±subnormals, ±0 and values at τ
             planted), on every leaf of the MLP and on views 1, 2 and 3
             floats off a 16-byte boundary, at τ = 0, 1e-39, 1e-38, FLT_MIN
             and the sampled thresholds of k = 1% and 10%: signs, masks and
             counts bitwise, the scale within rtol 1e-5, each bitwise
             repeatable over 3 calls; ``topk_threshold`` on the card equal
             to the CPU's. Two calls of each captured in one CUDA graph and
             replayed 3 times (outputs poisoned before each replay) give
             bitwise the eager results, which holds each stream's ticket to
             0 between launches; a first call on a stream inside a capture
             raises.
12. compressors — the compressor library at the MLP's full width on a
             client update from the trainer's state: ``make_compressor`` for
             identity, topk, randk, signsgd and stc and the flat
             ``ef_step`` over 3 steps (EF telescoping), then the B5/B6 front
             end against ``baselines.signsgd_compress`` and
             ``baselines.topk_compress``, one B5 or B6 launch per call.
13. accounted-only rounds — randk and FedSynth rounds through
             ``build_fl_round`` (N=10, K=5, B=32, float mode, EF on, 3
             rounds): N B1 launches per round and no other kernel; one
             FedSynth round on the card against the same round on the CPU.
14. faults — the trainer with ``--participation-rate 0.7 --drop-rate 0.2
             --straggler-rate 0.3 --staleness-max 2 --fault-seed 5`` for 4
             rounds: 3SFC+EF float (N·(S+1) B1 and N B2 per round: every
             client trains and encodes, scheduled or not), then signSGD
             with ``--wire codec`` (N B3a, 1 B3b, N B1 per round); the
             masked pipeline under the null schedule bitwise the unfaulted
             round for 3SFC float, 3SFC fused and signSGD codec; one round
             under an injected schedule (a skipped, a dropped and two late
             clients) on the card and on the CPU within the main path's
             tolerances, the skipped client's EF row bitwise its input and
             the dropped client's bitwise u = g + e as the card computes it.
15. CNNs   — MnistNet on FMNIST, ConvNet and ResNet on CIFAR-10, RegNet on
             CIFAR-100 at their published widths (54,840, 390,986, 77,706
             and 559,924 parameters in 8-32 leaves: one leaf table): the
             loss gradient and the encoder's gradient to D_syn (the double
             backward) on the card within CNN_GRAD_TOL of the CPU's f64
             (cuDNN's loss gradient reported beside); the trainer, 2 rounds
             of 3SFC+EF each: N·(S+1) B1 and N B2 launches per round,
             finite metrics; then one round of each (2 clients) on the card
             and on the CPU with no encoder step, within ten times the gap
             that a nudge of the params by a few ulps opens on the card,
             and at the trainer's S reported (the CNN rounds are
             ill-conditioned; nothing bitwise is claimed for them).
16. mamba2 training — the published mamba2-370m (48 layers, d_model 1,024,
             vocab 50,280, bf16 activations, f32 params: d = 368,338,432)
             through ``repro_torch.launch.train.train_lm`` under the
             reference's make_train_entry settings (K=1, lr 0.01, 3SFC with
             16 synthetic positions and rank-8 labels, one step), cut to
             N=4 clients of 2 sequences of 4,096 tokens (2 microbatches)
             and 2 rounds: exactly 16 B1 and 8 B2 launches and no other,
             the payload of the reference's budget (418,753 floats, 880x)
             and the peak device memory; B1 on that tree against f64 sums,
             and B2 bitwise its flat form; one signSGD codec round (N=4, EF
             on): 4 B3a, 1 B3b, 4 B1, the frames decoded as one batch
             bitwise those decoded frame by frame; ``LM.loss`` at full
             width in float32 on 2 x 2,048 tokens through B4 and through
             ``ssd_scan`` (48 B4 launches per loss, 96 per value and grad:
             the period remat runs each forward again), within
             LM_ROUTE_LOSS_RTOL and LM_ROUTE_GRAD_RTOL, and the 3SFC
             encoder through the B4 route raising (C3); one round at full
             width cut to 2 layers, float32, N=2, S=256, on the card and
             on the CPU within the main path's tolerances, with the gap a
             nudge of the params by a few ulps opens beside.

17. fan-out — ``client_parallel='shard_map'`` (``repro_torch.fl.sharding``)
             on the trainer's MLP setting, 3 rounds each of 3SFC+EF float,
             fused 3SFC, signSGD codec and phase 14's faulted 3SFC: (a) one
             rank on NCCL in this process (a 1-shard mesh; the group is
             destroyed after), (b) two ranks spawned on this card over gloo
             (``chip_smoke.py --fanout-rank ...``; NCCL refuses two ranks
             on one device), 5 clients each. In both the final params, the
             gathered EF, the staleness buffer and every RoundMetrics field
             are bitwise the single-process rounds', with one collective a
             round and each rank's own clients' share of kernel launches;
             the bytes each client puts into the gather, float against
             fused 3SFC.

Phase 7 adds the full-width mamba2 round's profile and B1, B2 (with
``torch.addcmul`` beside), B3a and B3b at mamba2's d, and the wall time of
a main-path round under phase 17 (a) beside the single-process round, in
turns. The phases run in the order 1-6, 8-17, 7, so that the times can
report each kernel's launches on its path. The last lines are the run's
wall time from the script's start, the card's name and power limit, one
JSON object with every kernel's numbers, the list of kernels, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import time

# the whole run's wall clock starts here, before torch is imported
_T0 = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.comm import Codec, frame  # noqa: E402
from repro_torch.configs.base import (CompressorConfig, FLConfig,  # noqa: E402
                                     get_config)
from repro_torch.configs.run import RunConfig  # noqa: E402
from repro_torch.core import baselines, flat  # noqa: E402
from repro_torch.core import error_feedback as ef  # noqa: E402
from repro_torch.core.compressor import make_compressor  # noqa: E402
from repro_torch.core.strategy import leaf_k, make_strategy  # noqa: E402
from repro_torch.core import threesfc  # noqa: E402
from repro_torch.core.threesfc import SynData, init_syn  # noqa: E402
from repro_torch.core.tree import tree_flatten, tree_unflatten  # noqa: E402
from repro_torch.data.synthetic import make_token_dataset  # noqa: E402
from repro_torch.fl.budget import matched_compressors  # noqa: E402
from repro_torch.fl.client import local_train  # noqa: E402
from repro_torch.fl import faults  # noqa: E402
from repro_torch.fl.engine import token_batcher  # noqa: E402
from repro_torch.fl.round import FLState, build_fl_round, fl_init  # noqa: E402
from repro_torch.fl import sharding as sharding_mod  # noqa: E402
from repro_torch.fl.sharding import make_fl_shardings  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import bitpack as bp_mod  # noqa: E402
from repro_torch.kernels import ef_update as ef_mod  # noqa: E402
from repro_torch.kernels import fused_cosine as fc_mod  # noqa: E402
from repro_torch.kernels import leaf_table, pack_table  # noqa: E402
from repro_torch.kernels import sign_quant as sq_mod  # noqa: E402
from repro_torch.kernels import ssd_chunk as ssd_mod  # noqa: E402
from repro_torch.kernels import topk_mask as tm_mod  # noqa: E402
from repro_torch.kernels.ftz import FLT_MIN, flush_subnormal  # noqa: E402
from repro_torch.launch import ranks as ranks_mod  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.build import (build_model, syn_loss_fn,  # noqa: E402
                                      syn_spec_for, vision_syn_spec)
from repro_torch.models.cnn import (DATASETS, MNIST_SPEC,  # noqa: E402
                                    make_mlp, make_paper_model)
from repro_torch.models.transformer import LM  # noqa: E402
from repro_torch.profiling import (call_ms, graph_ms,  # noqa: E402
                                  round_profile)

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 non-tensor FLOP/s
# and dense TF32 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12

N, K, B, S = 10, 5, 32, 10
ROUNDS = 3
MLP_D = 199_210
LENGTHS = (0, 1, 3, 1025, MLP_D, (1 << 22) + 5)
B3_LENGTHS = (0, 1, 31, 32, 33, 1025, MLP_D, (1 << 22) + 5)
CODEC_METHODS = ("fedavg", "dgc", "signsgd", "stc", "threesfc")
B1_RTOL = 1e-5       # of (‖x‖‖y‖, ‖x‖², ‖y‖²): another summation order
B2_ULP = 2.4e-7      # of (|u| + |s·d|): one FMA rounding vs two roundings
# the JAX package's fused-vs-float bounds (tests/test_fused_decode.py)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
EF_TOL = dict(rtol=1e-4, atol=1e-5)
# B4: (b, h, nc, Q, P, N) of the smoke config, a prompt shorter than one
# chunk, a 100-token prompt (one chunk of 100, no multiple of 16), and the
# full prefill (batch 4, prompt 2048 = 16 chunks of 128)
B4_SHAPES = ((2, 8, 2, 8, 32, 16), (1, 32, 1, 32, 64, 128),
             (1, 32, 1, 100, 64, 128), (4, 32, 16, 128, 64, 128))
B4_FULL = B4_SHAPES[-1]
# the reference's kernel-vs-oracle bound (tests/test_kernels.py)
B4_TOL = dict(rtol=1e-4, atol=1e-5)
# the serve main path and the model-level bound of
# tests/test_pallas_model_path.py for the three routes
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 2048, 16
SERVE_LAYERS = 48
ROUTE_BATCH, ROUTE_PROMPT, ROUTE_LAYERS, ROUTE_DECODE = 2, 256, 2, 4
ROUTE_TOL = dict(rtol=1e-4, atol=1e-4)
# B5/B6: phase 11's lengths, the reference's scale bound
# (tests/test_kernels.py), and ±subnormals, ±0, FLT_MIN and values at τ
B56_LENGTHS = (0, 1, 31, 1023, 1024, 1025, MLP_D, (1 << 22) + 5)
B5_RTOL = 1e-5
EDGE = (1e-40, -1e-40, -3e-39, 0.5, -0.25, 0.0, -0.0, FLT_MIN, -FLT_MIN,
        1e-38, -1e-38, 0.25, -0.5, 2.0, 1e-39, 0.125)
EDGE_TAUS = (0.0, 1e-39, 1e-38, FLT_MIN)
# phase 3's ragged tree: leaves of these sizes in turn, more than one table
RAGGED_SIZES = (0, 1, 3, 5, 1027)
RAGGED_LEAVES = 85
# B3a's ragged tree: 72 leaves, two tables cut inside a leaf, and words
# that take their bits from several leaves
B3_RAGGED_SIZES = (1, 7, 31, 33, 2000) * 14 + (0, 5)
# the frames phase 3 unpacks as one batch, and phase 7 times
B3_FRAMES = (1, 3, 10)
B3_SPECIALS = (0.0, -0.0, math.nan, math.inf, -math.inf, 1e-40, -1e-40,
               -3e-39, -FLT_MIN)
EF_STEPS = 3
# phase 14: the trainer's fault flags (a schedule from fault_seed), and the
# bound on a late payload's delay
FAULT_KNOBS = dict(participation_rate=0.7, drop_rate=0.2, straggler_rate=0.3,
                   staleness_max=2, fault_seed=5)
FAULT_ROUNDS = 4
# phase 15: the paper's CNNs on their tables' datasets, parameter counts at
# the published widths
CNN_CELLS = (("mnistnet", "fmnist", 54_840), ("convnet", "cifar10", 390_986),
             ("resnet", "cifar10", 77_706), ("regnet", "cifar100", 559_924))
CNN_ROUNDS = 2
# clients of phase 15's card-vs-CPU rounds (the CPU's time bounds it)
CNN_CPU_N = 2
# The CNN rounds are ill-conditioned: params moved by a few ulps (a
# relative CNN_NUDGE·U(-1/2, 1/2)) move a round's update far more than the
# MLP's, through the K SGD steps' ReLU kinks and most through the
# encoder's RMS-normalized steps. So the building blocks are held at f32's
# level (conv_precision), and the card-vs-CPU round with no encoder step
# (S = 0: local training, one objective, Eq. 8, B1, B2, the aggregate):
# its update's and EF's relative L2 gaps to the CPU's within
# ROUND_FACTOR times the gaps the nudge opens on the card, and never
# less than ROUND_FLOOR. At the trainer's S the gaps are reported.
CNN_CHECK_S = 0
CNN_NUDGE = 1e-6
ROUND_FACTOR, ROUND_FLOOR = 10.0, 1e-4
# a CNN's loss gradient on the card against the CPU's in f64: the worst
# leaf's largest error over its largest element, at f32's level (the CPU's
# own f32 gradients reach 3e-6)
CNN_GRAD_TOL = 1e-5
# phase 16: mamba2-370m at the published widths under the FL settings of
# the reference's make_train_entry (K = 1, local lr 0.01, 3SFC with 16
# synthetic positions and rank-8 labels, one step), cut to N = 4 clients of
# 2 sequences of 4,096 tokens (the microbatch rule: 2 slices) and 2 rounds
LM_N, LM_BATCH, LM_SEQ, LM_ROUNDS, LM_LR = 4, 2, 4096, 2, 0.01
LM_NUM_SEQS = 16
LM_COMP = CompressorConfig(kind="threesfc", syn_seq=16, soft_label_rank=8)
LM_D = 368_338_432
# the mirror of tests/test_pallas_model_path.py's loss and grad at full
# width, float32: the B4 route against the ssd_scan route, the loss
# within a relative LM_ROUTE_LOSS_RTOL and each gradient leaf within a
# relative L2 gap of LM_ROUTE_GRAD_RTOL (48 layers of B4's 3xTF32 products)
LM_ROUTE_BATCH, LM_ROUTE_SEQ = 2, 2048
LM_ROUTE_LOSS_RTOL, LM_ROUTE_GRAD_RTOL = 1e-4, 1e-3
# one round at full width cut to 2 layers, f32, on the card and the CPU:
# params and EF within PARAM_TOL and EF_TOL, and the update's relative L2
# gap to the card's within ROUND_FACTOR times the gap that params moved by
# a relative LM_NUDGE·U(-1/2, 1/2) open on the card (never under
# ROUND_FLOOR): the encoder's step makes the update ill-conditioned, as
# the CNNs'
LM_CPU_LAYERS, LM_CPU_N, LM_CPU_BATCH, LM_CPU_SEQ = 2, 2, 2, 256
LM_NUDGE = 1e-6
# phase 17: rounds of each fan-out case, the ranks of run (b) on one card
# (gloo: NCCL refuses two ranks on one device) and their time limit, and
# the walls phase 7 takes of a round under (a) and single-process, in turns
FANOUT_ROUNDS, FANOUT_WORLD, FANOUT_TIMEOUT_S = 3, 2, 300
FANOUT_WALLS = 3
# B1-B3 at mamba2's d in CUDA graphs: calls per graph and replays
LM_TIME_REPS, LM_TIME_REPLAYS = 10, 11
# vectors of 4 Mi + 5 elements the B5/B6 timing rotates over: 6 x 16.8 MB
# of inputs, twice the H100's 50 MB L2
L2_ROTATE = 6


def phase(name: str) -> None:
    print(f"== {name} (at {time.perf_counter() - _T0:.1f} s)", flush=True)


def reset_counts() -> None:
    fc_mod.LAUNCHES = 0
    ef_mod.LAUNCHES = 0
    for name in bp_mod.LAUNCHES:
        bp_mod.LAUNCHES[name] = 0
    ssd_mod.LAUNCHES = 0
    sq_mod.LAUNCHES = 0
    tm_mod.LAUNCHES = 0


def counts() -> dict:
    return {"fused_cosine": fc_mod.LAUNCHES, "ef_update": ef_mod.LAUNCHES,
            **bp_mod.LAUNCHES, "ssd_chunk": ssd_mod.LAUNCHES,
            "sign_quant": sq_mod.LAUNCHES, "topk_mask": tm_mod.LAUNCHES}


def only(**launches) -> dict:
    """The launch counts of a run that launches ``launches`` and no other
    kernel."""
    return {**{k: 0 for k in counts()}, **launches}


def to_cpu(tree):
    return flat.tree_map(lambda x: x.cpu(), tree)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality (so -0.0 differs from 0.0); f32 as its words."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.contiguous().view(torch.int32), b.contiguous().view(
            torch.int32)
    return torch.equal(a, b)


def gen(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def mlp_tree(g: torch.Generator, scale: float = 1.0) -> dict:
    params = make_mlp(MNIST_SPEC).init(g)
    return flat.tree_map(
        lambda p: scale * torch.randn(p.shape, generator=g, device=p.device),
        params)


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------


def check_b1(x: torch.Tensor, y: torch.Tensor) -> float:
    got = fc_mod.fused_cosine(x, y)
    again = fc_mod.fused_cosine(x, y)
    want = fc_mod.fused_cosine_plain(x, y)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"B1 not bitwise repeatable at n={x.numel()}: "
                             f"{got.tolist()} vs {again.tolist()}")
    return check_b1_result(got, want, x.numel())


def check_b1_result(got, want, n) -> float:
    scale = torch.stack([torch.sqrt(want[1] * want[2]), want[1], want[2]])
    err = (got - want).abs()
    if not bool((err <= B1_RTOL * scale).all()):
        raise AssertionError(f"B1 disagrees at n={n}: {got.tolist()} vs "
                             f"{want.tolist()}")
    return float(err.max())


def check_b2(u, d, s) -> float:
    got = ef_mod.ef_update(u, d, s)
    want = ef_mod.ef_update_plain(u, d, s)
    torch.cuda.synchronize()
    return check_b2_result(got, want, u, d, s)


def check_b2_result(got, want, u, d, s) -> float:
    if got.numel() == 0:
        return 0.0
    err = (got - want).abs()
    bound = B2_ULP * (u.abs() + (s.reshape(()) * d).abs())
    if not bool((err <= bound).all()):
        i = int(torch.argmax(err - bound))
        raise AssertionError(f"B2 disagrees at n={u.numel()}, element {i}: "
                             f"{float(got[i])} vs {float(want[i])}")
    return float(err.max())


def phase_kernels(dev) -> dict:
    phase("kernels vs plain, on the card")
    g = gen(dev, 11)
    s = torch.tensor([-0.37], device=dev)
    for n in LENGTHS:
        x = torch.randn(n, generator=g, device=dev)
        y = torch.randn(n, generator=g, device=dev)
        e1, e2 = check_b1(x, y), check_b2(x, y, s)
        print(f"  n={n}: B1 max_abs_err={e1:.3e} (bitwise repeatable), "
              f"B2 max_abs_err={e2:.3e}")
    # unaligned views take the scalar path
    x = torch.randn(1027, generator=g, device=dev)
    y = torch.randn(1027, generator=g, device=dev)
    check_b1(x[1:], y[1:])
    check_b2(x[3:1003], y[1:1001], s)
    # the MLP's 6-leaf tree, as the main path hands it over, and a ragged
    # tree of more than one table with an unaligned leaf
    a, b = mlp_tree(g, 1e-3), mlp_tree(g, 1e-3)
    err_b1, err_b2 = check_tree("MLP tree", a, b, s)
    check_tree("ragged tree", *ragged_trees(g), s)
    check_one_kernel("ops.tree_fused_stats on the MLP tree",
                     "fused_cosine_table", lambda: ops.tree_fused_stats(a, b))
    check_one_kernel("ops.tree_ef_update on the MLP tree", "ef_update_table",
                     lambda: ops.tree_ef_update(a, b, s))
    for n in B3_LENGTHS:
        check_b3(torch.randn(n, generator=g, device=dev))
    x = torch.randn(1027, generator=g, device=dev)
    check_b3(x[3:])                          # an unaligned view
    print(f"  B3 pack_signs/unpack_signs bitwise at n={B3_LENGTHS} and an "
          f"unaligned view, with 0.0, -0.0, NaN, +inf, -inf, ±subnormals and "
          f"-FLT_MIN planted")
    phase_b3_entries(dev, g)
    # B5 and B6 here too: after phase 9 torch.profiler drops the device
    # records of short sessions in this process (of B1's too)
    x = torch.randn(MLP_D, generator=g, device=dev)
    tau = ops.topk_threshold(x, MLP_D // 100)
    check_one_kernel("sign_quant at the MLP's d", "sign_quant_kernel",
                     lambda: sq_mod.sign_quant(x))
    check_one_kernel("topk_mask at the MLP's d", "topk_mask_kernel",
                     lambda: tm_mod.topk_mask(x, tau))
    return {"fused_cosine": err_b1, "ef_update": err_b2,
            "pack_signs": 0.0, "unpack_signs": 0.0}


def ragged_trees(g: torch.Generator):
    """Two trees of RAGGED_LEAVES leaves of sizes 0, 1, 3, 5 and 1,027 in
    turn (more than one table), one leaf of each an unaligned view."""
    dev = g.device
    a, b = {}, {}
    for i in range(RAGGED_LEAVES):
        n = RAGGED_SIZES[i % len(RAGGED_SIZES)]
        a[f"p{i:03d}"] = torch.randn(n, generator=g, device=dev)
        b[f"p{i:03d}"] = torch.randn(n, generator=g, device=dev)
    a["p004"], b["p009"] = unaligned(a["p004"]), unaligned(b["p009"])
    return a, b


def check_tree(label: str, a: dict, b: dict, s: torch.Tensor) -> tuple:
    """The tree forms against the concatenated operands: B1 within B1_RTOL
    of the plain version and bitwise repeatable, B2 bitwise the flat B2;
    each call ceil(L / TABLE) launches for L non-empty leaves."""
    la, lb = flat.tree_leaves(a), flat.tree_leaves(b)
    cat_a = torch.cat([t.reshape(-1) for t in la])
    cat_b = torch.cat([t.reshape(-1) for t in lb])
    tables = math.ceil(sum(t.numel() > 0 for t in la) / leaf_table.TABLE)
    reset_counts()
    got = ops.tree_fused_stats(a, b)
    again = ops.tree_fused_stats(a, b)
    e_tree = ops.tree_ef_update(a, b, s)
    launched = counts()
    torch.cuda.synchronize()
    if launched != only(fused_cosine=2 * tables, ef_update=tables):
        raise AssertionError(f"{label}: launches {launched}, expected "
                             f"{tables} per call")
    if not same_bits(got, again):
        raise AssertionError(f"{label}: B1 not bitwise repeatable: "
                             f"{got.tolist()} vs {again.tolist()}")
    err_b1 = check_b1_result(got, fc_mod.fused_cosine_plain(cat_a, cat_b),
                             cat_a.numel())
    e_leaves = flat.tree_leaves(e_tree)
    if [t.shape for t in e_leaves] != [t.shape for t in la]:
        raise AssertionError(f"{label}: B2 leaf shapes differ")
    got_e = torch.cat([t.reshape(-1) for t in e_leaves])
    if not same_bits(got_e, ef_mod.ef_update(cat_a, cat_b, s)):
        raise AssertionError(f"{label}: B2 tree differs from the flat B2 on "
                             f"the concatenated operands")
    err_b2 = check_b2_result(got_e, ef_mod.ef_update_plain(cat_a, cat_b, s),
                             cat_a, cat_b, s)
    print(f"  {label} ({len(la)} leaves, d={cat_a.numel()}, {tables} "
          f"launch(es) per call): B1 max_abs_err={err_b1:.3e} (bitwise "
          f"repeatable), B2 bitwise the flat B2 on the concatenation, "
          f"max_abs_err={err_b2:.3e}")
    return err_b1, err_b2


def check_one_kernel(label: str, kernel: str, fn, sessions: int = 3) -> None:
    """One ``fn()`` under torch.profiler after a warm-up call (which makes
    the stream's scratch): exactly one device kernel, ``kernel``, and no
    copy, cat, fill or memset. torch.profiler sometimes records no device
    work at all in a short session (on the card, in a process that has
    captured CUDA graphs or served the full model, for every kernel): such
    a session is taken again, up to ``sessions`` in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if names:
            break
    if len(names) != 1 or kernel not in names[0]:
        raise AssertionError(f"{label}: device work {names}, expected one "
                             f"{kernel} kernel")
    print(f"  {label}: one device kernel, {names[0]}")


def check_b3(x: torch.Tensor) -> None:
    """B3a and B3b against their plain versions, bitwise: the words, the
    ±1 they unpack to (= where(flush(x) >= 0, 1, -1)) and the tail bits
    (1)."""
    n = x.numel()
    for i, v in zip((0, 5, 7, 9, 12, 14, 17, 19, 22),
                    (0.0, -0.0, math.nan, math.inf, -math.inf, 1e-40,
                     -1e-40, -3e-39, -FLT_MIN)):
        if i < n:
            x[i] = v
    words = bp_mod.pack_signs(x)
    back = bp_mod.unpack_signs(words, n)
    want_words = bp_mod.pack_signs_plain(x)
    want_back = bp_mod.unpack_signs_plain(want_words, n)
    torch.cuda.synchronize()
    if not same_bits(words, want_words):
        bad = int(torch.nonzero(words != want_words)[0])
        raise AssertionError(f"B3a disagrees at n={n}, word {bad}: "
                             f"{int(words[bad])} vs {int(want_words[bad])}")
    if not same_bits(back, want_back) or not same_bits(
            back, torch.where(flush_subnormal(x) >= 0, 1.0, -1.0)):
        raise AssertionError(f"B3b disagrees at n={n}")
    tail = n % 32
    if tail and (int(words[-1]) & 0xFFFFFFFF) >> tail != (1 << (32 - tail)) - 1:
        raise AssertionError(f"B3a tail bits not 1 at n={n}: "
                             f"{int(words[-1]) & 0xFFFFFFFF:#010x}")


def planted_leaves(g: torch.Generator, sizes) -> list:
    """f32 leaves of ``sizes`` on ``g``'s device, B3_SPECIALS planted at
    the head of each in turn."""
    leaves = []
    for i, n in enumerate(sizes):
        x = torch.randn(n, generator=g, device=g.device)
        for j in range(min(n, len(B3_SPECIALS))):
            x[j] = B3_SPECIALS[(i + j) % len(B3_SPECIALS)]
        leaves.append(x)
    return leaves


def check_tree_pack(label: str, leaves: list, offset: int) -> None:
    """B3a's tree entry bitwise its plain version (the flat plain pack of
    the concatenation), writing into a section ``offset`` bytes into a
    buffer and nothing around it, in one launch per table."""
    d = sum(t.numel() for t in leaves)
    nb = bp_mod.num_bytes(d)
    buf = torch.full((offset + nb + 8,), 0x5A, dtype=torch.uint8,
                     device=leaves[0].device)
    out = buf[offset:offset + nb]
    tables = len(pack_table.pack_plan([t.numel() for t in leaves]))
    reset_counts()
    bp_mod.pack_signs_tree(leaves, out)
    launched = counts()
    want = bp_mod.pack_signs_tree_plain(leaves)
    torch.cuda.synchronize()
    if launched != only(pack_signs=tables):
        raise AssertionError(f"B3a {label}: launches {launched}, expected "
                             f"{tables}")
    if not torch.equal(out, want):
        bad = int(torch.nonzero(out != want)[0])
        raise AssertionError(f"B3a {label} disagrees at byte {bad}: "
                             f"{int(out[bad])} vs {int(want[bad])}")
    if not (bool((buf[:offset] == 0x5A).all())
            and bool((buf[offset + nb:] == 0x5A).all())):
        raise AssertionError(f"B3a {label} wrote outside its section")
    print(f"  B3a tree pack, {label} ({len(leaves)} leaves, d={d}, "
          f"{tables} launch(es)): bitwise the plain version, into a section "
          f"at byte {offset}")


def sign_frames(codec, params, g: torch.Generator, count: int) -> list:
    """``count`` signSGD frames of MLP updates with B3_SPECIALS planted,
    encoded on ``g``'s device."""
    frames = []
    sizes = [p.numel() for p in flat.tree_leaves(params)]
    for c in range(count):
        vals = iter(planted_leaves(g, sizes))
        u = flat.tree_map(lambda p: next(vals).reshape(p.shape), params)
        wire = codec.strategy.client_encode(g, u, params).wire
        frames.append(codec.encode(wire, round_idx=1, client_idx=c))
    return frames


def check_frames_unpack(label: str, codec, frames) -> None:
    """B3b's frames entry bitwise its plain version in one launch, and the
    codec's batch decode bitwise its frame-by-frame decode."""
    signs_at = codec.spec.section_offsets[0]
    reset_counts()
    got = bp_mod.unpack_signs_frames(frames, signs_at, codec.d)
    launched = counts()
    want = bp_mod.unpack_signs_frames_plain(frames, signs_at, codec.d)
    torch.cuda.synchronize()
    if launched != only(unpack_signs=1):
        raise AssertionError(f"B3b {label}: launches {launched}, expected 1")
    if not same_bits(got.contiguous(), want.contiguous()):
        raise AssertionError(f"B3b {label} disagrees with its plain version")
    batch = flat.tree_leaves(codec.decode_batch(frames))
    by_frame = flat.tree_leaves(Codec.decode_batch(codec, frames))
    if not all(same_bits(a, b) for a, b in zip(batch, by_frame)):
        raise AssertionError(f"decode_batch {label} differs from the "
                             f"frame-by-frame decode")
    print(f"  B3b frames unpack, {label}: bitwise the plain version in one "
          f"launch; decode_batch bitwise the frame-by-frame decode")


def check_frames_chunks(dev, g: torch.Generator) -> None:
    """B3b on more frames than one launch's table holds: MAX_FRAMES + 3
    short frames of random bytes (rows of 15 bytes, so they start at every
    alignment; a 10-byte section of n = 77 at byte 3), bitwise the plain
    version in two launches."""
    count, n, offset = bp_mod.MAX_FRAMES + 3, 77, 3
    frames = torch.randint(0, 256, (count, offset + bp_mod.num_bytes(n) + 2),
                           generator=g, device=dev, dtype=torch.uint8)
    reset_counts()
    got = bp_mod.unpack_signs_frames(frames, offset, n)
    launched = counts()
    want = bp_mod.unpack_signs_frames_plain(list(frames), offset, n)
    torch.cuda.synchronize()
    if launched != only(unpack_signs=2):
        raise AssertionError(f"B3b on {count} frames: launches {launched}, "
                             f"expected 2")
    if not same_bits(got.contiguous(), want.contiguous()):
        bad = torch.nonzero(got != want)[0].tolist()
        raise AssertionError(f"B3b on {count} frames disagrees with its "
                             f"plain version at (frame, sign) {bad}")
    print(f"  B3b frames unpack, {count} short frames (n={n}, section at "
          f"byte {offset}): bitwise the plain version in 2 launches")


def phase_b3_entries(dev, g: torch.Generator) -> None:
    """B3a's tree entry and B3b's frames entry against their plain
    versions, and one device kernel per call."""
    mlp = planted_leaves(g, [t.numel() for t in flat.tree_leaves(
        mlp_tree(g))])
    check_tree_pack("MLP tree", mlp, 32)
    ragged = planted_leaves(g, B3_RAGGED_SIZES)
    ragged[3] = unaligned(ragged[3])
    check_tree_pack("ragged tree", ragged, 3)
    codec, _ = codec_payload("signsgd", dev, g)
    params = make_mlp(MNIST_SPEC).init(g)
    frames = sign_frames(codec, params, g, max(B3_FRAMES))
    for count in B3_FRAMES:
        check_frames_unpack(f"{count} frame(s)", codec, frames[:count])
    check_frames_unpack(f"{len(frames)} frames stacked", codec,
                        torch.stack(frames))
    views = []
    for c, f in enumerate(frames[:3]):
        buf = torch.zeros(f.numel() + 4, dtype=torch.uint8, device=dev)
        views.append(buf[c + 1:c + 1 + f.numel()])
        views[-1].copy_(f)
    check_frames_unpack("3 unaligned frame views", codec, views)
    check_frames_chunks(dev, g)
    out = torch.empty(codec.spec.section_bytes[0], dtype=torch.uint8,
                      device=dev)
    check_one_kernel("bitpack.pack_signs_tree on the MLP tree",
                     "pack_signs_table",
                     lambda: bp_mod.pack_signs_tree(mlp, out))
    check_one_kernel(f"bitpack.unpack_signs_frames on {len(frames)} frames",
                     "unpack_signs_frames",
                     lambda: bp_mod.unpack_signs_frames(
                         frames, codec.spec.section_offsets[0], codec.d))


# ---------------------------------------------------------------------------
# phase 4: the main path through the entry point
# ---------------------------------------------------------------------------


def run_trainer(out_dir: str, compressor: str, wire: str, *,
                rounds: int = ROUNDS, model: str = "mlp",
                dataset: str = "mnist", extra=()):
    """``train.main`` for ``rounds`` rounds with every counter set to 0 just
    before; returns (state, launches, wall seconds), after checking the
    metrics rows are finite."""
    argv = ["--model", model, "--dataset", dataset, "--compressor",
            compressor, "--wire", wire, "--clients", str(N), "--local-steps",
            str(K), "--batch", str(B), "--rounds", str(rounds),
            "--eval-every", "1", "--device", "cuda", "--out", out_dir,
            *extra]
    reset_counts()
    t0 = time.perf_counter()
    state = train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    if len(rows) != rounds:
        raise AssertionError(f"expected {rounds} metrics rows, got {rows}")
    for r in rows:
        if not (math.isfinite(r["loss"]) and math.isfinite(r["cos"])):
            raise AssertionError(f"non-finite metrics: {r}")
    return state, launched, wall


def phase_main_path(out_dir: str):
    phase("main path: repro_torch.launch.train.main")
    state, launched, wall = run_trainer(out_dir, "threesfc", "float")
    want = only(fused_cosine=ROUNDS * N * (S + 1), ef_update=ROUNDS * N)
    if launched != want:
        raise AssertionError(f"launches {launched}, expected {want}")
    print(f"  {ROUNDS} rounds in {wall:.2f} s (first includes warm-up), "
          f"launches {launched}")
    return state, launched


# ---------------------------------------------------------------------------
# phase 5: fused decode vs float decode, and the card vs the CPU
# ---------------------------------------------------------------------------


def make_round(fused: bool):
    model = make_mlp(MNIST_SPEC)
    comp = CompressorConfig(kind="threesfc", syn_steps=S, syn_lr=0.1)
    strategy = make_strategy(comp, loss_fn=model.syn_loss,
                             syn_spec=vision_syn_spec(MNIST_SPEC, comp),
                             local_lr=0.01)
    run = RunConfig(fl=FLConfig(num_clients=N, local_steps=K, local_lr=0.01,
                                local_batch=B, compressor=comp),
                    fused_decode=fused)
    return build_fl_round(model.loss, strategy, run), strategy


def round_inputs(dev, spec):
    g = gen(dev, 5)
    batches = {"x": torch.rand((N, K, B, 28, 28, 1), generator=g, device=dev),
               "y": torch.randint(0, 10, (N, K, B), generator=g, device=dev)}
    syns = [init_syn(g, spec) for _ in range(N)]
    syn0 = SynData(*[torch.stack(ts) for ts in zip(*syns)])
    return batches, syn0


def assert_close(name, got, want, tol) -> None:
    """Elementwise |got − want| ≤ atol + rtol·|want| over every leaf."""
    worst, max_abs = -math.inf, 0.0
    for a, b in zip(flat.tree_leaves(got), flat.tree_leaves(want)):
        a, b = a.double().cpu(), b.double().cpu()
        d = (a - b).abs()
        max_abs = max(max_abs, float(d.max()))
        worst = max(worst, float((d / (tol["atol"]
                                       + tol["rtol"] * b.abs())).max()))
    if worst > 1.0:
        raise AssertionError(f"{name}: exceeds rtol={tol['rtol']} "
                             f"atol={tol['atol']} ({worst:.3f}x the bound)")
    print(f"  {name}: max |diff| {max_abs:.3e}, at most {worst:.3f}x the "
          f"bound rtol={tol['rtol']} atol={tol['atol']}")


def phase_fused(state: FLState, dev):
    phase("fused decode vs float decode; card vs CPU")
    float_round, strategy = make_round(False)
    fused_round, _ = make_round(True)
    batches, syn0 = round_inputs(dev, strategy.syn_spec)
    reset_counts()
    s_float, m_float = float_round(state, batches, 0, syn0=syn0)
    s_fused, m_fused = fused_round(state, batches, 0, syn0=syn0)
    torch.cuda.synchronize()
    print(f"  launches over the two rounds: {counts()}")
    assert_close("fused params", s_fused.params, s_float.params, PARAM_TOL)
    assert_close("fused EF", s_fused.ef, s_float.ef, EF_TOL)
    # the same float round on the CPU runs the kernels' plain versions
    s_cpu, m_cpu = float_round(
        FLState(to_cpu(state.params), to_cpu(state.ef), state.round),
        to_cpu(batches), 0, syn0=SynData(*to_cpu(list(syn0))))
    assert_close("card vs CPU params", s_float.params, s_cpu.params,
                 PARAM_TOL)
    assert_close("card vs CPU EF", s_float.ef, s_cpu.ef, EF_TOL)
    for m in (m_float, m_fused, m_cpu):
        if not bool(torch.isfinite(m.cosine).all()):
            raise AssertionError(f"non-finite cosine: {m.cosine}")
    return float_round, batches, syn0


# ---------------------------------------------------------------------------
# phase 6: the codec path through the entry point, and frames card vs CPU
# ---------------------------------------------------------------------------


def phase_codec_path(out_dir: str, float_state: FLState, batches):
    phase("codec path: repro_torch.launch.train.main --wire codec")
    sign_state, launched, wall = run_trainer(
        os.path.join(out_dir, "signsgd"), "signsgd", "codec")
    # per client per round: one frame packed (B3a) and one efficiency
    # cosine (B1); per round one B3b for the N frames; EF is u − recon, no
    # B2
    want = only(fused_cosine=ROUNDS * N, pack_signs=ROUNDS * N,
                unpack_signs=ROUNDS)
    if launched != want:
        raise AssertionError(f"signsgd codec launches {launched}, "
                             f"expected {want}")
    print(f"  signsgd: {ROUNDS} rounds in {wall:.2f} s, launches {launched}")
    check_batch_decode_rounds(sign_state, batches)
    sfc_state, sfc_launched, wall = run_trainer(
        os.path.join(out_dir, "threesfc"), "threesfc", "codec")
    want = only(fused_cosine=ROUNDS * N * (S + 1), ef_update=ROUNDS * N)
    if sfc_launched != want:
        raise AssertionError(f"threesfc codec launches {sfc_launched}, "
                             f"expected {want}")
    # the server's Eq. 10 backward on the decoded (D_syn, s) repeats the
    # client's last gradient: the same numbers, so the same params
    bitwise = all(same_bits(a, b) for a, b in zip(
        flat.tree_leaves(sfc_state.params),
        flat.tree_leaves(float_state.params)))
    print(f"  threesfc: {ROUNDS} rounds in {wall:.2f} s, launches "
          f"{sfc_launched}; params bitwise equal to the float-mode run: "
          f"{bitwise}")
    assert_close("threesfc codec vs float params", sfc_state.params,
                 float_state.params, PARAM_TOL)
    return sign_state, launched


def frame_by_frame(codec):
    """``codec`` decoding a round's frames one after another (the base
    class's ``decode_batch`` and ``recon_batch``), as rounds did before
    the batch decode."""
    codec.decode_batch = functools.partial(Codec.decode_batch, codec)
    codec.recon_batch = functools.partial(Codec.recon_batch, codec)
    return codec


def check_batch_decode_rounds(state: FLState, batches) -> None:
    """ROUNDS signSGD codec rounds from ``state`` that decode each round's
    N frames as one batch (one B3b launch), against the same rounds
    decoding frame by frame (N launches): params, EF and metrics bitwise."""
    runs = {}
    for label, by_frame in (("one batch", False), ("frame by frame", True)):
        one_round = sign_codec_round(state, by_frame)
        s, out = state, []
        reset_counts()
        for r in range(ROUNDS):
            s, m = one_round(s, batches, r)
            out.append((s, m))
        torch.cuda.synchronize()
        runs[label] = (out, counts())
    for label, per_round in (("one batch", 1), ("frame by frame", N)):
        want = only(fused_cosine=ROUNDS * N, pack_signs=ROUNDS * N,
                    unpack_signs=ROUNDS * per_round)
        if runs[label][1] != want:
            raise AssertionError(f"signsgd rounds decoded {label}: launches "
                                 f"{runs[label][1]}, expected {want}")
    for r, ((sa, ma), (sb, mb)) in enumerate(zip(runs["one batch"][0],
                                                  runs["frame by frame"][0])):
        pairs = list(zip(flat.tree_leaves((sa.params, sa.ef)),
                         flat.tree_leaves((sb.params, sb.ef))))
        pairs += [(getattr(ma, f), getattr(mb, f)) for f in
                  ("loss", "cosine", "payload_floats", "update_norm")]
        if not all(same_bits(a, b) for a, b in pairs):
            raise AssertionError(f"signsgd round {r}: the batch decode's "
                                 f"params, EF or metrics differ from the "
                                 f"frame-by-frame decode's")
    print(f"  signsgd: {ROUNDS} rounds decoding each round's {N} frames as "
          f"one batch are bitwise those decoding frame by frame (params, "
          f"EF, metrics); launches {runs['one batch'][1]} vs "
          f"{runs['frame by frame'][1]}")


def codec_payload(method: str, dev, g):
    """(codec, wire payload) of ``method`` at the MLP's shapes on ``dev``:
    the strategy's own encode of an update with planted exact zeros."""
    model = make_mlp(MNIST_SPEC)
    params = model.init(g)
    comp = matched_compressors("mlp", MNIST_SPEC, MLP_D)[method]
    strategy = make_strategy(comp, loss_fn=model.syn_loss,
                             syn_spec=vision_syn_spec(MNIST_SPEC, comp),
                             local_lr=0.01)
    if comp.kind == "threesfc":
        wire = (init_syn(g, strategy.syn_spec),
                torch.tensor(-0.37, device=dev))
    else:
        u = mlp_tree(g, 1e-2)
        for leaf in flat.tree_leaves(u):
            leaf.view(-1)[::16] = 0.0
        wire = strategy.client_encode(g, u, params).wire
    return strategy.wire_codec(params), wire


def phase_frames(dev) -> None:
    phase("frames: every codec on the card vs the CPU")
    g = gen(dev, 17)
    for method in CODEC_METHODS:
        codec, wire = codec_payload(method, dev, g)
        card = codec.encode(wire, round_idx=2, client_idx=9)
        cpu_wire = to_cpu(wire)
        host = codec.encode(cpu_wire, round_idx=2, client_idx=9)
        if not torch.equal(card.cpu(), host):
            bad = int(torch.nonzero(card.cpu() != host)[0])
            raise AssertionError(f"{codec.kind}: card frame differs from "
                                 f"the CPU's at byte {bad}")
        want = flat.tree_leaves(codec.canonical(cpu_wire))
        for where, got in (("CPU", codec.decode(card.cpu())),
                           ("card", to_cpu(codec.decode(card)))):
            leaves = flat.tree_leaves(got)
            if len(leaves) != len(want) or not all(
                    same_bits(a, b) for a, b in zip(leaves, want)):
                raise AssertionError(f"{codec.kind}: the card's frame "
                                     f"decoded on the {where} differs from "
                                     f"the canonical payload")
        print(f"  {codec.kind}: {codec.nbytes} B, card frame == CPU frame, "
              f"decodes to the canonical payload on the CPU and the card")


# ---------------------------------------------------------------------------
# phase 8: B4 against its plain version
# ---------------------------------------------------------------------------


def b4_inputs(g: torch.Generator, b, h, nc, Q, P, N, decay_scale=0.2,
              signed=False):
    """tests/test_kernels.py's distributions in the kernel layout:
    xdt = 0.1·N(0,1), dA = −scale·softplus(N), B and C = 0.5·N; with
    ``signed``, dA = scale·N (decays and growths mixed)."""
    dev = g.device
    xdt = 0.1 * torch.randn((b, h, nc, Q, P), generator=g, device=dev)
    dA = torch.randn((b, h, nc, Q), generator=g, device=dev)
    dA = (decay_scale * dA if signed
          else -decay_scale * torch.nn.functional.softplus(dA))
    B = 0.5 * torch.randn((b, nc, Q, N), generator=g, device=dev)
    C = 0.5 * torch.randn((b, nc, Q, N), generator=g, device=dev)
    return xdt, dA, B, C


def check_b4(inputs, label: str) -> float:
    """B4 twice (bitwise equal) against its plain version (elementwise
    |got − want| <= atol + rtol·|want|); returns the largest |got − want|."""
    got = ssd_mod.ssd_chunk(*inputs)
    again = ssd_mod.ssd_chunk(*inputs)
    want = ssd_mod.ssd_chunk_plain(*inputs)
    torch.cuda.synchronize()
    worst = 0.0
    for name, g, a, w in zip(("y", "state", "decay"), got, again, want):
        if not same_bits(g, a):
            raise AssertionError(f"B4 {name} not bitwise repeatable at "
                                 f"{label}")
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"B4 {name} not finite at {label}")
        err = (g - w).abs()
        bound = B4_TOL["atol"] + B4_TOL["rtol"] * w.abs()
        if not bool((err <= bound).all()):
            i = int(torch.argmax(err - bound))
            raise AssertionError(
                f"B4 {name} disagrees at {label}, element {i}: "
                f"{float(g.reshape(-1)[i])} vs {float(w.reshape(-1)[i])}")
        worst = max(worst, float(err.max()))
    return worst


def phase_b4(dev) -> float:
    phase("B4 ssd_chunk vs plain, on the card")
    g = gen(dev, 19)
    err_full = 0.0
    for shape in B4_SHAPES:
        err = check_b4(b4_inputs(g, *shape), f"{shape}")
        print(f"  (b,h,nc,Q,P,N)={shape}: max_abs_err={err:.3e} "
              f"(bitwise repeatable)")
        if shape == B4_FULL:
            err_full = err
    for shape in (B4_SHAPES[0], B4_FULL):
        err = check_b4(b4_inputs(g, *shape, decay_scale=30.0),
                       f"{shape}, dA = -30 softplus")
        print(f"  {shape} with decays that underflow (dA = -30 softplus): "
              f"max_abs_err={err:.3e}")
    # dA of both signs: L's entries above 1 as well as below
    err = check_b4(b4_inputs(g, *B4_FULL, decay_scale=0.05, signed=True),
                   f"{B4_FULL}, dA = 0.05 N(0, 1)")
    print(f"  {B4_FULL} with dA of both signs (dA = 0.05 N(0, 1)): "
          f"max_abs_err={err:.3e}")
    # a Q that is no multiple of 4 or of the kernel's 16-row tiles and a P
    # and N off its 16- and 8-wide tiles (edges zero-padded); then operands
    # the kernel does not take
    odd = (2, 3, 2, 5, 8, 12)
    err = check_b4(b4_inputs(g, *odd), f"{odd}")
    print(f"  (b,h,nc,Q,P,N)={odd}: max_abs_err={err:.3e}")
    shifted = [unaligned(t) for t in b4_inputs(g, *B4_SHAPES[0])]
    refused = [(f"{B4_SHAPES[0]}, tiles off a 16-byte boundary", shifted,
                "16-byte boundary"),
               ("(2, 3, 2, 5, 6, 7)", b4_inputs(g, 2, 3, 2, 5, 6, 7),
                "multiples of 4")]
    for label, inputs, match in refused:
        before = ssd_mod.LAUNCHES
        try:
            ssd_mod.ssd_chunk(*inputs)
        except ValueError as e:
            if match not in str(e):
                raise
        else:
            raise AssertionError(f"B4 took {label}")
        if ssd_mod.LAUNCHES != before:
            raise AssertionError(f"B4 launched on {label}")
        print(f"  {label}: refused by the wrapper")
    return err_full


def unaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` starting 4 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


# ---------------------------------------------------------------------------
# phase 9: the serve main path through the entry point
# ---------------------------------------------------------------------------


def phase_serve():
    phase("serve main path: repro_torch.launch.serve.main, mamba2-370m full "
          "width, --ssd-kernel")
    argv = ["--arch", "mamba2-370m", "--size", "full", "--batch",
            str(SERVE_BATCH), "--prompt-len", str(SERVE_PROMPT), "--gen",
            str(SERVE_GEN), "--ssd-kernel", "--device", "cuda"]
    reset_counts()
    res = serve.main(argv)
    torch.cuda.synchronize()
    launched = counts()
    want = only(ssd_chunk=SERVE_LAYERS)
    if launched != want:
        raise AssertionError(f"serve launches {launched}, expected {want}")
    if not bool(torch.isfinite(res.logits).all()):
        raise AssertionError("non-finite logits")
    if tuple(res.tokens.shape) != (SERVE_BATCH, SERVE_GEN):
        raise AssertionError(f"tokens {tuple(res.tokens.shape)}")
    if res.model.cfg != get_config("mamba2-370m").replace(
            use_pallas_ssd=True):
        raise AssertionError(f"not the full config: {res.model.cfg}")
    steps = SERVE_GEN - 1
    print(f"  launches {launched}; first prefill {res.prefill_s * 1e3:.3f} "
          f"ms (cold), {steps} decode steps in {res.decode_s * 1e3:.3f} ms: "
          f"{res.decode_s / steps * 1e3:.3f} ms per step, "
          f"{SERVE_BATCH * steps / res.decode_s:.1f} tok/s")
    reset_counts()
    with torch.inference_mode():
        # wall time of one prefill (median of 3), device time of one more
        prof = round_profile(lambda: res.model.prefill(
            res.params, res.prompt, SERVE_PROMPT + SERVE_GEN), KERNEL_NAMES)
    per_prefill = ssd_mod.LAUNCHES // 4      # 3 timed + 1 profiled
    if ssd_mod.LAUNCHES != 4 * SERVE_LAYERS:
        raise AssertionError(f"{ssd_mod.LAUNCHES} B4 launches in 4 "
                             f"prefills, expected {4 * SERVE_LAYERS}")
    print_profile(f"warm prefill (batch {SERVE_BATCH}, prompt "
                  f"{SERVE_PROMPT})", prof)
    with torch.inference_mode():
        logits, cache, t = res.model.prefill(res.params, res.prompt,
                                             SERVE_PROMPT + SERVE_GEN)
        reset_counts()
        tok = torch.argmax(logits, -1)
        for i in range(steps):
            logits, cache = res.model.decode_step(res.params, cache, tok,
                                                  t + i)
            tok = torch.argmax(logits, -1)
    torch.cuda.synchronize()
    if counts() != only():
        raise AssertionError(f"decode launched kernels: {counts()}")
    print(f"  B4 launches per prefill {per_prefill}, in {steps} decode "
          f"steps 0")
    return launched


# ---------------------------------------------------------------------------
# phase 10: kernel route vs ssd_scan on the card vs the CPU
# ---------------------------------------------------------------------------


def phase_routes(dev) -> None:
    phase(f"routes: full width, {ROUTE_LAYERS} layers, float32: B4 on the "
          f"card vs ssd_scan on the card vs the CPU")
    cfg = get_config("mamba2-370m").replace(num_layers=ROUTE_LAYERS,
                                            dtype="float32")
    kernel_model = build_model(cfg.replace(use_pallas_ssd=True))
    scan_model = build_model(cfg)
    g = gen(dev, 23)
    with torch.inference_mode():
        params = kernel_model.init(g)
        prompt = torch.randint(0, cfg.vocab_size, (ROUTE_BATCH, ROUTE_PROMPT),
                               generator=g, device=dev)
        params_cpu = to_cpu(params)
        routes = {"B4 on the card": (kernel_model, params, prompt),
                  "ssd_scan on the card": (scan_model, params, prompt),
                  "CPU": (kernel_model, params_cpu, prompt.cpu())}
        cache_len = ROUTE_PROMPT + ROUTE_DECODE
        state = {}
        for name, (model, p, tk) in routes.items():
            reset_counts()
            logits, cache, t = model.prefill(p, tk, cache_len)
            torch.cuda.synchronize()
            want = ROUTE_LAYERS if name == "B4 on the card" else 0
            if ssd_mod.LAUNCHES != want:
                raise AssertionError(f"{name}: {ssd_mod.LAUNCHES} B4 "
                                     f"launches, expected {want}")
            state[name] = (logits, cache)
        ref_logits, ref_cache = state["CPU"]
        for name in ("B4 on the card", "ssd_scan on the card"):
            assert_close(f"prefill logits, {name} vs CPU", state[name][0],
                         ref_logits, ROUTE_TOL)
            assert_close(f"prefill cache, {name} vs CPU", state[name][1],
                         ref_cache, ROUTE_TOL)
        # teacher-forced decode: every route is fed the CPU's greedy token
        for i in range(ROUTE_DECODE):
            tok = torch.argmax(state["CPU"][0], -1)
            for name, (model, p, _) in routes.items():
                logits, cache = model.decode_step(
                    p, state[name][1], tok.to(p["embed"]["table"].device),
                    ROUTE_PROMPT + i)
                state[name] = (logits, cache)
            for name in ("B4 on the card", "ssd_scan on the card"):
                assert_close(f"decode step {i} logits, {name} vs CPU",
                             state[name][0], state["CPU"][0], ROUTE_TOL)
                assert_close(f"decode step {i} cache, {name} vs CPU",
                             state[name][1], state["CPU"][1], ROUTE_TOL)
    for name, (logits, _) in state.items():
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{name}: non-finite logits")


# ---------------------------------------------------------------------------
# phase 11: B5 and B6 against their plain versions
# ---------------------------------------------------------------------------


def repeated(fn, label: str, calls: int = 3):
    """``calls`` calls of ``fn``; each must give bitwise the first's
    tensors. Returns the first call's."""
    first = fn()
    for _ in range(calls - 1):
        again = fn()
        torch.cuda.synchronize()
        if not all(same_bits(a, b) for a, b in zip(first, again)):
            raise AssertionError(f"not bitwise repeatable at {label}")
    return first


def check_b5(x: torch.Tensor, label: str) -> float:
    """B5 three times (signs and scale bitwise equal) against its plain
    version: signs bitwise, the scale within B5_RTOL; returns |scale −
    plain|."""
    signs, scale = repeated(lambda: sq_mod.sign_quant(x), f"B5, {label}")
    want_signs, want_scale = sq_mod.sign_quant_plain(x)
    torch.cuda.synchronize()
    if not same_bits(signs, want_signs):
        bad = int(torch.nonzero(signs != want_signs)[0])
        raise AssertionError(f"B5 signs disagree at {label}, element {bad}: "
                             f"{int(signs[bad])} vs {int(want_signs[bad])}")
    if x.numel() == 0:
        if not (bool(torch.isnan(scale)) and bool(torch.isnan(want_scale))):
            raise AssertionError(f"B5 scale of n=0 not NaN: {float(scale)}")
        return 0.0
    err = abs(float(scale) - float(want_scale))
    if err > B5_RTOL * abs(float(want_scale)):
        raise AssertionError(f"B5 scale disagrees at {label}: "
                             f"{float(scale)} vs {float(want_scale)}")
    return err


def check_b6(x: torch.Tensor, tau: torch.Tensor, label: str) -> int:
    """B6 three times (bitwise equal) against its plain version: the masked
    vector and the count bitwise; returns the count."""
    out, cnt = repeated(lambda: tm_mod.topk_mask(x, tau), f"B6, {label}")
    want, want_cnt = tm_mod.topk_mask_plain(x, tau)
    torch.cuda.synchronize()
    if not same_bits(out, want):
        bad = int(torch.nonzero(out.view(torch.int32)
                                != want.view(torch.int32))[0])
        raise AssertionError(f"B6 disagrees at {label}, element {bad}: "
                             f"{float(out[bad])} vs {float(want[bad])}")
    if not same_bits(cnt, want_cnt):
        raise AssertionError(f"B6 count disagrees at {label}: {float(cnt)} "
                             f"vs {float(want_cnt)}")
    return int(cnt)


def check_graph_replays(fn, label: str, replays: int = 3) -> None:
    """Two calls of ``fn`` captured in one CUDA graph, replayed ``replays``
    times with the outputs poisoned before each replay: every replay must
    write bitwise the eager call's results. A ticket left off 0 would leave
    the scale or count unwritten (still NaN) or written by the wrong
    block."""
    want = fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                    # the stream's scratch, outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        outs = [fn(), fn()]
    for _ in range(replays):
        for out in outs:
            for t in out:
                t.reshape(-1).view(torch.uint8).fill_(0xFF)  # NaN, -1
        graph.replay()
        torch.cuda.synchronize()
        for out in outs:
            if not all(same_bits(a, b) for a, b in zip(out, want)):
                raise AssertionError(f"{label}: a CUDA graph replay differs "
                                     f"from the eager call")


def check_first_call_in_capture_raises(fn, scratch, label: str) -> None:
    """The first call on a stream that has no scratch yet, made while that
    stream is being captured, must raise before it launches."""
    dev = torch.device("cuda", torch.cuda.current_device())
    for _ in range(64):
        side = torch.cuda.Stream()
        if (dev.index, side.cuda_stream) not in scratch._made:
            break
    else:
        raise AssertionError("no CUDA stream without a scratch left")
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, stream=side):
            fn()
    except RuntimeError as e:
        if "captured" not in str(e):
            raise
    else:
        raise AssertionError(f"{label}: a first call inside a capture did "
                             f"not raise")
    torch.cuda.synchronize()


def b6_taus(x: torch.Tensor) -> list:
    """The fixed edge thresholds, and the sampled ones of k = 1% and 10%
    (``topk_threshold`` on the card, equal bitwise to the CPU's)."""
    taus = [(f"tau={t:g}", torch.tensor(t, device=x.device))
            for t in EDGE_TAUS]
    if x.numel():
        for frac in (0.01, 0.1):
            k = max(1, int(frac * x.numel()))
            t = ops.topk_threshold(x, k)
            t_cpu = ops.topk_threshold(x.cpu(), k)
            if not same_bits(t.cpu(), t_cpu):
                raise AssertionError(f"topk_threshold at n={x.numel()}, "
                                     f"k={k}: card {float(t)} vs CPU "
                                     f"{float(t_cpu)}")
            taus.append((f"k={frac:.0%}", t))
    return taus


def check_b56(x: torch.Tensor, label: str) -> float:
    err = check_b5(x, label)
    for tlabel, tau in b6_taus(x):
        check_b6(x, tau, f"{label}, {tlabel}")
    return err


def phase_b56(dev) -> float:
    phase("B5 sign_quant and B6 topk_mask vs plain, on the card")
    g = gen(dev, 31)
    edge = torch.tensor(EDGE, device=dev)
    # a first call inside a capture raises, on a stream no call has used
    x = torch.randn(MLP_D, generator=g, device=dev)
    tau = ops.topk_threshold(x, MLP_D // 100)
    check_first_call_in_capture_raises(lambda: sq_mod.sign_quant(x),
                                       sq_mod._SCRATCH, "B5")
    check_first_call_in_capture_raises(lambda: tm_mod.topk_mask(x, tau),
                                       tm_mod._SCRATCH, "B6")
    # ±1 of a thread's step, of a block's tile and of one wave's elements
    edges = {n + d for n in (sq_mod.STEP, sq_mod.TILE, tm_mod.TILE,
                             sq_mod.TILE * sq_mod.wave(dev.index),
                             tm_mod.TILE * tm_mod.wave(dev.index))
             for d in (-1, 0, 1)}
    lengths = sorted(set(B56_LENGTHS) | edges)
    worst = 0.0
    for n in lengths:
        x = torch.randn(n, generator=g, device=dev)
        m = min(n, edge.numel())
        x[:m] = edge[:m]
        worst = max(worst, check_b56(x, f"n={n}"))
    worst = max(worst, check_b56(edge, "the edge vector"))
    # values exactly at a threshold are kept
    for v in (0.25, 0.125, FLT_MIN):
        if check_b6(edge, torch.tensor(v, device=dev),
                    f"edge vector, tau={v:g}") != int(
                        (edge.abs() >= v).sum()):
            raise AssertionError(f"B6 count at tau={v:g}")
    for leaf in flat.tree_leaves(mlp_tree(g, 1e-3)):
        worst = max(worst, check_b56(leaf.reshape(-1),
                                     f"MLP leaf {tuple(leaf.shape)}"))
    # views 1, 2 and 3 floats off a 16-byte boundary take the scalar loads
    for n in (sq_mod.TILE + 1, MLP_D):
        base = torch.randn(n + 3, generator=g, device=dev)
        for off in (1, 2, 3):
            worst = max(worst, check_b56(base[off:off + n],
                                         f"n={n}, {off} float(s) off"))
    # CUDA graph replays reuse each stream's ticket: it must be back at 0
    x = torch.randn(MLP_D, generator=g, device=dev)
    tau = ops.topk_threshold(x, MLP_D // 100)
    check_graph_replays(lambda: sq_mod.sign_quant(x), "B5")
    check_graph_replays(lambda: tm_mod.topk_mask(x, tau), "B6")
    print(f"  B5 signs bitwise and scale within rtol {B5_RTOL} (max |diff| "
          f"{worst:.3e}), B6 masks and counts bitwise, each bitwise "
          f"repeatable over 3 calls, at n={lengths}, the edge vector, the "
          f"MLP's 6 leaves and views 1, 2, 3 floats off a 16-byte boundary, "
          f"tau in {EDGE_TAUS} and the sampled k = 1%, 10% (card threshold "
          f"== CPU threshold); 3 CUDA graph replays of 2 calls each bitwise "
          f"the eager call; a first call inside a capture raises")
    return worst


# ---------------------------------------------------------------------------
# phase 12: the compressor library at the MLP's full width
# ---------------------------------------------------------------------------


def client_update(state: FLState, batches) -> dict:
    """Client 0's u = g + e at the trainer's state: K local SGD steps on
    its batches plus its EF residual."""
    g, _ = local_train(make_mlp(MNIST_SPEC).loss, state.params,
                       flat.tree_map(lambda x: x[0], batches), 0.01)
    return flat.tree_add(g, flat.tree_map(lambda e: e[0], state.ef))


def telescopes(name: str, total_g, total_recon, e) -> None:
    """Σ recon_t + e_T = Σ g_t (e_0 = 0), rtol 1e-4 and an absolute floor
    of 1e-4 of max |Σ g| (the reference's rtol/atol 1e-4 for unit-scale
    updates)."""
    lhs = flat.tree_add(total_recon, e)
    top = max(float(t.abs().max()) for t in flat.tree_leaves(total_g))
    assert_close(f"{name} EF telescoping", lhs, total_g,
                 dict(rtol=1e-4, atol=1e-4 * top))


def phase_compressors(state: FLState, batches, dev) -> dict:
    phase(f"compressor library at d={MLP_D} on a client update")
    u = client_update(state, batches)
    params = state.params
    g = gen(dev, 37)
    steps = [flat.tree_map(lambda t: t * (1.0 + 0.1 * i), u)
             for i in range(EF_STEPS)]
    for kind in ("identity", "topk", "randk", "signsgd", "stc"):
        comp = make_compressor(CompressorConfig(kind=kind, keep_ratio=0.01))
        e = comp.init_state(params)
        tg, tr = flat.tree_zeros_like(params), flat.tree_zeros_like(params)
        reset_counts()
        for gt in steps:
            recon, e, m = comp.step(g, gt, e, params)
            if not bool(torch.isfinite(m.cosine)):
                raise AssertionError(f"{kind}: non-finite cosine")
            tg, tr = flat.tree_add(tg, gt), flat.tree_add(tr, recon)
        torch.cuda.synchronize()
        # the efficiency cosine is one B1 launch per step (identity's is 1
        # by construction); EF is u − recon
        want = only(fused_cosine=0 if kind == "identity" else EF_STEPS)
        if counts() != want:
            raise AssertionError(f"{kind}: launches {counts()}, expected "
                                 f"{want}")
        telescopes(f"make_compressor({kind!r})", tg, tr, e)
    vec = torch.cat([t.reshape(-1) for t in flat.tree_leaves(u)])
    k = leaf_k(vec.numel(), 0.01)
    for name, fn in (("topk", lambda v: baselines.topk_compress(v, k)),
                     ("signsgd", baselines.signsgd_compress),
                     ("stc", lambda v: baselines.stc_compress(v, k)),
                     ("randk", lambda v: baselines.randk_compress(g, v, k))):
        e = ef.ef_init(vec.numel(), dev)
        tg, tr = torch.zeros_like(vec), torch.zeros_like(vec)
        for i in range(EF_STEPS):
            gt = vec * (1.0 + 0.1 * i)
            _, recon, e = ef.ef_step(fn, gt, e)
            tg, tr = tg + gt, tr + recon
        telescopes(f"flat ef_step({name})", tg, tr, e)
    # the B5/B6 front end against the exact baselines
    reset_counts()
    calls = 0
    for leaf in flat.tree_leaves(u):
        signs, scale = ops.sign_quant(leaf)
        calls += 1
        payload, _ = baselines.signsgd_compress(leaf.reshape(-1))
        if not torch.equal(signs.reshape(-1).float(), payload.data[0]):
            raise AssertionError(f"sign_quant vs signsgd_compress signs at "
                                 f"{tuple(leaf.shape)}")
        if abs(float(scale) - float(payload.data[1])) > B5_RTOL * abs(
                float(payload.data[1])):
            raise AssertionError(f"sign_quant vs signsgd_compress scale at "
                                 f"{tuple(leaf.shape)}: {float(scale)} vs "
                                 f"{float(payload.data[1])}")
    kept = {}
    for frac in (0.01, 0.1):
        kk = max(1, int(frac * vec.numel()))
        out, cnt = ops.topk_mask(vec, ops.topk_threshold(vec, kk))
        calls += 1
        _, exact = baselines.topk_compress(vec, kk)
        mask, top = out != 0, exact != 0
        if not 0.3 * kk <= int(cnt) <= 3 * kk:
            raise AssertionError(f"topk_mask kept {int(cnt)} of k={kk}")
        if int(mask.sum()) != int(cnt) or not torch.equal(out[mask],
                                                          vec[mask]):
            raise AssertionError("topk_mask's kept values are not x's")
        # both are the largest magnitudes above a threshold: one support
        # holds the other
        inter = int((mask & top).sum())
        if inter != min(int(mask.sum()), int(top.sum())):
            raise AssertionError(f"topk_mask support and top-k support "
                                 f"are not nested at k={kk}")
        kept[kk] = (int(cnt), inter)
    torch.cuda.synchronize()
    launched = counts()
    want = only(sign_quant=len(flat.tree_leaves(u)), topk_mask=2)
    if launched != want or launched["sign_quant"] + launched[
            "topk_mask"] != calls:
        raise AssertionError(f"front end launches {launched}, expected "
                             f"{want}")
    print(f"  front end: {calls} calls, launches {launched}; sign_quant == "
          f"signsgd_compress on the 6 leaves; topk_mask kept (count, in the "
          f"exact top-k) {kept}")
    return launched


# ---------------------------------------------------------------------------
# phase 13: randk and FedSynth rounds through build_fl_round
# ---------------------------------------------------------------------------


def accounted_round(kind: str):
    model = make_mlp(MNIST_SPEC)
    comp = CompressorConfig(kind=kind, keep_ratio=0.01)
    strategy = make_strategy(comp, loss_fn=model.syn_loss,
                             syn_spec=vision_syn_spec(MNIST_SPEC, comp),
                             local_lr=0.01)
    run = RunConfig(fl=FLConfig(num_clients=N, local_steps=K, local_lr=0.01,
                                local_batch=B, compressor=comp))
    return build_fl_round(model.loss, strategy, run), strategy


def phase_accounted(state: FLState, batches, syn0):
    phase(f"randk and FedSynth rounds (N={N}, K={K}, B={B}, float mode, "
          f"EF on, {ROUNDS} rounds)")
    rounds = {}
    for kind in ("randk", "fedsynth"):
        fl_round, strategy = accounted_round(kind)
        s = FLState(state.params, flat.tree_map(torch.zeros_like, state.ef),
                    0)
        reset_counts()
        t0 = time.perf_counter()
        for r in range(ROUNDS):
            s, m = fl_round(s, batches, r)
            if not (bool(torch.isfinite(m.cosine).all())
                    and math.isfinite(float(m.loss))
                    and math.isfinite(float(m.update_norm))):
                raise AssertionError(f"{kind}: non-finite metrics {m}")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = counts()
        # one efficiency cosine (B1) per client per round; EF is u − recon
        want = only(fused_cosine=ROUNDS * N)
        if launched != want:
            raise AssertionError(f"{kind} launches {launched}, expected "
                                 f"{want}")
        print(f"  {kind}: {ROUNDS} rounds in {wall:.2f} s, launches "
              f"{launched}, mean cosine {float(m.cosine.mean()):.4f}")
        rounds[kind] = (fl_round, s)
    fs_round, fs_state = rounds["fedsynth"]
    s_card, _ = fs_round(fs_state, batches, 0, syn0=syn0)
    s_cpu, _ = fs_round(FLState(to_cpu(fs_state.params), to_cpu(fs_state.ef),
                                fs_state.round),
                        to_cpu(batches), 0, syn0=SynData(*to_cpu(list(syn0))))
    assert_close("fedsynth card vs CPU params", s_card.params, s_cpu.params,
                 PARAM_TOL)
    assert_close("fedsynth card vs CPU EF", s_card.ef, s_cpu.ef, EF_TOL)
    return fs_round, fs_state


# ---------------------------------------------------------------------------
# phase 14: the in-round fault model on the main path
# ---------------------------------------------------------------------------


def fault_flags() -> list:
    return [a for k, v in FAULT_KNOBS.items()
            for a in (f"--{k.replace('_', '-')}", str(v))]


def mlp_round(method: str, params, *, wire: str = "float",
              fused: bool = False, fault_schedule_fn=None, **knobs):
    """One MLP round at the main path's N, K, B of the trainer's ``method``
    (``fl.budget.matched_compressors``), through ``build_fl_round``."""
    model = make_mlp(MNIST_SPEC)
    comp = matched_compressors("mlp", MNIST_SPEC, MLP_D)[method]
    strategy = make_strategy(comp, loss_fn=model.syn_loss,
                             syn_spec=vision_syn_spec(MNIST_SPEC, comp),
                             local_lr=0.01)
    run = RunConfig(fl=FLConfig(num_clients=N, local_steps=K, local_lr=0.01,
                                local_batch=B, compressor=comp),
                    wire=wire, fused_decode=fused, **knobs)
    codec = strategy.wire_codec(params) if wire == "codec" else None
    return build_fl_round(model.loss, strategy, run, codec=codec,
                          fault_schedule_fn=fault_schedule_fn)


def injected_schedule(r: int, n: int) -> faults.FaultSchedule:
    """Client 0 skipped, client 1 dropped, clients 2 and 3 late by 1 and 2
    rounds, the rest healthy."""
    ids = torch.arange(n)
    delay = torch.where(ids == 2, 1, torch.where(ids == 3, 2, 0)).to(
        torch.int32)
    return faults.FaultSchedule(ids != 0, ids != 1, delay,
                                faults.staleness_weight(delay))


def state_to_cpu(st: FLState) -> FLState:
    return FLState(to_cpu(st.params), to_cpu(st.ef), st.round,
                   None if st.buf is None else to_cpu(st.buf),
                   None if st.buf_w is None else st.buf_w.cpu())


def tree_bits_equal(a, b) -> bool:
    la, lb = flat.tree_leaves(a), flat.tree_leaves(b)
    return len(la) == len(lb) and all(same_bits(x, y) for x, y in zip(la, lb))


def check_null_schedule(label: str, method: str, state: FLState, batches,
                        syn0, **kw) -> None:
    """One round of the masked pipeline under the null schedule against
    the unfaulted round from the same state: params, EF and metrics
    bitwise."""
    plain = mlp_round(method, state.params, **kw)
    null = mlp_round(method, state.params, **kw,
                     fault_schedule_fn=lambda r, n: faults.null_schedule(n))
    sa, ma = plain(state, batches, 0, syn0=syn0)
    sb, mb = null(state, batches, 0, syn0=syn0)
    metrics = [(getattr(ma, f), getattr(mb, f))
               for f in ("loss", "cosine", "payload_floats", "update_norm")]
    if not (tree_bits_equal(sa.params, sb.params)
            and tree_bits_equal(sa.ef, sb.ef)
            and all(same_bits(x, y) for x, y in metrics)
            and float(mb.arrivals) == float(N)):
        raise AssertionError(f"{label}: the masked pipeline under the null "
                             f"schedule differs from the unfaulted round")
    print(f"  {label}: null schedule == unfaulted round, bitwise (params, "
          f"EF, loss, cosine, payload floats, update norm), arrivals "
          f"{float(mb.arrivals):g}")


def phase_faults(out_dir: str, state: FLState, batches, syn0):
    phase(f"faults: the trainer with {fault_flags()}")
    fstate, launched, wall = run_trainer(
        os.path.join(out_dir, "faults"), "threesfc", "float",
        rounds=FAULT_ROUNDS, extra=fault_flags())
    # every client trains and encodes, scheduled or not
    want = only(fused_cosine=FAULT_ROUNDS * N * (S + 1),
                ef_update=FAULT_ROUNDS * N)
    if launched != want:
        raise AssertionError(f"faulted 3SFC launches {launched}, expected "
                             f"{want}")
    knobs = {k: v for k, v in FAULT_KNOBS.items() if k != "fault_seed"}
    for r in range(FAULT_ROUNDS):
        sch = faults.fault_schedule(FAULT_KNOBS["fault_seed"], r, N, **knobs)
        print(f"  round {r}: {int(sch.participate.sum())} scheduled, "
              f"{int((sch.participate & ~sch.delivered).sum())} dropped, "
              f"{int(sch.arrives_late.sum())} late "
              f"(delays {sch.delay.tolist()})")
    print(f"  threesfc: {FAULT_ROUNDS} rounds in {wall:.2f} s, launches "
          f"{launched}, weight in flight "
          f"{float(faults.pending_mass(fstate.buf_w)):g}")
    _, launched, wall = run_trainer(
        os.path.join(out_dir, "faults_sign"), "signsgd", "codec",
        rounds=FAULT_ROUNDS, extra=fault_flags())
    want = only(fused_cosine=FAULT_ROUNDS * N, pack_signs=FAULT_ROUNDS * N,
                unpack_signs=FAULT_ROUNDS)
    if launched != want:
        raise AssertionError(f"faulted signsgd codec launches {launched}, "
                             f"expected {want}")
    print(f"  signsgd codec: {FAULT_ROUNDS} rounds in {wall:.2f} s, "
          f"launches {launched}")
    check_null_schedule("3SFC float", "threesfc", state, batches, syn0)
    check_null_schedule("3SFC fused", "threesfc", state, batches, syn0,
                        fused=True)
    check_null_schedule("signSGD codec", "signsgd", state, batches, None,
                        wire="codec")
    # an injected skip/drop/late round, on the card and on the CPU
    injected = mlp_round("threesfc", fstate.params, staleness_max=2,
                         fault_schedule_fn=injected_schedule)
    s_card, m_card = injected(fstate, batches, 0, syn0=syn0)
    s_cpu, m_cpu = injected(state_to_cpu(fstate), to_cpu(batches), 0,
                            syn0=SynData(*to_cpu(list(syn0))))
    assert_close("faulted round card vs CPU params", s_card.params,
                 s_cpu.params, PARAM_TOL)
    assert_close("faulted round card vs CPU EF", s_card.ef, s_cpu.ef, EF_TOL)
    assert_close("faulted round card vs CPU staleness buffer", s_card.buf,
                 s_cpu.buf, EF_TOL)
    row = lambda tree, i: flat.tree_map(lambda e: e[i], tree)
    if not tree_bits_equal(row(s_card.ef, 0), row(fstate.ef, 0)):
        raise AssertionError("the skipped client's EF row is not its input "
                             "row, bitwise")
    g, _ = local_train(make_mlp(MNIST_SPEC).loss, fstate.params,
                       row(batches, 1), 0.01)
    if not tree_bits_equal(row(s_card.ef, 1),
                           flat.tree_add(g, row(fstate.ef, 1))):
        raise AssertionError("the dropped client's EF row is not u = g + e "
                             "as the card computes it, bitwise")
    print(f"  injected schedule (0 skipped, 1 dropped, 2 and 3 late): "
          f"skipped EF row bitwise its input, dropped EF row bitwise u; "
          f"arrivals card {float(m_card.arrivals):.8g}, CPU "
          f"{float(m_cpu.arrivals):.8g}")
    return mlp_round("threesfc", fstate.params, **FAULT_KNOBS), fstate


# ---------------------------------------------------------------------------
# phase 15: the paper's four CNNs at their published widths
# ---------------------------------------------------------------------------


def cnn_round(name: str, dataset: str, clients: int, steps: int = S):
    """A 3SFC+EF float round of ``name`` at the trainer's K and B with
    ``steps`` encoder steps, for ``clients`` clients."""
    spec = DATASETS[dataset]
    model = make_paper_model(name, spec)
    comp = CompressorConfig(kind="threesfc", syn_steps=steps, syn_lr=0.1)
    strategy = make_strategy(comp, loss_fn=model.syn_loss,
                             syn_spec=vision_syn_spec(spec, comp),
                             local_lr=0.01)
    run = RunConfig(fl=FLConfig(num_clients=clients, local_steps=K,
                                local_lr=0.01, local_batch=B,
                                compressor=comp))
    return build_fl_round(model.loss, strategy, run), strategy


def cnn_inputs(dev, dataset: str, spec, clients: int):
    g = gen(dev, 47)
    shape = DATASETS[dataset].input_shape
    batches = {"x": torch.rand((clients, K, B, *shape), generator=g,
                               device=dev),
               "y": torch.randint(0, DATASETS[dataset].num_classes,
                                  (clients, K, B), generator=g, device=dev)}
    syns = [init_syn(g, spec) for _ in range(clients)]
    return batches, SynData(*[torch.stack(ts) for ts in zip(*syns)])


def rel_gap(a, b) -> float:
    """‖a − b‖ / ‖a‖ over whole trees, on the host."""
    return float(flat.tree_norm(flat.tree_sub(a, b))) / float(
        flat.tree_norm(a))


def cudnn_conv2d(p, x, stride: int = 1, padding: str = "SAME"):
    """``layers.conv2d`` through ``F.conv2d`` (cuDNN on the card): only to
    set cuDNN's precision beside the port's."""
    w = p["w"]
    xc = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        (ht, hb), (wl, wr) = (
            layers.same_padding(x.shape[1], w.shape[0], stride),
            layers.same_padding(x.shape[2], w.shape[1], stride))
        xc = torch.nn.functional.pad(xc, (wl, wr, ht, hb))
    y = torch.nn.functional.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1) + p["b"]


def conv_precision(dev) -> None:
    """Each CNN at its published width, on the card against the CPU in
    f64: the loss gradient on a batch of B images, through the port's
    convolutions and through cuDNN's (``cudnn_conv2d``, TF32 off), and the
    3SFC encoder's gradient to D_syn (the double backward: ∇ of ⟨∇_w F(D_syn,
    w), t⟩) through the port's. Each is the worst leaf's largest error over
    its largest element; the port's must be at f32's level (CNN_GRAD_TOL),
    cuDNN's is reported."""
    bad = {}
    for name, dataset, _ in CNN_CELLS:
        spec = DATASETS[dataset]
        model = make_paper_model(name, spec)
        g = gen(torch.device("cpu"), 0)
        params = model.init(g)
        x = torch.rand((B, *spec.input_shape), generator=g)
        y = torch.randint(0, spec.num_classes, (B,), generator=g)
        comp = CompressorConfig(kind="threesfc", syn_batch=1)
        syn = init_syn(g, vision_syn_spec(spec, comp))
        target = flat.tree_map(
            lambda p: 0.01 * torch.randn(p.shape, generator=g), params)

        def grads(device, dtype):
            w = flat.tree_map(lambda p: p.to(device=device, dtype=dtype)
                              .requires_grad_(True), params)
            loss = model.loss(w, {"x": x.to(device=device, dtype=dtype),
                                  "y": y.to(device)})
            gl = torch.autograd.grad(loss, flat.tree_leaves(w))
            sv = SynData(*[t.to(device=device, dtype=dtype)
                           .requires_grad_(True) for t in syn])
            gw = torch.autograd.grad(model.syn_loss(w, sv),
                                     flat.tree_leaves(w), create_graph=True)
            dot = sum((a * b.to(device=device, dtype=dtype)).sum()
                      for a, b in zip(gw, flat.tree_leaves(target)))
            return gl, torch.autograd.grad(dot, [sv.x, sv.y])

        def worst(got, want):
            return max(float((a.double().cpu() - b).abs().max()
                             / b.abs().max()) for a, b in zip(got, want))

        want = grads(torch.device("cpu"), torch.float64)
        port = grads(dev, torch.float32)
        port_conv, layers.conv2d = layers.conv2d, cudnn_conv2d
        try:
            cudnn, _ = grads(dev, torch.float32)
        finally:
            layers.conv2d = port_conv
        errs = (worst(port[0], want[0]), worst(port[1], want[1]),
                worst(cudnn, want[0]))
        print(f"  {name}: against the CPU's f64, worst leaf's max error over "
              f"its max: loss gradient at B={B} {errs[0]:.2e} (cuDNN's "
              f"{errs[2]:.2e}), gradient to D_syn {errs[1]:.2e}")
        if max(errs[:2]) > CNN_GRAD_TOL:
            bad[name] = errs[:2]
    if bad:
        raise AssertionError(f"CNN gradients off f32's level: {bad}")


def phase_cnns(out_dir: str, dev) -> dict:
    phase(f"the paper's CNNs at their published widths: "
          f"repro_torch.launch.train.main, {CNN_ROUNDS} rounds of 3SFC+EF")
    conv_precision(dev)
    rounds = {}
    for name, dataset, count in CNN_CELLS:
        st, launched, wall = run_trainer(
            os.path.join(out_dir, name), "threesfc", "float",
            rounds=CNN_ROUNDS, model=name, dataset=dataset)
        d, leaves = flat.tree_size(st.params), len(flat.tree_leaves(st.params))
        if d != count:
            raise AssertionError(f"{name}: {d} parameters, expected {count}")
        want = only(fused_cosine=CNN_ROUNDS * N * (S + 1),
                    ef_update=CNN_ROUNDS * N)
        if launched != want:
            raise AssertionError(f"{name} launches {launched}, expected "
                                 f"{want}")
        print(f"  {name} on {dataset}: d={d} in {leaves} leaves (one leaf "
              f"table), {CNN_ROUNDS} rounds in {wall:.2f} s, launches "
              f"{launched}")
        # one round on the card and on the CPU, from the trained params
        # and the first CNN_CPU_N clients' residuals
        s0 = FLState(st.params, flat.tree_map(lambda e: e[:CNN_CPU_N], st.ef),
                     st.round)
        gaps = {}
        for steps in (CNN_CHECK_S, S):
            fl_round, strategy = cnn_round(name, dataset, CNN_CPU_N, steps)
            batches, syn0 = cnn_inputs(dev, dataset, strategy.syn_spec,
                                       CNN_CPU_N)
            s_card, m_card = fl_round(s0, batches, 0, syn0=syn0)
            s_cpu, _ = fl_round(state_to_cpu(s0), to_cpu(batches), 0,
                                syn0=SynData(*to_cpu(list(syn0))))
            if not (math.isfinite(float(m_card.loss))
                    and bool(torch.isfinite(m_card.cosine).all())):
                raise AssertionError(f"{name}: non-finite round metrics")
            # the same round on the card from params moved by a few ulps
            g = gen(dev, 53)
            nudged = FLState(flat.tree_map(lambda p: p * (1 + CNN_NUDGE * (
                torch.rand(p.shape, generator=g, device=dev) - 0.5)),
                s0.params), s0.ef, s0.round)
            s_nudge, _ = fl_round(nudged, batches, 0, syn0=syn0)
            # relative L2 gaps to the card's round: the update w − w' and
            # the EF, the CPU's then the nudged card's
            update = to_cpu(flat.tree_sub(s0.params, s_card.params))
            ef_card = to_cpu(s_card.ef)
            gaps[steps] = [rel_gap(update, other) for other in (
                flat.tree_sub(to_cpu(s0.params), s_cpu.params),
                to_cpu(flat.tree_sub(nudged.params, s_nudge.params)))] + [
                rel_gap(ef_card, s_cpu.ef), rel_gap(ef_card, to_cpu(
                    s_nudge.ef))]
        print(f"  {name}: relative gaps to the card's round, update (CPU; "
              f"card from params x (1 + {CNN_NUDGE:g}·U(-1/2, 1/2))) and EF "
              f"(the same): " + "; ".join(
                  f"S={k}: {a:.2e}, {b:.2e}; EF {c:.2e}, {d:.2e}"
                  for k, (a, b, c, d) in gaps.items()))
        cpu_u, nudge_u, cpu_e, nudge_e = gaps[CNN_CHECK_S]
        bounds = [max(ROUND_FLOOR, ROUND_FACTOR * b)
                  for b in (nudge_u, nudge_e)]
        if cpu_u > bounds[0] or cpu_e > bounds[1]:
            raise AssertionError(
                f"{name}: card vs CPU round at S={CNN_CHECK_S} off by "
                f"{cpu_u:.2e} (update), {cpu_e:.2e} (EF), over "
                f"{bounds[0]:.2e}, {bounds[1]:.2e}")
        rounds[name] = (st, dataset)
    return rounds


# ---------------------------------------------------------------------------
# phase 16: mamba2-370m under federated training at full width
# ---------------------------------------------------------------------------


def lm_args(clients: int, batch: int, *flags: str):
    """The trainer's flags for a mamba2-370m run of ``clients`` clients of
    ``batch`` sequences, K = 1, local lr LM_LR, then ``flags``."""
    return train.parse_args([
        "--arch", "mamba2-370m", "--clients", str(clients), "--local-steps",
        "1", "--batch", str(batch), "--lr", str(LM_LR), *flags])


def lm_batches(dev, cfg, clients: int, batch: int, seq: int, seed: int):
    """One round's (N, 1, B, S) token batch from a planted-bigram set."""
    data = make_token_dataset(gen(torch.device("cpu"), seed),
                              clients * batch, seq, cfg.vocab_size)
    return token_batcher(data, clients, 1, batch, device=dev)(seed, 0)


def lm_tree(g: torch.Generator, cfg, scale: float) -> dict:
    """N(0, scale²) leaves in the shapes of ``cfg``'s LM params."""
    params = LM(cfg).init(g)
    return flat.tree_map(lambda p: scale * torch.randn(
        p.shape, generator=g, device=p.device), params)


def check_b1_f64(label: str, a: dict, b: dict) -> float:
    """B1's f32 triple on a tree against the triple summed in f64: within
    B1_RTOL of (‖a‖‖b‖, ‖a‖², ‖b‖²), as against the plain version; the
    plain version's own gap to f64 printed beside."""
    la = [t.reshape(-1) for t in flat.tree_leaves(a)]
    lb = [t.reshape(-1) for t in flat.tree_leaves(b)]
    got = fc_mod.fused_cosine_leaves(la, lb).double()
    plain = fc_mod.fused_cosine_leaves_plain(la, lb).double()
    x64, y64 = torch.cat(la).double(), torch.cat(lb).double()
    want = torch.stack([torch.dot(x64, y64), torch.dot(x64, x64),
                        torch.dot(y64, y64)])
    del x64, y64
    scale = torch.stack([torch.sqrt(want[1] * want[2]), want[1], want[2]])
    rel = ((got - want).abs() / scale).max()
    rel_plain = ((plain - want).abs() / scale).max()
    if not float(rel) <= B1_RTOL:
        raise AssertionError(f"{label}: B1 is {float(rel):.3e} of its scale "
                             f"from the f64 sums, over {B1_RTOL}")
    print(f"  {label}: B1 against the f64 sums {float(rel):.3e} of "
          f"(|a||b|, |a|², |b|²) (bound {B1_RTOL}); the plain version "
          f"(torch.dot in f32) {float(rel_plain):.3e}")
    return float(rel)


def phase_lm_train(out_dir: str, dev):
    phase(f"mamba2-370m federated training at full width: "
          f"repro_torch.launch.train.train_lm, 3SFC+EF, N={LM_N}, K=1, "
          f"B={LM_BATCH}, S={LM_SEQ}, {LM_ROUNDS} rounds")
    cfg = get_config("mamba2-370m")
    args = lm_args(LM_N, LM_BATCH, "--rounds", str(LM_ROUNDS),
                   "--eval-every", "1", "--out", out_dir)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reset_counts()
    state, hist = train.train_lm(args, cfg, LM_COMP, LM_SEQ, LM_NUM_SEQS)
    torch.cuda.synchronize()
    launched, wall = counts(), time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    want = only(fused_cosine=LM_ROUNDS * LM_N * (LM_COMP.syn_steps + 1),
                ef_update=LM_ROUNDS * LM_N)
    if launched != want:
        raise AssertionError(f"mamba2 3SFC rounds: launches {launched}, "
                             f"expected {want}")
    d = flat.tree_size(state.params)
    spec = syn_spec_for(cfg, LM_COMP)
    payload = spec.floats + 1
    m = hist.metrics
    if d != LM_D or any(float(p) != payload for p in m.payload_floats):
        raise AssertionError(f"d={d} (expected {LM_D}), payload "
                             f"{m.payload_floats} (expected {payload})")
    if not (np.isfinite(m.loss).all() and np.isfinite(m.cosine).all()):
        raise AssertionError(f"non-finite round metrics: {m}")
    print(f"  d={d}, payload {payload:.0f} floats ({spec.x_shape} inputs, "
          f"rank-{LM_COMP.soft_label_rank} labels, s): {d / payload:.1f}x; "
          f"num_micro {train.num_micro_for(LM_BATCH, LM_SEQ)}; losses "
          f"{m.loss.tolist()}, mean cosines "
          f"{m.cosine.mean(axis=1).tolist()}; {wall:.2f} s for "
          f"{LM_ROUNDS} rounds; launches {launched}; peak device memory "
          f"{peak / 2**30:.2f} GiB")
    # B1 and B2 on the whole tree: against the plain version on the
    # concatenation (B2 bitwise its flat form), and B1 against f64 sums, on
    # random leaves and on the round's own numbers (client 0's residual and
    # the params)
    g = gen(dev, 59)
    s = torch.tensor([-0.37], device=dev)
    check_tree("mamba2's tree", lm_tree(g, cfg, 1e-3), lm_tree(g, cfg, 1e-3),
               s)
    ef0 = flat.tree_map(lambda e: e[0], state.ef)
    check_b1_f64("mamba2's tree, client 0's residual and the params", ef0,
                 state.params)
    return state


def phase_lm_sign(state: FLState, dev) -> None:
    phase(f"mamba2-370m signSGD codec round at full width: N={LM_N}, EF on")
    cfg = get_config("mamba2-370m")
    comp = CompressorConfig(kind="signsgd")
    model, strategy, run = train.lm_setup(
        lm_args(LM_N, LM_BATCH, "--wire", "codec"), cfg, comp, LM_SEQ)
    codec = strategy.wire_codec(state.params)
    wires, frames = [], []
    encode = codec.encode

    def keep(wire, **kw):
        wires.append(wire)
        frames.append(encode(wire, **kw))
        return frames[-1]

    codec.encode = keep
    one_round = build_fl_round(model.loss, strategy, run, codec=codec)
    batches = lm_batches(dev, cfg, LM_N, LM_BATCH, LM_SEQ, 61)
    s0 = fl_init(state.params, LM_N, strategy)
    reset_counts()
    _, m = one_round(s0, batches, 0)
    torch.cuda.synchronize()
    launched = counts()
    del s0
    want = only(fused_cosine=LM_N, pack_signs=LM_N, unpack_signs=1)
    if launched != want:
        raise AssertionError(f"mamba2 signSGD codec round: launches "
                             f"{launched}, expected {want}")
    if not (math.isfinite(float(m.loss))
            and bool(torch.isfinite(m.cosine).all())):
        raise AssertionError("mamba2 signSGD codec round: non-finite metrics")
    print(f"  {LM_N} frames of {codec.nbytes} B (d={codec.d}); launches "
          f"{launched}; loss {float(m.loss):.4f}, cosines "
          f"{m.cosine.tolist()}")
    # B3a at d: client 0's update into a section, bitwise the plain pack
    check_tree_pack("mamba2's tree, client 0's update",
                    [l.reshape(-1).float() for l in flat.tree_leaves(wires[0][0])],
                    5)
    # B3b at d: the round's frames in one launch, each row bitwise the
    # plain unpack of its frame alone
    signs_at = codec.spec.section_offsets[0]
    reset_counts()
    pm1 = bp_mod.unpack_signs_frames(frames, signs_at, codec.d)
    launched = counts()
    torch.cuda.synchronize()
    if launched != only(unpack_signs=1):
        raise AssertionError(f"B3b on mamba2's {LM_N} frames: launches "
                             f"{launched}, expected 1")
    for i, f in enumerate(frames):
        plain = bp_mod.unpack_signs_frames_plain([f], signs_at, codec.d)[0]
        if not same_bits(pm1[i], plain):
            raise AssertionError(f"B3b on mamba2's frame {i} disagrees with "
                                 f"its plain version")
        del plain
    del pm1
    # the batch decode (what the round ran), row by row bitwise the
    # frame-by-frame decode and the canonical payload, which is computed
    # from the wire without the bytes
    batch = flat.tree_leaves(codec.recon_batch(frames, state.params))
    for i, (f, wire) in enumerate(zip(frames, wires)):
        rows = [t[i] for t in batch]
        for other, what in ((codec.decode(f), "decoded frame by frame"),
                            (codec.canonical(wire), "the canonical payload")):
            if not all(same_bits(a, b) for a, b in zip(
                    rows, flat.tree_leaves(other))):
                raise AssertionError(f"mamba2 signSGD: client {i}'s frame "
                                     f"decoded in the batch differs from "
                                     f"{what}")
    print(f"  B3b on the {LM_N} frames (one launch): each row bitwise the "
          f"plain unpack of its frame; the batch decode bitwise the "
          f"frame-by-frame decode and the canonical payload of each wire")


def phase_lm_routes(dev) -> float:
    phase(f"mamba2-370m LM.loss at full width, float32, batch "
          f"{LM_ROUTE_BATCH} x {LM_ROUTE_SEQ}: B4 route vs ssd_scan route; "
          f"C3")
    cfg = get_config("mamba2-370m").replace(dtype="float32")
    kernel_model = build_model(cfg.replace(use_pallas_ssd=True))
    scan_model = build_model(cfg)
    g = gen(dev, 67)
    params = scan_model.init(g)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (
        LM_ROUTE_BATCH, LM_ROUTE_SEQ), generator=g, device=dev)}
    leaves, treedef = tree_flatten(params)

    def value_and_grad(model):
        w = [p.detach().requires_grad_(True) for p in leaves]
        v = model.loss(tree_unflatten(treedef, w), batch)
        return v.detach(), torch.autograd.grad(v, w)

    reset_counts()
    with torch.no_grad():
        loss_fwd = kernel_model.loss(params, batch)
    torch.cuda.synchronize()
    fwd_launches = counts()
    reset_counts()
    loss_k, grads_k = value_and_grad(kernel_model)
    torch.cuda.synchronize()
    vg_launches = counts()
    loss_s, grads_s = value_and_grad(scan_model)
    want_fwd = only(ssd_chunk=cfg.num_layers)
    # cfg.remat: the backward runs each period's forward again
    want_vg = only(ssd_chunk=2 * cfg.num_layers)
    if fwd_launches != want_fwd or vg_launches != want_vg:
        raise AssertionError(f"B4 launches {fwd_launches} per loss, "
                             f"{vg_launches} per value and grad; expected "
                             f"{want_fwd}, {want_vg}")
    rel_loss = abs(float(loss_k) - float(loss_s)) / abs(float(loss_s))
    gaps = [float(torch.linalg.vector_norm(a - b)
                  / torch.linalg.vector_norm(b))
            for a, b in zip(grads_k, grads_s)]
    bad = not (math.isfinite(float(loss_k)) and rel_loss <= LM_ROUTE_LOSS_RTOL
               and float(loss_fwd) == float(loss_k)
               and max(gaps) <= LM_ROUTE_GRAD_RTOL
               and all(bool(torch.isfinite(t).all()) for t in grads_k))
    print(f"  loss {float(loss_k):.6f} (B4) vs {float(loss_s):.6f} "
          f"(ssd_scan): {rel_loss:.3e} (bound {LM_ROUTE_LOSS_RTOL}); "
          f"gradients' relative L2 gap per leaf, worst {max(gaps):.3e} "
          f"(bound {LM_ROUTE_GRAD_RTOL}); B4 launches {fwd_launches} per "
          f"loss evaluation, {vg_launches} per value and grad")
    if bad:
        raise AssertionError("B4 route vs ssd_scan route at full width out "
                             "of bounds")
    del grads_k, grads_s
    # C3: the 3SFC encoder's grad-of-grad through B4's route raises
    spec = syn_spec_for(cfg, LM_COMP)
    syn0 = init_syn(g, spec)
    target = flat.tree_map(torch.ones_like, params)
    try:
        threesfc.encode(syn_loss_fn(kernel_model), params, target, syn0,
                        steps=1)
    except RuntimeError as e:
        if "differentiable once" not in str(e):
            raise
        print(f"  C3: 3SFC encoding through the B4 route raises: {e}")
    else:
        raise AssertionError("C3: 3SFC encoding through the B4 route "
                             "returned instead of raising")
    return rel_loss


def phase_lm_cpu(dev) -> None:
    phase(f"mamba2 round at full width cut to {LM_CPU_LAYERS} layers, "
          f"float32, N={LM_CPU_N}, K=1, S={LM_CPU_SEQ}: card vs CPU")
    cfg = get_config("mamba2-370m").replace(num_layers=LM_CPU_LAYERS,
                                            dtype="float32")
    cpu = torch.device("cpu")
    model, strategy, run = train.lm_setup(lm_args(LM_CPU_N, LM_CPU_BATCH),
                                          cfg, LM_COMP, LM_CPU_SEQ)
    one_round = build_fl_round(model.loss, strategy, run)
    params = model.init(gen(cpu, 71))
    batches = lm_batches(cpu, cfg, LM_CPU_N, LM_CPU_BATCH, LM_CPU_SEQ, 72)
    syns = [init_syn(gen(cpu, 73 + i), strategy.syn_spec)
            for i in range(LM_CPU_N)]
    syn0 = SynData(*[torch.stack(ts) for ts in zip(*syns)])
    to_dev = lambda t: flat.tree_map(lambda x: x.to(dev), t)
    s0 = fl_init(to_dev(params), LM_CPU_N, strategy)
    t0 = time.perf_counter()
    s_card, m_card = one_round(s0, to_dev(batches), 0,
                               syn0=SynData(*to_dev(list(syn0))))
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    s_cpu, m_cpu = one_round(fl_init(params, LM_CPU_N, strategy), batches,
                             0, syn0=syn0)
    t_cpu = time.perf_counter() - t0
    # the same round on the card from params moved by a few ulps
    g = gen(dev, 74)
    nudged = FLState(flat.tree_map(lambda p: p * (1 + LM_NUDGE * (
        torch.rand(p.shape, generator=g, device=dev) - 0.5)), s0.params),
        s0.ef, s0.round)
    s_nudge, _ = one_round(nudged, to_dev(batches), 0,
                           syn0=SynData(*to_dev(list(syn0))))
    update = to_cpu(flat.tree_sub(s0.params, s_card.params))
    gap_cpu = rel_gap(update, flat.tree_sub(params, s_cpu.params))
    gap_nudge = rel_gap(update, to_cpu(flat.tree_sub(nudged.params,
                                                     s_nudge.params)))
    print(f"  card {t_card:.2f} s, CPU {t_cpu:.2f} s; loss "
          f"{float(m_card.loss):.6f} vs {float(m_cpu.loss):.6f}, cosines "
          f"{m_card.cosine.tolist()} vs {m_cpu.cosine.tolist()}; the "
          f"update's relative L2 gap to the card's: CPU {gap_cpu:.3e}, card "
          f"from params x (1 + {LM_NUDGE:g}·U(-1/2, 1/2)) {gap_nudge:.3e} "
          f"(bound on the CPU's: max({ROUND_FLOOR:g}, {ROUND_FACTOR:g} x "
          f"the nudge's))")
    bound = max(ROUND_FLOOR, ROUND_FACTOR * gap_nudge)
    if not gap_cpu <= bound:
        raise AssertionError(f"mamba2 round: the CPU's update is {gap_cpu:.3e} "
                             f"from the card's, over {bound:.3e}")
    assert_close("mamba2 round, card vs CPU params", s_card.params,
                 s_cpu.params, PARAM_TOL)
    assert_close("mamba2 round, card vs CPU EF", s_card.ef, s_cpu.ef, EF_TOL)


# ---------------------------------------------------------------------------
# phase 17: the client fan-out (client_parallel='shard_map') on the card
# ---------------------------------------------------------------------------


def fanout_cases(state: FLState, fault_state: FLState):
    """(label, trainer method, round knobs, start state) of phase 17: the
    main path's 3SFC+EF float round (B1, B2), fused 3SFC, the signSGD codec
    round (B3a, B3b, B1) and phase 14's faulted 3SFC round."""
    return (("3SFC+EF float", "threesfc", {}, state),
            ("fused 3SFC", "threesfc", {"fused": True}, state),
            ("signSGD codec", "signsgd", {"wire": "codec"}, state),
            ("faulted 3SFC", "threesfc", dict(FAULT_KNOBS), fault_state))


def fanout_rounds(method, knobs, state, batches, mesh=None):
    """FANOUT_ROUNDS rounds of one phase-17 case, single-process or sharded
    over ``mesh``; returns (state, metrics, launches, collectives, bytes
    gathered per local client per round). Every counter is set to 0 just
    before the rounds and read just after."""
    kw = dict(knobs)
    if mesh is not None:
        kw.update(client_parallel="shard_map", mesh=mesh)
        sh = make_fl_shardings(mesh)
        state, batches = sh.place_state(state), sh.place_client_tree(batches)
        local = len(sh.local_clients(N))
    one_round = mlp_round(method, state.params, **kw)
    reset_counts()
    c0, b0 = sharding_mod.COLLECTIVES, sharding_mod.GATHERED_BYTES
    ms = []
    for r in range(FANOUT_ROUNDS):
        state, m = one_round(state, batches, r)
        ms.append(m)
    if batches["x"].is_cuda:
        torch.cuda.synchronize()
    launched = counts()
    coll = sharding_mod.COLLECTIVES - c0
    per_client = ((sharding_mod.GATHERED_BYTES - b0)
                  / (FANOUT_ROUNDS * local) if mesh is not None else 0.0)
    return state, ms, launched, coll, per_client


def fanout_record(state: FLState, ms) -> dict:
    """What phase 17 compares, on the host: params, the whole EF, the
    staleness buffer and every RoundMetrics field of every round."""
    return {"state": to_cpu((state.params, state.ef, state.buf,
                             state.buf_w)),
            "metrics": [to_cpu([torch.as_tensor(getattr(m, f))
                                for f in m._fields]) for m in ms]}


def same_record(a: dict, b: dict) -> bool:
    return ranks_mod.tree_bits_diff((a["state"], a["metrics"]),
                                    (b["state"], b["metrics"])) is None


def want_launches(label: str, clients: int) -> dict:
    """A rank's launches over FANOUT_ROUNDS rounds with ``clients`` local
    clients: the encoder's per client, B3b once per round for all N
    frames."""
    r = FANOUT_ROUNDS
    if label == "signSGD codec":
        return only(fused_cosine=r * clients, pack_signs=r * clients,
                    unpack_signs=r)
    return only(fused_cosine=r * clients * (S + 1), ef_update=r * clients)


@contextlib.contextmanager
def nccl_one_rank(dev):
    """A one-rank NCCL process group (a FileStore, no port) and its (1, 1)
    host mesh; the group is destroyed on exit."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pg_") as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(
            os.path.join(tmp, "store"), 1), rank=0, world_size=1,
            device_id=dev)
        try:
            yield make_host_mesh(device=dev)
        finally:
            dist.destroy_process_group()


def fanout_in_process(cases, batches, dev):
    """Phase 17's single-process rounds, then (a): one rank on NCCL in
    this process, the 1-shard mesh. Returns (the single-process records,
    the bytes (a) gathered per client per round)."""
    single, out = {}, {}
    for label, method, knobs, st in cases:
        s1, m1, l1, c1, _ = fanout_rounds(method, knobs, st, batches)
        if l1 != want_launches(label, N) or c1 != 0:
            raise AssertionError(f"{label} single-process launches {l1}, "
                                 f"collectives {c1}")
        single[label] = fanout_record(s1, m1)
    with nccl_one_rank(dev) as mesh:
        sh = make_fl_shardings(mesh)
        for label, method, knobs, st in cases:
            s2, m2, l2, c2, per = fanout_rounds(method, knobs, st, batches,
                                                mesh)
            got = fanout_record(sh.gather_state(s2), m2)
            if not same_record(single[label], got):
                raise AssertionError(f"(a) {label}: the 1-rank sharded round "
                                     f"is not bitwise the single-process one")
            if l2 != want_launches(label, N) or c2 != FANOUT_ROUNDS:
                raise AssertionError(f"(a) {label}: launches {l2}, "
                                     f"collectives {c2}")
            out[label] = per
            print(f"  (a) 1 rank, NCCL: {label}: bitwise the single-process "
                  f"round (params, EF, buffer, {len(m2[0]._fields)} metrics "
                  f"x {FANOUT_ROUNDS} rounds); {c2} collectives, launches "
                  f"{l2}; {per:.0f} B gathered per client per round")
    return single, out


def phase_fanout(state: FLState, fault_state: FLState, batches, dev) -> dict:
    phase(f"client fan-out: client_parallel='shard_map' on the card, "
          f"{FANOUT_ROUNDS} rounds of each case (N={N}, K={K}, B={B}, "
          f"S={S})")
    cases = fanout_cases(state, fault_state)
    # (b)'s ranks start first and run beside this process's rounds
    with fanout_ranks(cases, batches, dev) as collect_b:
        single, out = fanout_in_process(cases, batches, dev)
        out_b = collect_b(single)
    for label in out:
        print(f"  gathered bytes per client per round, {label}: (a) "
              f"{out[label]:.0f}, (b) {out_b[label]:.0f}")
    ratio = out["3SFC+EF float"] / out["fused 3SFC"]
    print(f"  float / fused 3SFC bytes per client: {ratio:.4f} (the "
          f"reference's per-device all-gather bytes 796,852 / 3,188 = "
          f"{796_852 / 3_188:.4f})")
    if (out["3SFC+EF float"], out["fused 3SFC"]) != (4 * MLP_D + 12,
                                                     4 * 795 + 8):
        raise AssertionError(f"gathered bytes per client {out}")
    if out_b != out:
        raise AssertionError(f"(b) gathered {out_b} bytes per client, (a) "
                             f"{out}")
    return out


@contextlib.contextmanager
def fanout_ranks(cases, batches, dev):
    """Phase 17 (b): FANOUT_WORLD ranks spawned on ``dev`` over gloo, each
    running its N / FANOUT_WORLD clients of every case while this process
    runs the single-process rounds and (a). Yields ``collect(single)``,
    which waits for the ranks and holds each rank's params, gathered EF
    and metrics bitwise to the single-process rounds; returns the bytes
    gathered per client per round."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fanout_") as tmp:
        torch.save({"batches": to_cpu(batches),
                    "states": [(to_cpu((st.params, st.ef, st.buf, st.buf_w)),
                                st.round) for _, _, _, st in cases]},
                   os.path.join(tmp, "inputs.pt"))
        store = os.path.join(tmp, "store")
        argvs = [[sys.executable, os.path.abspath(__file__), "--fanout-rank",
                  str(r), str(FANOUT_WORLD), store, tmp, str(dev)]
                 for r in range(FANOUT_WORLD)]
        logs = [os.path.join(tmp, f"rank{r}.log") for r in range(FANOUT_WORLD)]
        ranks = ranks_mod.Ranks(argvs, logs)

        def collect(single) -> dict:
            rcs = ranks.join(FANOUT_TIMEOUT_S)
            for r, rc in enumerate(rcs):
                lines = ranks.log(r).strip().splitlines()
                print("\n".join(f"  (b) rank {r}: {line}" for line in
                                lines[-(30 if rc else 6):]))
                if rc != 0:
                    raise AssertionError(f"(b) rank {r} exited {rc}")
            per = {}
            local = N // FANOUT_WORLD
            for r in range(FANOUT_WORLD):
                res = torch.load(os.path.join(tmp, f"rank{r}.pt"))
                for label, _, _, _ in cases:
                    got = res[label]
                    if not same_record(single[label], got["record"]):
                        raise AssertionError(f"(b) rank {r} {label}: not "
                                             f"bitwise the single-process "
                                             f"round")
                    if (got["launches"] != want_launches(label, local)
                            or got["collectives"] != FANOUT_ROUNDS):
                        raise AssertionError(
                            f"(b) rank {r} {label}: launches "
                            f"{got['launches']}, collectives "
                            f"{got['collectives']}")
                    per[label] = got["per_client"]
            for label, _, _, _ in cases:
                print(f"  (b) {FANOUT_WORLD} ranks on one card, gloo: "
                      f"{label}: every rank bitwise the single-process "
                      f"round, {FANOUT_ROUNDS} collectives, launches per "
                      f"rank {want_launches(label, local)}")
            return per

        with ranks:
            yield collect


def fanout_walls(state: FLState, batches, dev) -> dict:
    """Phase 7: the wall time (host clock around ``torch.cuda.synchronize``)
    of one main-path 3SFC round under phase 17 (a), the 1-rank sharded
    round, beside the single-process round, FANOUT_WALLS each in turns
    after one warm-up each. The gap is the gather path's cost on one
    card."""
    def wall(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    with nccl_one_rank(dev) as mesh:
        sh = make_fl_shardings(mesh)
        single = mlp_round("threesfc", state.params)
        sharded = mlp_round("threesfc", state.params,
                            client_parallel="shard_map", mesh=mesh)
        placed, local = sh.place_state(state), sh.place_client_tree(batches)
        runs = {"single": lambda: single(state, batches, 0),
                "sharded": lambda: sharded(placed, local, 0)}
        walls = {k: [] for k in runs}
        for k, fn in runs.items():
            wall(fn)
        for _ in range(FANOUT_WALLS):
            for k, fn in runs.items():
                walls[k].append(wall(fn))
    med = {k: float(np.median(v)) for k, v in walls.items()}
    print(f"  main-path round wall ms, in turns: single-process "
          f"{[round(w, 3) for w in walls['single']]} (median "
          f"{med['single']:.3f}), 1-rank shard_map on NCCL "
          f"{[round(w, 3) for w in walls['sharded']]} (median "
          f"{med['sharded']:.3f}); gap {med['sharded'] - med['single']:+.3f}")
    return {"walls_ms": walls, "median_ms": med}


def fanout_child(argv) -> int:
    """One rank of phase 17 (b): ``chip_smoke.py --fanout-rank RANK WORLD
    STORE DIR DEVICE``."""
    rank, world, store, tmp = int(argv[0]), int(argv[1]), argv[2], argv[3]
    dev = torch.device(argv[4])
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        inputs = torch.load(os.path.join(tmp, "inputs.pt"))
        to_dev = lambda tree: flat.tree_map(lambda x: x.to(dev), tree)
        batches = to_dev(inputs["batches"])
        mesh = make_host_mesh(device=dev)
        sh = make_fl_shardings(mesh)
        res = {}
        states = []
        for (params, ef, buf, buf_w), rnd in inputs["states"]:
            params, ef, buf, buf_w = to_dev((params, ef, buf, buf_w))
            states.append(FLState(params, ef, rnd, buf, buf_w))
        for (label, method, knobs, _), st in zip(
                fanout_cases(None, None), states):
            s2, m2, launched, coll, per = fanout_rounds(method, knobs, st,
                                                        batches, mesh)
            res[label] = {"record": fanout_record(sh.gather_state(s2), m2),
                          "launches": launched, "collectives": coll,
                          "per_client": per}
            print(f"{label}: clients {list(sh.local_clients(N))}, launches "
                  f"{launched}, collectives {coll}", flush=True)
        torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# phase 7: times
# ---------------------------------------------------------------------------


def bound_ms(nbytes: int, flops: int) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


KERNEL_NAMES = ("fused_cosine_table", "ef_update_table",
                "pack_signs_table", "unpack_signs_frames",
                "ssd_chunk_kernel", "sign_quant_kernel", "topk_mask_kernel")


def in_turns(new, old) -> tuple:
    """([new, new], [old, old]) device times per call in CUDA graphs,
    taken in turns: old, new, new, old."""
    old_ms = [graph_ms(old)]
    new_ms = [graph_ms(new), graph_ms(new)]
    old_ms.append(graph_ms(old))
    return new_ms, old_ms


def b3_time_extras(dev) -> dict:
    """B3a's tree entry on the MLP's 6 leaves into a frame's sign section,
    beside the old route (cat of the leaves, the flat B3a, the frame's
    cat), with ``SignCodec.encode`` beside; B3b's frames entry on the
    largest of B3_FRAMES frames beside that many flat calls, with
    ``decode_batch`` and the frame-by-frame decode beside; each pair in
    turns in CUDA graphs. Then both flat at 4 Mi + 5, the calls rotating
    over L2_ROTATE vectors (so each reads device memory), with their plain
    versions. Bounds: bytes, each input read once, each output written
    once (no single PyTorch call packs signs: no library time)."""
    g = gen(dev, 43)
    codec, wire = codec_payload("signsgd", dev, g)
    leaves = [t.reshape(-1) for t in flat.tree_leaves(wire[0])]
    d, nb = codec.d, codec.spec.section_bytes[0]
    signs_at, scales_at = codec.spec.section_offsets
    section = torch.empty(codec.nbytes, dtype=torch.uint8,
                          device=dev)[signs_at:scales_at]
    header = frame.encode_header(codec.spec, 0, 0, dev)
    scale_bytes = wire[1].contiguous().view(torch.uint8)
    reset_counts()
    bp_mod.pack_signs_tree(leaves, section)
    per_call = counts()["pack_signs"]
    new_ms, old_ms = in_turns(
        lambda: bp_mod.pack_signs_tree(leaves, section),
        lambda: torch.cat([header, bp_mod.pack_signs(torch.cat(
            leaves)).view(torch.uint8)[:nb], scale_bytes]))
    b_ms, b_by = bound_ms(4 * d + nb, d)
    tree = {"leaves": len(leaves), "d": d, "ms": new_ms[0],
            "ms_again": new_ms[1], "bound_ms": b_ms, "bound_by": b_by,
            "old_route_ms": old_ms, "encode_ms": graph_ms(
                lambda: codec.encode(wire)), "launches_per_call": per_call}
    print(f"  pack_signs tree ({len(leaves)} leaves, d={d}) into a frame: "
          f"kernel_ms={new_ms[0]:.6f}, {new_ms[1]:.6f} bound_ms={b_ms:.6f} "
          f"({b_by}) library_ms=none; old route (cat of the leaves, flat "
          f"B3a, the frame's cat) {old_ms[0]:.6f}, {old_ms[1]:.6f}; "
          f"SignCodec.encode {tree['encode_ms']:.6f}; "
          f"launches_per_call={per_call}")
    F = max(B3_FRAMES)
    frames = sign_frames(codec, make_mlp(MNIST_SPEC).init(g), g, F)
    pad = torch.zeros(4 * bp_mod.num_words(d) - nb, dtype=torch.uint8,
                      device=dev)
    words = [torch.cat([f[signs_at:scales_at], pad]).view(torch.int32)
             for f in frames]
    reset_counts()
    bp_mod.unpack_signs_frames(frames, signs_at, d)
    per_call = counts()["unpack_signs"]
    new_ms, old_ms = in_turns(
        lambda: bp_mod.unpack_signs_frames(frames, signs_at, d),
        lambda: [bp_mod.unpack_signs(w, d) for w in words])
    b_ms, b_by = bound_ms(F * (nb + 4 * d), F * d)
    batched = {"frames": F, "d": d, "ms": new_ms[0], "ms_again": new_ms[1],
               "bound_ms": b_ms, "bound_by": b_by, "flat_calls_ms": old_ms,
               "decode_batch_ms": graph_ms(lambda: codec.decode_batch(frames)),
               "decode_by_frame_ms": graph_ms(
                   lambda: Codec.decode_batch(codec, frames)),
               "launches_per_call": per_call}
    print(f"  unpack_signs on {F} frames: kernel_ms={new_ms[0]:.6f}, "
          f"{new_ms[1]:.6f} bound_ms={b_ms:.6f} ({b_by}) library_ms=none; "
          f"{F} flat calls {old_ms[0]:.6f}, {old_ms[1]:.6f}; "
          f"SignCodec.decode_batch {batched['decode_batch_ms']:.6f}, frame "
          f"by frame {batched['decode_by_frame_ms']:.6f}; "
          f"launches_per_call={per_call}")
    n = (1 << 22) + 5
    xs = [torch.randn(n, generator=g, device=dev) for _ in range(L2_ROTATE)]
    ws = [bp_mod.pack_signs(x) for x in xs]
    nx, nw = itertools.cycle(xs).__next__, itertools.cycle(ws).__next__
    b_ms, b_by = bound_ms(4 * n + 4 * bp_mod.num_words(n), n)
    at = {}
    for name, kern, plain in (
            ("pack_signs", lambda: bp_mod.pack_signs(nx()),
             lambda: bp_mod.pack_signs_plain(nx())),
            ("unpack_signs", lambda: bp_mod.unpack_signs(nw(), n),
             lambda: bp_mod.unpack_signs_plain(nw(), n))):
        at[name] = {"ms": graph_ms(kern), "call_ms": call_ms(kern),
                    "plain_ms": graph_ms(plain), "bound_ms": b_ms,
                    "bound_by": b_by}
        print(f"  {name} at n={n} ({L2_ROTATE} vectors in turn): "
              f"kernel_ms={at[name]['ms']:.6f} (eager call "
              f"{at[name]['call_ms']:.6f}) bound_ms={b_ms:.6f} ({b_by}) "
              f"plain_ms={at[name]['plain_ms']:.6f} library_ms=none")
    return {"pack_signs": {"tree_mlp": tree, "at_4Mi5": at["pack_signs"]},
            "unpack_signs": {"frames": batched,
                             "at_4Mi5": at["unpack_signs"]}}


def model_tree(g: torch.Generator, name: str, dataset: str) -> dict:
    """N(0, 1) leaves in the shapes of ``name``'s params on ``dataset``."""
    params = make_paper_model(name, DATASETS[dataset]).init(g)
    return flat.tree_map(
        lambda p: torch.randn(p.shape, generator=g, device=p.device), params)


def tree_time_rows(a: dict, b: dict) -> dict:
    """B1's and B2's tree forms on the trees ``a`` and ``b`` (the MLP's 6
    leaves, RegNet's 32): the leaf-table entry in a CUDA graph and eagerly,
    the path's own call (``ops``) eagerly, and the old route rebuilt from
    the same kernel (``torch.cat`` of each operand, then the one-segment
    call), the two timed in turns in graphs (old, new, new, old). The bound
    counts the tree's bytes once (no single PyTorch call takes a list of
    leaves: no library time)."""
    dev = flat.tree_leaves(a)[0].device
    la = [t.reshape(-1) for t in flat.tree_leaves(a)]
    lb = [t.reshape(-1) for t in flat.tree_leaves(b)]
    d = sum(t.numel() for t in la)
    s = torch.tensor([0.37], device=dev)
    rows = {}
    for name, new, old, path, nbytes, flops in (
            ("fused_cosine", lambda: fc_mod.fused_cosine_leaves(la, lb),
             lambda: fc_mod.fused_cosine(torch.cat(la), torch.cat(lb)),
             lambda: ops.tree_fused_stats(a, b), 2 * d * 4 + 3 * 4, 6 * d),
            ("ef_update", lambda: ef_mod.ef_update_leaves(la, lb, s),
             lambda: ef_mod.ef_update(torch.cat(la), torch.cat(lb), s),
             lambda: ops.tree_ef_update(a, b, s), 3 * d * 4 + 4, 2 * d)):
        reset_counts()
        new()
        per_call = counts()[name]
        new_ms, old_ms = in_turns(new, old)
        eager_ms, path_ms, old_eager = call_ms(new), call_ms(path), call_ms(old)
        b_ms, b_by = bound_ms(nbytes, flops)
        print(f"  {name} tree ({len(la)} leaves, d={d}): kernel_ms="
              f"{new_ms[0]:.6f}, {new_ms[1]:.6f} (eager call {eager_ms:.6f}; "
              f"ops call {path_ms:.6f}) bound_ms={b_ms:.6f} ({b_by}) "
              f"library_ms=none; old route (cat + one-segment call) "
              f"{old_ms[0]:.6f}, {old_ms[1]:.6f} (eager {old_eager:.6f}); "
              f"launches_per_call={per_call}")
        rows[name] = {"leaves": len(la), "d": d, "ms": new_ms[0],
                      "ms_again": new_ms[1], "call_ms": eager_ms,
                      "ops_call_ms": path_ms, "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": None,
                      "old_route_ms": old_ms, "old_route_call_ms": old_eager,
                      "launches_per_call": per_call}
    return rows


def print_profile(label: str, prof: dict) -> None:
    busy = (f"{prof['round_device_ms']:.3f} ms, busy share "
            f"{prof['round_device_ms'] / prof['round_wall_ms']:.4f}"
            if prof["round_device_ms"] else "not measured")
    print(f"  {label}: wall {prof['round_wall_ms']:.3f} ms (median of "
          f"{len(prof['walls_ms'])}), "
          f"device kernel time {busy}, {prof['device_launches']} device "
          f"kernels and copies")
    for name, (t, cnt) in sorted(prof["per_kernel_us"].items()):
        print(f"    {name}: {cnt} launches, {t / cnt:.3f} us each")
    for t, key, cnt in prof["top"]:
        print(f"    top: {t / 1e3:.3f} ms  {cnt:5d}x  {key[:90]}")


def b4_flops(b, h, nc, Q, P, N) -> tuple:
    """The operations B4's outputs need, as (products, the rest). The
    products: C·Bᵀ once per (b, chunk) over its lower triangle (B and C
    are shared by the heads), per cell S·xdt over the lower triangle and
    the dense state product. The rest, per cell: L's lower triangle (cs_i
    − cs_j, exp, ⊙ C·Bᵀ), xdt ⊙ w, the cumsum and the exps of w and
    decay."""
    tri = Q * (Q + 1) // 2
    cells = b * h * nc
    products = b * nc * 2 * N * tri + cells * (2 * P * tri + 2 * Q * P * N)
    return products, cells * (3 * tri + Q * P + 4 * Q)


def b4_time_row(dev, launched: int, err: float) -> dict:
    """B4 at the full prefill shape: the kernel in a CUDA graph and eagerly,
    its plain version, and its bound from the shapes (no single PyTorch
    call gives the three outputs: no library time). The bound counts the
    products at the TF32 tensor-core rate, three times over (the kernel's
    3xTF32 split), and the rest at the f32 rate; the bound with every
    operation on the f32 pipe is printed beside it."""
    b, h, nc, Q, P, N = B4_FULL
    inputs = b4_inputs(gen(dev, 29), *B4_FULL)
    kern = lambda: ssd_mod.ssd_chunk(*inputs)
    plain = lambda: ssd_mod.ssd_chunk_plain(*inputs)
    cells = b * h * nc
    # each input read once, each output written once (B and C once per
    # (b, chunk))
    nbytes = 4 * (cells * (Q * P + Q) + 2 * b * nc * Q * N
                  + cells * (Q * P + P * N + Q))
    products, rest = b4_flops(b, h, nc, Q, P, N)
    flops = products + rest
    # the dense per-cell work of the TPU kernel and of this one, printed
    # beside the bound but not used for it
    dense = cells * (2 * Q * Q * N + 2 * Q * Q * P + 2 * Q * P * N)
    kern_ms = graph_ms(kern, reps=20, replays=11)
    eager_ms = call_ms(kern, reps=50)
    plain_ms = graph_ms(plain, reps=20, replays=11)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (3 * products / TF32_FLOP_PER_S + rest / F32_FLOP_PER_S) * 1e3
    b_ms, b_by = ((t_bytes, "bytes") if t_bytes >= t_ops
                  else (t_ops, "operations"))
    f32_ms, f32_by = bound_ms(nbytes, flops)
    print(f"  ssd_chunk at (b,h,nc,Q,P,N)={B4_FULL}: kernel_ms={kern_ms:.6f} "
          f"(eager call {eager_ms:.6f}) bound_ms={b_ms:.6f} ({b_by}; "
          f"{nbytes} B, {products} FLOP of products as 3xTF32 "
          f"{3 * products / TF32_FLOP_PER_S * 1e3:.6f} ms, {rest} other "
          f"FLOP) bound on the f32 pipe {f32_ms:.6f} ({f32_by}; the dense "
          f"work, {dense} FLOP, would take {bound_ms(nbytes, dense)[0]:.6f} "
          f"ms) plain_ms={plain_ms:.6f} library_ms=none "
          f"launches_per_prefill={SERVE_LAYERS}")
    return {"name": "ssd_chunk", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
            "replaces": "src/repro/kernels/ssd_chunk.py:57",
            "launches": launched, "max_abs_err": err, "ms": kern_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "call_ms": eager_ms,
            "launches_per_prefill": SERVE_LAYERS}


def b56_time_rows(dev, launched, errs) -> list:
    """B5 and B6 at the MLP's d (the row's numbers) and at 4 Mi + 5
    (``at_4Mi5``): the kernel in a CUDA graph and eagerly, its plain
    version, and its bound, 5n bytes for B5 and 8n for B6 (no single
    PyTorch call gives either result: no library time). B6 at the sampled
    threshold of k = 1%. At the MLP's d one vector is reused, L2-resident
    as the main path's just-computed update is; at 4 Mi + 5 the calls
    rotate over L2_ROTATE vectors (over 100 MB in all, twice the 50 MB L2),
    so each call reads from device memory."""
    g = gen(dev, 41)
    rows = []
    for name, source, replaces, per_elem in (
            ("sign_quant", "src/repro_torch/kernels/csrc/sign_quant.cu",
             "src/repro/kernels/sign_quant.py:36", 5),
            ("topk_mask", "src/repro_torch/kernels/csrc/topk_mask.cu",
             "src/repro/kernels/topk_mask.py:38", 8)):
        at = {}
        for n, copies in ((MLP_D, 1), ((1 << 22) + 5, L2_ROTATE)):
            xs = [torch.randn(n, generator=g, device=dev)
                  for _ in range(copies)]
            tau = ops.topk_threshold(xs[0], max(1, n // 100))
            nxt = itertools.cycle(xs).__next__
            if name == "sign_quant":
                kern = lambda: sq_mod.sign_quant(nxt())
                plain = lambda: sq_mod.sign_quant_plain(nxt())
                nbytes = n * 4 + n + 4
            else:
                kern = lambda: tm_mod.topk_mask(nxt(), tau)
                plain = lambda: tm_mod.topk_mask_plain(nxt(), tau)
                nbytes = n * 4 + 4 + n * 4 + 4
            if n == MLP_D:
                reset_counts()
                kern()
                per_call = counts()[name]
            kern_ms, eager_ms = graph_ms(kern), call_ms(kern)
            plain_ms = graph_ms(plain)
            b_ms, b_by = bound_ms(nbytes, 2 * n)
            print(f"  {name} at n={n} ({copies} vector(s) in turn): "
                  f"kernel_ms={kern_ms:.6f} (eager call {eager_ms:.6f}) "
                  f"bound_ms={b_ms:.6f} ({b_by}, {per_elem}n bytes) "
                  f"plain_ms={plain_ms:.6f} library_ms=none")
            at[n] = {"ms": kern_ms, "call_ms": eager_ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by}
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launched[name],
                     "max_abs_err": errs[name], **at[MLP_D],
                     "library_ms": None, "at_4Mi5": at[(1 << 22) + 5],
                     "launches_per_call": per_call})
    return rows


def lm_time_rows(dev) -> dict:
    """B1 and B2 on mamba2's 11-leaf tree (d = 368,338,432) and B3a's tree
    entry into a sign section and B3b's frames entry on LM_N frames at d,
    in CUDA graphs of LM_TIME_REPS calls, each beside its flat form on the
    concatenation; the plain versions and the one-call PyTorch yardsticks
    (B1: ``torch.mm`` of the (2, d) stack by its transpose; B2:
    ``torch.addcmul``) on the flat vectors. Bounds: bytes, each input read
    once and each output written once."""
    cfg = get_config("mamba2-370m")
    g = gen(dev, 79)
    a, b = lm_tree(g, cfg, 1.0), lm_tree(g, cfg, 1.0)
    la = [t.reshape(-1) for t in flat.tree_leaves(a)]
    lb = [t.reshape(-1) for t in flat.tree_leaves(b)]
    d = sum(t.numel() for t in la)
    x, y = torch.cat(la), torch.cat(lb)
    s = torch.tensor([0.37], device=dev)
    nb = bp_mod.num_bytes(d)
    section = torch.empty(nb, dtype=torch.uint8, device=dev)
    frames = []
    for leaves in (la, lb):
        f = torch.empty(nb, dtype=torch.uint8, device=dev)
        bp_mod.pack_signs_tree(leaves, f)
        frames.append(f)
    frames = frames * (LM_N // 2)
    words = bp_mod.pack_signs(x)
    X = torch.stack([x, y])
    reps = dict(reps=LM_TIME_REPS, replays=LM_TIME_REPLAYS)
    once = dict(reps=1, replays=3)
    rows = {}
    for name, tree, flat_form, plain, lib, nbytes, flops in (
            ("fused_cosine", lambda: fc_mod.fused_cosine_leaves(la, lb),
             lambda: fc_mod.fused_cosine(x, y),
             lambda: fc_mod.fused_cosine_plain(x, y),
             lambda: torch.mm(X, X.T), 8 * d + 12, 6 * d),
            ("ef_update", lambda: ef_mod.ef_update_leaves(la, lb, s),
             lambda: ef_mod.ef_update(x, y, s),
             lambda: ef_mod.ef_update_plain(x, y, s),
             lambda: torch.addcmul(x, y, s, value=-1), 12 * d + 4, 2 * d),
            ("pack_signs", lambda: bp_mod.pack_signs_tree(la, section),
             lambda: bp_mod.pack_signs(x),
             lambda: bp_mod.pack_signs_plain(x), None, 4 * d + nb, d),
            ("unpack_signs",
             lambda: bp_mod.unpack_signs_frames(frames, 0, d),
             lambda: bp_mod.unpack_signs(words, d),
             lambda: bp_mod.unpack_signs_plain(words, d), None,
             LM_N * (nb + 4 * d), LM_N * d)):
        reset_counts()
        tree()
        per_call = counts()[name]
        ms = [graph_ms(tree, **reps), graph_ms(tree, **reps)]
        flat_ms = graph_ms(flat_form, **reps)
        plain_ms = graph_ms(plain, **once)
        lib_ms = graph_ms(lib, **reps) if lib is not None else None
        b_ms, b_by = bound_ms(nbytes, flops)
        what = (f"{LM_N} frames" if name == "unpack_signs"
                else f"{len(la)} leaves")
        lib_txt = f"{lib_ms:.6f}" if lib_ms is not None else "none"
        print(f"  {name} on mamba2's tree ({what}, d={d}): kernel_ms="
              f"{ms[0]:.6f}, {ms[1]:.6f} bound_ms={b_ms:.6f} ({b_by}; "
              f"{ms[0] and b_ms / ms[0]:.3f} of it) flat form "
              f"{flat_ms:.6f} plain_ms={plain_ms:.6f} (flat, one frame) "
              f"library_ms={lib_txt} launches_per_call={per_call}")
        rows[name] = {"tree_mamba2": {
            "d": d, "leaves": len(la), "ms": ms[0], "ms_again": ms[1],
            "flat_ms": flat_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "launches_per_call": per_call}}
    return rows


def phase_times(dev, launched, errs, rounds):
    """``launched`` holds each kernel's launches on its path's run;
    ``rounds`` is [(label, one_round)] to profile."""
    phase("times at the main path's shape")
    g = gen(dev, 13)
    x = torch.randn(MLP_D, generator=g, device=dev)
    y = torch.randn(MLP_D, generator=g, device=dev)
    s = torch.tensor([0.37], device=dev)
    X = torch.stack([x, y])
    n = x.numel()
    words = bp_mod.pack_signs(x)
    nw = words.numel()
    rows = []
    specs = [
        ("fused_cosine", "src/repro_torch/kernels/csrc/fused_cosine.cu",
         "src/repro/kernels/fused_cosine.py:60",
         lambda: fc_mod.fused_cosine(x, y),
         lambda: fc_mod.fused_cosine_plain(x, y),
         lambda: torch.mm(X, X.T),
         2 * n * 4 + 3 * 4, 6 * n),
        ("ef_update", "src/repro_torch/kernels/csrc/ef_update.cu",
         "src/repro/kernels/ef_update.py:31",
         lambda: ef_mod.ef_update(x, y, s),
         lambda: ef_mod.ef_update_plain(x, y, s),
         lambda: torch.addcmul(x, y, s, value=-1),
         3 * n * 4 + 4, 2 * n),
        # no single PyTorch call packs signs into words: no library time
        ("pack_signs", "src/repro_torch/kernels/csrc/bitpack.cu",
         "src/repro/kernels/bitpack.py:56",
         lambda: bp_mod.pack_signs(x),
         lambda: bp_mod.pack_signs_plain(x),
         None, n * 4 + nw * 4, n),
        ("unpack_signs", "src/repro_torch/kernels/csrc/bitpack.cu",
         "src/repro/kernels/bitpack.py:71",
         lambda: bp_mod.unpack_signs(words, n),
         lambda: bp_mod.unpack_signs_plain(words, n),
         None, nw * 4 + n * 4, n),
    ]
    for name, source, replaces, kern, plain, lib, nbytes, flops in specs:
        # the path's measured launches over its ROUNDS rounds
        per_round = launched[name] // ROUNDS
        kern_ms = graph_ms(kern)
        eager_ms = call_ms(kern)
        plain_ms = graph_ms(plain)
        library_ms = graph_ms(lib) if lib is not None else None
        b_ms, b_by = bound_ms(nbytes, flops)
        lib_txt = f"{library_ms:.6f}" if library_ms is not None else "none"
        print(f"  {name}: kernel_ms={kern_ms:.6f} (eager call "
              f"{eager_ms:.6f}) bound_ms={b_ms:.6f} ({b_by}) "
              f"plain_ms={plain_ms:.6f} library_ms={lib_txt} "
              f"launches_per_round={per_round}")
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launched[name],
                     "max_abs_err": errs[name], "ms": kern_ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": library_ms,
                     "call_ms": eager_ms,
                     "launches_per_round": per_round})
    g = gen(dev, 23)
    trees = tree_time_rows(mlp_tree(g), mlp_tree(g))
    regnet = tree_time_rows(model_tree(g, "regnet", "cifar100"),
                            model_tree(g, "regnet", "cifar100"))
    b3 = b3_time_extras(dev)
    for row in rows:
        if row["name"] in trees:
            row["tree_mlp"] = trees[row["name"]]
            row["tree_regnet"] = regnet[row["name"]]
        row.update(b3.get(row["name"], {}))
    rows.append(b4_time_row(dev, launched["ssd_chunk"], errs["ssd_chunk"]))
    rows += b56_time_rows(dev, launched, errs)
    t0 = time.perf_counter()
    for name, extra in lm_time_rows(dev).items():
        next(r for r in rows if r["name"] == name).update(extra)
    print(f"  (mamba2's rows in {time.perf_counter() - t0:.1f} s)")
    for label, one_round in rounds:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        print_profile(label, round_profile(one_round, KERNEL_NAMES))
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"    peak device memory {peak:.2f} GiB (the process's live "
              f"tensors included)")
    return rows


def sign_codec_round(state: FLState, by_frame: bool = False):
    """One signSGD codec-mode round at the main path's N, K, B; with
    ``by_frame`` it decodes its frames one after another."""
    model = make_mlp(MNIST_SPEC)
    comp = matched_compressors("mlp", MNIST_SPEC, MLP_D)["signsgd"]
    strategy = make_strategy(comp, local_lr=0.01)
    run = RunConfig(fl=FLConfig(num_clients=N, local_steps=K, local_lr=0.01,
                                local_batch=B, compressor=comp), wire="codec")
    codec = strategy.wire_codec(state.params)
    return build_fl_round(model.loss, strategy, run,
                          codec=frame_by_frame(codec) if by_frame else codec)


def main() -> int:
    phase("device")
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; "
                           "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    # the reference computes in full f32: TF32 stays off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    phase("build")
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"  built {sorted(built) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.2f} s")

    errs = phase_kernels(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
        state, launched = phase_main_path(out_dir)
        float_round, batches, syn0 = phase_fused(state, dev)
        sign_state, codec_launched = phase_codec_path(out_dir, state,
                                                      batches)
    phase_frames(dev)
    errs["ssd_chunk"] = phase_b4(dev)
    serve_launched = phase_serve()
    phase_routes(dev)
    err_b5 = phase_b56(dev)
    front_launched = phase_compressors(state, batches, dev)
    fs_round, fs_state = phase_accounted(state, batches, syn0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
        fault_round, fault_state = phase_faults(out_dir, state, batches,
                                                syn0)
        cnn_states = phase_cnns(out_dir, dev)
        lm_state = phase_lm_train(out_dir, dev)
    phase_lm_sign(lm_state, dev)
    phase_lm_routes(dev)
    phase_lm_cpu(dev)
    fanout_bytes = phase_fanout(state, fault_state, batches, dev)
    lm_cfg = get_config("mamba2-370m")
    lm_model, lm_strategy, lm_run = train.lm_setup(
        lm_args(LM_N, LM_BATCH), lm_cfg, LM_COMP, LM_SEQ)
    lm_one_round = build_fl_round(lm_model.loss, lm_strategy, lm_run)
    lm_inputs = lm_batches(dev, lm_cfg, LM_N, LM_BATCH, LM_SEQ, 83)
    cnn_profiles = []
    for name in ("convnet", "regnet"):
        cnn_state, dataset = cnn_states[name]
        one_round, strategy = cnn_round(name, dataset, N)
        cnn_batches, cnn_syn0 = cnn_inputs(dev, dataset, strategy.syn_spec, N)
        cnn_profiles.append((
            f"{name} 3SFC round on {dataset} (S={S}, N={N}, K={K}, B={B})",
            functools.partial(one_round, cnn_state, cnn_batches, 0,
                              syn0=cnn_syn0)))
    launched = {**launched, "pack_signs": codec_launched["pack_signs"],
                "unpack_signs": codec_launched["unpack_signs"],
                "ssd_chunk": serve_launched["ssd_chunk"],
                "sign_quant": front_launched["sign_quant"],
                "topk_mask": front_launched["topk_mask"]}
    errs = {**errs, "sign_quant": err_b5, "topk_mask": 0.0}
    sign_round = sign_codec_round(sign_state)
    sign_round_by_frame = sign_codec_round(sign_state, by_frame=True)
    rows = phase_times(dev, launched, errs, [
        (f"main-path round (S={S}, N={N}, K={K}, B={B})",
         lambda: float_round(state, batches, 0, syn0=syn0)),
        (f"signSGD codec round (N={N}, K={K}, B={B})",
         lambda: sign_round(sign_state, batches, 0)),
        (f"signSGD codec round decoding frame by frame (N={N}, K={K}, "
         f"B={B})", lambda: sign_round_by_frame(sign_state, batches, 0)),
        (f"FedSynth round (N={N}, K={K}, B={B}, 10 opt x 5 unroll steps)",
         lambda: fs_round(fs_state, batches, 0, syn0=syn0)),
        (f"faulted main-path round ({FAULT_KNOBS}, round "
         f"{fault_state.round})",
         lambda: fault_round(fault_state, batches, 0, syn0=syn0)),
        *cnn_profiles,
        (f"mamba2-370m 3SFC round at full width (N={LM_N}, K=1, "
         f"B={LM_BATCH}, S={LM_SEQ}, round {lm_state.round})",
         lambda: lm_one_round(lm_state, lm_inputs, 0)),
    ])
    fanout = fanout_walls(state, batches, dev)
    print(json.dumps({"fanout": {**fanout, "gathered_bytes_per_client":
                                 fanout_bytes}}))

    print(f"chip_smoke wall {time.perf_counter() - _T0:.1f} s (from the "
          f"script's start, the kernels' build included)")
    print(card)
    print(json.dumps({"kernels": rows}))
    print("kernels: " + json.dumps([r["name"] for r in rows]))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--fanout-rank"]:
        sys.exit(fanout_child(sys.argv[2:]))
    sys.exit(main())
