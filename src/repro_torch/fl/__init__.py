"""repro_torch.fl — the federated round, its engine, faults and placement.

``round``   — ``build_fl_round`` and the round state (``FLState``,
              ``fl_init``); ``make_fl_round`` is the deprecated shim.
``engine``  — ``RoundEngine`` (device-resident data, seeded batches, EF
              donation), ``LiveRoundLoop`` and the transport's retries.
``faults``  — the seeded fault schedule and its masked aggregate.
``encode_graph`` — each client row's 3SFC encode as a CUDA graph, and
              where the round takes that path.
``sharding`` — ``FLShardings``, the placement of the sharded fan-out.
              DTensor's import (sympy, fx) takes seconds, so its two names
              load on first use: a socket worker never pays for it.
"""
import importlib

from repro_torch.fl.budget import matched_compressors, payload_budget
from repro_torch.fl.client import local_train
from repro_torch.fl.engine import (ClientPools, DeliveryReport, EngineStats,
                                   LiveRoundLoop, RetryPolicy, RoundEngine,
                                   device_pools, token_batcher,
                                   vision_batcher)
from repro_torch.fl.faults import (FaultSchedule, fault_schedule,
                                   null_schedule, residual_mass_conserved)
from repro_torch.fl.round import (FLState, build_fl_round, fl_init, fl_round,
                                  make_fl_round)
from repro_torch.fl.server import aggregate, server_update

_LAZY = {"FLShardings": "repro_torch.fl.sharding",
         "make_fl_shardings": "repro_torch.fl.sharding"}

__all__ = ["ClientPools", "DeliveryReport", "EngineStats", "FLShardings",
           "FLState", "FaultSchedule", "LiveRoundLoop", "RetryPolicy",
           "RoundEngine", "aggregate", "build_fl_round", "device_pools",
           "fault_schedule", "fl_init", "fl_round", "local_train",
           "make_fl_round", "make_fl_shardings", "matched_compressors",
           "null_schedule", "payload_budget", "residual_mass_conserved",
           "server_update", "token_batcher", "vision_batcher"]


def __getattr__(name):
    if name in _LAZY:
        value = getattr(importlib.import_module(_LAZY[name]), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
