"""Fault model for federated rounds: who shows up, what arrives, and when.

The port of the JAX package's ``fl/faults.py``: the same semantics and the
same EF-correctness contract. Per client i, round t:

* **non-participation** (``participate[i] = False``): the client is not
  scheduled. Its EF residual is FROZEN (``e^{t+1} = e^t``), its loss is
  excluded from the round mean, and it contributes nothing to the
  aggregate.
* **dropout mid-round** (``delivered[i] = False`` while participating):
  the client trained and encoded, but its payload never reached the
  server. The server renormalizes over the payloads it did receive; the
  client keeps its whole accumulated update in the residual
  (``e^{t+1} = u^t = g + e^t`` under error feedback).
* **straggler / staleness** (``delay[i] = k > 0``): the round-t payload
  arrives at round t+k (``k ≤ staleness_max``). The client's EF updates
  normally at t; the server banks the reconstruction in the ``FLState``
  staleness ring buffer and folds it into the round-(t+k) aggregate with
  weight ``1 / (1 + k)``, renormalizing by the total arrived weight.

EF residual-mass conservation, for every fault pattern::

    participate=0:            e' = e,        delivered 0
    delivered=0 (dropped):    e' = u,        delivered 0        u = g + e
    delay=k (straggler):      e' = u - r,    delivered r at t+k
    healthy:                  e' = u - r,    delivered r at t

``residual_mass_conserved`` checks the identity on concrete trees.

The schedule is host data. ``fault_schedule`` draws every mask on a CPU
``torch.Generator`` seeded from ``fold_in(fault_seed, round)``
(``repro_torch.fl.round.fold_in``), one sub-stream each for participation,
dropout, straggling and delay, so the schedule for round t is a pure
function of ``(fault_seed, t)``: the card and the CPU get the same masks,
how rounds are grouped into blocks never changes it, and turning
staleness on never changes who participates. Its streams are the port's
own, not JAX's. The zero-fault schedule is bitwise inert: every mask is
all-true or all-zero and every weight exactly 1.0.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import flat
from repro_torch.core.tree import tree_leaves, tree_map

PyTree = Any

# sub-streams of a round's fault key, in the reference's split order
_PARTICIPATE, _DROP, _STRAGGLE, _DELAY = range(4)


class FaultSchedule(NamedTuple):
    """One round's fault pattern over N clients, as CPU tensors.

    ``participate``/``delivered`` are (N,) bool; ``delay`` is (N,) int32 in
    ``[0, staleness_max]``; ``weight`` is the (N,) f32 staleness weight
    ``1/(1+delay)``, exactly 1.0 wherever ``delay == 0``.
    """

    participate: torch.Tensor
    delivered: torch.Tensor
    delay: torch.Tensor
    weight: torch.Tensor

    @property
    def arrives_now(self) -> torch.Tensor:
        """(N,) bool: payload delivered this round with zero delay."""
        return self.participate & self.delivered & (self.delay == 0)

    @property
    def arrives_late(self) -> torch.Tensor:
        """(N,) bool: payload delivered, but banked for a future round."""
        return self.participate & self.delivered & (self.delay > 0)


def staleness_weight(delay: torch.Tensor) -> torch.Tensor:
    """Aggregation weight of a payload ``delay`` rounds late: 1/(1+delay),
    in f32; exactly 1.0 at delay 0."""
    return 1.0 / (1.0 + delay.to(torch.float32))


def fault_schedule(fault_seed: int, round_idx: int, num_clients: int, *,
                   participation_rate: float = 1.0, drop_rate: float = 0.0,
                   straggler_rate: float = 0.0,
                   staleness_max: int = 0) -> FaultSchedule:
    """The round's ``FaultSchedule``, a pure function of (seed, round).

    Rate edges are exact: ``rand() < 1.0`` is always true (the draws lie in
    [0, 1)) and ``rand() < 0.0`` never, so rate-1 participation and rate-0
    dropout/straggling give all-true/all-false masks with no special case.
    """
    from repro_torch.fl.round import fold_in   # fl.round imports this module
    key = fold_in(fault_seed, round_idx)
    n = (num_clients,)

    def stream(j: int) -> torch.Generator:
        return torch.Generator().manual_seed(fold_in(key, j))

    participate = torch.rand(n, generator=stream(_PARTICIPATE)) \
        < participation_rate
    delivered = ~(torch.rand(n, generator=stream(_DROP)) < drop_rate)
    if staleness_max > 0:
        straggle = torch.rand(n, generator=stream(_STRAGGLE)) \
            < straggler_rate
        late = torch.randint(1, staleness_max + 1, n, dtype=torch.int32,
                             generator=stream(_DELAY))
        delay = torch.where(straggle, late, torch.zeros_like(late))
    else:
        delay = torch.zeros(n, dtype=torch.int32)
    return FaultSchedule(participate, delivered, delay,
                         staleness_weight(delay))


def null_schedule(num_clients: int) -> FaultSchedule:
    """The all-healthy schedule: everyone participates, everything arrives
    on time with weight exactly 1.0."""
    n = (num_clients,)
    return FaultSchedule(torch.ones(n, dtype=torch.bool),
                         torch.ones(n, dtype=torch.bool),
                         torch.zeros(n, dtype=torch.int32),
                         torch.ones(n, dtype=torch.float32))


# ---------------------------------------------------------------------------
# staleness ring buffer (server-side FLState extension)
# ---------------------------------------------------------------------------


def init_stale_buffer(params: PyTree, staleness_max: int
                      ) -> Tuple[Optional[PyTree], Optional[torch.Tensor]]:
    """Zeroed ring buffer for payloads in flight: per params leaf an
    ``(S, *shape)`` f32 bank (slot j holds the weighted sum of
    reconstructions maturing at rounds ≡ j mod S) plus the (S,)
    arrived-weight accumulator, on the params' device. ``(None, None)``
    when staleness is off."""
    if staleness_max <= 0:
        return None, None
    buf = tree_map(lambda p: torch.zeros((staleness_max, *p.shape),
                                         dtype=torch.float32,
                                         device=p.device), params)
    device = tree_leaves(params)[0].device
    return buf, torch.zeros((staleness_max,), dtype=torch.float32,
                            device=device)


def consume_and_bank(buf: PyTree, buf_w: torch.Tensor, round_idx: int,
                     delay: torch.Tensor, w_late: torch.Tensor,
                     recons: PyTree):
    """One round of ring-buffer turnover.

    ``delay`` is the schedule's (N,) host delays, ``w_late`` the (N,)
    banking weight of each client's payload on the buffer's device (nonzero
    only for late payloads), ``recons`` the (N, ...) reconstructions.
    Returns ``(mature, mature_w, new_buf, new_buf_w)``: the weighted sum and
    weight maturing this round (slot ``t mod S``), and a new buffer with
    that slot cleared and every payload banked at slot ``(t + delay) mod
    S``. Consume-then-bank lets ``delay == S`` land in the just-freed slot.
    Every client is banked, zero weights included, in client order with
    plain adds, so the sums' order (and bits) never vary from run to run;
    the inputs are not written.
    """
    S = buf_w.shape[0]
    slot = round_idx % S
    targets = [(round_idx + int(k)) % S for k in delay.tolist()]
    mature = tree_map(lambda b: b[slot], buf)
    mature_w = buf_w[slot]

    def bank(b, r):
        out = b.clone()
        out[slot] = 0.0
        for i, t in enumerate(targets):
            out[t].add_(w_late[i] * r[i].to(torch.float32))
        return out

    new_buf = tree_map(bank, buf, recons)
    new_w = buf_w.clone()
    new_w[slot] = 0.0
    for i, t in enumerate(targets):
        new_w[t].add_(w_late[i])
    return mature, mature_w, new_buf, new_w


def pending_mass(buf_w: Optional[torch.Tensor]) -> torch.Tensor:
    """Total staleness weight still in flight (0 when staleness is off)."""
    if buf_w is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sum(buf_w)


# ---------------------------------------------------------------------------
# the EF-correctness oracle (host-side, test surface)
# ---------------------------------------------------------------------------


def residual_mass_conserved(u: PyTree, e_new: PyTree,
                            delivered_payload: PyTree, *,
                            atol: float = 0.0) -> bool:
    """Check the per-round identity ``e' + delivered == u``.

    ``delivered_payload`` is the reconstruction the server will (eventually)
    receive from this client: the zero tree for a dropped payload. Exact for
    the frozen and dropped branches; the healthy and straggler branch is
    ``u - r + r``, within one f32 rounding: pass a small ``atol`` there.
    """
    diff = flat.tree_sub(u, flat.tree_add(e_new, delivered_payload))
    worst = max((float(torch.max(torch.abs(l))) if l.numel() else 0.0
                 for l in tree_leaves(diff)), default=0.0)
    return worst <= atol
