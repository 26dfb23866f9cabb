"""How ``correct`` is decided: the gaps between the program's first rounds
and the reference's, each held to its limit from the cell's file.

Every round record holds the round's mean loss, each client's cosine,
the aggregate's norm (``update_norm``), the floats a client sends
(``payload``, held exactly) and each client's residual by leaf (``ef``);
the first also the params' change by leaf (``delta``, what the server
applied) and the last the change since the start (``change``).
A gap between norms is taken by the worst leaf: ``|‖p‖ − ‖r‖|`` over the
reference's norm of that leaf or of the median leaf, whichever is larger.
``delta`` and ``change`` leave out a leaf whose reference ``delta`` is 0
or under a thousandth of the median leaf's (a key's bias under softmax
has no gradient but round-off; an update under half an f32 ulp of its
parameter leaves it as it was). ``applied`` compares the whole tree's
change instead, after the first round and after the last, as a factor
either way, ``|ln(‖Δp‖ / ‖Δr‖)|``: a server that applies nothing reads
infinity, where a leaf's gap of norms reads 1, which the rounding of a
change below an f32 ulp can reach in a sound run.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Sequence

Record = Dict


def leaf_gap(p: Dict[str, float], r: Dict[str, float],
             keep: Optional[Sequence[str]] = None) -> float:
    names = sorted(r) if keep is None else list(keep)
    med = statistics.median(r[n] for n in sorted(r))
    worst = 0.0
    for n in names:
        gap = abs(p[n] - r[n]) / max(r[n], med, 1e-300)
        if not math.isfinite(gap) or not math.isfinite(p[n]):
            return math.inf
        worst = max(worst, gap)
    return worst


def moved(delta_r: Dict[str, float]) -> List[str]:
    med = statistics.median(delta_r.values())
    return [n for n in sorted(delta_r)
            if delta_r[n] > 0 and delta_r[n] >= 1e-3 * med]


def tree_factor(p: Dict[str, float], r: Dict[str, float]) -> float:
    """``|ln(‖p‖ / ‖r‖)|`` of two trees given by their leaves' norms."""
    tp = math.sqrt(sum(v * v for v in p.values()))
    tr = math.sqrt(sum(v * v for v in r.values()))
    if not (math.isfinite(tp) and math.isfinite(tr)):
        return math.inf
    if tp == 0.0 or tr == 0.0:
        return 0.0 if tp == tr else math.inf
    return abs(math.log(tp / tr))


def _rel(a: float, b: float, floor: float = 0.0) -> float:
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / max(abs(b), floor, 1e-300)


def gaps(prog: List[Record], ref: List[Record]) -> Dict[str, float]:
    """Every number the check can compare, by name."""
    n = min(len(prog), len(ref))
    cos_r = [abs(c) for rec in ref[:n] for c in rec["cosine"]]
    cos_floor = statistics.median(cos_r)
    keep = moved(ref[0]["delta"])
    return {
        "loss": max(_rel(p["loss"], r["loss"])
                    for p, r in zip(prog, ref)),
        "cosine": max(_rel(cp, cr, cos_floor)
                      for p, r in zip(prog, ref)
                      for cp, cr in zip(p["cosine"], r["cosine"])),
        "update_norm": max(_rel(p["update_norm"], r["update_norm"])
                           for p, r in zip(prog, ref)),
        "ef": max(leaf_gap(ep, er) for p, r in zip(prog, ref)
                  for ep, er in zip(p["ef"], r["ef"])),
        "delta": leaf_gap(prog[0]["delta"], ref[0]["delta"], keep),
        "change": leaf_gap(prog[n - 1]["change"], ref[n - 1]["change"],
                           keep),
        "applied": max(tree_factor(prog[0]["delta"], ref[0]["delta"]),
                       tree_factor(prog[n - 1]["change"],
                                   ref[n - 1]["change"])),
        "payload": max(abs(p["payload"] - r["payload"])
                       for p, r in zip(prog, ref)),
    }


def verdict(values: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, value, limit)]) over the numbers with a limit."""
    rows = [(k, values.get(k, math.inf), float(lim))
            for k, lim in sorted(limits.items())]
    ok = bool(rows) and all(math.isfinite(v) and v <= lim
                            for _, v, lim in rows)
    return ok, rows
