"""How unevenly the routed slots fall on the experts held here: the
largest held expert's count of (token, slot) pairs over the mean of the
held experts' counts, over the traced window (the program's counters
``moe.slots.held.<j>``, counted on the device by every MoE layer's
forward call that records a span, and read at the rounds' host syncs).
1 is an even load; None where the program has no such counters."""
from typing import Dict, Optional

PREFIX = "moe.slots.held."


def held_counts() -> Dict[int, float]:
    """The program's per-held-expert slot counts, by the expert's index
    among those held."""
    from repro_torch.obs import get_registry
    counters = get_registry().snapshot()["counters"]
    return {int(k[len(PREFIX):]): v for k, v in counters.items()
            if k.startswith(PREFIX) and k[len(PREFIX):].isdigit()}


def held_share() -> Optional[float]:
    """The held experts' share of all routed slots (``moe.slots``)."""
    from repro_torch.obs import get_registry
    total = get_registry().snapshot()["counters"].get("moe.slots")
    held = held_counts()
    if not total or not held:
        return None
    return sum(held.values()) / total


def read(run):
    counts = list(held_counts().values())
    if not counts or not sum(counts):
        return None
    return max(counts) / (sum(counts) / len(counts))
