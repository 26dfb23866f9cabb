"""The round's model FLOPs over the mean wall time of the window's rounds
at the card's dense bf16 peak, in percent.

The FLOPs are the benchmark's own count from the configuration's shapes
(``forward_flops`` of the cell's family): each client's K local steps at
three forwards each (forward and backward, the remat's recomputed forward
not counted), and at the synthetic shapes the encode (eight forwards a
grad-of-grad step: the forward, its backward, and that backward's own
backward, which differentiates each layer's three backward products and
runs the forward's backward again; three for the final evaluation) and
the server's decode (three).
"""
import flb_peaks


def round_flops(cell) -> float:
    t, cfg, fam = cell.traffic, cell.cfg, cell.family
    lm = 3 * t["local_steps"] * fam.forward_flops(cfg, t["seq_len"],
                                                  t["batch"])
    syn = fam.syn_forward_flops(cfg, t["syn_batch"], t["syn_seq"],
                                t["label_rank"])
    return t["clients"] * (lm + (8 * t["syn_steps"] + 3 + 3) * syn)


def read(run):
    if "trace" not in run:
        return None
    per_round = run["window_s"] / run["rounds"]
    return 100.0 * round_flops(run["cell"]) / (per_round
                                               * flb_peaks.BF16_FLOPS)
