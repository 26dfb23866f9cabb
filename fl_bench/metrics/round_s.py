"""Wall time of a round: the timed window's host-clock seconds over the
whole rounds it ran, closed loop (each round starts when the last one's
metrics reached the host)."""


def read(run):
    return run["window_s"] / run["rounds"]
