"""Share of the traced rounds' wall time in which no record ran on the
device: 1 − the union of the device's activity intervals over the wall,
in percent."""


def read(run):
    tr = run.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
