"""Mean of the engine's ``engine.dispatch`` span a round over the traced
window: the host's time to enqueue a round (it blocks whenever the launch
queue is full, so a device-bound round reads near its wall time)."""


def read(run):
    spans = run.get("dispatch_s")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
