import os
import signal
import sys

import pytest

# tests must see 1 CPU device (the 512-device flag is dryrun-only)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

sys.path.insert(0, REPO)  # benchmarks/

from benchmarks.bench_collectives import multidev_env  # noqa: E402


def run_multidev(args, timeout=1200):
    """Run ``python <args...>`` in a child process that sees 8 host CPU
    devices. The device count is locked at first jax init, so multi-device
    sharding tests cannot run in the (single-device) pytest process itself —
    they run their scenario in a subprocess and assert on its exit status.
    The environment recipe is shared with benchmarks/bench_collectives.
    """
    import subprocess
    return subprocess.run([sys.executable] + list(args), env=multidev_env(),
                          cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)


@pytest.fixture(scope="session")
def multidev_scenario():
    """Session fixture running one child scenario (``__main__`` entry of
    ``file``, default tests/test_shard_round.py) on 8 forced host devices
    and asserting it exits clean."""

    def run_scenario(scenario, timeout=1200, file="tests/test_shard_round.py"):
        p = run_multidev([file, scenario], timeout)
        assert p.returncode == 0, (
            f"scenario {scenario!r} failed (exit {p.returncode})\n"
            f"--- stdout ---\n{p.stdout}\n--- stderr ---\n{p.stderr}")

    return run_scenario


# ---------------------------------------------------------------------------
# transport marker: live-socket tests get a hard wall-clock ceiling
# ---------------------------------------------------------------------------

TRANSPORT_TIMEOUT_S = 120


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "transport: live socket-transport test (real sockets / subprocess "
        "workers); armed with a hard SIGALRM timeout (default "
        f"{TRANSPORT_TIMEOUT_S}s, override per-test with timeout=<s>) so a "
        "hung wire fails loudly instead of hanging the suite")
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where none is visible "
        "(the test decides when it runs)")


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    m = item.get_closest_marker("transport")
    if m is None or not hasattr(signal, "SIGALRM"):
        yield
        return
    limit = int(m.kwargs.get("timeout", TRANSPORT_TIMEOUT_S))

    def _alarm(signum, frame):
        raise TimeoutError(
            f"transport test exceeded the hard {limit}s timeout — a socket "
            f"or worker subprocess is hung (the transport's own deadlines "
            f"should have fired long before this)")

    old = signal.signal(signal.SIGALRM, _alarm)
    signal.alarm(limit)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
