"""The port's protocol analyzer: the mirror of tests/test_analysis.py's
five ``test_protocol_*``/``test_race_detector_*`` cases for
``repro_torch.analysis.protocol``, pointed at the port's
``comm/transport.py``, ``launch/worker.py`` and ``fl/engine.py``. It reads
source files only: dead vocabulary, black-hole sends and unguarded
cross-thread writes in the port's ``SocketServer`` are caught here."""
import ast
import os

import pytest

from repro_torch.analysis import protocol

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_analyzer_reads_the_port_files():
    port = os.path.join(REPO, "src", "repro_torch")
    assert protocol.TRANSPORT_PATH == os.path.join(port, "comm",
                                                   "transport.py")
    assert protocol.WORKER_PATH == os.path.join(port, "launch", "worker.py")
    assert protocol.ENGINE_PATH == os.path.join(port, "fl", "engine.py")


def test_protocol_handler_deletion_fires():
    # delete the worker's MSG_EF_SYNC handler from the port's source: the
    # server still sends it -> black-hole send
    w_src = protocol._read(protocol.WORKER_PATH)
    assert "mtype == MSG_EF_SYNC" in w_src, "worker handler shape changed"
    broken = w_src.replace("mtype == MSG_EF_SYNC", "False")
    _, viol = protocol.check_protocol(worker_src=broken)
    assert any("MSG_EF_SYNC" in v and "black-hole" in v for v in viol)


def test_protocol_black_hole_and_dead_vocabulary():
    t_src = ("MSG_A = 0\n"
             "MSG_B = 1\n"
             "MSG_C = 2\n"
             "class SocketServer:\n"
             "    def pump(self, mtype):\n"
             "        if mtype == MSG_A:\n"
             "            pass\n"
             "        send_msg(None, MSG_B, b'')\n"
             "class ServerLink:\n"
             "    pass\n")
    w_src = "def serve(link):\n    send_msg(None, MSG_A, b'')\n"
    _, viol = protocol.check_protocol(transport_src=t_src, worker_src=w_src)
    assert any("MSG_B" in v and "black-hole" in v for v in viol)
    assert any("MSG_C" in v and "dead vocabulary" in v for v in viol)
    assert not any("MSG_A" in v for v in viol)


def test_protocol_clean_at_head():
    rep = protocol.run_protocol()
    assert rep["violations"] == 0, rep["rules"]
    t = rep["transitions"]
    assert len(t["messages"]) >= 10
    assert set(t["sends"]["server"]) == set(t["handles"]["worker"])
    assert set(t["sends"]["worker"]) == set(t["handles"]["server"])
    # the port's analyzer sees what the reference's sees in its own files
    from repro.analysis import protocol as jprotocol
    assert t == jprotocol.run_protocol()["transitions"]


def test_race_detector_fires_on_unguarded_write():
    racy = ("import threading\n"
            "class Racy:\n"
            "    def __init__(self):\n"
            "        self._lock = threading.Lock()\n"
            "        self.counter = 0\n"
            "        t = threading.Thread(target=self._loop)\n"
            "        t.start()\n"
            "    def _loop(self):\n"
            "        self.counter += 1\n"
            "    def bump(self):\n"
            "        self.counter += 1\n")
    _, viol = protocol.analyze_class_races(ast.parse(racy), "Racy")
    assert viol and all("counter" in v for v in viol)
    guarded = racy.replace(
        "        self.counter += 1\n",
        "        with self._lock:\n            self.counter += 1\n")
    _, viol = protocol.analyze_class_races(ast.parse(guarded), "Racy")
    assert not viol
    # an unguarded write planted in the port's SocketServer is caught
    src = protocol._read(protocol.TRANSPORT_PATH)
    planted = src.replace(
        "                elif mtype == MSG_FRAME:\n",
        "                elif mtype == MSG_FRAME:\n"
        "                    self.overhead_up += 1\n", 1)
    assert planted != src
    _, viol = protocol.check_races(transport_src=planted)
    assert any("overhead_up" in v for v in viol)


def test_race_detector_rejects_missing_class():
    with pytest.raises(ValueError):
        protocol.analyze_class_races(ast.parse("x = 1\n"), "SocketServer")
