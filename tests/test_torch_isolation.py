"""The port stands alone: no module of ``repro_torch`` (nor ``chip_smoke.py``)
imports JAX or anything of the reference package ``repro``; its entry
point runs on the CUDA device unless the CPU is asked for; its kernel
wrappers never fall back from a device tensor to the plain version."""
import ast
import glob
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import bitpack
from repro_torch.kernels import ef_update as ef_mod
from repro_torch.kernels import fused_cosine as fc_mod
from repro_torch.kernels import sign_quant as sq_mod
from repro_torch.kernels import ssd_chunk as ssd_mod
from repro_torch.kernels import topk_mask as tm_mod
from repro_torch.launch import train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py"),
           os.path.join(REPO, "scripts", "torch_round_profile.py")]
    # the port's examples, beside the reference's
    out += glob.glob(os.path.join(REPO, "examples", "*_torch.py"))
    for dirpath, _, names in os.walk(PORT):
        out += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(out)


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module or ""


def _forbidden(mod: str) -> bool:
    # the module itself or a submodule: ``repro`` and ``repro.x`` match,
    # ``repro_torch`` does not
    return any(mod == f or mod.startswith(f + ".") for f in FORBIDDEN)


def test_no_port_module_imports_jax_or_the_reference():
    files = _port_files()
    assert len(files) > 20
    assert {"quickstart_torch.py", "compress_llm_update_torch.py"} <= {
        os.path.basename(p) for p in files}
    bad = [(os.path.relpath(p, REPO), m) for p in files
           for m in _imported_modules(p) if _forbidden(m)]
    assert not bad, bad


def test_forbidden_match_is_exact():
    assert _forbidden("repro") and _forbidden("repro.core.flat")
    assert _forbidden("jax.numpy")
    assert not _forbidden("repro_torch") and not _forbidden("repro_torch.fl")
    assert not _forbidden("jaxtyping_like") and not _forbidden("reprox")


def test_importing_the_trainer_loads_no_jax():
    code = ("import sys, repro_torch.launch.train, repro_torch.fl.engine, "
            "repro_torch.launch.serve, repro_torch.models.ssm, "
            "repro_torch.models.transformer, repro_torch.kernels.ssd_chunk, "
            "repro_torch.core.compressor, repro_torch.core.fedsynth, "
            "repro_torch.core.baselines, repro_torch.core.error_feedback\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    p = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr


def test_trainer_without_cuda_raises_unless_cpu_is_asked(monkeypatch,
                                                         tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(["--rounds", "1", "--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--rounds", "1", "--device", "cuda",
                    "--out", str(tmp_path)])
    assert train.resolve_device("cpu").type == "cpu"


def test_wrappers_raise_on_a_device_they_do_not_run_on():
    x = torch.ones(8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fc_mod.fused_cosine(x, x)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ef_mod.ef_update(x, x, torch.ones(1, device="meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        bitpack.pack_signs(torch.ones(40, device="meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        bitpack.unpack_signs(torch.ones(2, dtype=torch.int32, device="meta"),
                             40)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ssd_mod.ssd_chunk(torch.ones((1, 2, 1, 8, 4), device="meta"),
                          torch.ones((1, 2, 1, 8), device="meta"),
                          torch.ones((1, 1, 8, 4), device="meta"),
                          torch.ones((1, 1, 8, 4), device="meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        sq_mod.sign_quant(x)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tm_mod.topk_mask(x, torch.ones((), device="meta"))


def test_missing_nvcc_names_where_it_looked(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os, "access", lambda path, mode: False)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda")
    with pytest.raises(RuntimeError) as e:
        _build.find_nvcc()
    msg = str(e.value)
    assert "PATH" in msg and "/nonexistent-cuda" in msg \
        and "/usr/local/cuda/bin" in msg


def test_library_names_follow_the_sources():
    paths = {n: _build._lib_path(n) for n in _build.KERNELS}
    assert sorted(p.name.split("-")[0] for p in paths.values()) == \
        ["libbitpack", "libef_update", "libfused_cosine", "libsign_quant",
         "libssd_chunk", "libtopk_mask"]
    # one source per library
    assert sorted(p.name for p in _build.CSRC.glob("*.cu")) == \
        sorted(f"{n}.cu" for n in _build.KERNELS)
    assert all(p.parent == _build.BUILD_DIR for p in paths.values())
    assert _build._lib_path("fused_cosine") == paths["fused_cosine"]


def test_library_names_follow_the_headers_they_include(tmp_path,
                                                       monkeypatch):
    for p in _build.CSRC.iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {n: _build._lib_path(n) for n in _build.KERNELS}
    including = {n for n in _build.KERNELS
                 if '#include "launch.cuh"' in (tmp_path / f"{n}.cu")
                 .read_text()}
    assert including == {"bitpack", "ef_update", "fused_cosine", "sign_quant",
                         "topk_mask"}
    header = tmp_path / "launch.cuh"
    header.write_text(header.read_text() + "// edited\n")
    changed = {n for n in _build.KERNELS if _build._lib_path(n) != before[n]}
    assert changed == including
