"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/<name>.cu`` compiles into its own shared library with a plain
``extern "C"`` interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
        -Xcompiler -fPIC -o build/kernels/lib<name>-<hash>.so csrc/<name>.cu

The output name carries a hash of the source, the ``csrc/*.cuh`` headers it
includes (``launch.cuh``: the launch helpers of the table kernels) and the
flags, so an unchanged tree never rebuilds and an edited one never loads a
stale library. The
build directory (``build/kernels/`` at the repository root) is git-ignored.
``build_all()`` starts one ``nvcc`` per source at once and waits for all of
them; ``load(name)`` builds one source at first use. Nothing here runs at
import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("fused_cosine", "ef_update", "bitpack", "ssd_chunk", "sign_quant",
           "topk_mask", "causal_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``nvcc`` from ``PATH``, else ``$CUDA_HOME/bin``, else the toolkit's
    default prefix ``/usr/local/cuda/bin``; raises naming all three."""
    found = shutil.which("nvcc")
    if found:
        return found
    homes = [os.environ.get("CUDA_HOME"), "/usr/local/cuda"]
    for home in homes:
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found: looked on PATH, in $CUDA_HOME/bin (CUDA_HOME="
        f"{os.environ.get('CUDA_HOME')!r}) and in /usr/local/cuda/bin; the "
        "port's CUDA kernels need the CUDA toolkit to build")


def _headers(src: bytes) -> list:
    """The ``csrc/*.cuh`` headers that a source includes, by name."""
    return [h for h in sorted(CSRC.glob("*.cuh"))
            if f'#include "{h.name}"'.encode() in src]


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    flags = " ".join(NVCC_FLAGS).encode()
    text = b"\0".join([src, *(h.read_bytes() for h in _headers(src)), flags])
    digest = hashlib.sha256(text).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names: Sequence[str] = KERNELS) -> Dict[str, str]:
    """Compile every missing library, one ``nvcc`` per source, all started
    together. Returns ``{name: compiler output}`` for the sources it built.
    Raises ``RuntimeError`` with the compiler's output on failure."""
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        # build under a process-unique name, then rename: a concurrent
        # loader never sees a half-written library
        final = _lib_path(n)
        tmp = final.with_name(f"{final.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, final)
    logs, failed = {}, []
    for n, (p, tmp, final) in procs.items():
        out, _ = p.communicate()
        logs[n] = out
        if p.returncode != 0:
            failed.append(f"--- nvcc {n}.cu (exit {p.returncode}) ---\n{out}")
            continue
        os.replace(tmp, final)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    lib: Optional[ctypes.CDLL] = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib
