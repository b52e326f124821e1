"""Build the CUDA sources under ``csrc/`` into shared libraries and load them.

``csrc/{name}.cu`` has a plain C interface and is compiled with ``nvcc`` for
Hopper (``sm_90a``) into ``lib{name}_{hash}.so``, loaded with ``ctypes``.
The hash covers the source and the flags, so an edited source rebuilds at
its first use.  The build directory is ``kernels/_build`` in the package
(listed in ``.gitignore``), or ``$MAUA_TORCH_BUILD_DIR``.  ``build`` starts
one ``nvcc`` per missing library, all at once; a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG_DIR, "csrc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")


def build_dir() -> str:
    return os.environ.get("MAUA_TORCH_BUILD_DIR") or os.path.join(_PKG_DIR, "kernels", "_build")


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (needed to build the CUDA kernels); put the CUDA toolkit's bin on PATH or set CUDA_HOME")


def library_path(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(build_dir(), f"lib{name}_{digest}.so")


def build(names) -> dict[str, float]:
    """Compile every missing library of ``names`` in parallel; returns the
    wall seconds each build took (0 for a library already built)."""
    started = {}
    for name in names:
        path = library_path(name)
        if os.path.exists(path):
            continue
        os.makedirs(build_dir(), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, path, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, path, t0) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/{name}.cu``, compiled first if it is missing."""
    build([name])
    return ctypes.CDLL(library_path(name))
