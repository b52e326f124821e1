"""Build the CUDA sources under ``csrc/`` into shared libraries and load them.

``csrc/{name}.cu`` has a plain C interface and is compiled with ``nvcc`` for
Hopper (``sm_90a``) into ``lib{name}_{hash}.so``, loaded with ``ctypes``.
A source may be compiled in variants, each with its own ``-D`` defines (the
cost-volume kernel fixes its displacement stride and register blocking at
compile time).  The hash covers the source, the flags and the defines, so an
edited source rebuilds at its first use.  The build directory is
``kernels/_build`` in the package (listed in ``.gitignore``), or
``$MAUA_TORCH_BUILD_DIR``.  ``build`` starts one ``nvcc`` per missing
library, all at once; a failed build raises.
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


def _spec(item) -> tuple[str, tuple[str, ...]]:
    """A library: ``name`` or ``(name, defines)``, defines as ``"KEY=VALUE"``."""
    return (item, ()) if isinstance(item, str) else (item[0], tuple(item[1]))


def nvcc_command(name: str, defines=(), out: str = "") -> list[str]:
    return [nvcc_path(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", out, os.path.join(CSRC, f"{name}.cu")]


def library_path(name: str, defines=()) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join((*NVCC_FLAGS, *defines)).encode()).hexdigest()[:16]
    return os.path.join(build_dir(), f"lib{name}_{digest}.so")


def build(items) -> dict[str, float]:
    """Compile every missing library of ``items`` (each ``name`` or
    ``(name, defines)``) in parallel; returns the wall seconds each build
    took (0 for a library already built), keyed by its file name."""
    started = {}
    for item in items:
        name, defines = _spec(item)
        path = library_path(name, defines)
        if os.path.exists(path) or path in started:
            continue
        os.makedirs(build_dir(), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.Popen(nvcc_command(name, defines, tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        started[path] = (name, proc, tmp, time.perf_counter())
    seconds = {os.path.basename(library_path(*_spec(item))): 0.0 for item in items}
    failed = []
    for path, (name, proc, tmp, t0) in started.items():
        log, _ = proc.communicate()
        seconds[os.path.basename(path)] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return seconds


def load(name: str, defines=()) -> ctypes.CDLL:
    """The library of ``csrc/{name}.cu`` with ``defines``, compiled first if
    it is missing."""
    build([(name, defines)])
    return ctypes.CDLL(library_path(name, defines))


def ptxas_report(name: str, defines=()) -> str:
    """What ``ptxas -v`` says of each kernel of a variant (registers, shared
    memory, spill stores and loads): one more ``nvcc`` with
    ``NVCC_FLAGS`` plus ``-Xptxas -v``, whose library is thrown away.
    Reports of several variants may run at once (each in its own file)."""
    os.makedirs(build_dir(), exist_ok=True)
    tmp = f"{library_path(name, defines)}.ptxas.{os.getpid()}.so"
    cmd = nvcc_command(name, defines, tmp)
    proc = subprocess.run([*cmd[:1], "-Xptxas", "-v", *cmd[1:]], capture_output=True, text=True)
    if os.path.exists(tmp):
        os.remove(tmp)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc -Xptxas -v failed for {name}.cu:\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr
