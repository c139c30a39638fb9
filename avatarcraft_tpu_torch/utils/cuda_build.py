"""Build the hand-written CUDA kernels of ``csrc/`` with nvcc and load them
with ctypes (a plain C interface: no PyTorch headers, so a build takes
seconds).

Libraries go to ``avatarcraft_tpu_torch/_build/`` (listed in .gitignore),
named by a hash of their source, so an edited source is rebuilt and two
processes never load a half-written file. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
NVCC_TIMEOUT_S = 300


def nvcc_path() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def library_path(name: str) -> str:
    with open(source_path(name), "rb") as fp:
        digest = hashlib.sha256(fp.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def nvcc_command(name: str, out: str) -> list[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", out, source_path(name)]


def build(names) -> dict:
    """Compile every named kernel that is not built yet, all nvcc processes
    started together. Returns {name: seconds spent building (0.0 if it was
    built already)}; raises with nvcc's output if a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        lib = library_path(name)
        if os.path.isfile(lib):
            continue
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = nvcc_command(name, tmp)
        if not os.path.isfile(cmd[0]):
            raise RuntimeError(f"cannot build {name}: nvcc not found on PATH or at {cmd[0]}")
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
            tmp,
            lib,
            time.perf_counter(),
        )
    seconds = {name: 0.0 for name in names}
    failures = []
    for name, (proc, tmp, lib, t0) in procs.items():
        try:
            log, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            failures.append(f"{name}: nvcc timed out after {NVCC_TIMEOUT_S} s")
            continue
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exit {proc.returncode}\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, lib)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The built kernel library (built first if needed), loaded once per
    process."""
    build([name])
    return ctypes.CDLL(library_path(name))
