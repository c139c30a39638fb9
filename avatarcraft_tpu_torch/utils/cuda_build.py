"""Build the hand-written sources of ``csrc/`` and load them with ctypes (a
plain C interface: no PyTorch headers, so a build takes seconds): each
``.cu`` kernel with nvcc for sm_90a, each ``.cpp`` host library (the mesh
extractor) with g++ as the JAX package's utils/native.py builds its copy.

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
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")


def nvcc_path() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def gxx_path() -> str:
    return shutil.which("g++") or "/usr/bin/g++"


def source_path(name: str) -> str:
    """csrc/<name>.cu, else the host source csrc/<name>.cpp."""
    cu = os.path.join(CSRC_DIR, f"{name}.cu")
    return cu if os.path.isfile(cu) else os.path.join(CSRC_DIR, f"{name}.cpp")


def library_path(name: str) -> str:
    with open(source_path(name), "rb") as fp:
        digest = hashlib.sha256(fp.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def nvcc_command(name: str, out: str) -> list[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", out, source_path(name)]


def gxx_command(name: str, out: str) -> list[str]:
    return [gxx_path(), *GXX_FLAGS, source_path(name), "-o", out]


def build_command(name: str, out: str) -> list[str]:
    """g++ for a .cpp source, nvcc for a .cu kernel."""
    return gxx_command(name, out) if source_path(name).endswith(".cpp") else nvcc_command(name, out)


def build(names) -> dict:
    """Compile every named source that is not built yet, all compiler
    processes started together, each into a temporary file renamed into
    place (processes that build at once each rename a whole library).
    Returns {name: seconds spent building (0.0 if it was built already)};
    raises with the compiler's output if a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        lib = library_path(name)
        if os.path.isfile(lib):
            continue
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = build_command(name, tmp)
        if not os.path.isfile(cmd[0]):
            tool = os.path.basename(cmd[0])
            raise RuntimeError(f"cannot build {name}: {tool} not found on PATH or at {cmd[0]}")
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
            tmp,
            lib,
            time.perf_counter(),
        )
    seconds = {name: 0.0 for name in names}
    failures = []
    for name, (proc, tmp, lib, t0) in procs.items():
        tool = os.path.basename(proc.args[0])
        try:
            log, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            failures.append(f"{name}: {tool} timed out after {NVCC_TIMEOUT_S} s")
        else:
            seconds[name] = time.perf_counter() - t0
            if proc.returncode == 0:
                os.replace(tmp, lib)
                continue
            failures.append(f"{name}: {tool} exit {proc.returncode}\n{log.decode(errors='replace')}")
        if os.path.exists(tmp):
            os.remove(tmp)
    if failures:
        raise RuntimeError("build failed:\n" + "\n".join(failures))
    return seconds


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The built library (built first if needed), loaded once per process."""
    build([name])
    return ctypes.CDLL(library_path(name))
