"""The compiler's report on the port's CUDA kernels: ``nvcc -Xptxas -v``
(registers, shared memory, spills) and the count of each SASS opcode in
each kernel function (``cuobjdump -sass``).

    python3 -m avatarcraft_tpu_torch.compiler_report                  # every kernel of csrc/
    python3 -m avatarcraft_tpu_torch.compiler_report all_gather_rows  # one

Needs the CUDA toolkit (nvcc, cuobjdump), no card. Prints one JSON line per
kernel source.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess

from avatarcraft_tpu_torch.parallel import ring
from avatarcraft_tpu_torch.utils import cuda_build

_SASS_OP = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9]*)")


def report(name: str) -> dict:
    """ptxas's lines for the source ``csrc/<name>.cu`` and, for each kernel
    function in it, its SASS opcodes with their counts."""
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    lib = os.path.join(cuda_build.BUILD_DIR, f"{name}-report-{os.getpid()}.so")
    try:
        res = subprocess.run(cuda_build.nvcc_command(name, lib) + ["-Xptxas", "-v"], capture_output=True,
                             text=True, timeout=cuda_build.NVCC_TIMEOUT_S, check=True)
        cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True, timeout=120,
                              check=True).stdout
    finally:
        if os.path.exists(lib):
            os.remove(lib)
    functions = {}
    for part in sass.split("Function : ")[1:]:
        fn, _, body = part.partition("\n")
        ops = collections.Counter(m.group(1) for m in _SASS_OP.finditer(body))
        functions[fn.strip()] = dict(ops.most_common())
    ptxas = [ln.strip() for ln in (res.stdout + res.stderr).splitlines() if "ptxas" in ln]
    return {"source": os.path.relpath(cuda_build.source_path(name)), "ptxas": ptxas, "sass_ops": functions}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="nvcc -Xptxas -v and SASS opcode counts of the port's kernels")
    ap.add_argument("names", nargs="*", default=[ring.KERNEL, ring.RS_KERNEL], help="kernel sources in csrc/")
    for name in ap.parse_args(argv).names:
        print(json.dumps(report(name)), flush=True)


if __name__ == "__main__":
    main()
