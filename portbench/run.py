"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python3 portbench/run.py --workload recon_scan.fast --seed 7 --seconds 30 --trace 0

Everything is found by name: the cell in BENCHMARK.json, its configuration
in ``portbench/configs/<config>.json``, its traffic mix in
``portbench/traffic/<traffic>.json`` (which names the job that drives it,
``portbench/jobs/<job>.py``), the limits of its correctness check in
``portbench/limits/<cell>.json`` and each per-layer metric's reader in
``portbench/metrics/<metric>.py``.

A run: set-up (the program's objects, the inputs and weights from
``--seed``, the first steps the reference follows, every shape warmed up),
then a window of ``--seconds`` that ends in a synchronize, then the check
of what the timed path produced against the plain reference
(``portbench/reference``), run once the program's state is freed. The last
line of standard output is the result; the numbers compared, each beside
its limit, are the last lines of standard error and the result's last key.

``--trace 1`` follows the window with two short traced ones (the card's
activity alone, then with the host's ranges) and reports the per-layer
metrics instead of the end-to-end ones. ``--check`` (not used by
the benchmark's own runs) reads the comparison's readings over several
seeds in one process: the program against the reference, the reference's
lower-precision control and the planted faults, for setting the limits.

Needs CUDA cards: without as many as the cell asks for, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()  # set-up is timed from here, before the heavy imports

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# every cache of the program inside the checkout, at fixed paths; a library
# that would load JAX by itself is kept from doing so
CACHE = os.path.join(ROOT, ".portbench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one cell of BENCHMARK.json")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--check", default="",
                    help="comma-separated seeds: read the comparison's readings (program, control, faults) "
                         "for each, in one process, instead of a timed run")
    args = ap.parse_args(argv)

    from portbench import harness

    if args.check:
        seeds = [int(s) for s in args.check.split(",") if s.strip()]
        return harness.check_main(ROOT, args.workload, seeds)
    return harness.run_main(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), T_PROCESS)


if __name__ == "__main__":
    sys.exit(main())
