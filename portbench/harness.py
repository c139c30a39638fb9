"""The general run of a cell: find its files by name, set up its job, time
the window, check the timed path against the reference, read the metrics
and print the result. See ``portbench/run.py`` for the command."""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time

# loaded by no run: compared by the top-level name of every module
FORBIDDEN = ("jax", "jaxlib", "flax", "avatarcraft_tpu")


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level names among ``names`` (default: the modules
    loaded in this process), each compared whole: ``avatarcraft_tpu_torch``
    is not ``avatarcraft_tpu``."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


# -- finding a cell's files by name ---------------------------------------------


def _load_json(path: str) -> dict:
    with open(path) as fp:
        return json.load(fp)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    metrics_e2e: list
    metrics_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(root: str, name: str) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its
    configuration, traffic mix and limits, read from their files."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    base = os.path.join(root, "portbench")
    return Cell(
        name=name,
        chips=int(entry["chips"]),
        config=_load_json(os.path.join(root, conf["file"])),
        traffic=_load_json(os.path.join(base, "traffic", entry["traffic"] + ".json")),
        limits=_load_json(os.path.join(base, "limits", name + ".json")),
        metrics_e2e=[m for m in bench["end_to_end"] if _applies(m, name)],
        metrics_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def _load_file_module(path: str, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(root: str, name: str):
    """``portbench/metrics/<name>.py``, else the reader of the metric's
    kind, ``portbench/metrics/<kind>.py`` (the name up to its first dot:
    ``idle_share`` reads ``idle_share.train`` and ``idle_share.frame``):
    ``read(view)`` -> a number, or None where the run holds nothing to
    read."""
    base = os.path.join(root, "portbench", "metrics")
    path = os.path.join(base, name + ".py")
    if not os.path.isfile(path):
        path = os.path.join(base, name.split(".")[0] + ".py")
    return _load_file_module(path, "portbench_metric_" + name.replace(".", "_").replace("-", "_"))


def job_module(name: str):
    """``portbench/jobs/<name>.py``: ``build(ctx)`` -> the job a traffic
    mix names."""
    return importlib.import_module(f"portbench.jobs.{name}")


# -- the run's context and what the readers see -----------------------------


class Spans:
    """The benchmark's own host spans, kept in memory: (name, start, end)
    in seconds of ``time.perf_counter``; under a trace each is also a
    profiler range ``portbench.<name>``, so that the breakdown sees it."""

    def __init__(self):
        self.items: list = []
        self.traced = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = None
        if self.traced:
            from torch.profiler import record_function

            rf = record_function("portbench." + name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.items.append((name, t0, time.perf_counter()))
            if rf is not None:
                rf.__exit__(None, None, None)

    def seconds(self, name: str, since: float = float("-inf"), until: float = float("inf")) -> list[float]:
        """The durations of the spans called ``name`` begun from ``since``
        to before ``until``."""
        return [e - s for n, s, e in self.items if n == name and since <= s < until]


@dataclasses.dataclass
class Context:
    root: str
    cell: Cell
    seed: int
    device: object
    spans: Spans


@dataclasses.dataclass
class Traced:
    """One traced window: its length, the units it completed, the
    program's counters over it, the profiler's events and the device's."""

    window_s: float
    units: int
    counters: dict
    events: list
    dev_events: list
    busy_us: float


@dataclasses.dataclass
class View:
    """What a metric's reader reads: the untraced window's times, counts
    and spans; with ``--trace 1`` the CUDA-only trace (``cuda``) and the
    trace with the host's ranges (``full``)."""

    cell: Cell
    job: object
    device_name: str
    setup_s: float
    window_s: float
    window_start: float  # perf_counter at the window's start
    window_end: float
    units: int
    spans: Spans
    cuda: Traced | None = None
    full: Traced | None = None


# -- the run --------------------------------------------------------------------


def _err(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _card_ok(torch, chips: int) -> bool:
    if not torch.cuda.is_available():
        _err("portbench: torch.cuda.is_available() is false: no result")
        return False
    if torch.cuda.device_count() < chips:
        _err(f"portbench: {torch.cuda.device_count()} cards, the cell asks for {chips}: no result")
        return False
    return True


def power_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


@contextlib.contextmanager
def tf32(on: bool):
    """The process's TF32 switches for matrix products and cuDNN, restored
    after: off for the reference, on for its lower-precision control."""
    import torch

    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _free(torch) -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


# a --trace 1 run traces this many seconds twice after its untraced window:
# the card's activity alone, then with the host's ranges (reading a trace
# costs about ten seconds for each traced second)
TRACE_SECONDS = 4.0


def time_window(job, seconds: float, sync) -> tuple[int, float, float]:
    """(units, start, end): the job's calls, the next after the last
    returns, until ``seconds`` have passed; the window ends in a
    synchronize."""
    units = 0
    sync()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        units += job.run_one()
    sync()
    return units, t0, time.perf_counter()


def traced_window(job, seconds: float, sync, spans: Spans, host: bool) -> Traced:
    """A window of ``seconds`` under torch.profiler: the card's activity
    alone, or with ``host`` the host's ops and ranges too."""
    from torch.profiler import ProfilerActivity, profile

    from portbench import trace as tr

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    before = job.counters()
    spans.traced = host
    with profile(activities=acts) as p:
        units, t0, t1 = time_window(job, seconds, sync)
    spans.traced = False
    after = job.counters()
    t2 = time.perf_counter()
    events = list(p.events())
    dev = tr.device_events(events)
    _err(f"portbench: a {'full' if host else 'CUDA-only'} trace of {t1 - t0:.2f} s, {len(events)} events read in "
         f"{time.perf_counter() - t2:.1f} s")
    return Traced(window_s=t1 - t0, units=units, counters={k: after[k] - before.get(k, 0) for k in after},
                  events=events, dev_events=dev, busy_us=tr.busy_us(dev))


def read_metrics(root: str, metrics: list, view: View) -> dict:
    out = {}
    for m in metrics:
        value = metric_reader(root, m["name"]).read(view)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def reference_numbers(job, torch) -> tuple[dict, dict]:
    """(the comparison of the program's witness with the reference's, the
    reference's witness): the reference runs in full f32, TF32 off."""
    with tf32(False):
        ref = job.reference("f32")
    _free(torch)
    return job.compare(job.witness, ref), ref


def run_cell(root: str, cell: Cell, seed: int, seconds: float, trace: bool, t_process: float, device):
    """(result, [(name, number, limit)]) of one run of ``cell`` on
    ``device``."""
    import torch

    from portbench import counts, trace as tr
    from portbench.compare import judge

    on_card = torch.device(device).type == "cuda"
    spans = Spans()
    ctx = Context(root=root, cell=cell, seed=seed, device=device, spans=spans)
    job = job_module(cell.traffic["job"]).build(ctx)
    job.warm()
    counts.sync(device)
    setup_s = time.perf_counter() - t_process

    def sync():
        counts.sync(device)

    units, t0, t1 = time_window(job, seconds, sync)
    view = View(cell=cell, job=job, device_name=torch.cuda.get_device_name(0) if on_card else "cpu",
                setup_s=setup_s, window_s=t1 - t0, window_start=t0, window_end=t1, units=units, spans=spans)
    if trace:
        view.cuda = traced_window(job, min(seconds, TRACE_SECONDS), sync, spans, host=False)
        view.full = traced_window(job, min(seconds, TRACE_SECONDS), sync, spans, host=True)
    attempted, failed = job.finish()
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(cell.chips)) if on_card else 0

    job.release()
    _free(torch)
    t2 = time.perf_counter()
    numbers, _ = reference_numbers(job, torch)
    correct, rows = judge(numbers, cell.limits)
    t3 = time.perf_counter()
    metrics = read_metrics(root, cell.metrics_layer if trace else cell.metrics_e2e, view)
    _err(f"portbench: the reference in {t3 - t2:.1f} s, the metrics read in {time.perf_counter() - t3:.1f} s")
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": view.device_name, "count": cell.chips,
                   "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct and units > 0), "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = view.cuda.busy_us / 1e6
        device_info["window_s"] = view.cuda.window_s
        ops = tr.breakdown(view.cuda.events, view.cuda.dev_events)["device_ops"]
        result["breakdown"] = {"device_ops": ops,
                               "idle_gaps": tr.breakdown(view.full.events, view.full.dev_events)["idle_gaps"]}
        _err(f"portbench: traced busy {view.cuda.busy_us / 1e6:.3f} s of {view.cuda.window_s:.3f} s "
             f"({view.cuda.units} {job.unit}s); full trace {view.full.units} {job.unit}s in "
             f"{view.full.window_s:.3f} s")
    _err(f"portbench: {cell.name} seed {seed}: {units} {job.unit}s in {t1 - t0:.3f} s, set-up {setup_s:.3f} s")
    return result, rows


def run_main(root: str, workload: str, seed: int, seconds: float, trace: bool, t_process: float) -> int:
    cell = find_cell(root, workload)
    import torch

    if not _card_ok(torch, cell.chips):
        return 2
    result, rows = run_cell(root, cell, seed, seconds, trace, t_process, torch.device("cuda", 0))
    if trace:
        _err(f"portbench: card {power_line()}")
    bad = forbidden_modules()
    if bad:
        _err(f"portbench: forbidden modules loaded in this process: {', '.join(bad)}; no result")
        return 3
    result["compared"] = {name: {"value": value, "limit": limit} for name, value, limit in rows}
    for name, value, limit in rows:
        _err(f"compared {name} {value!r} limit {limit!r}")
    print(json.dumps(result), flush=True)
    return 0


def check_cell(root: str, cell: Cell, seed: int, device) -> dict:
    """The readings of one seed: the program's first steps (or frames) and
    its witness against the reference in f32 ("program"), a second run of
    the reference against the first ("reference_again"), the reference
    with TF32 on against it ("control"), and each planted fault of the job
    ("fault.<name>")."""
    import torch

    job = job_module(cell.traffic["job"]).build(Context(root=root, cell=cell, seed=seed, device=device,
                                                        spans=Spans()))
    job.warm()
    for _ in range(job.check_units):
        job.run_one()
    job.finish()
    job.release()
    _free(torch)
    readings, ref = reference_numbers(job, torch)
    out = {"program": readings}
    if isinstance(ref, dict) and "change" in ref:  # where the widest gaps lie
        from portbench.compare import leaf_gaps

        _err(f"portbench: seed {seed}: change {leaf_gaps(job.witness['change'], ref['change'])[:4]}; grad "
             f"{leaf_gaps(job.witness['grad'], ref['grad'])[:3]}; losses {job.witness['losses']} against "
             f"{ref['losses']}")
    with tf32(False):  # the reference against itself: what the card's f32 kernels vary from run to run
        again = job.reference("f32")
    out["reference_again"] = job.compare(again, ref)
    del again
    _free(torch)
    with tf32(True):
        control = job.reference("lower")
    out["control"] = job.compare(control, ref)
    del control
    _free(torch)
    for fault in job.faults:
        with tf32(False):
            planted = job.reference(fault)
        out["fault." + fault] = job.compare(planted, ref)
        del planted
        _free(torch)
    return out


def check_main(root: str, workload: str, seeds: list[int]) -> int:
    """``check_cell`` for each seed, one JSON line a seed, then the
    program's largest reading of each number and the control's and each
    fault's smallest."""
    cell = find_cell(root, workload)
    import torch

    if not _card_ok(torch, cell.chips):
        return 2
    worst: dict = {}
    for seed in seeds:
        t0 = time.perf_counter()
        out = check_cell(root, cell, seed, torch.device("cuda", 0))
        print(json.dumps({"seed": seed, "seconds": time.perf_counter() - t0, **out}), flush=True)
        for kind, nums in out.items():
            pick = max if kind in ("program", "reference_again") else min
            for k, v in nums.items():
                key = f"{kind}.{k}"
                worst[key] = v if key not in worst else pick(worst[key], v)
        _free(torch)
    if forbidden_modules():
        _err(f"portbench: forbidden modules loaded: {forbidden_modules()}")
        return 3
    print(json.dumps({"workload": workload, "seeds": seeds, "readings": worst}), flush=True)
    return 0
