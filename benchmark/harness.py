"""The harness: finds a cell's parts by name and runs it once.

``BENCHMARK.json`` at the root of the checkout names each cell's
configuration and traffic mix.  ``configs/<config>.json`` holds the
configuration as it is run, ``traffic/<traffic>.json`` the mix's
parameters and the name of its runner, ``runners/<runner>.py`` the code
that drives the program, ``workloads/<cell>.json`` the limits of the
comparison that decides ``correct``, ``judges/<judge>.py`` that
comparison (the configuration's ``judge``; ``style`` where it names
none), and ``metrics/<name>.py`` (for a name with a suffix,
``metrics/<name before the first dot>.py``) the reader of each metric.
A later change adds a cell, a mix, a metric or a configuration with its
own reference as new files and new entries; nothing here names one.

A run: set-up (the runner's: weights, inputs, warm-up), then units (an
image, a call) back to back while the window lasts, starting another only
where the units so far say it ends within ``--seconds``; the window holds
whole units only.  With ``--trace 1`` one unit runs under
``torch.profiler`` before the window (its trace is read for the per-layer
numbers), and every unit of the window under the host instrumentation of
``instrument.py``.  After the window the program is freed and the
configuration's judge runs its reference over one unit drawn from the
seed."""

from __future__ import annotations

import importlib.util
import json
import math
import os
import random
import shutil
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from . import flops, instrument

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "maua_style_tpu")


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec(root: str) -> dict:
    return read_json(os.path.join(root, "BENCHMARK.json"))


def load_cell(root: str, name: str, bench_dir: str = HERE) -> dict:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration,
    traffic mix and limits read from their files."""
    spec = benchmark_spec(root)
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {[w['name'] for w in spec['workloads']]}")
    cfg = read_json(os.path.join(bench_dir, "configs", f"{entry['config']}.json"))
    traffic = read_json(os.path.join(bench_dir, "traffic", f"{entry['traffic']}.json"))
    cell = {**entry, "config": cfg, "traffic": traffic,
            "check": read_json(os.path.join(bench_dir, "workloads", f"{name}.json"))}
    judge = judge_module(judge_name(cell), bench_dir)
    limits, required = set(cell["check"]["limits"]), set(getattr(judge, "REQUIRED", ()))
    if not required <= limits <= set(judge.NUMBERS):
        raise SystemExit(f"{name}: limits {sorted(limits)}; judge {judge_name(cell)!r} returns "
                         f"{list(judge.NUMBERS)} and needs a limit on each of {sorted(required)}")
    return cell


def metrics_for(spec: dict, cell: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell`` reports:
    those that list it, and those without a list that apply to every cell
    (an end-to-end metric) or to every cell reporting the end-to-end
    metric they move (a per-layer one)."""
    e2e = [m for m in spec["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
    if kind == "end_to_end":
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"] if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def load_module(path: str, name: str):
    mod_spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(mod_spec)
    sys.modules[name] = module
    mod_spec.loader.exec_module(module)
    return module


def runner(traffic: dict):
    return load_module(os.path.join(HERE, "runners", f"{traffic['runner']}.py"), f"benchmark.runners.{traffic['runner']}")


def reader(metric: str, bench_dir: str = HERE):
    base = metric.split(".")[0]
    return load_module(os.path.join(bench_dir, "metrics", f"{base}.py"), f"benchmark.metrics.{base}")


def judge_name(cell: dict) -> str:
    return cell["config"].get("judge", "style")


def judge_module(name: str, bench_dir: str = HERE):
    """``judges/<name>.py``: ``NUMBERS`` (what it can return, the names a
    cell's limits may take), optionally ``REQUIRED`` (names every cell's
    limits must hold) and ``FAULTS`` ({fault: () -> ``patched`` targets}),
    and ``judge(cell, runner_answer, seed, device)`` -> {number: value,
    ``rows``: per-unit details}."""
    return load_module(os.path.join(bench_dir, "judges", f"{name}.py"), f"benchmark.judges.{name}")


def judge_names() -> list[str]:
    return sorted(f[:-3] for f in os.listdir(os.path.join(HERE, "judges")) if f.endswith(".py") and f != "__init__.py")


def process_age() -> float:
    """Seconds since this process started (``/proc/self/stat``)."""
    with open("/proc/self/stat") as f:
        start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def jax_modules() -> list[str]:
    """The JAX libraries or the JAX package among the loaded modules, by
    whole top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Run:
    """What the readers read: the cell, ``setup_s``, the window (seconds,
    units, peak bytes), the host measurements and the trace summary."""

    def __init__(self, cell: dict):
        self.cell = cell
        self.setup_s = None
        self.window_s = None
        self.units: list[dict] = []
        self.peak_bytes = 0
        self.between_scales_s: list[float] = []
        self.syncs: list[int] = []
        self.trace: dict | None = None


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _host_hooks(rn, device, gram_shapes: list) -> tuple[list, list]:
    """The traced run's patches: host ranges, the optimiser's range, each
    engine call's first and last step times, K1's input shapes."""
    from maua_style_tpu_torch.engine import LBFGS, Adam, StyleEngine
    from maua_style_tpu_torch.ops import gram as G

    calls: list[list] = []

    def each_call(fn, engine, *a, **kw):
        calls.append([])
        return fn(engine, *a, **kw)

    def steps(fn, engine, *a, **kw):
        _sync(device)
        t0 = time.perf_counter()
        with record_function(instrument.SPAN + "iterate"):
            out = fn(engine, *a, **kw)
        _sync(device)
        if calls:
            calls[-1].append((t0, time.perf_counter()))
        return out

    def shapes(fn, f):
        gram_shapes.append(tuple(f.shape))
        return fn(f)

    hooks = [(StyleEngine, "optimize", each_call), (StyleEngine, "_run", steps),
             (StyleEngine, "content_targets", instrument.labelled("capture")),
             (StyleEngine, "style_targets", instrument.labelled("capture")),
             (LBFGS, "update", instrument.labelled("optimizer")), (Adam, "update", instrument.labelled("optimizer")),
             (G._GramFn, "apply", shapes), *rn.host_spans()]
    return hooks, calls


def run(cell: dict, seed: int, seconds: float, traced: bool, device, precision: str | None = None) -> tuple[Run, dict]:
    """Set-up, window and check of one run; returns the readings and the
    check's numbers.  ``precision`` replaces the configuration's (the
    control runs the program with TF32 on)."""
    device = torch.device(device)
    rn_mod = runner(cell["traffic"])
    workdir = tempfile.mkdtemp(prefix="bench-")
    r = Run(cell)
    try:
        rn = rn_mod.Runner(cell, seed, device, workdir, precision)
        _sync(device)
        gram_shapes: list = []
        hooks, calls = _host_hooks(rn, device, gram_shapes) if traced else ([], [])
        if traced and device.type == "cuda":
            r.trace = profiled_unit(rn, hooks, gram_shapes, device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        r.setup_s = process_age()
        start = time.perf_counter()
        with instrument.patched(*hooks):
            while True:
                syncs: dict = {}
                n_calls = len(calls)
                if traced and device.type == "cuda":
                    with instrument.counting_syncs(syncs):
                        unit = rn.unit(len(r.units))
                else:
                    unit = rn.unit(len(r.units))
                _sync(device)
                r.units.append(unit)
                if traced:
                    r.syncs.append(syncs.get("total", 0))
                    mine = calls[n_calls:]
                    if len(mine) > 1:
                        r.between_scales_s.append(sum(b[0][0] - a[-1][1] for a, b in zip(mine, mine[1:])))
                elapsed = time.perf_counter() - start
                if elapsed + elapsed / len(r.units) > seconds:
                    break
        r.window_s = time.perf_counter() - start
        if device.type == "cuda":
            r.peak_bytes = torch.cuda.max_memory_allocated(device)
        sample = random.Random(seed).randrange(len(r.units))
        answer = r.units[sample]["answer"]
        for u in r.units:
            u.pop("answer", None)
        numbers = judge(cell, rn, answer, seed, device)
        numbers["sample"] = sample
        return r, numbers
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def profiled_unit(rn, hooks: list, gram_shapes: list, device) -> dict:
    """One unit under ``torch.profiler`` and the host ranges, before the
    window: ``instrument.summarize``'s numbers, with the unit's iterations,
    K1's least time over the launches it made, and ``bound_s``, the
    runner's {kernel: least seconds} from the launches its own
    ``host_spans`` recorded (empty where it reports none)."""
    with instrument.patched(*hooks):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(instrument.UNIT):
                unit = rn.unit("profiled")
                _sync(device)
    summary = instrument.summarize(prof)
    summary["iters"] = unit["iters"]
    summary["gram_bound_s"] = sum(flops.gram_bound_s(*s) for s in gram_shapes)
    summary["bound_s"] = unit.get("bound_s", {})
    gram_shapes.clear()
    return summary


def judge(cell: dict, rn, answer, seed: int, device) -> dict:
    """Frees the program, then has the configuration's judge run its
    reference over ``answer``."""
    runner_answer = rn.reference_scales(answer)
    rn.release()
    del rn
    return judge_module(judge_name(cell)).judge(cell, runner_answer, seed, device)


def readings(cell: dict, seeds, device, precision: str | None = None):
    """One unit on each seed, each judged by the reference (no window, no
    metrics): yields (seed, numbers).  The first seed warms the shapes."""
    device = torch.device(device)
    rn_mod = runner(cell["traffic"])
    for i, seed in enumerate(seeds):
        workdir = tempfile.mkdtemp(prefix="bench-")
        try:
            rn = rn_mod.Runner(cell, seed, device, workdir, precision, warm=i == 0)
            answer = rn.unit(0)["answer"]
            yield seed, judge(cell, rn, answer, seed, device)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)


def verdict(cell: dict, numbers: dict) -> tuple[bool, dict]:
    """(correct, {number: {value, limit}}): each compared number within its
    limit."""
    limits = cell["check"]["limits"]
    out, ok = {}, True
    for name in limits:
        v = numbers[name]
        good = math.isfinite(v) and v <= limits[name]
        ok &= good
        out[name] = {"value": v if math.isfinite(v) else None, "limit": limits[name]}
    return ok, out


def result(root: str, cell: dict, r: Run, numbers: dict, traced: bool, device) -> dict:
    """The result line's object."""
    spec = benchmark_spec(root)
    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in metrics_for(spec, cell["name"], kind):
        value = reader(m["name"]).read(r)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct, compared = verdict(cell, numbers)
    device = torch.device(device)
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": r.peak_bytes}
    out = {"correct": correct, "attempted": len(r.units), "failed": 0 if correct else 1, "metrics": metrics,
           "device": dev}
    if traced and r.trace is not None:
        dev["busy_s"] = r.trace["busy_us"] / 1e6
        dev["window_s"] = r.trace["window_us"] / 1e6
        out["breakdown"] = {"device_ops": r.trace["device_ops"], "idle_gaps": r.trace["idle_gaps"]}
    out["check"] = compared
    return out
