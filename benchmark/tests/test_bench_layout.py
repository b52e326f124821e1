"""The benchmark's files: every configuration, traffic mix, cell and metric
named in BENCHMARK.json has its file and parses, each cell's limits are
numbers its judge returns, and a cell, a mix and a metric, and a
configuration with its own architecture, judge, fault and kernel bound,
added as new files (in a copy) are found by name and run, by the harness
and by the benchmark's own tests, without an edit to any file already
there."""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import textwrap
from xml.etree import ElementTree

import pytest

from benchmark import flops, harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = harness.benchmark_spec(ROOT)


def test_top_level_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and 1 <= SPEC["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_loads_with_its_files(cell):
    c = harness.load_cell(ROOT, cell)
    assert c["chips"] in (1, 4)
    assert os.path.exists(os.path.join(BENCH, "runners", f"{c['traffic']['runner']}.py"))
    limits = c["check"]["limits"]
    judge = harness.judge_module(harness.judge_name(c))
    assert set(limits) <= set(judge.NUMBERS) and set(getattr(judge, "REQUIRED", ())) <= set(limits)
    assert all(0 < v for v in limits.values())
    if harness.judge_name(c) == "style":
        assert c["check"]["compare_iters"] >= 1
    # every cell reports setup_s, another end-to-end metric and a per-layer one
    e2e = [m["name"] for m in harness.metrics_for(SPEC, cell, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.metrics_for(SPEC, cell, "per_layer")


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_each_config_file_holds_what_it_lists(cfg):
    data = harness.read_json(os.path.join(ROOT, cfg["file"]))
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert set(cfg["reduced"]) <= set(data) and data["reduced"] == cfg["reduced"]


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
def test_each_metric_has_a_reader(metric):
    assert callable(harness.reader(metric).read)


def test_a_limit_its_judge_does_not_return_is_refused(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    path = root / "benchmark" / "workloads" / "vgg19.2048.json"
    check = json.loads(path.read_text())
    check["limits"]["flow_gap"] = 1e-3
    path.write_text(json.dumps(check))
    with pytest.raises(SystemExit, match="flow_gap"):
        harness.load_cell(str(root), "vgg19.2048", bench_dir=str(root / "benchmark"))


def test_core_files_name_no_cell_mix_or_metric():
    """The harness finds every cell, mix, metric, judge and fault by the
    name in BENCHMARK.json or a configuration: none of its own files names
    one (beside the default judge, ``style``)."""
    names = {w["name"] for w in SPEC["workloads"]} | {w["traffic"] for w in SPEC["workloads"]}
    names |= {m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    names |= {j for j in harness.judge_names() if j != "style"}
    names |= {f for j in harness.judge_names() for f in getattr(harness.judge_module(j), "FAULTS", {})}
    for f in ("harness.py", "run.py", "check.py", "instrument.py", "calibrate.py"):
        text = open(os.path.join(BENCH, f)).read()
        assert not [n for n in names if re.search(rf"['\"]{re.escape(n)}['\"]", text)], f


# A configuration whose reference is not the Gram-style one: the program's
# cost volume (ops.correlation) of two seeded feature maps, judged by a
# plain cost volume, with a number, a fault and a kernel bound of its own.
TOY_RUNNER = '''
"""Runner ``toycorr``: the program's cost volume of two seeded feature maps."""
import torch

from .. import flops, inputs


def tiny(traffic, config):
    return dict(traffic)  # already a CPU size


class Runner:
    def __init__(self, cell, seed, device, workdir, precision=None, warm=True):
        self.cfg, self.traffic, self.device = cell["config"], cell["traffic"], torch.device(device)
        b, (h, w) = self.traffic["batch"], self.traffic["hw"]
        gen = inputs.generator(seed, self.device, 0)
        self.f1, self.f2 = torch.randn((2, b, self.cfg["channels"], h, w), generator=gen, device=self.device)
        self.launches = []
        if warm:
            self.unit("warmup")

    def host_spans(self):
        from maua_style_tpu_torch.ops import correlation

        def shapes(fn, f1, f2, max_disp, stride=1):
            self.launches.append((*f1.shape, (2 * max_disp // stride + 1) ** 2))
            return fn(f1, f2, max_disp, stride)

        return [(correlation, "correlation", shapes)]

    def unit(self, index):
        from maua_style_tpu_torch.ops import correlation

        out = correlation.correlation(self.f1, self.f2, self.cfg["max_disp"])
        bound = {"correlation": sum(flops.correlation_bound_s(*s) for s in self.launches)} if self.launches else {}
        self.launches.clear()
        h, w = self.traffic["hw"]
        return {"images": 1, "iters": 1, "mp_iters": h * w / 1e6, "flops": 0.0, "answer": out.cpu(), "bound_s": bound}

    def release(self):
        pass

    def reference_scales(self, answer):
        return {"f1": self.f1.cpu(), "f2": self.f2.cpu(), "out": answer}
'''
TOY_JUDGE = '''
"""Judge ``toycorr``: a plain cost volume against the program's."""
import torch
import torch.nn.functional as F

NUMBERS = ("corr_gap",)
REQUIRED = ("corr_gap",)


def _zero(fn, *a, **kw):
    return torch.zeros_like(fn(*a, **kw))


def _zero_volume():
    from maua_style_tpu_torch.ops import correlation

    return [(correlation, "correlation", _zero)]


FAULTS = {"zero_volume": _zero_volume}
SHARED_FAULTS = ()  # no optimiser, no engine answer: none of faults.py's reaches it


def judge(cell, runner_answer, seed, device):
    f1, f2, out = (runner_answer[k].double() for k in ("f1", "f2", "out"))
    d, (h, w) = cell["config"]["max_disp"], f1.shape[2:]
    pad = F.pad(f2, (d, d, d, d))
    want = torch.stack([(f1 * pad[:, :, y : y + h, x : x + w]).mean(1)
                        for y in range(2 * d + 1) for x in range(2 * d + 1)], 1)
    gap = float((out - want).abs().max() / want.abs().max())
    return {"corr_gap": gap, "rows": [{"shape": list(out.shape), "corr_gap": gap}]}
'''
TOY_METRIC = '''
def read(run):
    t = run.trace
    us = sum(v for k, v in t["kernel_us"].items() if "corr" in k) if t else 0.0
    if us <= 0 or "correlation" not in t["bound_s"]:
        return None
    return 100.0 * t["bound_s"]["correlation"] / (us / 1e6)
'''
# run in the copy: the sound run and the faulted one through harness.run,
# then the profiled unit's bound_s and the metric that reads it beside the
# trace's kernel_us (a CPU profile holds no device kernel: one is put in)
TOY_SCRIPT = '''
import json, os, sys
sys.path.insert(0, os.getcwd())
import torch
from benchmark import faults, harness
from benchmark.instrument import patched

torch.set_num_threads(2)
cell = harness.load_cell(".", "toyflow.small")
out = {}
for fault in (None, "zero_volume"):
    with patched(*(faults.patches(fault) if fault else [])):
        r, numbers = harness.run(cell, 2**31 + 11, 0.05, False, "cpu")
    out[str(fault)] = harness.result(".", cell, r, numbers, False, "cpu")
rn = harness.runner(cell["traffic"]).Runner(cell, 5, "cpu", ".", warm=False)
summary = harness.profiled_unit(rn, rn.host_spans(), [], torch.device("cpu"))
summary["kernel_us"]["corr_forward_kernel"] = 2.0
run = harness.Run(cell)
run.trace = summary
out["bound_s"] = summary["bound_s"]
out["roofline"] = harness.reader("toy_roofline").read(run)
print(json.dumps(out))
'''


def _digests(top) -> dict:
    return {str(p.relative_to(top)): hashlib.sha256(p.read_bytes()).hexdigest() for p in top.rglob("*") if p.is_file()}


def _add_toy(bench, spec: dict) -> None:
    """Adds to the copy ``bench`` a configuration with an architecture of
    its own (not in nets.TABLES), its judge, number, fault, runner, mix,
    cell and kernel-bound metric, and their entries to ``spec``."""
    (bench / "configs" / "toyflow.json").write_text(json.dumps({
        "name": "toyflow", "source": "https://arxiv.org/abs/1709.02371", "arch": "toycorr", "judge": "toycorr",
        "channels": 8, "max_disp": 2, "reduced": []}))
    (bench / "judges" / "toycorr.py").write_text(textwrap.dedent(TOY_JUDGE))
    (bench / "runners" / "toycorr.py").write_text(textwrap.dedent(TOY_RUNNER))
    (bench / "traffic" / "toycorr_small.json").write_text(json.dumps({"runner": "toycorr", "batch": 2, "hw": [6, 10]}))
    (bench / "workloads" / "toyflow.small.json").write_text(json.dumps({"limits": {"corr_gap": 1e-6}}))
    (bench / "metrics" / "toy_roofline.py").write_text(textwrap.dedent(TOY_METRIC))
    spec["configs"].append({"name": "toyflow", "source": "https://arxiv.org/abs/1709.02371",
                            "file": "benchmark/configs/toyflow.json", "reduced": [], "why": "a test's configuration"})
    spec["workloads"].append({"name": "toyflow.small", "config": "toyflow", "traffic": "toycorr_small", "chips": 1,
                              "why": "a test's cell"})
    spec["per_layer"].append({"name": "toy_roofline", "unit": "%", "better": "higher", "source": "device_trace",
                              "layer": "kernels", "moves": "mpix_it_per_s", "workloads": ["toyflow.small"]})
    for m in spec["end_to_end"]:
        if m["name"] == "mpix_it_per_s":
            m["workloads"].append("toyflow.small")


def _copy(tmp_path):
    """A checkout in ``tmp_path`` with this benchmark's files: (its root,
    its benchmark directory, a copy of BENCHMARK.json's contents)."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    return root, root / "benchmark", json.loads(json.dumps(SPEC))


def test_new_cell_mix_and_metric_are_files_of_their_own(tmp_path):
    root, bench, spec = _copy(tmp_path)
    before = _digests(bench)
    (bench / "traffic" / "scale_tiny.json").write_text(json.dumps({"runner": "scale", "hw": [48, 48], "iters": 3,
                                                                    "warmup_iters": 1}))
    (bench / "workloads" / "vgg19.tiny.json").write_text(json.dumps({"compare_iters": 2, "limits": {
        "loss_gap": 1e-3, "answer_gap": 1.0}}))
    (bench / "metrics" / "iters_per_unit.py").write_text("def read(run):\n    return run.units[0]['iters']\n")
    spec["workloads"].append({"name": "vgg19.tiny", "config": "vgg19", "traffic": "scale_tiny", "chips": 1,
                              "why": "a test's cell"})
    spec["per_layer"].append({"name": "iters_per_unit.tiny", "unit": "it", "better": "higher", "source": "host_clock",
                              "layer": "engine loop", "moves": "mpix_it_per_s", "workloads": ["vgg19.tiny"]})
    for m in spec["end_to_end"]:
        if m["name"] == "mpix_it_per_s":
            m["workloads"].append("vgg19.tiny")
    _add_toy(bench, spec)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.load_cell(str(root), "vgg19.tiny", bench_dir=str(bench))
    assert cell["traffic"]["hw"] == [48, 48] and cell["config"]["arch"] == "vgg19"
    listed = [m["name"] for m in harness.metrics_for(spec, "vgg19.tiny", "per_layer")]
    assert listed == ["iters_per_unit.tiny"]
    run = harness.Run(cell)
    run.units = [{"iters": 3}]
    assert harness.reader("iters_per_unit.tiny", bench_dir=str(bench)).read(run) == 3

    env = {**os.environ, "PYTHONPATH": ROOT, "PYTHONDONTWRITEBYTECODE": "1"}
    proc = subprocess.run([sys.executable, "-c", TOY_SCRIPT], cwd=root, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    sound, faulted = out["None"], out["zero_volume"]
    assert sound["correct"] and sound["check"]["corr_gap"]["value"] <= 1e-6, sound
    assert set(sound["metrics"]) == {"mpix_it_per_s", "setup_s"}
    assert not faulted["correct"] and faulted["check"]["corr_gap"]["value"] == pytest.approx(1.0), faulted
    want = flops.correlation_bound_s(2, 8, 6, 10, 25)
    assert out["bound_s"] == {"correlation": pytest.approx(want, rel=1e-12)}
    assert out["roofline"] == pytest.approx(100.0 * want / 2e-6, rel=1e-12)
    # every file that was in the copy is unchanged, byte for byte
    after = _digests(bench)
    assert {k: after.get(k) for k in before} == before


# the benchmark's own tests of every cell, as the copy's files find it
COPY_TESTS = ["benchmark/tests/test_bench_faults.py", "benchmark/tests/test_bench_reference.py",
              "benchmark/tests/test_bench_layout.py::test_each_cell_loads_with_its_files"]


def test_benchmark_tests_take_a_configuration_with_its_own_judge(tmp_path):
    """The copy's own fault, reference and layout tests, run on the toy
    cell: its tiny size comes from its runner's ``tiny``, its cases are its
    judge's faults and no other, and no style-judge case is made for it."""
    root, bench, spec = _copy(tmp_path)
    before = _digests(bench)
    _add_toy(bench, spec)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    report = tmp_path / "report.xml"
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}
    env.update(PYTHONPATH=ROOT, PYTHONDONTWRITEBYTECODE="1")
    proc = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "--rootdir", str(root),
                           "-k", "toyflow", f"--junitxml={report}", *COPY_TESTS],
                          cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    outcomes = {}
    for case in ElementTree.parse(report).iter("testcase"):
        failed = [c.tag for c in case if c.tag in ("failure", "error", "skipped")]
        outcomes[case.get("name")] = failed[0] if failed else "passed"
    assert outcomes == {
        "test_fault_comes_out_not_correct[toyflow.small-sound]": "passed",
        "test_fault_comes_out_not_correct[toyflow.small-zero_volume]": "passed",
        "test_each_cell_loads_with_its_files[toyflow.small]": "passed",
    }
    after = _digests(bench)
    assert {k: after.get(k) for k in before} == before
