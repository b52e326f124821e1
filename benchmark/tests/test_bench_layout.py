"""The benchmark's files: every configuration, traffic mix, cell and metric
named in BENCHMARK.json has its file and parses, and a cell, a mix and a
metric added as new files (in a copy) are found by name without an edit
to any file already there."""

from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from benchmark import harness

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
    assert c["chips"] == 1
    assert os.path.exists(os.path.join(BENCH, "runners", f"{c['traffic']['runner']}.py"))
    limits = c["check"]["limits"]
    assert "loss_gap" in limits and set(limits) <= {"loss_gap", "step_gap", "answer_gap", "last_gap", "host_gap"}
    assert all(0 < v for v in limits.values())
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


def test_core_files_name_no_cell_mix_or_metric():
    """The harness finds every cell, mix and metric by the name in
    BENCHMARK.json: none of its own files names one."""
    names = {w["name"] for w in SPEC["workloads"]} | {w["traffic"] for w in SPEC["workloads"]}
    names |= {m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    for f in ("harness.py", "run.py", "check.py", "instrument.py", "calibrate.py"):
        text = open(os.path.join(BENCH, f)).read()
        assert not [n for n in names if re.search(rf"['\"]{re.escape(n)}['\"]", text)], f


def test_new_cell_mix_and_metric_are_files_of_their_own(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    bench = root / "benchmark"
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
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.load_cell(str(root), "vgg19.tiny", bench_dir=str(bench))
    assert cell["traffic"]["hw"] == [48, 48] and cell["config"]["arch"] == "vgg19"
    listed = [m["name"] for m in harness.metrics_for(spec, "vgg19.tiny", "per_layer")]
    assert listed == ["iters_per_unit.tiny"]
    run = harness.Run(cell)
    run.units = [{"iters": 3}]
    assert harness.reader("iters_per_unit.tiny", bench_dir=str(bench)).read(run) == 3
    # the files already there are unchanged
    for sub in ("harness.py", "check.py", "runners/scale.py", "configs/vgg19.json"):
        assert (bench / sub).read_text() == open(os.path.join(BENCH, sub)).read()
