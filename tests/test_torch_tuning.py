"""The port's capacity tuner (``tuning/max_sizes.py``) against the JAX
package's: with the port's constant table set to JAX's v5e literals the
footprint formula is byte for byte JAX's, the boundary search over one
fake bytes function gives equal tables, the frame sizing and the CLI's
JSON are equal, and vid_img's chunk choices are JAX's.  Then the port's own
fitted constants keep JAX's orderings, the refusals, and the measured
probe's CPU and out-of-memory paths."""

import argparse
import json

import pytest
import torch

from maua_style_tpu.pipelines import frame_loop as jax_frame_loop
from maua_style_tpu.tuning import max_sizes as jax_ms
from maua_style_tpu_torch.pipelines import frame_loop
from maua_style_tpu_torch.tuning import max_sizes as ms
from test_torch_threads import torch_threads_per_worker  # noqa: F401  (autouse: one torch thread pool per core)

V5E = {"activations": 2.1, "arch_fudge": {"prune": 2.1}, "lbfgs": {"compact": 5.3, "two_loop": 4.0},
       "lbfgs_pixels": 6, "slack": 64 * 1024 * 1024}
GIB = 1024 ** 3


@pytest.fixture
def v5e(monkeypatch):
    monkeypatch.setattr(ms, "CONSTANTS", V5E)


def test_defaults_equal():
    assert ms.DEFAULT_MODELS == jax_ms.DEFAULT_MODELS and ms.DEFAULT_OPTIMIZERS == jax_ms.DEFAULT_OPTIMIZERS
    for x in (0, 31.9, 32, 1000.5, 4095):
        assert ms._round32(x) == jax_ms._round32(x)
    for model in ms.DEFAULT_MODELS:
        a, b = ms._loss_cfg_for(model), jax_ms._loss_cfg_for(model)
        assert (a.content_layers, a.style_layers) == (b.content_layers, b.style_layers)


@pytest.mark.parametrize("model", ms.DEFAULT_MODELS)
def test_formula_is_jax_byte_for_byte(v5e, model):
    for optimizer in ("lbfgs", "adam"):
        for size in (256, 384, 512, 1000, 1024, 2048, 4096):
            for dtype in ("float32", "bfloat16"):
                for method in ("compact", "two_loop"):
                    for split in (False, True):
                        kw = dict(lbfgs_method=method, compute_dtype=dtype, _split_fixed=split)
                        assert ms.estimate_step_bytes(model, optimizer, size, **kw) == \
                            jax_ms.estimate_step_bytes(model, optimizer, size, **kw), (optimizer, size, kw)
        assert ms.estimate_step_bytes(model, "lbfgs", 768, lbfgs_history=20) == \
            jax_ms.estimate_step_bytes(model, "lbfgs", 768, lbfgs_history=20)


def _fake_bytes(oom_above=None):
    """bytes(s) affine in s², model and optimizer dependent; None (out of
    memory) above ``oom_above``."""
    def fake(model, optimizer, size, **_):
        if oom_above is not None and size > oom_above:
            return None
        per = {"lbfgs": 900.0, "adam": 210.0}[optimizer] * (1 + 0.1 * len(model))
        return int(per * size * size + 3e8)
    return fake


@pytest.mark.parametrize("case", ["budgets", "start_too_big", "seed_table", "oom_above", "raises"])
def test_search_equals_jax(monkeypatch, case):
    fake = _fake_bytes(oom_above=2400 if case == "oom_above" else None)
    if case == "raises":
        def fake(model, optimizer, size, **_):  # noqa: F811
            if size > 3000:
                raise RuntimeError("out of memory")
            return _fake_bytes()(model, optimizer, size)
    monkeypatch.setattr(jax_ms, "_compiled_step_bytes", fake)
    monkeypatch.setattr(ms, "measure_step_bytes", fake)
    runs = {
        "budgets": [dict(budget_bytes=b * GIB) for b in (4, 16, 80)],
        "start_too_big": [dict(budget_bytes=8 * GIB, start_size=8192)],
        "seed_table": [dict(budget_bytes=16 * GIB, seed_table={"vgg19,adam,1": {"safe_max_size": 5000},
                                                               "nin,lbfgs,1": {"safe_max_size": 700}})],
        "oom_above": [dict(budget_bytes=80 * GIB)],
        "raises": [dict(budget_bytes=80 * GIB)],
    }[case]
    for kw in runs:
        args = dict(models=("vgg19", "nin", "prune"), optimizers=("lbfgs", "adam"), method="analysis", verbose=False,
                    compute_dtype="float32", **kw)
        got, want = ms.probe_max_sizes(**args), jax_ms.probe_max_sizes(**args)
        assert got == want
        assert all(e["safe_max_size"] is not None for e in got.values())


def test_estimate_search_equals_jax(v5e):
    for budget in (4, 16, 80):
        kw = dict(models=ms.DEFAULT_MODELS, method="estimate", budget_bytes=budget * GIB, verbose=False)
        assert ms.probe_max_sizes(**kw) == jax_ms.probe_max_sizes(**kw)


def test_sizing_equals_jax(v5e):
    for hbm in (16 * GIB, 80 * GIB, 85 * 10 ** 9):
        for model in ("vgg19", "nin"):
            for optimizer in ("lbfgs", "adam"):
                for hw in ((288, 512), (576, 1024), (1080, 1920), (64, 64), (4096, 4096)):
                    for dtype in ("float32", "bfloat16"):
                        kw = dict(compute_dtype=dtype, hbm=hbm)
                        assert ms.frames_per_program(model, optimizer, hw, **kw) == \
                            jax_ms.frames_per_program(model, optimizer, hw, **kw)
                        assert ms.chain_frames_per_program(model, optimizer, hw, **kw) == \
                            jax_ms.chain_frames_per_program(model, optimizer, hw, **kw)
    assert ms.frames_per_program("vgg19", "lbfgs", (576, 1024), hbm=80 * GIB, cap=4) == \
        jax_ms.frames_per_program("vgg19", "lbfgs", (576, 1024), hbm=80 * GIB, cap=4)


def _args(**kw):
    base = dict(model_file="vgg19", optimizer="lbfgs", lbfgs_num_correction=100, lbfgs_method="compact",
                compute_dtype="float32", frame_batch=0, device=torch.device("cpu"))
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("kw", [{}, {"optimizer": "adam"}, {"compute_dtype": "bfloat16"}, {"model_file": "nin"},
                                {"lbfgs_num_correction": 5}, {"lbfgs_method": "two_loop"}, {"frame_batch": 3},
                                {"frame_batch": 1}])
def test_auto_chunks_equal_jax(v5e, kw):
    """On the CPU both packages budget 16 GiB (JAX's value for a device
    without memory statistics, and the port's for the CPU)."""
    args = _args(**kw)
    assert frame_loop._capacity_kwargs(args)["hbm"] == 16 * GIB
    for hw in ((16, 16), (288, 512), (576, 1024), (1080, 1920), (2160, 3840)):
        assert frame_loop._auto_frame_batch(hw, args.frame_batch, args) == \
            jax_frame_loop._auto_frame_batch(hw, args.frame_batch, args)
        assert frame_loop._auto_chain_k(hw, args) == jax_frame_loop._auto_chain_k(hw, args)


def test_cli_json_equals_jax(v5e, tmp_path, capsys):
    got, want = tmp_path / "port.json", tmp_path / "jax.json"
    ms.main(["--method", "estimate", "--hbm_gb", "16", "--out", str(got)])
    jax_ms.main(["--method", "estimate", "--hbm_gb", "16", "--out", str(want)])
    assert json.loads(got.read_text()) == json.loads(want.read_text())
    assert len(json.loads(got.read_text())) == 12
    # a seed table from the first run
    ms.main(["--method", "estimate", "--hbm_gb", "16", "--seed_from", str(want), "--models", "vgg19",
             "--out", str(got)])
    jax_ms.main(["--method", "estimate", "--hbm_gb", "16", "--seed_from", str(want), "--models", "vgg19",
                 "--out", str(want)])
    assert json.loads(got.read_text()) == json.loads(want.read_text())


@pytest.mark.parametrize("argv, match", [(["--devices", "2"], "item 18"), (["--topology", "v5e:2x2"], "not ported")])
def test_refusals(argv, match, tmp_path):
    with pytest.raises(NotImplementedError, match=match):
        ms.main(["--method", "estimate", "--hbm_gb", "16", "--out", str(tmp_path / "t.json"), *argv])


def test_analysis_needs_a_card(monkeypatch):
    """Without CUDA the measured probe raises, and so does the default
    budget (CUDA device 0's memory); the CPU's is 16 GiB."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ms.measure_step_bytes("vgg19", "adam", 64)
    with pytest.raises(RuntimeError, match="CUDA"):
        ms.measure_step_bytes("vgg19", "adam", 64, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ms.hbm_bytes()
    assert ms.hbm_bytes("cpu") == 16 * GIB
    # in the search a failed probe is over budget: nothing fits
    table = ms.probe_max_sizes(models=("vgg19",), optimizers=("adam",), method="analysis", budget_bytes=GIB,
                               verbose=False)
    assert table["vgg19,adam,1"]["safe_max_size"] is None


def test_out_of_memory_counts_as_over_budget(monkeypatch):
    def probe(model, optimizer, size, **_):
        if size > 1000:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return size * size * 5000

    monkeypatch.setattr(ms, "measure_step_bytes", probe)
    entry = ms.probe_max_sizes(models=("vgg19",), optimizers=("adam",), method="analysis", budget_bytes=80 * GIB,
                               verbose=False)["vgg19,adam,1"]
    assert entry["safe_max_size"] == 992 and entry["true_max_size"] == 1024


def test_orderings_on_the_ports_constants():
    """JAX's tests/test_tuning.py orderings, on the fitted table."""
    assert ms.estimate_step_bytes("vgg19", "adam", 1024) > 3 * ms.estimate_step_bytes("vgg19", "adam", 512) * 0.9
    for size in (512, 1024, 2048):
        assert ms.estimate_step_bytes("vgg19", "lbfgs", size) > ms.estimate_step_bytes("vgg19", "adam", size)
        for opt in ("lbfgs", "adam"):
            assert ms.estimate_step_bytes("vgg19", opt, size, compute_dtype="bfloat16") < \
                ms.estimate_step_bytes("vgg19", opt, size)
    table = ms.probe_max_sizes(models=("vgg19",), optimizers=("adam", "lbfgs"), budget_bytes=16 * GIB, verbose=False)
    adam, lbfgs = table["vgg19,adam,1"], table["vgg19,lbfgs,1"]
    for e in (adam, lbfgs):
        assert e["true_max_size"] > e["safe_max_size"] and e["safe_max_size"] % 32 == 0
    assert adam["safe_max_size"] > lbfgs["safe_max_size"]
    hbm = 16 * GIB
    small = ms.frames_per_program("vgg19", "lbfgs", (512, 512), hbm=hbm)
    big = ms.frames_per_program("vgg19", "lbfgs", (1024, 1024), hbm=hbm)
    big_adam = ms.frames_per_program("vgg19", "adam", (1024, 1024), hbm=hbm)
    big_bf16 = ms.frames_per_program("vgg19", "lbfgs", (1024, 1024), compute_dtype="bfloat16", hbm=hbm)
    assert small > big and big_adam > big and big_bf16 > big
    assert all(1 <= v <= 16 for v in (small, big, big_adam, big_bf16))
    assert ms.chain_frames_per_program("vgg19", "adam", (256, 256), hbm=hbm) == 16
    assert ms.chain_frames_per_program("vgg19", "lbfgs", (4096, 4096), hbm=hbm) <= 4


def test_fit_recovers_the_constants(monkeypatch):
    """``fit_constants`` on peaks the formula itself gives returns its
    constants."""
    want = {"activations": 1.7, "arch_fudge": {"prune": 1.3}, "lbfgs": {"compact": 2.2, "two_loop": 2.1},
            "lbfgs_pixels": 9.0, "slack": 300 * 1024 * 1024}
    monkeypatch.setattr(ms, "CONSTANTS", want)
    rows = []
    for model, opts in (("vgg19", (("lbfgs", "compact"), ("lbfgs", "two_loop"), ("adam", "compact"))),
                        ("prune", (("adam", "compact"),))):
        for optimizer, method in opts:
            for dtype in ("float32", "bfloat16"):
                for size in (512, 1024, 2048):
                    rows.append((model, optimizer, method, dtype, size,
                                 ms.estimate_step_bytes(model, optimizer, size, lbfgs_method=method, compute_dtype=dtype)))
    got = ms.fit_constants(rows)
    for key in ("activations", "lbfgs_pixels"):
        assert got[key] == pytest.approx(want[key], rel=1e-4)
    assert got["slack"] == pytest.approx(want["slack"], rel=1e-3)
    for m in ("compact", "two_loop"):
        assert got["lbfgs"][m] == pytest.approx(want["lbfgs"][m], rel=1e-4)
    assert got["arch_fudge"]["prune"] == pytest.approx(1.3, rel=1e-3)
