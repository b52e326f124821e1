"""The port's capacity tuner (``tuning/max_sizes.py``) against the JAX
package's: with the port's constant table set to JAX's v5e literals the
footprint formula is byte for byte JAX's, the boundary search over one
fake bytes function gives equal tables, the frame sizing and the CLI's
JSON are equal, and vid_img's chunk choices are JAX's; so are the N-device
tables (``--devices``).  Then the port's own fitted constants keep JAX's
orderings, the refusals, the measured probe's CPU and out-of-memory paths,
its N-device probe (the largest device's peak; it needs N cards), and the
search's convergence where the reserved peak levels off under the
budget."""

import argparse
import json
import os

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


@pytest.mark.parametrize("argv, match", [(["--topology", "v5e:2x2"], "not ported")])
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


def test_default_out_is_the_ports_configs(monkeypatch, tmp_path):
    """Without ``--out`` the CLI writes under the port's ``configs/`` with
    JAX's file name, never into the repository's top-level ``configs/``
    (the JAX package's tables), which stays byte-identical."""
    import hashlib
    import os

    top = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(ms.__file__))), "..", "configs")
    top = os.path.normpath(top)
    assert not os.path.normpath(ms.default_table_path(16)).startswith(top + os.sep)
    assert ms.default_table_path(79) == os.path.join(ms.TABLE_DIR, "max-sizes-79GB-1chip.json")
    assert ms.TABLE_DIR.endswith(os.path.join("maua_style_tpu_torch", "configs"))

    def digest():
        return {f: hashlib.sha256(open(os.path.join(top, f), "rb").read()).hexdigest() for f in sorted(os.listdir(top))}

    before = digest()
    monkeypatch.setattr(ms, "TABLE_DIR", str(tmp_path))  # the test writes no table into the package
    ms.main(["--method", "estimate", "--hbm_gb", "16"])
    assert digest() == before
    assert len(json.loads((tmp_path / "max-sizes-16GB-1chip.json").read_text())) == 12


def test_search_budget_follows_free_memory(monkeypatch):
    """The measured search's budget is the free memory at its start, not
    the card's total: a process that ran other work first gets a smaller
    budget; each probe is held to it by the allocator's reserved peak."""
    free = {"bytes": 70 * GIB}
    emptied = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: emptied.append(1))
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (free["bytes"], 80 * GIB))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: 2 * GIB)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device=None: argparse.Namespace(total_memory=80 * GIB))
    assert ms.search_budget_bytes() == 70 * GIB and emptied
    free["bytes"] = 30 * GIB
    assert ms.search_budget_bytes() == 30 * GIB
    assert ms.hbm_bytes() == 80 * GIB  # the estimate still sizes the whole card

    def probe(model, optimizer, size, *a, **_):  # the allocator's peaks: what tensors took, and what it reserved
        return {"allocated": size * size * 500, "reserved": size * size * 1000, "free": free["bytes"]}

    monkeypatch.setattr(ms, "measure_step", probe)
    entry = ms.probe_max_sizes(models=("vgg19",), optimizers=("adam",), method="analysis", verbose=False)["vgg19,adam,1"]
    assert entry["budget_gb"] == 30.0
    safe = entry["safe_max_size"]
    assert safe * safe * 1000 <= 30 * GIB < (safe + 32) ** 2 * 1000


# -- N-device tables (--devices) -----------------------------------------------------------


@pytest.mark.parametrize("devices", [2, 4, 8])
def test_estimate_devices_equal_jax(v5e, devices, tmp_path, capsys):
    """The estimate's N-device table equals JAX's: the same keys
    ("model,optimizer,N"), the same ``/ N * 1.03`` footprint, the CLI's JSON
    byte for byte, and the default file name ``max-sizes-{gb}GB-{N}chip.json``
    under the port's ``configs/``."""
    kw = dict(models=ms.DEFAULT_MODELS, method="estimate", budget_bytes=16 * GIB, verbose=False, devices=devices)
    got = ms.probe_max_sizes(**kw)
    assert got == jax_ms.probe_max_sizes(**kw)
    assert sorted(got) == sorted(f"{m},{o},{devices}" for m in ms.DEFAULT_MODELS for o in ms.DEFAULT_OPTIMIZERS)
    one = ms.probe_max_sizes(**{**kw, "devices": 1})
    assert all(got[f"{m},{o},{devices}"]["safe_max_size"] > one[f"{m},{o},1"]["safe_max_size"]
               for m in ms.DEFAULT_MODELS for o in ms.DEFAULT_OPTIMIZERS)
    port, jax_out = tmp_path / "port.json", tmp_path / "jax.json"
    argv = ["--method", "estimate", "--hbm_gb", "16", "--devices", str(devices)]
    ms.main([*argv, "--out", str(port)])
    jax_ms.main([*argv, "--out", str(jax_out)])
    assert port.read_bytes() == jax_out.read_bytes()
    assert ms.default_table_path(16, devices) == os.path.join(ms.TABLE_DIR, f"max-sizes-16GB-{devices}chip.json")


def test_sharded_probe_needs_n_cards(monkeypatch):
    """The measured N-device probe raises ``RuntimeError`` with fewer than N
    CUDA devices, before any probe (JAX's "need N devices for the sharded
    probe"), on this CPU and with one card faked; it never repeats a card."""
    with pytest.raises(RuntimeError, match="need 2 devices for the sharded probe"):
        ms.probe_max_sizes(models=("vgg19",), optimizers=("adam",), method="analysis", devices=2, verbose=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="need 2 devices for the sharded probe"):
        ms.measure_step("vgg19", "adam", 64, devices=2)
    with pytest.raises(RuntimeError, match="need 4 devices"):
        ms.probe_max_sizes(models=("vgg19",), optimizers=("adam",), method="analysis", devices=4,
                           budget_bytes=GIB, verbose=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert ms.probe_devices(2) == [torch.device("cuda", 0), torch.device("cuda", 1)]


def test_sharded_probe_reads_the_largest_device(monkeypatch):
    """On N cards the probe builds its engine on a space:N mesh of the first
    N distinct CUDA devices and reports the largest device's peaks (and the
    least free memory), each above where that device stood before: the
    CUDA allocator's per-device readings faked, the engine a stand-in."""
    from maua_style_tpu_torch.engine import optimize as optimize_module

    peak = {0: (5 * GIB, 6 * GIB), 1: (7 * GIB, 7 * GIB), 2: (4 * GIB, 9 * GIB)}
    base = {0: GIB, 1: 0, 2: 0}
    for name, fn in {"is_available": lambda: True, "device_count": lambda: 3, "synchronize": lambda d=None: None,
                     "reset_peak_memory_stats": lambda d=None: None, "empty_cache": lambda: None,
                     "memory_allocated": lambda d: base[d.index], "memory_reserved": lambda d: base[d.index],
                     "max_memory_allocated": lambda d: peak[d.index][0] + base[d.index],
                     "max_memory_reserved": lambda d: peak[d.index][1] + base[d.index],
                     "mem_get_info": lambda d: ((70 - d.index) * GIB, 80 * GIB)}.items():
        monkeypatch.setattr(torch.cuda, name, fn)
    built = []

    class Engine:
        def __init__(self, *a, device=None, mesh=None, **k):
            built.append((device, mesh))

        def optimize(self, *a, **k):
            pass

    monkeypatch.setattr(optimize_module, "StyleEngine", Engine)
    got = ms.measure_step("vgg19", "adam", 64, compute_dtype="float32", devices=3)
    assert got == {"allocated": 7 * GIB, "reserved": 9 * GIB, "free": 68 * GIB}
    device, mesh = built[0]
    assert device == torch.device("cuda", 0)
    assert mesh.devices == tuple(torch.device("cuda", i) for i in range(3)) and mesh.axes == (("space", 3),)
    assert ms.search_budget_bytes(devices=3) == 68 * GIB
    assert ms.measure_step_bytes("vgg19", "adam", 64, devices=2, allocated=True) == (7 * GIB, 7 * GIB)


# -- the measured search's convergence ------------------------------------------------------


def _plateau(budget, per_px, oom_margin):
    """The card's probes near its limit (VGG-19 f32 on an H100): tensors
    take ``per_px`` bytes a pixel (Adam 2310, L-BFGS 4700, constant to 0.3%
    from 2912² to the limit), the allocator reserves 20% more until that
    reaches the free memory, then hands back its cached blocks and retries,
    so the reserved peak levels off just under the budget; out of memory
    where what tensors take passes the budget plus ``oom_margin`` (the
    allocated peak is read above the process's own cached workspaces: on
    the card a probe failed 0.2 GiB under the budget in one process and
    fitted 0.05 GiB over it in another)."""
    def step(model, optimizer, size, *_, **__):
        a = per_px * size * size + 0.05 * GIB
        if a > budget + oom_margin * GIB:
            return None
        return {"allocated": int(a), "reserved": int(min(1.2 * a, budget * (0.98 + 0.01 * (size // 32 % 2)), budget)),
                "free": budget}
    return step


@pytest.mark.parametrize("budget_gib, per_px, oom_margin", [(76.34, 2310, -0.2), (78.46, 2310, -0.2),
                                                            (76.34, 4700, -0.2), (40.0, 2310, -0.2),
                                                            (76.17, 2310, 0.1), (76.17, 4700, 0.1)])
def test_search_converges_where_reserved_levels_off(monkeypatch, budget_gib, per_px, oom_margin):
    """Where the reserved peak levels off under the budget while what
    tensors take still grows as size², the search brackets the size in at
    most 6 probes (the parent's search, JAX's on the reserved peak, creeps
    32 px a probe: 15 to 20 here), on the same 32-px bracket."""
    budget = int(budget_gib * GIB)
    step = _plateau(budget, per_px, oom_margin)
    parent, port = [], []

    def parent_probe(model, optimizer, size, **_):
        parent.append(size)
        got = step(model, optimizer, size)
        return None if got is None else got["reserved"]

    def port_probe(*a, **k):
        port.append(a[2])
        return step(*a)

    monkeypatch.setattr(jax_ms, "_compiled_step_bytes", parent_probe)
    monkeypatch.setattr(ms, "measure_step", port_probe)
    kw = dict(models=("vgg19",), optimizers=("adam",), method="analysis", verbose=False, compute_dtype="float32",
              budget_bytes=budget, start_size=4160)
    want, got = jax_ms.probe_max_sizes(**kw), ms.probe_max_sizes(**kw)
    assert got == want
    assert len(port) <= 6 < len(parent), (port, parent)
    entry = got["vgg19,adam,1"]
    assert entry["true_max_size"] - entry["safe_max_size"] == 32


def test_search_takes_the_next_rung_where_a_fit_meets_the_budget(monkeypatch):
    """Where the best fit's allocated peak lies within a rung of the budget
    (an H100's Adam probes, VGG-19 f32: 5952² took 81.83 GB of a 82.15 GB
    budget), the fitted boundary lies just above the fit: the search probes
    the next rung (3 probes: 2912, 5952, 5984 out of memory), not a quarter
    octave up (7072, out of memory, 20 s on the card), on JAX's bracket."""
    budget = 82145640448
    step = _plateau(budget, 2310, 0.0)
    port = []

    def port_probe(*a, **k):
        port.append(a[2])
        return step(*a)

    monkeypatch.setattr(jax_ms, "_compiled_step_bytes", lambda model, optimizer, size, **_: (
        None if step(model, optimizer, size) is None else step(model, optimizer, size)["reserved"]))
    monkeypatch.setattr(ms, "measure_step", port_probe)
    kw = dict(models=("vgg19",), optimizers=("adam",), method="analysis", verbose=False, compute_dtype="float32",
              budget_bytes=budget, start_size=4160)
    got = ms.probe_max_sizes(**kw)
    assert got == jax_ms.probe_max_sizes(**kw)
    assert port == [2912, 5952, 5984]
    assert (got["vgg19,adam,1"]["safe_max_size"], got["vgg19,adam,1"]["true_max_size"]) == (5952, 5984)


@pytest.mark.parametrize("seed", range(8))
def test_search_equals_jax_on_random_footprints(monkeypatch, seed):
    """Wherever the footprint is monotone in size the search ends on JAX's
    32-px bracket: random affine-in-size² footprints (slopes, intercepts,
    budgets, start sizes), some running out of memory or raising above a
    random size, 25 tables a seed."""
    import random

    rng = random.Random(seed)
    for _ in range(25):
        per = {o: rng.uniform(50, 5000) for o in ms.DEFAULT_OPTIMIZERS}
        intercept = rng.uniform(0, 3e9)
        oom, raise_above = (rng.choice([None, rng.randint(300, 12000)]) for _ in range(2))

        def fake(model, optimizer, size, *_, **__):
            if raise_above and size > raise_above:
                raise RuntimeError("probe failed")
            if oom and size > oom:
                return None
            return int(per[optimizer] * (1 + 0.1 * len(model)) * size * size + intercept)

        monkeypatch.setattr(jax_ms, "_compiled_step_bytes", fake)
        monkeypatch.setattr(ms, "measure_step_bytes", fake)
        kw = dict(models=("vgg19", "nin"), optimizers=ms.DEFAULT_OPTIMIZERS, method="analysis", verbose=False,
                  compute_dtype="float32", budget_bytes=rng.uniform(1, 100) * GIB,
                  start_size=rng.choice([256, 512, 8192]))
        assert ms.probe_max_sizes(**kw) == jax_ms.probe_max_sizes(**kw)
