"""The engine's measured selection of cuDNN's convolution algorithms
(``StyleEngine(cudnn_autotune=...)``, ``models/conv_plans.py``), on the
CPU: the process-wide ``torch.backends.cudnn.benchmark`` and
``deterministic`` are on while a step's input gradient runs (but for the
convolution that reads the image, and for a banded pastiche), the
caller's while the forward runs and
whenever control is back with the caller; ``--no_cudnn_autotune`` turns it
off; the ``net.autotune_shapes`` counter and ``net.autotune`` spans mark
the first meeting of each pastiche shape."""

import numpy as np
import pytest
import torch

from maua_style_tpu_torch import config, trace
from maua_style_tpu_torch.engine import StyleEngine
from maua_style_tpu_torch.engine.optimize import to_nchw
from maua_style_tpu_torch.losses import LossConfig
from maua_style_tpu_torch.models import Extractor, ExtractorSpec, init_params, registry
from maua_style_tpu_torch.parallel import build_mesh
from maua_style_tpu_torch.pipelines import common
from test_torch_threads import torch_threads_per_worker  # noqa: F401  (autouse: one torch thread pool per core)

NARROW = [8, "P", 16, "P", 16, 16, "P", 24, 24, "P", 24, "P"]
CPU = torch.device("cpu")


def _engine(**kw):
    spec = registry._vgg_spec("vgg19", NARROW, "max")
    return StyleEngine(spec, init_params(spec, seed=1), LossConfig(), optimizer="adam", device="cpu", **kw)


def _images(h=32, w=32, seed=0):
    rng = np.random.default_rng(seed)
    content = rng.normal(0, 40, (1, h, w, 3)).astype(np.float32)
    style_img = rng.normal(0, 40, (1, 24, 28, 3)).astype(np.float32)
    init = rng.normal(0, 1, (1, h, w, 3)).astype(np.float32)
    return content, style_img, init


def _flags() -> tuple[bool, bool]:
    return torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic


@pytest.fixture
def caller_flag():
    """Sets the caller's ``benchmark`` and ``deterministic`` for a test
    and puts the process's back after."""
    saved = _flags()

    def set_to(value: bool) -> tuple[bool, bool]:
        torch.backends.cudnn.benchmark = torch.backends.cudnn.deterministic = value
        return value, value

    yield set_to
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = saved


def _watch(engine, raise_in=None) -> list:
    """(pass, flags) each time the second convolution runs forward, and
    each time its output's gradient arrives in a backward, before its own
    input gradient runs; ``raise_in`` names the pass that raises instead."""
    seen = []

    def on_grad(g):
        seen.append(("backward", _flags()))
        if raise_in == "backward":
            raise RuntimeError("the net's backward fails")

    def on_forward(module, inputs, out):
        seen.append(("forward", _flags()))
        if raise_in == "forward":
            raise RuntimeError("the net's forward fails")
        if out.requires_grad:
            out.register_hook(on_grad)

    engine.extractor.conv2_1.register_forward_hook(on_forward)
    return seen


def _watch_image_grad(engine) -> list:
    """The flags each time the pastiche's gradient is done: just after the
    input gradient of the convolution that reads it."""
    seen = []

    def on_forward(module, inputs, out):
        if inputs[0].requires_grad:
            inputs[0].register_hook(lambda g: seen.append(_flags()))

    engine.extractor.conv1_1.register_forward_hook(on_forward)
    return seen


def _expected(seen, caller, measured=True) -> list:
    """What ``_watch`` should have seen: the caller's flags in every
    forward, both flags on in each backward (the caller's without
    measured selection)."""
    on = (True, True) if measured else caller
    return [(p, on if p == "backward" else caller) for p, _ in seen]


def test_the_net_runs_with_measured_selection(caller_flag):
    caller = caller_flag(False)
    engine = _engine()
    seen = _watch(engine)
    content, style_img, init = _images()
    engine.optimize(content, [style_img], init, 3)
    # the content and style captures, then each step's forward and backward
    assert [p for p, _ in seen] == ["forward"] * 2 + ["forward", "backward"] * 3
    assert seen == _expected(seen, caller)
    assert _flags() == caller


@pytest.mark.parametrize("caller", [False, True])
@pytest.mark.parametrize("autotune", [True, False])
def test_the_image_convolutions_input_gradient_runs_on_heuristics(autotune, caller, caller_flag):
    """The last convolution of the backward, the one that reads the image,
    runs under the caller's flags, with measured selection or without: with
    the caller's default, cuDNN's heuristics, as before."""
    caller = caller_flag(caller)
    engine = _engine(cudnn_autotune=autotune)
    seen = _watch_image_grad(engine)
    content, style_img, init = _images()
    engine.optimize(content, [style_img], init, 3)
    assert seen == [caller] * 3
    assert _flags() == caller


def _run_optimize(engine, content, style_img, init):
    engine.optimize(content, [style_img], init, 2)


def _run_pyramid(engine, content, style_img, init):
    """Two scales: the top-left three quarters of the images, then all."""
    h, w = content.shape[1:3]
    sh, sw = h * 3 // 4, w * 3 // 4
    engine.optimize_pyramid([content[:, :sh, :sw], content], [[style_img], [style_img]], init[:, :sh, :sw],
                            [((sh, sw), 2), ((h, w), 2)])


@pytest.mark.parametrize("caller", [False, True])
@pytest.mark.parametrize("how", ["optimize", "optimize_pyramid", "forward_raises", "backward_raises",
                                 "generator_at_a_yield"])
def test_the_caller_gets_its_flag_back(how, caller, caller_flag):
    caller = caller_flag(caller)
    engine = _engine()
    content, style_img, init = _images()
    seen = _watch(engine, raise_in=how.split("_")[0] if how.endswith("raises") else None)
    if how == "optimize":
        _run_optimize(engine, content, style_img, init)
    elif how == "optimize_pyramid":
        _run_pyramid(engine, content, style_img, init)
    elif how == "generator_at_a_yield":
        targets = {"content": engine.content_targets(content), "style": engine.style_targets([style_img], [1.0])}
        opt = engine._make_optimizer()
        p = to_nchw(init, engine.device)
        steps = engine._steps(p, opt, opt.init(p), targets, {}, 3)
        next(steps)
        assert _flags() == caller  # left at the first step's yield
        next(steps)
        assert _flags() == caller
        steps.close()
    else:
        with pytest.raises(RuntimeError, match="the net's"):
            _run_optimize(engine, content, style_img, init)
    assert _flags() == caller
    assert seen and seen == _expected(seen, caller)


@pytest.mark.parametrize("caller", [False, True])
@pytest.mark.parametrize("run", [_run_optimize, _run_pyramid], ids=["optimize", "optimize_pyramid"])
def test_without_autotune_the_flag_is_never_touched(run, caller, caller_flag):
    caller = caller_flag(caller)
    engine = _engine(cudnn_autotune=False)
    seen = _watch(engine)
    before = trace.counter("net.autotune_shapes")
    run(engine, *_images(48, 36))
    assert {p for p, _ in seen} == {"forward", "backward"}
    assert seen == _expected(seen, caller, measured=False)
    assert _flags() == caller
    assert trace.counter("net.autotune_shapes") == before


@pytest.mark.parametrize("caller", [False, True])
def test_a_banded_pastiche_keeps_the_callers_flags(caller, caller_flag, monkeypatch):
    """On a "space" mesh each step's input gradient of the bands runs under
    the caller's flags, and counts no shape."""
    caller = caller_flag(caller)
    engine = _engine(mesh=build_mesh([CPU] * 2, [("space", 2)]))
    assert engine.band_devices == [CPU, CPU]
    seen, grad = [], torch.autograd.grad

    def watched(outputs, inputs, *a, **kw):
        seen.append((isinstance(inputs, list) and len(inputs), _flags()))
        return grad(outputs, inputs, *a, **kw)

    monkeypatch.setattr(torch.autograd, "grad", watched)
    before = trace.counter("net.autotune_shapes")
    _run_optimize(engine, *_images(48, 36, seed=5))
    assert seen == [(2, caller)] * 2  # two steps, each over both bands
    assert _flags() == caller
    assert trace.counter("net.autotune_shapes") == before


@pytest.mark.parametrize("extra,want", [([], True), (["--no_cudnn_autotune"], False)])
def test_the_cli_flag_reaches_the_engine(extra, want, monkeypatch):
    made = []
    monkeypatch.setattr(common, "load_params", lambda *a, **k: {})
    monkeypatch.setattr(common, "StyleEngine", lambda *a, **k: made.append(k))
    common.build_engine(config.get_args(["--gpu", "c", *extra]))
    assert [k["cudnn_autotune"] for k in made] == [want]


@pytest.mark.parametrize("autotune", [True, False])
def test_a_replica_keeps_the_setting(autotune):
    engine = _engine(cudnn_autotune=autotune, mesh=build_mesh([CPU] * 2, [("space", 2)]))
    engine.band_devices = None  # as on distinct cards: the row is not the engine's own
    replica = engine._replica((CPU, CPU))
    assert replica is not engine and replica.conv_plans.measured is autotune


def test_a_shape_counts_once():
    """A pastiche shape no other test meets: the first call counts it once,
    its first backward under a ``net.autotune`` span; a second call on
    another engine counts nothing; a new shape counts once more."""
    content, style_img, init = _images(40, 44, seed=3)
    style_img = style_img[:, :20, :22]
    trace.enable()
    try:
        counts = []
        for engine, (c, i) in ((_engine(), (content, init)), (_engine(), (content, init)),
                               (_engine(), (content[:, :, :36], init[:, :, :36]))):
            before = trace.counter("net.autotune_shapes")
            engine.optimize(c, [style_img], i, 2)
            root = trace.roots()[-1]
            counts.append((trace.counter("net.autotune_shapes") - before, root.counters.get("net.autotune_shapes", 0),
                           [r[4]["shape"] for r in root.spans("net.autotune")]))
    finally:
        trace.disable()
    assert counts == [(1, 1, [[1, 3, 40, 44]]), (0, 0, []), (1, 1, [[1, 3, 40, 36]])]


def test_the_feature_net_names_its_image_convolution():
    """The hook goes on the convolution that reads the image: the first of
    the spec's, none in a net without convolutions."""
    engine = _engine()
    assert engine.extractor.image_conv is engine.extractor.conv1_1
    assert Extractor(ExtractorSpec("none", ())).image_conv is None
