"""vid_img's stacked first pass: the port's ``StyleEngine.optimize_frames``
(one stacked step per iteration, per-frame optimiser state) against the
JAX package's vmap ``optimize_frames`` and against the port's own
per-frame ``optimize_frame``, L-BFGS with a stalled frame, and the CLI's
capacity-sized chunks against JAX's.

VGG-19 with numpy-made weights handed to both packages, B = 4 frames of
32x48, the default loss layers.  Bars: loss logs within rtol 1e-4;
pastiches within 1e-4 (max|Δ|) for L-BFGS, from a 0.001·N(0, 1) init with
JAX's threefry draws replayed into the port (``_noise``; from an
image-scale init its first curvature pair is set by float noise, ROADMAP
Queue 3).  Adam (lr 1, the CLI's) runs from the content init; its step is
sign(g) wherever |g| >> eps, and at the content init entries of g are
float noise (the content term's, its normalised gradient at full
strength; TV's at ties of neighbouring u8 pixels), so a pixel's step flips
with the convolutions' summation order, in either package: on the CPU
up to 7.6e-3 from JAX and 4.0e-2 from the per-frame path, varying with the
torch thread count, and a flipped pixel moves its neighbours' later
steps.  So Adam's pastiches (Caffe units, one u8 level each) are held to
the u8 drift bound's mean (mean|Δ| <= 0.5) and every entry to 2·lr·iterations
(what flipped steps can move it)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maua_style_tpu import style as jax_style
from maua_style_tpu.engine import StyleEngine as JaxEngine
from maua_style_tpu.losses import LossConfig as JaxLossConfig
from maua_style_tpu.models import select_model as jax_select_model
from maua_style_tpu_torch import losses
from maua_style_tpu_torch import style as torch_style
from maua_style_tpu_torch.engine import LBFGS, StyleEngine
from maua_style_tpu_torch.losses import LossConfig
from maua_style_tpu_torch.models import select_model
from maua_style_tpu_torch.models.convert import params_from_jax
from maua_style_tpu_torch.ops import frame_ops
from test_torch_threads import torch_threads_per_worker  # noqa: F401  (autouse: one torch thread pool per core)
from test_torch_vid_img import _PAIRS, _assert_u8_drift, _cli_argv, _cli_setup, _vgg_np_params, _write_flow_artifacts

HW = (32, 48)
SEEDS = [3, 4, 5, 6]


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return {
        "contents": rng.integers(0, 256, (4, *HW, 3), dtype=np.uint8),
        "style": (rng.standard_normal((1, 32, 32, 3)) * 40).astype(np.float32),
        "params": _vgg_np_params(),
    }


def _jax_noise(seed, out_hw):
    """JAX's frame program's random init for ``seed``, as (1, 3, h, w)."""
    z = 0.001 * jax.random.normal(jax.random.PRNGKey(int(seed)), (1, *out_hw, 3), jnp.float32)
    return torch.from_numpy(np.asarray(z).transpose(0, 3, 1, 2).copy())


def _port(params, optimizer, init_mode, jax_draws=True):
    te = StyleEngine(select_model("vgg19", "max"), params_from_jax(params), LossConfig(), optimizer=optimizer, learning_rate=1.0, lbfgs_history=5, device="cpu")
    if init_mode == "random" and jax_draws:
        te._noise = _jax_noise
    return te


def _kw(init_mode, hist=None):
    return dict(out_hw=HW, blend_weights=[1.0], init_mode=init_mode, seeds=SEEDS, hist_stats=hist)


def _assert_close(got_p, got_log, want_p, want_log, adam_iters=0):
    """``adam_iters``: Adam's bars (see the module docstring)."""
    assert got_p.shape == want_p.shape and got_log.shape == want_log.shape
    d = np.abs(got_p - want_p)
    if adam_iters:
        assert float(d.mean()) <= 0.5 and float(d.max()) <= 2 * adam_iters, (float(d.mean()), float(d.max()))
    else:
        assert float(d.max()) <= 1e-4
    np.testing.assert_allclose(got_log, want_log, rtol=1e-4, atol=0)


@pytest.mark.parametrize("optimizer, init_mode, iters", [("adam", "content", 5), ("lbfgs", "random", 3)])
def test_stacked_matches_jax(inputs, optimizer, init_mode, iters):
    params = inputs["params"]
    je = JaxEngine(jax_select_model("vgg19", "max"), {k: {kk: jnp.asarray(v) for kk, v in p.items()} for k, p in params.items()},
                   JaxLossConfig(), optimizer=optimizer, learning_rate=1.0, lbfgs_history=5)
    te = _port(params, optimizer, init_mode)
    jp, jd = je.optimize_frames(inputs["contents"], [inputs["style"]], iters, **_kw(init_mode))
    tp, td = te.optimize_frames(inputs["contents"], [inputs["style"]], iters, **_kw(init_mode))
    assert tp.shape == (4, 1, 3, *HW) and td.shape == (4, *HW, 3) and td.dtype == torch.uint8
    assert te.last_loss_log.shape == (4, iters, len(LossConfig().loss_names()))
    _assert_close(tp.numpy().transpose(0, 1, 3, 4, 2), te.last_loss_log.numpy(), np.asarray(jp),
                  np.asarray(je.last_loss_log), iters if optimizer == "adam" else 0)
    assert int(np.abs(td.numpy().astype(int) - np.asarray(jd).astype(int)).max()) <= 1


@pytest.mark.parametrize("optimizer, init_mode, iters, hist", [("adam", "content", 5, False), ("lbfgs", "random", 3, False),
                                                               ("lbfgs", "random", 3, True)])
def test_stacked_matches_per_frame(inputs, optimizer, init_mode, iters, hist):
    """The same inits on both sides.  With histogram matching the outputs
    are compared by their loss logs and displays (within one u8 level):
    the output's colour match multiplies a pastiche's differences by its
    gain, Qs·Qt⁻¹, large for a pastiche near its 0.001-scale init (on the
    CPU at one torch thread, 1e-6 before the match became 5e-2 after it).
    From a 0.001·N(0, 1) init Adam's first steps are sign(g) on float noise
    everywhere, so only L-BFGS starts there.  L-BFGS takes JAX's draws: from the port's
    draw for seed 3 the CPU's batched convolution backward gives frame 0 a
    gradient 0.8% from an f64 one (batch 1: 5e-7)."""
    te = _port(inputs["params"], optimizer, init_mode)
    stats = frame_ops.style_hist_stats(inputs["style"], rng=np.random.default_rng(0)) if hist else None
    outs, disps = te.optimize_frames(inputs["contents"], [inputs["style"]], iters, **_kw(init_mode, stats))
    stacked_log = te.last_loss_log
    for i, seed in enumerate(SEEDS):
        out, disp = te.optimize_frame(inputs["contents"][i], [inputs["style"]], iters, out_hw=HW, blend_weights=[1.0],
                                      init_mode=init_mode, hist_stats=stats, seed=seed)
        if hist:
            np.testing.assert_allclose(stacked_log[i].numpy(), te.last_loss_log.numpy(), rtol=1e-4, atol=0)
        else:
            _assert_close(outs[i].numpy(), stacked_log[i].numpy(), out.numpy(), te.last_loss_log.numpy(),
                          iters if optimizer == "adam" else 0)
        assert int((disps[i].int() - disp.int()).abs().max()) <= 1


def test_stacked_random_init_is_per_frame(inputs):
    """Each stacked frame starts from its own seed's draw, as
    ``optimize_frame`` draws it (the port's ``torch.Generator``)."""
    te = _port(inputs["params"], "lbfgs", "random", jax_draws=False)
    outs, _ = te.optimize_frames(inputs["contents"], [inputs["style"]], 0, **_kw("random"))
    assert te.last_loss_log.shape == (4, 0, len(LossConfig().loss_names()))
    for i, seed in enumerate(SEEDS):
        out, _ = te.optimize_frame(inputs["contents"][i], [inputs["style"]], 0, out_hw=HW, blend_weights=[1.0],
                                   init_mode="random", seed=seed)
        assert torch.equal(outs[i], out)
    assert not torch.equal(outs[0], outs[1])


def test_stacked_step_takes_one_gram_per_layer(inputs, monkeypatch):
    """Each iteration hands every style layer's Gram the whole stack once."""
    te = _port(inputs["params"], "adam", "content")
    seen = []
    orig = losses.batch_gram
    monkeypatch.setattr(losses, "batch_gram", lambda a, cov=False: seen.append(a.shape[0]) or orig(a, cov))
    te.optimize_frames(inputs["contents"], [inputs["style"]], 2, **_kw("content"))
    # one style capture (batch 1) and 2 iterations of the 4-frame stack
    assert seen == [1] * 5 + [4] * 10


@pytest.mark.parametrize("method", ["compact", "two_loop"])
def test_stalled_frame_leaves_the_others_alone(method):
    """Frame 1's gradient is zero, so it never inserts a curvature pair; the
    other frames' pointers, counts, histories and iterates are what their
    own runs give."""
    rng = np.random.RandomState(0)
    a = torch.from_numpy(rng.rand(40, 40).astype(np.float32))
    h = a @ a.T / 40 + 0.5 * torch.eye(40)

    def f(p):  # zero gradient at p = 0
        return 0.5 * p @ h @ p + 0.01 * (p**4).sum()

    x0 = torch.from_numpy(rng.standard_normal((3, 40)).astype(np.float32))
    x0[1] = 0
    opt = LBFGS(1.0, 4, method, frames=True)
    p, st = x0.clone(), opt.init(x0)
    for _ in range(9):
        q = p.clone().requires_grad_(True)
        sum(f(q[b]) for b in range(3)).backward()
        upd, st = opt.update(q.grad, st)
        p = p + upd
    assert st["count"].tolist()[1] == 0 and st["ptr"].tolist()[1] == 0
    for b in range(3):
        one = LBFGS(1.0, 4, method)
        q0, s1 = x0[b].clone(), one.init(x0[b])
        for _ in range(9):
            q = q0.clone().requires_grad_(True)
            f(q).backward()
            upd, s1 = one.update(q.grad, s1)
            q0 = q0 + upd
        assert torch.equal(p[b], q0)
        for k in ("ptr", "count", "s_hist", "y_hist", "h_diag", "rho", "w_sy"):
            assert torch.equal(st[k][b], s1[k]), (b, k)


def test_stacked_state_saves(tmp_path, inputs):
    """The stacked L-BFGS state is a dict of tensors ``torch.save`` writes,
    with a leading frame dim; bf16 histories stay bf16."""
    opt = LBFGS(1.0, 3, frames=True, history_dtype=torch.bfloat16)
    st = opt.init(torch.zeros(4, 1, 3, 8, 8))
    assert st["s_hist"].shape == (4, 3, 192) and st["s_hist"].dtype == torch.bfloat16 and st["ptr"].shape == (4,)
    torch.save(st, tmp_path / "st.pt")
    back = torch.load(tmp_path / "st.pt", weights_only=True)
    assert all(torch.equal(back[k], v) for k, v in st.items())


def test_vid_img_cli_chunks_match_jax(tmp_path, monkeypatch, capsys):
    """Both CLIs, ``--init random`` and no ``--frame_batch``: the capacity
    model's chunks (the ``Optimizing...`` lines) are JAX's, and the
    artifacts are within the u8 drift bound.  L-BFGS from JAX's draws
    (Adam's first steps from noise follow float noise)."""
    _cli_setup(tmp_path, monkeypatch)
    _write_flow_artifacts(tmp_path)
    monkeypatch.setattr(StyleEngine, "_noise", lambda self, seed, out_hw: _jax_noise(seed, out_hw))

    def argv(out):
        a = _cli_argv(out)
        a[a.index("--init") + 1] = "random"
        a[a.index("--optimizer") + 1] = "lbfgs"
        return a

    jax_style.main(argv("jax"))
    jax_lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("Optimizing...")]
    torch_style.main(argv("torch"))
    torch_lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("Optimizing...")]
    assert torch_lines == jax_lines
    # three independent frames: a stacked chunk of 2 and one of 1, then the chained pass
    assert [ln.split("frames: ")[-1] for ln in jax_lines[:2]] == ["00002, 00003", "00001"]
    jdir, tdir = tmp_path / "jax" / "vid_style", tmp_path / "torch" / "vid_style"
    for p in (1, 2):
        for _, b in _PAIRS:
            _assert_u8_drift(str(jdir / "16" / f"{p}_{b}.png"), str(tdir / "16" / f"{p}_{b}.png"))
