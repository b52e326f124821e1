"""The port's losses against maua_style_tpu.losses: captured targets, loss
values and the pastiche gradient (jax.value_and_grad through
apply_extractor), TV, and the --normalize_weights strength scale.  A
narrow VGG-shaped net with the VGG-19 layer names keeps it fast."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_style_tpu import losses as jl
from maua_style_tpu.engine import StyleEngine as JaxEngine
from maua_style_tpu.models import extractor as jax_ext
from maua_style_tpu.models import registry as jax_registry
from maua_style_tpu_torch import losses as tl
from maua_style_tpu_torch.engine import StyleEngine
from maua_style_tpu_torch.models import Extractor, registry
from maua_style_tpu_torch.models.convert import params_from_jax

NARROW = [8, 8, "P", 16, 16, "P", 24, 24, "P", 32, 32, "P", 32, "P"]
HIGHEST = jax.lax.Precision.HIGHEST


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(x), (0, 3, 1, 2))))


def _setup(seed=0):
    jspec = jax_registry._vgg_spec("vgg19", NARROW, "max")
    params = {k: {kk: np.asarray(vv) for kk, vv in v.items()} for k, v in jax_ext.init_params(jspec, seed).items()}
    ext = Extractor(registry._vgg_spec("vgg19", NARROW, "max"), params_from_jax(params))
    return jspec, params, ext


@pytest.mark.parametrize("normalize,cov,scaled", [(True, False, False), (False, True, False), (True, False, True)])
def test_losses_and_gradient_match_jax(normalize, cov, scaled):
    cfg = dict(normalize_gradients=normalize, use_covariance=cov)
    jcfg, tcfg = jl.LossConfig(**cfg), tl.LossConfig(**cfg)
    assert jcfg.loss_names() == tcfg.loss_names() and jcfg.all_layers == tcfg.all_layers
    jspec, params, ext = _setup()
    rng = np.random.default_rng(1)
    content = rng.normal(0, 50, (1, 32, 48, 3)).astype(np.float32)
    style = rng.normal(0, 40, (1, 40, 36, 3)).astype(np.float32)
    pastiche = rng.normal(0, 30, (1, 32, 48, 3)).astype(np.float32)

    jextract = partial(lambda x, layers: jax_ext.apply_extractor(params, x, jspec, layers, HIGHEST))
    jt = {
        "content": jl.capture_content_targets(jextract, jnp.asarray(content), jcfg),
        "style": jl.capture_style_targets(jextract, [jnp.asarray(style)], [0.7], jcfg),
    }
    tt = {
        "content": tl.capture_content_targets(ext, _nchw(content), tcfg),
        "style": tl.capture_style_targets(ext, [_nchw(style)], [0.7], tcfg),
    }
    for l, t in jt["content"].items():
        np.testing.assert_allclose(tt["content"][l].numpy(), _nchw(t).numpy(), atol=1e-5 * float(jnp.abs(t).max()))
    for l, t in jt["style"].items():
        np.testing.assert_allclose(tt["style"][l].numpy(), np.asarray(t), atol=1e-5 * float(jnp.abs(t).max()))

    scale = None
    if scaled:  # the strength scales, and a weighted temporal target
        scale = {"content:relu4_2": 0.5, "style:relu1_1": 2.0, "style:relu3_1": 0.25, "temporal": 0.1}
        warp = rng.normal(0, 30, (1, 32, 48, 3)).astype(np.float32)
        weights = rng.random((1, 32, 48, 1)).astype(np.float32)
        jt["temporal"] = jl.capture_temporal_targets(jnp.asarray(warp), jnp.asarray(weights))
        tt["temporal"] = tl.capture_temporal_targets(_nchw(warp), _nchw(weights))

    def jloss(p):
        return jl.evaluate_losses(p, jextract(p, jcfg.all_layers), jt, jcfg, scale)

    (jtotal, jper), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jnp.asarray(pastiche))
    p = _nchw(pastiche).requires_grad_(True)
    total, per = tl.evaluate_losses(p, ext(p, tcfg.all_layers), tt, tcfg, scale)
    total.backward()
    total = total.detach()
    # f32 through a few convs summed in another order: 1e-5 relative
    np.testing.assert_allclose(per.detach().numpy(), np.asarray(jper), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-5)
    jg = _nchw(jgrad).numpy()
    np.testing.assert_allclose(p.grad.numpy(), jg, atol=1e-4 * float(np.abs(jg).max()), rtol=0)


def test_tv_loss_matches_jax():
    x = np.random.default_rng(2).normal(0, 10, (2, 7, 9, 3)).astype(np.float32)
    np.testing.assert_allclose(float(tl.tv_loss(_nchw(x))), float(jl.tv_loss(jnp.asarray(x))), rtol=1e-6)


def test_scale_gradients_normalises_backward():
    x = torch.tensor([3.0, 4.0], requires_grad=True)
    (tl.scale_gradients(x, 2.0) * torch.tensor([1.0, 1.0])).sum().backward()
    g = jax.grad(lambda v: jnp.sum(jl.scale_gradients(v, 2.0)))(jnp.asarray([3.0, 4.0]))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), rtol=1e-6)


def test_strength_scale_matches_jax():
    jspec, params, ext = _setup()
    tspec = registry._vgg_spec("vgg19", NARROW, "max")
    rng = np.random.default_rng(3)
    content = rng.normal(0, 50, (1, 24, 40, 3)).astype(np.float32)
    style = rng.normal(0, 50, (1, 30, 30, 3)).astype(np.float32)
    jeng = JaxEngine(jspec, jax.tree_util.tree_map(jnp.asarray, params), jl.LossConfig(), normalize_weights=True)
    teng = StyleEngine(tspec, params_from_jax(params), tl.LossConfig(), normalize_weights=True, device="cpu")
    want = jeng._strength_scale({"content": jeng.content_targets(content), "style": jeng.style_targets([style], [1.0])})
    got = teng._strength_scale({"content": teng.content_targets(content), "style": teng.style_targets([style], [1.0])})
    assert got == want
    assert StyleEngine(tspec, params_from_jax(params), tl.LossConfig(), device="cpu")._strength_scale({}) == ()
