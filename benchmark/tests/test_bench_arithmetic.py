"""The yardstick's arithmetic at known shapes."""

from __future__ import annotations

import pytest

from benchmark import flops
from benchmark.reference import nets

VGG = {"arch": "vgg19", "content_layers": ["relu4_2"],
       "style_layers": ["relu1_1", "relu2_1", "relu3_1", "relu4_1", "relu5_1"]}
NIN = {"arch": "nin", "content_layers": ["relu8"], "style_layers": ["relu1", "relu3", "relu5", "relu7", "relu9", "relu11"]}


def test_vgg19_forward_to_conv5_1_at_1024():
    # 2·Cin·Cout·9·H·W summed over conv1_1 … conv5_1: 0.757e12
    assert flops.conv_forward_flops("vgg19", ["relu5_1"], 1024, 1024) == 757_390_639_104


def test_conv_flops_by_hand_at_a_small_shape():
    # conv1_1 and conv1_2 at 8x8: 2·3·64·9·64 + 2·64·64·9·64
    assert flops.conv_forward_flops("vgg19", ["relu1_2"], 8, 8) == 2 * 3 * 64 * 9 * 64 + 2 * 64 * 64 * 9 * 64


def test_iteration_flops_is_forward_and_input_gradient_plus_grams():
    fwd = flops.conv_forward_flops("vgg19", ["relu4_2", "relu5_1"], 1024, 1024)
    grams = sum(n * c * (c + 1) for c, n in ((64, 1024**2), (128, 512**2), (256, 256**2), (512, 128**2), (512, 64**2)))
    assert flops.iteration_flops(VGG, 1024, 1024) == 2 * fwd + grams


def test_nin_shapes_at_9088():
    sizes = nets.layer_sizes("nin", NIN["style_layers"], 9088, 9088)
    # conv1: (9088 - 11) / 4 + 1 = 2270; the ceil pools: 1135, 567, 283
    assert sizes["relu1"] == (96, 2270, 2270)
    assert sizes["relu5"] == (256, 1135, 1135)
    assert sizes["relu7"] == (384, 567, 567)
    assert sizes["relu11"] == (1024, 283, 283)


@pytest.mark.parametrize("n,want", [(9, 4), (10, 5), (11, 5), (2270, 1135), (3, 1)])
def test_ceil_pool_never_starts_past_the_edge(n, want):
    assert nets.pool_len(n, 3, 2, True) == want


def test_gram_bound_matches_chip_smoke_at_1024():
    # chip_smoke.gram_bound_ms(1, C, N, float32) over VGG-19's five style
    # layers at 1024²: 0.17895240004197197 ms (bytes-bound at C = 64, 128)
    shapes = ((64, 1048576), (128, 262144), (256, 65536), (512, 16384), (512, 4096))
    total = sum(flops.gram_bound_s(1, c, n) for c, n in shapes) * 1e3
    assert total == pytest.approx(0.17895240004197197, rel=1e-12)
    assert flops.gram_bound_s(1, 64, 1048576) == pytest.approx((4 * 64 * 1048576 + 4 * 64 * 64) / flops.PEAK_BYTES)
    assert flops.gram_bound_s(1, 512, 4096) == pytest.approx(3 * 4096 * 512 * 513 / flops.PEAK_TF32)


def test_correlation_bound_matches_chip_smoke_at_1024x576():
    # chip_smoke.corr_bound_ms over PWC's five levels (d = 4, K = 81) for 8
    # pairs of 1024x576 frames: 0.07797148656716418 ms, bound by bytes
    levels = ((196, 9, 16), (128, 18, 32), (96, 36, 64), (64, 72, 128), (32, 144, 256))
    total = sum(flops.correlation_bound_s(8, c, h, w, 81) for c, h, w in levels) * 1e3
    assert total == pytest.approx(0.07797148656716418, rel=1e-12)
    assert flops.correlation_bound_s(8, 32, 144, 256, 81) == pytest.approx(
        4 * 8 * 144 * 256 * (2 * 32 + 81) / flops.PEAK_BYTES)
    # UnFlow's one level (d = 20, s = 2, K = 441) is bound by operations
    assert flops.correlation_bound_s(8, 256, 72, 128, 441) == pytest.approx(
        2 * 8 * 72 * 128 * 441 * 256 / flops.PEAK_FP32)
