"""The port's config against maua_style_tpu.config: the same option set, the
same scaling-table swap, and the port's device rules."""

import argparse
import json

import pytest
import torch

from maua_style_tpu import config as jax_config
from maua_style_tpu_torch import config
from maua_style_tpu_torch.engine import StyleEngine
from maua_style_tpu_torch.losses import LossConfig
from maua_style_tpu_torch.models import init_params, select_model


def _options(parser):
    return {(a.dest, tuple(a.option_strings), repr(a.default), str(a.choices)) for a in parser._actions}


def test_parser_option_set_matches_jax():
    assert _options(config.build_parser()) == _options(jax_config.build_parser())


@pytest.mark.parametrize("size", [256, 1448, 2080, 3000, 4800, 6400, 10000, 20000])
@pytest.mark.parametrize("cli_set", [(), ("optimizer", "model_file")])
def test_set_model_args_matches_jax(size, cli_set):
    def ns():
        return argparse.Namespace(
            scaling_args="configs/scaling-img.json", devices=[None], _cli_set=list(cli_set),
            model_file="vgg19", optimizer="lbfgs", style_layers="relu1_1", content_layers="relu4_2", mesh=None,
        )

    want, got = ns(), ns()
    jax_config.set_model_args(want, size)
    config.set_model_args(got, size)
    assert vars(got) == vars(want)


def test_gpu_c_selects_cpu():
    args = config.get_args(["--gpu", "c"])
    assert args.device == torch.device("cpu")
    assert args.devices == [torch.device("cpu")]


def test_no_cuda_raises_without_gpu_c(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--gpu c"):
        config.get_args([])
    spec = select_model("vgg19")
    cfg = LossConfig(content_layers=(), style_layers=("relu1_1",))
    with pytest.raises(RuntimeError, match="CUDA"):
        StyleEngine(spec, init_params(spec), cfg)


@pytest.mark.parametrize("argv", [["--gpu", "c", "--mesh", "space:2"], ["--gpu", "0,1"]])
def test_multi_device_raises(argv):
    with pytest.raises(NotImplementedError, match="item 18"):
        config.get_args(argv)


def test_single_device_mesh_accepted():
    assert config.get_args(["--gpu", "c", "--mesh", "space:1"]).device == torch.device("cpu")


def test_load_args_merge_matches_jax(tmp_path):
    preset = tmp_path / "preset.json"
    full = vars(config.build_parser().parse_args([]))  # a full args dump, as --save_args writes
    full.update(image_sizes="64,96", num_iters="5,4", style_weight=7.0, optimizer="adam",
                content="c.png", style=["s.png"], output_dir="o", gpu="c")
    preset.write_text(json.dumps(full))
    argv = ["--gpu", "c", "--load_args", str(preset), "--style_weight", "100", "--tv_weight", "0.5"]
    got, want = config.get_args(argv), jax_config.get_args(argv)
    for key in ("image_sizes", "num_iters", "style_weight", "tv_weight", "optimizer", "output", "style_blend_weights"):
        assert getattr(got, key) == getattr(want, key), key
    assert got.style_weight == 100.0 and got.optimizer == "adam"  # explicit CLI flag beats the file
    loaded, jloaded = config.load_args(str(preset)), jax_config.load_args(str(preset))
    assert (loaded.output, loaded.image_sizes) == (jloaded.output, jloaded.image_sizes)


def test_arity_and_output_name_match_jax(tmp_path):
    argv = ["--gpu", "c", "--content", "a/b/cat.png", "--style", "x/dog.jpg", "y/fox.png",
            "--output_dir", str(tmp_path), "--style_blend_weights", "1,3"]
    got, want = config.get_args(argv), jax_config.get_args(argv)
    assert got.output == want.output
    assert got.style_blend_weights == want.style_blend_weights
    assert (got.image_sizes, got.num_iters) == (want.image_sizes, want.num_iters)
    with pytest.raises(ValueError):
        config.get_args(["--gpu", "c", "--image_sizes", "64,96", "--num_iters", "20"])
