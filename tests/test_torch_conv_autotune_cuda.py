"""cuDNN's convolutions on a card, f32 with TF32 off, against an f64
convolution on the same card: each layer of the benchmark's feature nets at
its cells' sizes (VGG-19 to conv5_1 at 256², 512², the pyramid's 724² to
1448² and 2048²; NIN to cccp7 at 9088²), forward and input gradient, with
the plans the engine's measured selection picks
(``models.conv_plans.measured_selection`` around the input gradient, the
image convolution's under the caller's flags, as the engine runs them) and
with cuDNN's heuristics.

PyTorch keeps one plan a problem for the process, so each case runs in a
fresh process.  These tests import no JAX, so they also run on a GPU host
without it:

    python -m pytest --noconftest -m cuda tests/test_torch_conv_autotune_cuda.py

Without a CUDA device they skip."""

import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL_TOL = 1e-5
# case: (arch, deepest layer, sides)
CASES = {"vgg19.small": ("vgg19", "relu5_1", (256, 512)), "vgg19.pyramid": ("vgg19", "relu5_1", (724, 1024, 1448)),
         "vgg19.2048": ("vgg19", "relu5_1", (2048,)), "nin.9088": ("nin", "relu11", (9088,))}


def _worst(mode: str, case: str) -> dict:
    """max |got - f64| / max |f64| of each layer's forward and input
    gradient at each side, in this process."""
    import contextlib

    import torch.nn.functional as F

    from maua_style_tpu_torch.models.conv_plans import measured_selection
    from maua_style_tpu_torch.models import select_model
    from maua_style_tpu_torch.models.extractor import pool_out_len, truncate_spec

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = torch.backends.cudnn.deterministic = False
    arch, deepest, sides = CASES[case]
    spec = truncate_spec(select_model(arch), [deepest])
    gen = torch.Generator(device="cuda").manual_seed(len(case))
    out = {}
    for side in sides:
        cin, h, w = 3, side, side
        for layer in spec.layers:
            if layer.kind in ("maxpool", "avgpool"):
                h = pool_out_len(h, layer.kernel[0], layer.stride[0], layer.ceil_mode)
                w = pool_out_len(w, layer.kernel[1], layer.stride[1], layer.ceil_mode)
            if layer.kind != "conv":
                continue
            kh, kw = layer.kernel
            oh = (h + 2 * layer.pad[0] - kh) // layer.stride[0] + 1
            ow = (w + 2 * layer.pad[1] - kw) // layer.stride[1] + 1
            f64 = dict(device="cuda", dtype=torch.float64, generator=gen)
            x = torch.randn((1, cin, h, w), **f64)
            wt = torch.randn((layer.out_ch, cin, kh, kw), **f64) * (2 / (kh * kw * cin)) ** 0.5
            gy = torch.randn((1, layer.out_ch, oh, ow), **f64)
            measured = mode == "measured" and layer is not spec.conv_layers[0]

            def passes(x, wt, gy, measured):
                y = F.conv2d(x, wt, None, layer.stride, layer.pad)
                with measured_selection() if measured else contextlib.nullcontext():
                    gx = torch.ops.aten.convolution_backward(gy, x, wt, None, layer.stride, layer.pad, (1, 1), False,
                                                             (0, 0), 1, (True, False, False))[0]
                return y, gx

            want = passes(x, wt, gy, False)
            got = passes(x.float(), wt.float(), gy.float(), measured)
            for name, g, r in zip(("forward", "input_grad"), got, want):
                out[f"{layer.name}@{side}.{name}"] = float((g.double() - r).abs().max() / r.abs().max())
            del x, wt, gy, want, got
            cin, h, w = layer.out_ch, oh, ow
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mode", ["measured", "heuristic"])
def test_convolutions_match_an_f64_reference(mode, case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: cuDNN's algorithms run only there")
    done = subprocess.run([sys.executable, os.path.abspath(__file__), mode, case], cwd=ROOT, check=True,
                          capture_output=True, text=True, env={**os.environ, "PYTHONPATH": ROOT}, timeout=900)
    errors = json.loads(done.stdout.strip().splitlines()[-1])
    arch, deepest, sides = CASES[case]
    from maua_style_tpu_torch.models import select_model
    from maua_style_tpu_torch.models.extractor import truncate_spec

    assert len(errors) == 2 * len(truncate_spec(select_model(arch), [deepest]).conv_layers) * len(sides)
    assert max(errors.values()) <= REL_TOL, errors


if __name__ == "__main__":
    print(json.dumps(_worst(sys.argv[1], sys.argv[2])))
