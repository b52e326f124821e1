"""Config / flag system (JAX counterpart: maua_style_tpu/config.py).

The option set, the preset kinds and the merge rule are the JAX package's:
file args are the base; CLI flags that differ from their defaults (or are
missing from the file) win; an explicit CLI flag also beats the per-scale
scaling table.

Devices: ``--gpu 0`` (the default) selects ``cuda:0`` and ``--gpu c`` the
CPU.  Without a CUDA device and without ``--gpu c`` parsing raises — the
port never carries on silently on the CPU.  ``--gpu 0,1`` lists several
cards and ``--mesh`` names their axes (``setup_devices``; the mesh itself
is ``parallel/mesh.py``).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import uuid

import torch

from .utils import name

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_CONFIG_SEARCH = (".", os.path.join(_PKG_DIR, ".."), _PKG_DIR)


def resolve_config_path(path: str) -> str | None:
    """Find a preset file relative to cwd, the repo root, or the package."""
    if os.path.isabs(path):
        return path if os.path.exists(path) else None
    for base in _CONFIG_SEARCH:
        cand = os.path.join(base, path)
        if os.path.exists(cand):
            return cand
    return None


def build_parser() -> argparse.ArgumentParser:
    # fmt: off
    parser = argparse.ArgumentParser("maua_style_tpu_torch")

    # input options
    parser.add_argument("--transfer_type", default="img_img", choices=["img_img", "vid_img", "img_vid"])
    parser.add_argument("--output_dir", default="./output")
    parser.add_argument("--content", help="Content target image")
    parser.add_argument("--style", help="Style target image(s)", nargs="*")
    parser.add_argument("--init", type=str, default="random")
    parser.add_argument("--seed", type=int, default=-1)

    # main parameters
    parser.add_argument("--image_sizes", default="256,512,724,1024,1448")
    parser.add_argument("--num_iters", default="500,400,300,200,100")
    parser.add_argument("--content_weight", type=float, default=5)
    parser.add_argument("--temporal_weight", type=float, default=50)
    parser.add_argument("--style_weight", type=float, default=100)
    parser.add_argument("--style_blend_weights", default=None)
    parser.add_argument("--style_scale", type=float, default=1.0)
    parser.add_argument("--tv_weight", type=float, default=1e-3)

    # model settings
    parser.add_argument("--model_file", type=str, default="vgg19",
                        help="Path to .npz/.pth checkpoint or one of [prune, nyud, fcn32s, sod, vgg19, vgg16, nin]")
    parser.add_argument("--content_layers", default="relu4_2")
    parser.add_argument("--style_layers", default="relu1_1,relu2_1,relu3_1,relu4_1,relu5_1")
    parser.add_argument("--pooling", choices=["avg", "max"], default="max")
    parser.add_argument("--disable_check", action="store_true")
    parser.add_argument("--allow_random_weights", action="store_true",
                        help="Proceed with deterministic random weights when a feature "
                             "checkpoint is missing (outputs are meaningless; tests/smoke only)")
    parser.add_argument("--download_weights", action="store_true",
                        help="Fetch missing checkpoints into modelzoo/ and convert them (needs network access)")

    # switches
    parser.add_argument("--original_colors", action="store_true")
    parser.add_argument("--normalize_weights", action="store_true")
    parser.add_argument("--no_grad_norm", action="store_true")
    parser.add_argument("--no_hist_match", action="store_true")
    parser.add_argument("--use_covariance", action="store_true")

    # optimizer
    parser.add_argument("--optimizer", choices=["lbfgs", "adam"], default="lbfgs")
    parser.add_argument("--learning_rate", type=float, default=1)
    parser.add_argument("--lbfgs_num_correction", type=int, default=100)
    parser.add_argument("--lbfgs_method", choices=["compact", "two_loop"], default="compact",
                        help="compact = one streaming pass per history buffer; two_loop = the classic recursion")
    parser.add_argument("--lbfgs_tolerance_change", type=int, default=-1)  # accepted for CLI compat; never triggers
    parser.add_argument("--lbfgs_tolerance_grad", type=int, default=-1)

    # devices
    parser.add_argument("--gpu", type=str, default="0",
                        help="CUDA device id(s) '0' or '0,1', or 'c' for the CPU")
    parser.add_argument("--mesh", type=str, default=None,
                        help="device mesh axes, e.g. 'space:2' (img_img split into bands) or 'frames:2' "
                             "(vid_img's first pass split by frames); default: every device on 'space'")
    parser.add_argument("--precision", choices=["highest", "high", "default"], default="highest",
                        help="'highest' = full f32 (TF32 off for matmul and cuDNN); 'high'/'default' allow TF32")
    parser.add_argument("--compute_dtype", choices=["float32", "bfloat16"], default="float32",
                        help="Feature-net activation dtype; Gram and losses stay float32")
    parser.add_argument("--backend", default="xla", help="accepted for reference CLI compat; ignored")
    parser.add_argument("--multidevice_strategy", default="5", help="accepted for reference CLI compat; ignored")
    parser.add_argument("--no_cudnn_autotune", action="store_true",
                        help="let cuDNN's heuristics pick the feature net's convolution algorithms instead of "
                             "timing them the first time each shape runs")

    # video content settings
    parser.add_argument("--flow_models", type=str, default="spynet,pwc")
    parser.add_argument("--no_check_occlusion", action="store_true")
    parser.add_argument("--passes_per_scale", type=int, default=4)
    parser.add_argument("--loop", action="store_true")
    parser.add_argument("--temporal_blend", type=float, default=0.5)
    parser.add_argument("--frame_batch", type=int, default=0,
                        help="vid_img: frames per batch when first-pass frames are independent")
    parser.add_argument("--fps", type=float, default=24)

    # video style settings
    parser.add_argument("--num_frames", type=int, default=48)
    parser.add_argument("--video_style_factor", type=float, default=100)
    parser.add_argument("--gram_frame_window", type=str, default="18,9,7")
    parser.add_argument("--avg_frame_window", type=int, default=18)
    parser.add_argument("--shift_factor", type=float, default=0)

    # clip settings
    parser.add_argument("--content_text", type=str, default=None)
    parser.add_argument("--style_text", type=str, default=None)
    parser.add_argument("--text_weight", type=float, default=1)
    parser.add_argument("--vqgan_dir", type=str, default="imagenet_16384",
                        help="Path to VQGAN checkpoint dir or one of [imagenet_1024, imagenet_16384, coco, faceshq, wikiart_1024, wikiart_16384, sflckr]")
    parser.add_argument("--clip_backbone", type=str, default="ViT-B/32", choices=["RN50", "RN101", "RN50x4", "ViT-B/32"])

    # logging
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--print_iter", type=int, default=0)
    parser.add_argument("--save_iter", type=int, default=0)
    parser.add_argument("--save_args", action="store_true")
    parser.add_argument("--checkpoint_every", type=int, default=0,
                        help="run-state checkpoint interval in iterations (0=off); resumes optimizer state across crashes")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="trace the job: a torch.profiler chrome trace of each optimization's first chunk "
                             "and the job's spans (spans.json) into this directory")
    parser.add_argument("--fuse_scales", action="store_true",
                        help="accepted for CLI compat; the per-scale loop runs (with a warning)")
    parser.add_argument("--load_args", type=str, default=None)
    parser.add_argument("--ffmpeg_args", type=str, default="configs/ffmpeg-libx264.json")
    parser.add_argument("--scaling_args", type=str, default="configs/scaling-img.json",
                        help="multi-scale model configuration table")
    parser.add_argument("--uniq", action="store_true")
    # fmt: on
    return parser


def get_args(argv=None) -> argparse.Namespace:
    parser = build_parser()
    args = parser.parse_args(argv)

    output = _output_name(args)
    # flags set explicitly on the command line (even to the default value)
    # win over both --load_args presets and scaling-table entries
    probe = build_parser()
    for action in probe._actions:
        action.default = argparse.SUPPRESS
    cli_set = set(vars(probe.parse_known_args(argv)[0]))

    if args.load_args is not None:
        file_args = argparse.Namespace()
        with open(resolve_config_path(args.load_args) or args.load_args, "r") as f:
            file_args.__dict__ = json.load(f)
        argdict = vars(args)
        for key in argdict:
            if key in cli_set or key not in file_args.__dict__:
                setattr(file_args, key, argdict[key])
        args = file_args
        output = _output_name(args)

    if args.save_args:
        os.makedirs("configs", exist_ok=True)
        with open(f"configs/{output}_args.json", "w") as f:
            json.dump(args.__dict__, f, indent=2)

    args.output = f"{args.output_dir}/{output}"

    ff_path = resolve_config_path(args.ffmpeg_args)
    if ff_path:
        with open(ff_path, "r") as f:
            ffargs = json.load(f)
    else:
        ffargs = {"c:v": "libx264", "preset": "slow", "pix_fmt": "yuv420p"}
    ffargs["framerate"] = args.fps
    args.ffmpeg = ffargs

    args._cli_set = sorted(cli_set)
    return postprocess(args)


def _output_name(args) -> str:
    content = getattr(args, "content", None) or "content"
    styles = getattr(args, "style", None) or ["style"]
    if isinstance(styles, str):
        styles = styles.split(",")
    output = f"{name(content)}_{'_'.join(name(s) for s in styles)}"
    if getattr(args, "uniq", False):
        output += f"_{str(uuid.uuid4())[:6]}"
    return output


def postprocess(args) -> argparse.Namespace:
    args.normalize_gradients = not args.no_grad_norm
    args.match_histograms = not args.no_hist_match

    if getattr(args, "allow_random_weights", False):
        os.environ["MAUA_ALLOW_RANDOM_WEIGHTS"] = "1"

    if getattr(args, "download_weights", False):
        from .io.download import ensure_weights, names_for_args

        ensure_weights(names_for_args(args))

    args.image_sizes = [int(s) for s in str(args.image_sizes).split(",")] if not isinstance(args.image_sizes, list) else args.image_sizes
    args.num_iters = [int(s) for s in str(args.num_iters).split(",")] if not isinstance(args.num_iters, list) else args.num_iters
    if len(args.image_sizes) != len(args.num_iters):
        raise ValueError("-image_sizes and -num_iters must have the same number of elements!")

    # style blend weight normalisation (reference config.py:146-164)
    if args.style_blend_weights is None:
        weights = [1.0] * (len(args.style) if args.style else 1)
    elif isinstance(args.style_blend_weights, list):
        weights = [float(w) for w in args.style_blend_weights]
    else:
        weights = [float(x) for x in str(args.style_blend_weights).split(",")]
        if args.style is not None and len(weights) != len(args.style):
            raise ValueError("-style_blend_weights and -style must have the same number of elements!")
    total = sum(weights)
    args.style_blend_weights = [w / total for w in weights]

    args.devices, args.mesh_shape = setup_devices(args)
    args.device = args.devices[0]
    return args


def setup_devices(args) -> tuple[list[torch.device], list[tuple[str, int]]]:
    """The devices and the mesh's axes from the reference-style ``--gpu``
    flag and ``--mesh`` (JAX config.py:255-303): ``(devices, [(axis,
    size), ...])``.

    - ``--gpu 0,1`` lists CUDA devices; every one must exist (JAX drops an
      id that does not and falls back to device 0: a hidden fallback this
      port does not copy).  Without CUDA a CUDA request raises.
    - ``c`` anywhere in ``--gpu`` selects the CPU, as one entry, or as many
      entries as ``--mesh`` spans (``--gpu c --mesh space:2``: two, JAX's
      virtual CPU devices).  A device may repeat (``--gpu 0,0``): one card
      then stands in for two.
    - ``--mesh frames:2`` / ``space:2`` names the axes; without it every
      device is on "space".  A mesh larger than the devices shrinks to
      ``space:len(devices)`` (JAX :301-302); a smaller one takes the first
      devices (``parallel.mesh.build_mesh``).

    A scaling table's per-scale ``"mesh"`` (``set_model_args`` writes
    ``args.mesh``) does not reach the engine, as in JAX: the engine's mesh
    is this ``args.mesh_shape``, set once here.
    """
    gpu = str(getattr(args, "gpu", "0"))
    axes = parse_mesh(getattr(args, "mesh", None))
    if "c" in gpu.lower():
        if any(d.strip().lower() != "c" for d in gpu.split(",")):
            print(f"Warning: mixed device list {gpu!r} runs CPU-only in this build.")
        devices = [torch.device("cpu")] * (math.prod(s for _, s in axes) if axes else 1)
    else:
        ids = [int(i) for i in gpu.split(",")]
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"--gpu {gpu} asks for a CUDA device but torch.cuda.is_available() is False; "
                "pass --gpu c to run on the CPU"
            )
        missing = [i for i in ids if i >= torch.cuda.device_count()]
        if missing:
            raise RuntimeError(f"--gpu {gpu}: only {torch.cuda.device_count()} CUDA device(s) visible")
        devices = [torch.device("cuda", i) for i in ids]
    if not axes or math.prod(s for _, s in axes) > len(devices):
        axes = [("space", len(devices))]
    return devices, axes


def parse_mesh(mesh: str | None) -> list[tuple[str, int]]:
    """``"frames:2,space:4"`` -> ``[("frames", 2), ("space", 4)]``."""
    if not mesh:
        return []
    axes = []
    for part in str(mesh).split(","):
        axis, size = part.split(":")
        axes.append((axis.strip(), int(size)))
    return axes


def single_device(args, what: str, why: str) -> torch.device:
    """The one device of a path that runs on one: the first of
    ``args.devices`` (chosen here by ``setup_devices`` when the caller's
    parser did not); a mesh over more than one device raises
    ``NotImplementedError`` saying ``why`` (a ROADMAP item, or the JAX
    CLI's own single device)."""
    if getattr(args, "devices", None) is None:
        args.devices, args.mesh_shape = setup_devices(args)
    n = math.prod(s for _, s in args.mesh_shape)
    if n > 1:
        raise NotImplementedError(f"{what} runs on one device; a mesh over {n} devices ({args.mesh_shape}): {why}")
    return args.devices[0]


def load_args(filepath: str, **overrides) -> argparse.Namespace:
    """Load a full args preset from JSON (reference config.py:210-224);
    ``overrides`` (``gpu="c"``, ...) replace the preset's values before the
    devices are chosen."""
    args = argparse.Namespace()
    with open(filepath, "r") as f:
        args.__dict__ = json.load(f)
    args.__dict__.update(overrides)
    if getattr(args, "content", None) is not None and getattr(args, "style", None) is not None:
        args.output = f"{args.output_dir}/{_output_name(args)}"
    if not hasattr(args, "ffmpeg"):
        args.ffmpeg = {"c:v": "libx264", "framerate": getattr(args, "fps", 24)}
    return postprocess(args)


def set_model_args(args, current_size: int) -> None:
    """Per-scale model/optimizer swap from the scaling table (reference
    optim.py:93-108): pick the first entry with size >= current whose device
    requirement fits the selected devices; mutate args in place."""
    path = resolve_config_path(args.scaling_args)
    if path is None:
        return
    with open(path, "r") as f:
        scaling = json.load(f)

    available = len(getattr(args, "devices", None) or [None])
    params = None
    for size, cand in sorted(scaling.items(), key=lambda kv: int(kv[0])):
        if int(size) < current_size:
            continue
        need = cand.get("devices", len(str(cand.get("gpu", "0")).split(",")))
        if int(need) > available:
            continue
        params = cand
        break
    if params is None:
        print("Warning: no model configuration found for this size, out of memory error is likely...")
        params = list(scaling.values())[-1]
    cli_set = set(getattr(args, "_cli_set", ()))
    for key, val in params.items():
        if key in ("gpu", "devices"):
            continue  # device requirements used for selection, not settings
        if key in cli_set:
            continue  # an explicit CLI flag beats the table
        args.__dict__[key] = val


__all__ = ["get_args", "load_args", "postprocess", "set_model_args", "build_parser", "resolve_config_path", "setup_devices",
           "parse_mesh", "single_device"]
