"""CLI entry point for style transfer (JAX counterpart:
maua_style_tpu/style.py; reference: style.py:314-323).

Usage::

    python -m maua_style_tpu_torch.style --content c.png --style s.png [...]

Runs on CUDA device 0 unless ``--gpu c`` asks for the CPU.  All three
transfer types of the JAX CLI are ported: ``img_img``, ``vid_img`` and
``img_vid``.  A job is the span ``pipeline.<transfer_type>``; with
``--profile_dir`` tracing is on for the whole job, and ``spans.json`` in
that directory holds the job's roots (``trace.Root.to_dict``) at its end.
"""

from __future__ import annotations

import json
import os

import numpy as np

from . import config, trace


def main(argv=None) -> None:
    args = config.get_args(argv)

    if args.seed >= 0:
        np.random.seed(args.seed)

    profile_dir = getattr(args, "profile_dir", None)
    if profile_dir:
        trace.enable()
        before = set(trace.roots())
    try:
        with trace.span(f"pipeline.{args.transfer_type}"):
            _run(args)
    finally:
        if profile_dir:
            trace.disable()
            os.makedirs(profile_dir, exist_ok=True)
            with open(os.path.join(profile_dir, "spans.json"), "w") as f:
                json.dump([r.to_dict() for r in trace.roots() if r not in before], f)


def _run(args) -> None:
    if args.transfer_type == "vid_img":
        from .pipelines.vid_img import vid_img

        vid_img(args)
    elif args.transfer_type == "img_vid":
        from .pipelines.img_vid import img_vid

        img_vid(args)
    else:
        from .pipelines.img_img import img_img

        img_img(args)


if __name__ == "__main__":
    main()
