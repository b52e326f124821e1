"""CLI entry point for style transfer (JAX counterpart:
maua_style_tpu/style.py; reference: style.py:314-323).

Usage::

    python -m maua_style_tpu_torch.style --content c.png --style s.png [...]

Runs on CUDA device 0 unless ``--gpu c`` asks for the CPU.  All three
transfer types of the JAX CLI are ported: ``img_img``, ``vid_img`` and
``img_vid``.
"""

from __future__ import annotations

import numpy as np

from . import config


def main(argv=None) -> None:
    args = config.get_args(argv)

    if args.seed >= 0:
        np.random.seed(args.seed)

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
