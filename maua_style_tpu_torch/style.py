"""CLI entry point for style transfer (JAX counterpart:
maua_style_tpu/style.py; reference: style.py:314-323).

Usage::

    python -m maua_style_tpu_torch.style --content c.png --style s.png [...]

Runs on CUDA device 0 unless ``--gpu c`` asks for the CPU.
``--transfer_type img_img`` and ``vid_img`` are ported; ``img_vid`` raises.
"""

from __future__ import annotations

import numpy as np

from . import config

_LATER = {"img_vid": "ROADMAP Queue 1, Slice C (img_vid, item 12)"}


def main(argv=None) -> None:
    args = config.get_args(argv)

    if args.seed >= 0:
        np.random.seed(args.seed)

    if args.transfer_type in _LATER:
        raise NotImplementedError(
            f"--transfer_type {args.transfer_type} is not ported yet: {_LATER[args.transfer_type]}"
        )
    if args.transfer_type == "vid_img":
        from .pipelines.vid_img import vid_img

        vid_img(args)
    else:
        from .pipelines.img_img import img_img

        img_img(args)


if __name__ == "__main__":
    main()
