"""The benchmark of the PyTorch/CUDA port (``maua_style_tpu_torch``); see README.md."""
