"""maua_style_tpu_torch — the PyTorch/CUDA port of maua_style_tpu for NVIDIA Hopper.

The package mirrors the JAX package's module names (``config``,
``io/image``, ``ops/gram``, ``models/extractor``, ``engine/lbfgs``, ...) so
each module has an obvious counterpart, but uses PyTorch idiom inside:
``nn.Module``s and plain tensor functions, an explicit ``device``, explicit
``torch.Generator``s and ``torch.autograd.Function`` where JAX had
``custom_vjp``.

Layout: host numpy arrays keep the JAX package's (1, H, W, 3) Caffe-BGR,
mean-subtracted layout (preprocess/deprocess, histogram matching, resize,
the pipeline); tensors inside the extractor, the losses and the engine are
NCHW, cuDNN's native layout.

Kernels: the Gram statistic of every style layer runs through a
hand-written CUDA kernel (``csrc/gram.cu``) for CUDA tensors; its plain
PyTorch version serves CPU tensors and the tests.

Entry points run on the GPU unless the caller asks for the CPU
(``--gpu c``); without a CUDA device they raise instead of falling back.
"""

__version__ = "0.1.0"
