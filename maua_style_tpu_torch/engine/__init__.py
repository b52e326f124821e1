"""The optimisation engine (JAX counterpart: maua_style_tpu/engine)."""

from .lbfgs import LBFGS, Adam
from .optimize import StyleEngine

__all__ = ["LBFGS", "Adam", "StyleEngine"]
