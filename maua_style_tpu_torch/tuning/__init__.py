"""Capacity tuning (JAX counterpart: maua_style_tpu/tuning; reference:
max-sizes.py)."""

from .max_sizes import estimate_step_bytes, probe_max_sizes

__all__ = ["probe_max_sizes", "estimate_step_bytes"]
