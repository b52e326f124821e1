"""Tensor and host-array operations (JAX counterpart: maua_style_tpu/ops)."""
