"""End-to-end pipelines (JAX counterpart: maua_style_tpu/pipelines)."""
