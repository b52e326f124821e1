"""Small shared helpers (JAX counterpart: maua_style_tpu/utils)."""

from __future__ import annotations


def name(s: str) -> str:
    """Stem of a path-like string (reference: utils.py:53-54)."""
    return str(s).split("/")[-1].split(".")[0]


__all__ = ["name"]
