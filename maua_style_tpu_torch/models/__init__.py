"""Feature-extractor model zoo (JAX counterpart: maua_style_tpu/models)."""

from .extractor import Extractor, ExtractorSpec, Layer, init_params, truncate_spec
from .registry import MODEL_NAMES, load_params, select_model

__all__ = ["Extractor", "ExtractorSpec", "Layer", "init_params", "truncate_spec", "select_model", "load_params", "MODEL_NAMES"]
