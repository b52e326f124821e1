"""CLIP in PyTorch (JAX counterpart: maua_style_tpu/models/clip): the
ViT-B/32 visual and text towers, the BPE tokenizer, and converters from the
JAX package's tree and OpenAI's state dict."""

from .model import CLIP, CLIPConfig, VIT_B32, init_clip
from .tokenizer import SimpleTokenizer, tokenize

__all__ = ["CLIP", "CLIPConfig", "VIT_B32", "init_clip", "tokenize", "SimpleTokenizer"]
