"""CLIP in PyTorch (JAX counterpart: maua_style_tpu/models/clip): the
ViT-B/32 and ResNet (RN50, RN101, RN50x4) visual towers, the text tower,
the BPE tokenizer, and converters from the JAX package's tree and OpenAI's
state dict."""

from .model import CLIP, CLIPConfig, VIT_B32, init_clip
from .resnet import RESNET_CONFIGS, CLIPResNet, ResNetConfig, init_clip_resnet
from .tokenizer import SimpleTokenizer, tokenize

__all__ = ["CLIP", "CLIPConfig", "VIT_B32", "init_clip", "CLIPResNet", "ResNetConfig", "RESNET_CONFIGS",
           "init_clip_resnet", "tokenize", "SimpleTokenizer"]
