"""Host-side input/output (JAX counterpart: maua_style_tpu/io).  Arrays are
NHWC float32 in the Caffe-BGR space (x*255, RGB->BGR, mean subtracted)."""

from .image import CAFFE_MEAN, deprocess, load_u8, preprocess, process_style_images, save_image, save_tensor_to_file
from .video import preprocess_video, process_style_videos, save_video

__all__ = ["CAFFE_MEAN", "preprocess", "load_u8", "deprocess", "save_image", "save_tensor_to_file", "process_style_images",
           "preprocess_video", "save_video", "process_style_videos"]
