"""Host-side input/output (JAX counterpart: maua_style_tpu/io).  Arrays are
NHWC float32 in the Caffe-BGR space (x*255, RGB->BGR, mean subtracted)."""

from .image import CAFFE_MEAN, deprocess, preprocess, process_style_images, save_image, save_tensor_to_file

__all__ = ["CAFFE_MEAN", "preprocess", "deprocess", "save_image", "save_tensor_to_file", "process_style_images"]
