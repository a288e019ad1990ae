"""Depth Anything, the `depth` condition preprocessor's model: `dinov2.py`
(the backbone), `dpt.py` (neck and head), `processing.py` (DPT's
preprocessing and the pipeline's post-processing) and `model.py` (the model,
its random init and the snapshot reader / writer)."""

from .dinov2 import Dinov2Backbone
from .dpt import DepthAnythingHead, DepthAnythingNeck
from .model import DepthAnythingForDepthEstimation, load_depth_anything, save_depth_anything
from .processing import DepthProcessorConfig, depth_to_uint8, preprocess, resize_depth, resize_output_size

__all__ = ["DepthAnythingForDepthEstimation", "DepthAnythingHead", "DepthAnythingNeck", "DepthProcessorConfig",
           "Dinov2Backbone", "depth_to_uint8", "load_depth_anything", "preprocess", "resize_depth",
           "resize_output_size", "save_depth_anything"]
