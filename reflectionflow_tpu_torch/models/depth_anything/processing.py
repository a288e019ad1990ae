"""DPT's image preprocessing and the depth pipeline's post-processing, on the
host.

Counterpart of transformers' `DPTImageProcessor.preprocess` (the slow
processor, which a snapshot's `preprocessor_config.json` names) and of the
depth-estimation pipeline's `postprocess`, which the JAX package's `depth`
preprocessor runs:

  * resize keeping the aspect ratio (the scale nearer to 1 wins) to sides
    rounded to multiples of `ensure_multiple_of` (Python's `round`, half to
    even, as `constrain_to_multiple_of`), by PIL's bicubic `Image.resize` on
    the uint8 image (`utils/image_io.resize_bicubic`, bit for bit);
  * rescale in float64 then cast to float32, normalize in float32 with the
    snapshot's mean and std, channels first;
  * post-processing: the predicted depth bicubically resized
    (align_corners=False) to the input's (H, W), min-max scaled in numpy
    float32, times 255 and truncated to uint8, the grey map repeated to three
    channels (`Image.fromarray(..., "L").convert("RGB")`).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ...utils.image_io import resize_bicubic

_BICUBIC = 3  # PIL's Resampling.BICUBIC


@dataclass(frozen=True)
class DepthProcessorConfig:
    """The `preprocessor_config.json` keys the port reads. Defaults =
    depth-anything-small's file."""

    do_resize: bool = True
    height: int = 518
    width: int = 518
    keep_aspect_ratio: bool = True
    ensure_multiple_of: int = 14
    do_rescale: bool = True
    rescale_factor: float = 1 / 255
    do_normalize: bool = True
    image_mean: tuple[float, ...] = (0.485, 0.456, 0.406)
    image_std: tuple[float, ...] = (0.229, 0.224, 0.225)

    @staticmethod
    def from_json(d: dict) -> "DepthProcessorConfig":
        """A snapshot's `preprocessor_config.json`; keys missing mean
        `DPTImageProcessor`'s defaults. A processor or an option the port
        does not run raises ValueError."""
        kind = d.get("image_processor_type", "DPTImageProcessor")
        if kind != "DPTImageProcessor":
            raise ValueError(f"image_processor_type {kind!r}: the port runs DPTImageProcessor (ROADMAP queue 1)")
        if d.get("do_pad") or d.get("resample", _BICUBIC) != _BICUBIC:
            raise ValueError("a DPT processor with do_pad or a filter other than bicubic (ROADMAP queue 1)")
        size = d.get("size") or {"height": 384, "width": 384}
        if "shortest_edge" in size or "longest_edge" in size:
            raise ValueError(f"DPT processor size {size}: the port reads height and width (ROADMAP queue 1)")
        return DepthProcessorConfig(
            do_resize=d.get("do_resize", True), height=size["height"], width=size["width"],
            keep_aspect_ratio=d.get("keep_aspect_ratio", False), ensure_multiple_of=d.get("ensure_multiple_of", 1),
            do_rescale=d.get("do_rescale", True), rescale_factor=d.get("rescale_factor", 1 / 255),
            do_normalize=d.get("do_normalize", True),
            image_mean=tuple(d.get("image_mean") or (0.5, 0.5, 0.5)),
            image_std=tuple(d.get("image_std") or (0.5, 0.5, 0.5)))

    @staticmethod
    def from_dir(model_dir: str) -> "DepthProcessorConfig":
        path = os.path.join(model_dir, "preprocessor_config.json")
        if not os.path.exists(path):
            raise FileNotFoundError(f"{path}: a Depth Anything snapshot needs its preprocessor_config.json")
        with open(path) as f:
            return DepthProcessorConfig.from_json(json.load(f))

    def to_json(self) -> dict:
        return {"image_processor_type": "DPTImageProcessor", "do_resize": self.do_resize,
                "size": {"height": self.height, "width": self.width}, "resample": _BICUBIC,
                "keep_aspect_ratio": self.keep_aspect_ratio, "ensure_multiple_of": self.ensure_multiple_of,
                "do_rescale": self.do_rescale, "rescale_factor": self.rescale_factor,
                "do_normalize": self.do_normalize, "image_mean": list(self.image_mean),
                "image_std": list(self.image_std), "do_pad": False}


def _to_multiple(val: float, multiple: int) -> int:
    """transformers' `constrain_to_multiple_of` (min_val 0, no max: a
    positive side only rounds)."""
    return round(val / multiple) * multiple


def resize_output_size(h: int, w: int, cfg: DepthProcessorConfig) -> tuple[int, int]:
    """DPT's `get_resize_output_image_size` -> (height, width)."""
    sh, sw = cfg.height / h, cfg.width / w
    if cfg.keep_aspect_ratio:
        if abs(1 - sw) < abs(1 - sh):
            sh = sw
        else:
            sw = sh
    return _to_multiple(sh * h, cfg.ensure_multiple_of), _to_multiple(sw * w, cfg.ensure_multiple_of)


def preprocess(img: np.ndarray, cfg: DepthProcessorConfig) -> np.ndarray:
    """(H, W, 3) uint8 RGB -> (3, h, w) float32 pixel values."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise TypeError(f"depth preprocessing takes (H, W, 3) uint8 images, got {img.dtype} {img.shape}")
    x = img
    if cfg.do_resize:
        h, w = resize_output_size(img.shape[0], img.shape[1], cfg)
        x = resize_bicubic(img, (w, h))
    if cfg.do_rescale:
        x = (x.astype(np.float64) * cfg.rescale_factor).astype(np.float32)
    if cfg.do_normalize:
        x = x.astype(np.float32, copy=False)
        x = (x - np.asarray(cfg.image_mean, np.float32)) / np.asarray(cfg.image_std, np.float32)
    return np.ascontiguousarray(x.transpose(2, 0, 1), dtype=np.float32)


def resize_depth(predicted: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """(h, w) predicted depth -> (H, W), the post-processing's bicubic resize."""
    return F.interpolate(predicted[None, None], size=size, mode="bicubic", align_corners=False)[0, 0]


def depth_to_uint8(depth: np.ndarray) -> np.ndarray:
    """(H, W) float32 depth -> (H, W, 3) uint8: min-max scaled, times 255,
    truncated (numpy float32, as the pipeline), grey repeated to RGB."""
    depth = np.asarray(depth, np.float32)
    depth = (depth - depth.min()) / (depth.max() - depth.min())
    grey = (depth * 255).astype("uint8")
    return np.repeat(grey[..., None], 3, axis=-1)
