"""Condition stream encoding ("cot" conditioning, OminiControl style).

Counterpart of `reflectionflow_tpu/sampler/condition.py`: a conditioning
image is VAE-encoded (the posterior's mode), packed into 2x2 latent tokens
and given RoPE ids offset by `position_delta` (ReflectionFlow uses
`(0, -condition_size // 16)`). `empty=True` encodes one black image and
broadcasts it, the unconditional branch of image CFG.

The preprocessors are the JAX package's: the identities, and `canny`,
`coloring` and `deblurring`, which call OpenCV there and are written here in
numpy to OpenCV's integer semantics, bit for bit (`cv2.Canny(img, 100, 200)`,
`cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)`, `cv2.GaussianBlur(img, (0, 0),
sigmaX=4)`; the tests hold them to cv2). `depth` runs Depth Anything
(`models/depth_anything/`) from the local snapshot `$DEPTH_MODEL_DIR` on
`$DEPTH_DEVICE` (default cuda) in fp32, as the JAX package's transformers
pipeline runs it, without transformers; the loaded model is kept per (path,
device), where the JAX package builds its pipeline on every call.
`register_preprocessor` adds one.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..models.flux.latents import pack_latents
from ..models.flux.rope import make_image_ids
from ..models.flux.vae import FluxVAE, vae_encode, vae_encode_tiled

# condition_type -> type id, as the JAX package
CONDITION_TYPE_IDS = {
    "depth": 0,
    "canny": 1,
    "subject": 4,
    "coloring": 6,
    "deblurring": 7,
    "depth_pred": 8,
    "fill": 9,
    "sr": 10,
    "cartoon": 11,
    "cot": 12,
}


def _blur_kernel(n: int, sigma: float) -> np.ndarray:
    """OpenCV's 8-bit Gaussian taps: `getGaussianKernelBitExact`'s normalised
    exp(-x^2 / (2 sigma^2)) as fixed point with 8 fractional bits, the
    rounding error carried from tap to tap (`getGaussianKernelFixedPoint_ED`)
    and the centre tap what the others leave of 256."""
    half = (n - 1) // 2
    scale2x = -0.125 / (sigma * sigma)
    vals = [math.exp(float((2 * i + 1 - n) ** 2) * scale2x) for i in range(half)]
    mul = 1.0 / (2.0 * sum(vals) + 1.0)
    taps, err, total = [0] * n, 0.0, 0
    for i, v in enumerate(vals):
        adj = v * mul * 256.0 + err
        taps[i] = taps[n - 1 - i] = round(adj)  # round half to even, as cvRound
        err = adj - taps[i]
        total += taps[i]
    taps[half] = 256 - 2 * total
    return np.asarray(taps, np.int32)


def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """`cv2.GaussianBlur(img, (0, 0), sigmaX=sigma)` on a uint8 (H, W[, C])
    image, bit for bit: OpenCV's 8-bit kernel size (round(6 sigma + 1) | 1),
    its fixed-point taps (`_blur_kernel`), BORDER_REFLECT_101, and its exact
    integer path: the horizontal pass keeps 8 fractional bits, the vertical
    one 16, rounded half up to uint8."""
    n = int(math.floor(sigma * 6 + 1 + 0.5)) | 1
    k, pad = _blur_kernel(n, sigma), n // 2
    x = img.astype(np.int32)
    if x.ndim == 2:
        x = x[..., None]
    H, W = x.shape[:2]
    xp = np.pad(x, ((0, 0), (pad, pad), (0, 0)), mode="reflect")  # numpy's reflect is REFLECT_101
    h = k[0] * xp[:, :W]
    for j in range(1, n):
        h += k[j] * xp[:, j:j + W]
    hp = np.pad(h, ((pad, pad), (0, 0), (0, 0)), mode="reflect")
    v = k[0] * hp[:H]
    for j in range(1, n):
        v += k[j] * hp[j:j + H]
    out = ((v + (1 << 15)) >> 16).clip(0, 255).astype(np.uint8)
    return out.reshape(img.shape)


def rgb_to_gray(img: np.ndarray) -> np.ndarray:
    """`cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)` on uint8 (H, W, 3), bit for bit:
    OpenCV's 15-bit fixed point (0.299, 0.587, 0.114 as 9798, 19235, 3735 of
    2^15), rounded half up. Exhaustive over the 2^24 colours in the tests."""
    x = img.astype(np.int32)
    return ((x[..., 0] * 9798 + x[..., 1] * 19235 + x[..., 2] * 3735 + (1 << 14)) >> 15).astype(np.uint8)


def canny_edges(img: np.ndarray, low: float = 100, high: float = 200) -> np.ndarray:
    """`cv2.Canny(img, low, high)` on uint8 (H, W[, C]) -> (H, W) uint8 of 0 /
    255, bit for bit: a 3x3 Sobel per channel (BORDER_REPLICATE), the L1
    magnitude, per pixel the channel of the largest magnitude (the first on a
    tie), OpenCV's fixed-point non-maximum test (tan 22.5 degrees as
    13573 / 2^15; strict on one side of the gradient and not on the other, as
    its code), candidates above `low`, and hysteresis: a candidate is an edge
    when its 8-connected candidate component holds one above `high`. A `low`
    above `high` swaps them, as OpenCV does."""
    from scipy import ndimage  # connected components for the hysteresis

    low, high = min(low, high), max(low, high)

    x = img.astype(np.int32)
    if x.ndim == 2:
        x = x[..., None]
    H, W = x.shape[:2]
    p = np.pad(x, ((1, 1), (1, 1), (0, 0)), mode="edge")

    def at(a, dy, dx):
        return a[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]

    dx = at(p, -1, 1) + 2 * at(p, 0, 1) + at(p, 1, 1) - at(p, -1, -1) - 2 * at(p, 0, -1) - at(p, 1, -1)
    dy = at(p, 1, -1) + 2 * at(p, 1, 0) + at(p, 1, 1) - at(p, -1, -1) - 2 * at(p, -1, 0) - at(p, -1, 1)
    mag = np.abs(dx) + np.abs(dy)
    pick = np.argmax(mag, axis=-1)[..., None]
    mag, dx, dy = (np.take_along_axis(a, pick, -1)[..., 0] for a in (mag, dx, dy))
    m = np.pad(mag, 1)  # the rows and columns beyond the image have magnitude 0

    ax, ay = np.abs(dx).astype(np.int64), np.abs(dy).astype(np.int64) << 15
    tg22x = ax * 13573  # int(tan(22.5 deg) * 2^15 + 0.5)
    horizontal = ay < tg22x
    vertical = ~horizontal & (ay > tg22x + (ax << 16))
    keep_h = (mag > at(m, 0, -1)) & (mag >= at(m, 0, 1))
    keep_v = (mag > at(m, -1, 0)) & (mag >= at(m, 1, 0))
    keep_d = np.where((dx ^ dy) < 0, (mag > at(m, -1, 1)) & (mag > at(m, 1, -1)),
                      (mag > at(m, -1, -1)) & (mag > at(m, 1, 1)))
    cand = (mag > math.floor(low)) & np.where(horizontal, keep_h, np.where(vertical, keep_v, keep_d))
    labels, n = ndimage.label(cand, structure=np.ones((3, 3), bool))
    edge = np.zeros(n + 1, bool)
    edge[labels[cand & (mag > math.floor(high))]] = True
    edge[0] = False
    return np.where(edge[labels], 255, 0).astype(np.uint8)


def _canny(img: np.ndarray) -> np.ndarray:
    return np.stack([canny_edges(img, 100, 200)] * 3, axis=-1)


def _coloring(img: np.ndarray) -> np.ndarray:
    return np.stack([rgb_to_gray(img)] * 3, axis=-1)


def _deblurring(img: np.ndarray) -> np.ndarray:
    return gaussian_blur(img, 4.0)


DEPTH_MODEL_DEFAULT = "LiheYoung/depth-anything-small-hf"  # the JAX package's DEPTH_MODEL_DIR default
_depth_models: dict = {}


def depth_model(model_dir: str | None = None, device: str | torch.device | None = None):
    """The Depth Anything model of the local snapshot `model_dir` (default
    `$DEPTH_MODEL_DIR`, else the JAX package's default name) on `device`
    (default `$DEPTH_DEVICE`, else cuda), in fp32, loaded once per (path,
    device). A path that is not a local directory raises FileNotFoundError:
    the port reads no hub."""
    from ..models.depth_anything import load_depth_anything
    from ..utils.device import default_device

    model_dir = model_dir or os.environ.get("DEPTH_MODEL_DIR", DEPTH_MODEL_DEFAULT)
    if not os.path.isdir(model_dir):
        raise FileNotFoundError(f"DEPTH_MODEL_DIR={model_dir!r} is not a local directory: the 'depth' "
                                "preprocessor reads a local Depth Anything snapshot (config.json, "
                                "preprocessor_config.json, *.safetensors) and downloads nothing")
    device = default_device(device or os.environ.get("DEPTH_DEVICE") or None)
    key = (os.path.realpath(model_dir), str(device))
    if key not in _depth_models:
        _depth_models[key] = load_depth_anything(model_dir, torch.float32, device)
    return _depth_models[key]


def _depth(img: np.ndarray) -> np.ndarray:
    """Monocular depth: the map transformers' depth-estimation pipeline gives
    the JAX package for the snapshot `$DEPTH_MODEL_DIR`."""
    return depth_model().depth_map(np.asarray(img))


# preprocessors: image (H, W, 3) uint8 -> image (H, W, 3) uint8
PREPROCESSORS: dict[str, Callable[[np.ndarray], np.ndarray]] = {
    "cot": lambda img: img,
    "subject": lambda img: img,
    "fill": lambda img: img,
    "sr": lambda img: img,
    "cartoon": lambda img: img,
    "depth_pred": lambda img: img,  # precomputed depth map passed through
    "depth": _depth,
    "canny": _canny,
    "coloring": _coloring,
    "deblurring": _deblurring,
}


def register_preprocessor(name: str, fn: Callable[[np.ndarray], np.ndarray]) -> None:
    """Add (or replace) the preprocessor of condition type `name`."""
    PREPROCESSORS[name] = fn


@dataclass
class Condition:
    """A conditioning image and its token-grid placement."""

    condition_type: str = "cot"
    image: np.ndarray | None = None  # (H, W, 3) uint8
    position_delta: tuple[int, int] = (0, 0)

    @property
    def type_id(self) -> int:
        return CONDITION_TYPE_IDS[self.condition_type]

    def preprocess(self) -> np.ndarray:
        return PREPROCESSORS[self.condition_type](self.image)


def encode_conditions(conditions: list[Condition], vae: FluxVAE, dtype=torch.bfloat16,
                      empty: bool = False, tiled: bool = False):
    """Batch-encode one condition per candidate -> (cond tokens (B, L_c, 4 C),
    cond ids (L_c, 3)) on the VAE's device. All conditions share size and
    position_delta. `tiled` encodes through `vae_encode_tiled` (diffusers'
    enable_vae_tiling covers encode too; a no-op at conditions of <= 512 px)."""
    encode = vae_encode_tiled if tiled else vae_encode
    device = next(vae.parameters()).device
    if empty:
        # black image: encode one frame and broadcast it (an all-identical batch)
        H, W = conditions[0].preprocess().shape[:2]
        x = torch.full((1, H, W, 3), -1.0, dtype=dtype, device=device)
        latents = encode(vae, x)
        latents = latents.expand(len(conditions), *latents.shape[1:])
    else:
        imgs = np.stack([c.preprocess() for c in conditions])  # (B, H, W, 3) uint8
        x = torch.from_numpy(imgs.astype(np.float32) / 127.5 - 1.0).to(device, dtype)
        latents = encode(vae, x)  # deterministic (mode)
    ids = make_image_ids(latents.shape[1] // 2, latents.shape[2] // 2,
                         position_delta=conditions[0].position_delta)
    return pack_latents(latents).to(dtype), torch.from_numpy(ids).to(device)


def cot_position_delta(condition_size: int) -> tuple[int, int]:
    """ReflectionFlow's delta for the 'cot' condition."""
    return (0, -condition_size // 16)
