"""Depth Anything (`DepthAnythingForDepthEstimation`): the model behind the
`depth` condition preprocessor.

Counterpart of transformers' class of that name, which the JAX package's
`depth` preprocessor runs through `pipeline("depth-estimation")`: the DINOv2
backbone (`dinov2.py`), the DPT neck and head (`dpt.py`), and the snapshot's
preprocessing (`processing.py`). The parameter names are transformers'
(`backbone.*`, `neck.*`, `head.*`), so a published snapshot (a local
directory: `config.json`, `preprocessor_config.json`, `*.safetensors`) loads
unchanged with `load_depth_anything`, and `save_depth_anything` writes one.
"""

from __future__ import annotations

import contextlib
import json
import os

import numpy as np
import torch
from torch import nn

from ...config import DepthAnythingConfig
from ...utils.device import default_device
from .dinov2 import Dinov2Backbone
from .dpt import DepthAnythingHead, DepthAnythingNeck
from .processing import DepthProcessorConfig, depth_to_uint8, preprocess, resize_depth

@contextlib.contextmanager
def no_tf32():
    """cuBLAS and cuDNN without TF32 inside the block (restored after)."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn


INIT_STD = 0.02  # the CLS token's and the positions' std in `random_init` (transformers' initializer_range)


class DepthAnythingForDepthEstimation(nn.Module):
    """Backbone, neck and head; `processor` is the snapshot's preprocessing."""

    def __init__(self, cfg: DepthAnythingConfig = DepthAnythingConfig(),
                 processor: DepthProcessorConfig = DepthProcessorConfig()):
        super().__init__()
        self.cfg, self.processor = cfg, processor
        self.backbone = Dinov2Backbone(cfg.backbone)
        self.neck = DepthAnythingNeck(cfg)
        self.head = DepthAnythingHead(cfg)

    @property
    def device(self) -> torch.device:
        return self.head.conv3.weight.device

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(B, 3, h, w) pixel values -> (B, h', w') predicted depth, h' = patch
        * (h // patch)."""
        gh, gw = pixel_values.shape[2] // self.cfg.patch_size, pixel_values.shape[3] // self.cfg.patch_size
        return self.head(self.neck(self.backbone(pixel_values), gh, gw), gh, gw)

    @classmethod
    def random_init(cls, seed: int, cfg: DepthAnythingConfig = DepthAnythingConfig(),
                    processor: DepthProcessorConfig = DepthProcessorConfig(), dtype: torch.dtype = torch.float32,
                    device: str | torch.device | None = None) -> "DepthAnythingForDepthEstimation":
        """Random weights drawn on the CPU from `seed` (the same on every
        device), then moved to `device` (default cuda) in `dtype`: linear and
        conv weights N(0, 1/fan_in) (a transposed conv's fan-in is its input
        channels), biases N(0, INIT_STD^2), unit LayerNorms and LayerScales,
        the CLS token and the positions N(0, INIT_STD^2), a zero mask token."""
        device = default_device(device)
        g = torch.Generator().manual_seed(seed)
        model = cls(cfg, processor)
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                    fan_in = m.weight.shape[0] if isinstance(m, nn.ConvTranspose2d) else m.weight[0].numel()
                    m.weight.normal_(0.0, fan_in ** -0.5, generator=g)
                    if m.bias is not None:
                        m.bias.normal_(0.0, INIT_STD, generator=g)
                elif isinstance(m, nn.LayerNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
            emb = model.backbone.embeddings
            emb.cls_token.normal_(0.0, INIT_STD, generator=g)
            emb.position_embeddings.normal_(0.0, INIT_STD, generator=g)
            if cfg.backbone.use_mask_token:
                emb.mask_token.zero_()
            for layer in model.backbone.encoder.layer:
                layer.layer_scale1.lambda1.fill_(cfg.backbone.layerscale_value)
                layer.layer_scale2.lambda1.fill_(cfg.backbone.layerscale_value)
        return model.to(device=device, dtype=dtype).eval().requires_grad_(False)

    @torch.no_grad()
    def predict(self, img: np.ndarray) -> torch.Tensor:
        """(H, W, 3) uint8 RGB -> (H, W) depth on the model's device: the
        pipeline's preprocessing, the forward, and the post-processing's
        bicubic resize to the input's size. On the card TF32 is off for the
        call: fp32 is fp32, as in the JAX package's CPU run of the model."""
        w = self.head.conv3.weight
        pix = torch.from_numpy(preprocess(img, self.processor))[None].to(w.device, w.dtype)
        with no_tf32():
            return resize_depth(self(pix)[0], tuple(img.shape[:2]))

    def depth_map(self, img: np.ndarray) -> np.ndarray:
        """(H, W, 3) uint8 RGB -> the (H, W, 3) uint8 depth map the JAX
        package's `depth` preprocessor gives."""
        return depth_to_uint8(self.predict(img).float().cpu().numpy())


def load_depth_anything(model_dir: str, dtype: torch.dtype = torch.float32,
                        device: str | torch.device | None = None) -> DepthAnythingForDepthEstimation:
    """A local Depth Anything snapshot directory -> the model on `device`
    (default cuda) in `dtype`, with the snapshot's processor. A tensor missing
    from the snapshot or left over raises KeyError; a configuration the port
    does not run raises ValueError."""
    from ...utils.hf_loader import load_module

    device = default_device(device)
    path = os.path.join(model_dir, "config.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path}: not a Depth Anything snapshot directory")
    with open(path) as f:
        cfg = DepthAnythingConfig.from_json(json.load(f))
    processor = DepthProcessorConfig.from_dir(model_dir)
    return load_module(lambda: DepthAnythingForDepthEstimation(cfg, processor), model_dir, dtype, device)


def save_depth_anything(model: DepthAnythingForDepthEstimation, model_dir: str) -> None:
    """Write `model` as a snapshot transformers and `load_depth_anything` read:
    `config.json`, `preprocessor_config.json`, `model.safetensors`."""
    from ...utils.safetensors_io import save_file

    os.makedirs(model_dir, exist_ok=True)
    save_file(model.state_dict(), os.path.join(model_dir, "model.safetensors"), metadata={"format": "pt"})
    for name, d in (("config.json", model.cfg.to_json()), ("preprocessor_config.json", model.processor.to_json())):
        with open(os.path.join(model_dir, name), "w") as f:
            json.dump(d, f, indent=1)
