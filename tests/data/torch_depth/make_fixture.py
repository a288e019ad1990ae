"""Writes this directory's Depth Anything fixture with transformers and the
JAX package's `depth` preprocessor.

    python tests/data/torch_depth/make_fixture.py

  * `config.json`, `preprocessor_config.json`, `model.safetensors`: a tiny
    Depth Anything snapshot (`tiny_config`: DINOv2 width 32, 4 layers, the
    published 518 px position grid; a narrow neck), seeded weights from numpy
    (`seeded_state`), written by transformers' `save_pretrained` with the
    published DPTImageProcessor settings;
  * `image.png`: a seeded 90x120 RGB image;
  * `depth.png`: the grey map the JAX package's `_depth` gives for it with
    `DEPTH_MODEL_DIR` at this directory (its three channels are equal);
  * `manifest.json`: the sha256 of each file.
`tests/test_torch_depth.py` holds the port and the JAX package to these files
on the CPU; `chip_smoke.py` phase 18 holds the port on the card to them.
"""

import hashlib
import io
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 23
IMAGE_HW = (90, 120)
FILES = ("config.json", "preprocessor_config.json", "model.safetensors", "image.png", "depth.png")
PROCESSOR = {"size": {"height": 518, "width": 518}, "keep_aspect_ratio": True, "ensure_multiple_of": 14,
             "resample": 3, "image_mean": [0.485, 0.456, 0.406], "image_std": [0.229, 0.224, 0.225]}


def tiny_config(depth_estimation_type: str = "relative", **backbone):
    from transformers import DepthAnythingConfig, Dinov2Config

    bb = Dinov2Config(**{"hidden_size": 32, "num_hidden_layers": 4, "num_attention_heads": 4, "image_size": 518,
                         "out_indices": [1, 2, 3, 4], "apply_layernorm": True, "reshape_hidden_states": False,
                         **backbone})
    return DepthAnythingConfig(backbone_config=bb, reassemble_hidden_size=bb.hidden_size,
                               neck_hidden_sizes=[8, 16, 24, 32], fusion_hidden_size=16, head_hidden_size=8,
                               depth_estimation_type=depth_estimation_type,
                               max_depth=20 if depth_estimation_type == "metric" else None)


def seeded_state(model, seed: int) -> dict:
    """numpy-seeded weights for every tensor of a transformers model: weights
    N(0, 1 / weight[0].numel()), vectors (biases) and the embeddings N(0, 0.02^2), norms
    and LayerScales 1 + N(0, 0.02^2)."""
    import torch

    rng = np.random.default_rng(seed)
    out = {}
    for k, v in model.state_dict().items():
        if v.ndim <= 1 or k.startswith("backbone.embeddings.") and "projection" not in k:
            a = rng.standard_normal(v.shape) * 0.02
            if k.endswith("lambda1") or ("norm" in k and k.endswith("weight")):
                a += 1.0
        else:
            a = rng.standard_normal(v.shape) * v[0].numel() ** -0.5
        out[k] = torch.from_numpy(a.astype(np.float32))
    return out


def write_snapshot(path: str, seed: int = SEED, **kw):
    """A seeded tiny snapshot written by transformers -> the transformers model."""
    from transformers import DepthAnythingForDepthEstimation, DPTImageProcessor

    model = DepthAnythingForDepthEstimation(tiny_config(**kw)).eval()
    model.load_state_dict(seeded_state(model, seed))
    model.save_pretrained(path)
    DPTImageProcessor(**PROCESSOR).save_pretrained(path)
    return model


def seeded_image(h: int, w: int, seed: int) -> np.ndarray:
    """A smooth seeded RGB image with mild noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    f = rng.uniform(0.02, 0.1, (3, 2))
    img = np.stack([128 + 90 * np.sin(xx * f[c, 0] + c) * np.cos(yy * f[c, 1] - c) for c in range(3)], -1)
    return np.clip(img + rng.normal(0, 4, img.shape), 0, 255).astype(np.uint8)


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from PIL import Image

    from reflectionflow_tpu.sampler import condition as jcond

    write_snapshot(HERE)
    img = seeded_image(*IMAGE_HW, SEED)
    Image.fromarray(img).save(os.path.join(HERE, "image.png"))
    os.environ["DEPTH_MODEL_DIR"] = HERE
    depth = jcond._depth(img)
    assert (depth == depth[..., :1]).all()
    buf = io.BytesIO()
    Image.fromarray(depth[..., 0]).save(buf, format="PNG")
    with open(os.path.join(HERE, "depth.png"), "wb") as f:
        f.write(buf.getvalue())
    manifest = {"seed": SEED, "image_hw": list(IMAGE_HW)}
    for name in FILES:
        with open(os.path.join(HERE, name), "rb") as f:
            manifest[name] = hashlib.sha256(f.read()).hexdigest()
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
