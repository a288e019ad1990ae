"""Guards of the PyTorch port: its config tree against the JAX package's, the
weight bridge as the exact inverse of `utils/hf_convert.py`, and the
standard-library PNG writer against PIL."""

import dataclasses
import glob
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from reflectionflow_tpu import config as jconfig
from reflectionflow_tpu.models.flux.dit import flux_dit_init
from reflectionflow_tpu.models.flux.text import clip_text_init, t5_encoder_init
from reflectionflow_tpu.models.flux.vae import vae_init
from reflectionflow_tpu.utils import hf_convert
from reflectionflow_tpu_torch import config as tconfig
from reflectionflow_tpu_torch.models.flux.dit import FluxDiT
from reflectionflow_tpu_torch.models.flux.text import CLIPTextEncoder, T5Encoder
from reflectionflow_tpu_torch.models.flux.vae import FluxVAE
from reflectionflow_tpu_torch.search.artifacts import save_image
from reflectionflow_tpu_torch.utils import jax_bridge

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.json")))


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p) for p in CONFIGS])
def test_every_config_loads_to_equal_fields(path):
    want = dataclasses.asdict(jconfig.TTSConfig.load(path))
    got = dataclasses.asdict(tconfig.TTSConfig.load(path))
    assert got == want
    assert isinstance(tconfig.TTSConfig.load(path).pipeline_args.dtype, torch.dtype)


def test_model_configs_match():
    for name in ("FluxDiTConfig", "FluxVAEConfig", "T5Config", "CLIPTextConfig"):
        jcls, tcls = getattr(jconfig, name), getattr(tconfig, name)
        assert dataclasses.asdict(tcls()) == dataclasses.asdict(jcls())
        assert dataclasses.asdict(tcls.tiny()) == dataclasses.asdict(jcls.tiny())


def _assert_trees_equal(got, want, path="root"):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(set(got) ^ set(want)))
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_equal(g, w, f"{path}/{i}")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=path)


def _numpy_sd(module, sd):
    """Load through the port module (keys and shapes must fit), then export."""
    module.load_state_dict(sd)
    return {k: v.numpy() for k, v in module.state_dict().items()}


def test_bridge_round_trips_dit():
    cfg = jconfig.FluxDiTConfig.tiny()
    params = jax.tree.map(np.asarray, flux_dit_init(jax.random.PRNGKey(0), cfg))
    sd = _numpy_sd(FluxDiT(tconfig.FluxDiTConfig.tiny()), jax_bridge.dit_state_dict(params, cfg))
    _assert_trees_equal(hf_convert.convert_flux_dit_state(sd, cfg), params)


def test_bridge_round_trips_text_encoders():
    t5_cfg, clip_cfg = jconfig.T5Config.tiny(), jconfig.CLIPTextConfig.tiny()
    t5 = jax.tree.map(np.asarray, t5_encoder_init(jax.random.PRNGKey(1), t5_cfg))
    sd = _numpy_sd(T5Encoder(tconfig.T5Config.tiny()), jax_bridge.t5_state_dict(t5, t5_cfg))
    _assert_trees_equal(hf_convert.convert_t5_state(sd, t5_cfg), t5)
    clip = jax.tree.map(np.asarray, clip_text_init(jax.random.PRNGKey(2), clip_cfg))
    sd = _numpy_sd(CLIPTextEncoder(tconfig.CLIPTextConfig.tiny()), jax_bridge.clip_state_dict(clip, clip_cfg))
    _assert_trees_equal(hf_convert.convert_clip_text_state(sd, clip_cfg), clip)


@pytest.mark.parametrize("chans", [(8, 16), (8, 16, 16)])
def test_bridge_round_trips_vae_decoder(chans):
    cfg = dataclasses.replace(jconfig.FluxVAEConfig.tiny(), block_out_channels=chans)
    params = jax.tree.map(np.asarray, vae_init(jax.random.PRNGKey(3), cfg))
    sd = _numpy_sd(FluxVAE(tconfig.FluxVAEConfig(**dataclasses.asdict(cfg))),
                   jax_bridge.vae_state_dict(params))
    # the converter reads the whole AutoencoderKL; the encoder half is checked
    # in tests/test_torch_vae_encode.py
    _assert_trees_equal(hf_convert.convert_flux_vae_state(sd, cfg)["decoder"], params["decoder"])


@pytest.mark.parametrize("shape", [(17, 23, 3), (5, 9), (4, 6, 4)], ids=["rgb", "grey", "rgba"])
def test_save_image_reads_back_through_pil(tmp_path, shape):
    img = np.random.default_rng(0).integers(0, 256, size=shape, dtype=np.uint8)
    path = str(tmp_path / "sub" / "img.png")
    save_image(path, img)
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im), img)
