"""The PyTorch port's T5, CLIP and VAE decoder against the JAX package.

Weights are the JAX package's init plus seeded numpy noise, carried to the
port by `utils/jax_bridge.py`; fp32, bound 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reflectionflow_tpu.config import CLIPTextConfig, FluxVAEConfig, T5Config
from reflectionflow_tpu.models.flux.text import clip_text_encode, clip_text_init, t5_encode, t5_encoder_init
from reflectionflow_tpu.models.flux.vae import vae_decode, vae_init
from reflectionflow_tpu_torch import config as tconfig
from reflectionflow_tpu_torch.models.flux import text as ttext
from reflectionflow_tpu_torch.models.flux import vae as tvae
from reflectionflow_tpu_torch.utils.jax_bridge import clip_state_dict, t5_state_dict, vae_state_dict

from test_torch_flux_dit import perturbed

torch.set_num_threads(1)
ATOL = 1e-4


def _port_cfg(cfg, cls):
    return cls(**dataclasses.asdict(cfg))


def test_t5_encode_matches_jax():
    cfg = T5Config.tiny()
    params = perturbed(t5_encoder_init(jax.random.PRNGKey(0), cfg), seed=1)
    t5 = ttext.T5Encoder(_port_cfg(cfg, tconfig.T5Config))
    t5.load_state_dict(t5_state_dict(params, cfg))
    ids = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(2, 20)).astype(np.int32)
    want = t5_encode(jax.tree.map(jnp.asarray, params), cfg, jnp.asarray(ids))
    with torch.no_grad():
        got = ttext.t5_encode(t5, torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=1e-4)


@pytest.mark.parametrize("eos", [2, 5], ids=["legacy_argmax_eos", "eos_token"])
def test_clip_pooled_matches_jax(eos):
    cfg = dataclasses.replace(CLIPTextConfig.tiny(), eos_token_id=eos)
    params = perturbed(clip_text_init(jax.random.PRNGKey(0), cfg), seed=3)
    clip = ttext.CLIPTextEncoder(_port_cfg(cfg, tconfig.CLIPTextConfig))
    clip.load_state_dict(clip_state_dict(params, cfg))
    ids = np.random.default_rng(4).integers(6, cfg.vocab_size, size=(2, 16)).astype(np.int32)
    ids[0, 9], ids[1, 3] = eos, eos
    want_h, want_pooled = clip_text_encode(jax.tree.map(jnp.asarray, params), cfg, jnp.asarray(ids))
    with torch.no_grad():
        got_h, got_pooled = ttext.clip_text_encode(clip, torch.from_numpy(ids).long())
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=ATOL, rtol=1e-4)
    np.testing.assert_allclose(got_pooled.numpy(), np.asarray(want_pooled), atol=ATOL, rtol=1e-4)


@pytest.mark.parametrize("chans", [(8, 16, 16), (8,)], ids=["three_levels", "no_upsampler"])
def test_vae_decode_matches_jax(chans):
    cfg = FluxVAEConfig(latent_channels=4, block_out_channels=chans, layers_per_block=1,
                        norm_num_groups=4, scaling_factor=0.3611, shift_factor=0.1159)
    params = perturbed(vae_init(jax.random.PRNGKey(0), cfg), seed=5)
    vae = tvae.FluxVAE(_port_cfg(cfg, tconfig.FluxVAEConfig))
    vae.load_state_dict(vae_state_dict(params))
    lat = np.random.default_rng(6).standard_normal((2, 4, 6, 4)).astype(np.float32)
    want = vae_decode(jax.tree.map(jnp.asarray, params["decoder"]), cfg, jnp.asarray(lat))
    with torch.no_grad():
        got = tvae.vae_decode(vae, torch.from_numpy(lat))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=1e-4)
