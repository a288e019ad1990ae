"""The PyTorch port's VAE encoder and condition encoding against the JAX package.

Weights are the JAX package's init plus seeded numpy noise, carried to the
port by `utils/jax_bridge.py`; fp32, bound 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reflectionflow_tpu.config import FluxVAEConfig
from reflectionflow_tpu.models.flux.vae import vae_encode, vae_init
from reflectionflow_tpu.sampler import condition as jcond
from reflectionflow_tpu.utils import hf_convert
from reflectionflow_tpu_torch import config as tconfig
from reflectionflow_tpu_torch.models.flux import vae as tvae
from reflectionflow_tpu_torch.sampler import condition as tcond
from reflectionflow_tpu_torch.utils import threefry
from reflectionflow_tpu_torch.utils.jax_bridge import vae_state_dict

from test_torch_flux_dit import perturbed

torch.set_num_threads(1)
ATOL = 1e-4


def _vae(chans=(8, 16, 16), seed=5):
    cfg = FluxVAEConfig(latent_channels=4, block_out_channels=chans, layers_per_block=1,
                        norm_num_groups=4, scaling_factor=0.3611, shift_factor=0.1159)
    params = perturbed(vae_init(jax.random.PRNGKey(0), cfg), seed=seed)
    vae = tvae.FluxVAE(tconfig.FluxVAEConfig(**dataclasses.asdict(cfg)))
    vae.load_state_dict(vae_state_dict(params))
    return cfg, params, vae.eval()


@pytest.mark.parametrize("chans", [(8, 16, 16), (8,)], ids=["three_levels", "no_downsampler"])
def test_vae_encode_matches_jax(chans):
    cfg, params, vae = _vae(chans)
    x = np.random.default_rng(6).uniform(-1, 1, (2, 16, 24, 3)).astype(np.float32)
    want = vae_encode(jax.tree.map(jnp.asarray, params["encoder"]), cfg, jnp.asarray(x))
    with torch.no_grad():
        got = tvae.vae_encode(vae, torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=1e-4)


def test_vae_encode_samples_with_a_generator():
    """With a key the latents are mean + exp(logvar / 2) * noise, the noise
    the JAX package's `vae_encode` draws from the same key."""
    cfg, params, vae = _vae()
    x = np.random.default_rng(7).uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    with torch.no_grad():
        mean, logvar = tvae.vae_encode_moments(vae, torch.from_numpy(x)).chunk(2, dim=-1)
        got = tvae.vae_encode(vae, torch.from_numpy(x), key=threefry.prng_key(3))
    noise = threefry.normal(threefry.prng_key(3), tuple(mean.shape))
    want = (mean + torch.exp(0.5 * logvar.clamp(-30, 20)) * noise - cfg.shift_factor) * cfg.scaling_factor
    torch.testing.assert_close(got, want)
    jwant = vae_encode(jax.tree.map(jnp.asarray, params["encoder"]), cfg, jnp.asarray(x),
                       jax.random.PRNGKey(3))
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), atol=ATOL, rtol=1e-4)


def test_bridge_round_trips_vae_encoder():
    """The port's encoder state dict is what the JAX converter reads back."""
    cfg, params, vae = _vae()
    sd = {k: v.numpy() for k, v in vae.state_dict().items()}
    back = hf_convert.convert_flux_vae_state(sd, cfg)["encoder"]
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params["encoder"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("empty", [False, True])
def test_encode_conditions_matches_jax(empty):
    cfg, params, vae = _vae()
    rng = np.random.default_rng(8)
    delta = tcond.cot_position_delta(32)
    assert delta == jcond.cot_position_delta(32) == (0, -2)
    imgs = [rng.integers(0, 256, (32, 32, 3), dtype=np.uint8) for _ in range(3)]
    want_tok, want_ids = jcond.encode_conditions(
        [jcond.Condition("cot", im, position_delta=delta) for im in imgs], params, cfg,
        dtype=jnp.float32, empty=empty)
    with torch.no_grad():
        got_tok, got_ids = tcond.encode_conditions(
            [tcond.Condition("cot", im, position_delta=delta) for im in imgs], vae,
            dtype=torch.float32, empty=empty)
    assert got_tok.shape == want_tok.shape == (3, 16, 16)
    np.testing.assert_allclose(got_tok.numpy(), np.asarray(want_tok), atol=ATOL, rtol=1e-4)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))


def test_condition_types_and_unported_preprocessors(monkeypatch):
    assert tcond.CONDITION_TYPE_IDS == jcond.CONDITION_TYPE_IDS
    img = np.zeros((8, 8, 3), np.uint8)
    assert tcond.Condition("cot", img).type_id == 12
    assert tcond.Condition("subject", img).preprocess() is img
    # canny, coloring and deblurring are ported (tests/test_torch_controlnet_preprocess.py)
    for name in ("canny", "coloring", "deblurring"):
        np.testing.assert_array_equal(tcond.Condition(name, img).preprocess(), img)  # black stays black
    # depth is ported (tests/test_torch_depth.py): without a local snapshot it raises, downloading nothing
    monkeypatch.delenv("DEPTH_MODEL_DIR", raising=False)
    with pytest.raises(FileNotFoundError, match="DEPTH_MODEL_DIR"):
        tcond.Condition("depth", img).preprocess()
    _, _, vae = _vae()
    # tiled encode (vae_tiling) of a condition within one 512 px tile is the untiled encode
    tiled = tcond.encode_conditions([tcond.Condition("cot", img)], vae, torch.float32, tiled=True)
    plain = tcond.encode_conditions([tcond.Condition("cot", img)], vae, torch.float32)
    assert all(torch.equal(a, b) for a, b in zip(tiled, plain))
