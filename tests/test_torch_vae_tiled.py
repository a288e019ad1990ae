"""The port's tiled VAE (`models/flux/vae.py::vae_decode_tiled`,
`vae_encode_tiled`) and `FluxPipeline.vae_tiling` against the JAX package.

The same fp32 weights (the JAX init plus seeded noise, carried by
`utils/jax_bridge.py`); tiles small enough that several tiles and seams
occur, at an overlap that meets the stitch rule; within 1e-4 of max |ref|.
A single-tile input takes the untiled path bit for bit. About 15 s on one core."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reflectionflow_tpu.models.flux.vae import vae_decode_tiled as j_decode_tiled
from reflectionflow_tpu.models.flux.vae import vae_encode_tiled as j_encode_tiled
from reflectionflow_tpu_torch.models.flux import vae as tvae

from test_torch_pipeline import _pipelines
from test_torch_vae_encode import _vae

torch.set_num_threads(1)
REL = 1e-4


def _close(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= REL * np.abs(ref).max()


@pytest.mark.parametrize("hw", [(16, 20), (14, 8)])
def test_decode_tiled_matches_jax(hw):
    """Latent tiles of 8 at overlap 0.25 (stride 6, 8 px blended at scale 4)."""
    cfg, params, vae = _vae()
    z = np.random.default_rng(11).standard_normal((2, *hw, cfg.latent_channels)).astype(np.float32)
    want = j_decode_tiled(jax.tree.map(jnp.asarray, params["decoder"]), cfg, jnp.asarray(z), tile_latent=8)
    with torch.no_grad():
        got = tvae.vae_decode_tiled(vae, torch.from_numpy(z), tile_latent=8)
    assert got.shape == (2, hw[0] * 4, hw[1] * 4, 3)
    _close(got, want)


def test_encode_tiled_matches_jax():
    """Image tiles of 32 px at overlap 0.25 (stride 24, latent tiles of 8)."""
    cfg, params, vae = _vae()
    x = np.random.default_rng(12).uniform(-1, 1, (1, 48, 64, 3)).astype(np.float32)
    want = j_encode_tiled(jax.tree.map(jnp.asarray, params["encoder"]), cfg, jnp.asarray(x), tile_sample=32)
    with torch.no_grad():
        got = tvae.vae_encode_tiled(vae, torch.from_numpy(x), tile_sample=32)
    assert got.shape == (1, 12, 16, cfg.latent_channels)
    _close(got, want)


def test_single_tile_is_the_untiled_path_bitwise():
    _, _, vae = _vae()
    rng = np.random.default_rng(13)
    z = torch.from_numpy(rng.standard_normal((1, 8, 8, 4)).astype(np.float32))
    x = torch.from_numpy(rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(tvae.vae_decode_tiled(vae, z, tile_latent=8), tvae.vae_decode(vae, z))
        assert torch.equal(tvae.vae_encode_tiled(vae, x, tile_sample=32), tvae.vae_encode(vae, x))


def test_stitch_rule_and_bad_tiles_raise():
    _, _, vae = _vae()
    with pytest.raises(ValueError, match="misalign"):
        tvae.vae_decode_tiled(vae, torch.zeros(1, 16, 16, 4), tile_latent=8, overlap_factor=0.3)
    with pytest.raises(ValueError, match="multiples of the VAE scale"):
        tvae.vae_encode_tiled(vae, torch.zeros(1, 48, 48, 3), tile_sample=30)


def test_vae_tiling_generate_matches_jax():
    """`vae_tiling` at 160 px: the 80 x 80 latent grid of the tiny VAE decodes
    as 2 x 2 tiles of the default 64 latents."""
    jpipe, tpipe = _pipelines()
    jpipe.vae_tiling = tpipe.vae_tiling = True
    lat = np.random.default_rng(14).standard_normal((1, 1600, 16), dtype=np.float32)
    kw = dict(height=160, width=160, num_inference_steps=2, max_sequence_length=8)
    want = jpipe.generate(["a red cube"], latents=jnp.asarray(lat), **kw)
    got = tpipe.generate(["a red cube"], latents=lat, **kw)
    assert got.shape == want.shape == (1, 160, 160, 3)
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1
    tpipe.vae_tiling = False
    assert not np.array_equal(tpipe.generate(["a red cube"], latents=lat, **kw), got)  # seams differ
