"""The port's latent registry (`reflectionflow_tpu_torch/models/registry.py`)
against the JAX package's (`tests/test_latents.py` is the JAX counterpart):
per family the spec fields, `seq_len`, and the shape of what `prepare` draws.
The noise itself differs (`torch.Generator` vs `jax.random`, ROADMAP item 24).
Under a second on one core."""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from reflectionflow_tpu.models import registry as jreg
from reflectionflow_tpu_torch.models import registry as treg

torch.set_num_threads(1)


@pytest.mark.parametrize("family", sorted(jreg.LATENT_SPECS))
def test_spec_fields_seq_len_and_prepared_shapes_match_jax(family):
    jspec, tspec = jreg.get_latent_spec(family), treg.get_latent_spec(family)
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    for h, w in ((1024, 1024), (512, 768), (64, 48)):
        assert tspec.seq_len(h, w) == jspec.seq_len(h, w)
        want = jspec.prepare(jax.random.PRNGKey(0), 2, h, w, jnp.float32)
        got = tspec.prepare(torch.Generator().manual_seed(0), 2, h, w, torch.float32)
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    assert tspec.prepare(torch.Generator().manual_seed(0), 1, 64, 64).dtype == torch.bfloat16


@pytest.mark.parametrize("name", ["black-forest-labs/FLUX.1-dev", "stabilityai/stable-diffusion-3-medium",
                                  "stabilityai/stable-diffusion-xl-base-1.0", "runwayml/stable-diffusion-v1-5",
                                  "some/other-model"])
def test_family_for_model_matches_jax(name):
    assert treg.family_for_model(name) == jreg.family_for_model(name)


def test_register_family_and_packed_tokens():
    spec = treg.LatentSpec(channels=8, vae_downscale=4, packed=True)
    treg.register_family("toy", spec)
    try:
        assert treg.get_latent_spec("toy") is spec
        lat = spec.prepare(torch.Generator().manual_seed(1), 1, 32, 32, torch.float32)
        assert tuple(lat.shape) == (1, spec.seq_len(32, 32), 32) == (1, 16, 32)
    finally:
        del treg.LATENT_SPECS["toy"]
