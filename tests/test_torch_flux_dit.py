"""The PyTorch port's FLUX DiT and its parts against the JAX package.

Weights are the JAX package's own init, perturbed with seeded numpy noise so
that biases and norm scales are not trivially 0 or 1, carried to the port by
`utils/jax_bridge.py`. Inputs are seeded numpy arrays handed to both. fp32
bound 1e-4 (the bound of `test_flux_torch_parity.py`); the bf16 forward is
held within 3e-2 of the output's max magnitude, since both frameworks round
to bf16 at their own places.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reflectionflow_tpu.config import FluxDiTConfig
from reflectionflow_tpu.models.flux import latents as jlat
from reflectionflow_tpu.models.flux import rope as jrope
from reflectionflow_tpu.models.flux.dit import flux_dit_apply, flux_dit_init, timestep_embedding as j_temb
from reflectionflow_tpu.ops import norms as jnorms
from reflectionflow_tpu_torch.config import FluxDiTConfig as TFluxDiTConfig
from reflectionflow_tpu_torch.models.flux import latents as tlat
from reflectionflow_tpu_torch.models.flux import rope as trope
from reflectionflow_tpu_torch.models.flux.dit import FluxDiT, timestep_embedding as t_temb
from reflectionflow_tpu_torch.ops import norms as tnorms
from reflectionflow_tpu_torch.utils.jax_bridge import dit_state_dict

torch.set_num_threads(1)
ATOL = 1e-4
B, TY, TX, LT = 2, 4, 4, 6


def _t(x):
    return torch.from_numpy(np.asarray(x))


def perturbed(tree, seed, scale=0.02):
    """JAX param tree -> numpy tree with seeded noise added to every leaf."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a, np.float32) + scale * rng.standard_normal(a.shape)).astype(np.float32),
        tree)


def _cfg(**kw):
    base = dict(in_channels=8, hidden_size=64, num_heads=2, head_dim=32, num_double_blocks=2,
                num_single_blocks=3, text_dim=48, pooled_dim=24, axes_dims_rope=(8, 12, 12),
                time_freq_dim=32)
    base.update(kw)
    return FluxDiTConfig(**base), TFluxDiTConfig(**base)


def _inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    return dict(
        img=rng.standard_normal((B, TY * TX, cfg.in_channels), dtype=np.float32),
        txt=rng.standard_normal((B, LT, cfg.text_dim), dtype=np.float32),
        pooled=rng.standard_normal((B, cfg.pooled_dim), dtype=np.float32),
        timestep=np.asarray([0.7, 0.3], np.float32),
        img_ids=jrope.make_image_ids(TY, TX),
        txt_ids=jrope.make_text_ids(LT),
        guidance=np.asarray([3.5, 3.5], np.float32),
    )


def _models(guidance=True):
    jcfg, tcfg = _cfg(guidance_embeds=guidance)
    params = perturbed(flux_dit_init(jax.random.PRNGKey(0), jcfg), seed=1)
    dit = FluxDiT(tcfg)
    dit.load_state_dict(dit_state_dict(params, jcfg))
    return jcfg, params, dit.eval()


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("guidance", [True, False], ids=["dev", "no_guidance"])
def test_dit_forward_fp32(impl, guidance):
    jcfg, params, dit = _models(guidance)
    x = _inputs(jcfg, seed=2)
    g = x.pop("guidance")
    want = flux_dit_apply(jax.tree.map(jnp.asarray, params), jcfg,
                          **{k: jnp.asarray(v) for k, v in x.items()},
                          guidance=jnp.asarray(g) if guidance else None)
    with torch.no_grad():
        got = dit(**{k: _t(v) for k, v in x.items()}, guidance=_t(g) if guidance else None,
                  attn_impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=1e-4)


def test_dit_forward_bf16():
    jcfg, params, dit = _models()
    dit = dit.to(torch.bfloat16)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    x = _inputs(jcfg, seed=3)
    want = np.asarray(flux_dit_apply(
        jparams, jcfg, **{k: jnp.asarray(v, jnp.bfloat16 if k in ("img", "txt", "pooled") else None)
                          for k, v in x.items() if k != "guidance"},
        guidance=jnp.asarray(x["guidance"], jnp.bfloat16)).astype(jnp.float32))
    with torch.no_grad():
        got = dit(**{k: _t(v).to(torch.bfloat16) if k in ("img", "txt", "pooled") else _t(v)
                     for k, v in x.items() if k != "guidance"},
                  guidance=_t(x["guidance"]).to(torch.bfloat16), attn_impl="pallas")
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 3e-2 * np.abs(want).max(), (err, np.abs(want).max())


def test_dit_rejects_unported_modes():
    _, tcfg = _cfg()
    dit = FluxDiT(tcfg)
    x = {k: _t(v) for k, v in _inputs(tcfg, seed=4).items()}
    # ControlNet residuals are ported (tests/test_torch_controlnet_preprocess.py); module mode refuses them
    with pytest.raises(ValueError, match="module cache"):
        dit(**x, controlnet_block_samples=x["img"][None], return_module_outs=True)
    # the velocity-cache hooks are ported (tests/test_torch_vcache.py)
    with torch.no_grad():
        out, resid = dit(**x, return_img_residual=True)
    assert out.shape == x["img"].shape and resid.shape == (*x["img"].shape[:2], tcfg.hidden_size)
    # the cond stream is ported (tests/test_torch_cond_dit.py); it needs its ids
    with pytest.raises(ValueError, match="cond_ids"):
        dit(**x, cond=x["img"])
    # the split serving layout needs q/k permuted first (ops.fuse.permute_rope_layout)
    with pytest.raises(ValueError, match="permute_rope_layout"):
        dit(**x, rope_layout="split")


def test_state_dict_names_are_diffusers():
    _, tcfg = _cfg()
    keys = set(FluxDiT(tcfg).state_dict())
    for k in ("transformer_blocks.0.attn.to_q.weight", "transformer_blocks.1.norm1.linear.bias",
              "transformer_blocks.0.attn.norm_added_k.weight", "transformer_blocks.0.ff.net.2.weight",
              "single_transformer_blocks.2.proj_out.weight", "time_text_embed.guidance_embedder.linear_1.weight",
              "norm_out.linear.weight", "x_embedder.weight", "context_embedder.bias"):
        assert k in keys, k


def test_rope_matches_jax():
    rng = np.random.default_rng(5)
    ids = np.concatenate([jrope.make_text_ids(5), jrope.make_image_ids(3, 4, position_delta=(1, -2))])
    axes = (8, 12, 12)
    jc, js = jrope.rope_tables(jnp.asarray(ids), axes)
    tc, ts = trope.rope_tables(_t(ids), axes)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    x = rng.standard_normal((2, len(ids), 3, 32)).astype(np.float32)
    np.testing.assert_allclose(trope.apply_rope(_t(x), tc, ts).numpy(),
                               np.asarray(jrope.apply_rope(jnp.asarray(x), jc, js)), atol=1e-6)


def test_latent_packing_matches_jax():
    rng = np.random.default_rng(6)
    grid = rng.standard_normal((2, 8, 12, 16)).astype(np.float32)
    packed = tlat.pack_latents(_t(grid))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jlat.pack_latents(jnp.asarray(grid))))
    np.testing.assert_array_equal(tlat.unpack_latents(packed, 4, 6).numpy(), grid)
    assert tlat.latent_tokens(1024, 768) == jlat.latent_tokens(1024, 768)
    noise = tlat.draw_packed_noise(torch.Generator().manual_seed(0), 2, 64, 32, dtype=torch.float32)
    assert noise.shape == (2, 4 * 2, 64)


def test_norms_and_timestep_embedding_match_jax():
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, 5, 64)) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    sh, sc = (rng.standard_normal((2, 64)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(tnorms.layer_norm(_t(x)).numpy(), np.asarray(jnorms.layer_norm(x)), atol=1e-5)
    np.testing.assert_allclose(tnorms.rms_norm(_t(x), _t(scale)).numpy(),
                               np.asarray(jnorms.rms_norm(x, scale)), atol=1e-5)
    np.testing.assert_allclose(tnorms.adaln_modulate(_t(x), _t(sh), _t(sc)).numpy(),
                               np.asarray(jnorms.adaln_modulate(x, sh, sc)), atol=1e-5)
    t = np.asarray([0.0, 250.0, 1000.0], np.float32)
    np.testing.assert_allclose(t_temb(_t(t), 32).numpy(), np.asarray(j_temb(jnp.asarray(t), 32)), atol=1e-5)
