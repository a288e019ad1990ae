"""The PyTorch port's DiT with the condition stream against the JAX package.

The tiny DiT (JAX init plus seeded noise, bridged) runs with a cond stream
that reads a LoRA view of the weights (JAX `attach_lora`, the port's
`attach_lora`, the same adapters bridged by `lora_from_jax`), on "xla" (dense
bias) and on "pallas" (structural bias; the JAX Pallas kernel in interpret
mode, the port's plain K1). fp32, max abs error <= 1e-4 of max |out|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reflectionflow_tpu.lora import lora as jlora
from reflectionflow_tpu.models.flux import rope as jrope
from reflectionflow_tpu.models.flux.dit import flux_dit_apply
from reflectionflow_tpu.ops.attention import _cond_bias_template
from reflectionflow_tpu_torch.lora import lora as tlora
from reflectionflow_tpu_torch.utils.jax_bridge import lora_from_jax

from test_torch_flux_dit import TX, TY, _inputs, _models, _t

torch.set_num_threads(1)
REL_TOL = 1e-4


@pytest.fixture(autouse=True)
def _fresh_cond_bias_cache():
    """The JAX reference `lru_cache`s its cond bias template; a template built
    while a jitted `denoise` traces holds a tracer, which an eager call at the
    same length in a later test of this worker would raise on. Clear it around
    every test."""
    _cond_bias_template.cache_clear()
    yield
    _cond_bias_template.cache_clear()


VARIANTS = {
    "union": dict(union_cond_attn=True, latent_lora=False),
    "no_union_latent_lora": dict(union_cond_attn=False, latent_lora=True),
    "c_factor": dict(c_factor=2.0, union_cond_attn=False, latent_lora=False),
    "add_cond_attn": dict(add_cond_attn=True, latent_lora=False),
}


def jax_lora(params, seed=11, r=4, alpha=8.0):
    """A JAX adapter with non-zero B (so the adapter acts), numpy leaves."""
    lora = jlora.lora_init(jax.random.PRNGKey(seed), params, r=r, alpha=alpha)
    rng = np.random.default_rng(seed)
    lora["adapters"] = {p: {"A": np.asarray(ab["A"]),
                            "B": (0.05 * rng.standard_normal(ab["B"].shape)).astype(np.float32)}
                        for p, ab in lora["adapters"].items()}
    return lora


def cond_inputs(cfg, seed):
    x = _inputs(cfg, seed)
    rng = np.random.default_rng(seed + 100)
    x["cond"] = rng.standard_normal((x["img"].shape[0], TY * TX, cfg.in_channels), dtype=np.float32)
    x["cond_ids"] = jrope.make_image_ids(TY, TX, position_delta=(0, -TX))
    return x


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_cond_dit_matches_jax(impl, variant):
    kw = dict(VARIANTS[variant])
    latent = kw.pop("latent_lora")
    jcfg, params, dit = _models()
    jl = jax_lora(params)
    jparams = jax.tree.map(jnp.asarray, params)
    attached = jlora.attach_lora(jparams, jax.tree.map(jnp.asarray, jl))
    x = cond_inputs(jcfg, seed=21)
    want = np.asarray(flux_dit_apply(
        attached if latent else jparams, jcfg, **{k: jnp.asarray(v) for k, v in x.items()},
        cond_params=attached, attn_impl="pallas_interpret" if impl == "pallas" else "xla", **kw))
    view = tlora.attach_lora(dit, lora_from_jax(jl, dit))
    with torch.no_grad():
        got = (view if latent else dit)(**{k: _t(v) for k, v in x.items()}, cond_params=view,
                                        attn_impl=impl, **kw).numpy()
    err = np.abs(got - want).max()
    assert err <= REL_TOL * np.abs(want).max(), (err, np.abs(want).max())


def test_cond_stream_reads_only_the_view():
    """With latent_lora=False the adapter changes the output only through
    the cond stream: no cond stream, no effect; the base weights stay as
    they were."""
    jcfg, params, dit = _models()
    view = tlora.attach_lora(dit, lora_from_jax(jax_lora(params), dit))
    x = {k: _t(v) for k, v in cond_inputs(jcfg, seed=22).items()}
    plain = {k: v for k, v in x.items() if k not in ("cond", "cond_ids")}
    before = {k: v.clone() for k, v in dit.state_dict().items()}
    with torch.no_grad():
        torch.testing.assert_close(dit(**plain, cond_params=view), dit(**plain), rtol=0, atol=0)
        assert not torch.equal(dit(**x, cond_params=view), dit(**x))
    assert all(torch.equal(v, dit.state_dict()[k]) for k, v in before.items())
    assert isinstance(view.transformer_blocks[0].attn.to_q, tlora.LoRALinear)
    assert view.transformer_blocks[0].attn.add_q_proj is dit.transformer_blocks[0].attn.add_q_proj


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_remat_gives_identical_outputs_and_gradients(impl):
    jcfg, params, dit = _models()
    lora = lora_from_jax(jax_lora(params), dit)
    view = tlora.attach_lora(dit, lora)
    x = {k: _t(v) for k, v in cond_inputs(jcfg, seed=23).items()}
    w = torch.from_numpy(np.random.default_rng(24).standard_normal((2, TY * TX, jcfg.in_channels),
                                                                    dtype=np.float32))
    params_t = tlora.lora_parameters(lora)
    results = []
    for remat in (False, True):
        out = dit(**x, cond_params=view, attn_impl=impl, remat=remat)
        grads = torch.autograd.grad((out * w).sum(), params_t, allow_unused=True)
        # the cond stream's last output feeds nothing: those adapters get no gradient
        results.append((out.detach(), [torch.zeros_like(p) if g is None else g
                                       for g, p in zip(grads, params_t)]))
    (o1, g1), (o2, g2) = results
    assert torch.equal(o1, o2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    assert any(a.abs().sum() > 0 for a in g1)
