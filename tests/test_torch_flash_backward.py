"""K6a/K6b (flash-attention backward) of the PyTorch port against the JAX package.

The port's `FlashAttention` (K1 forward, K6a + K6b backward; on CPU tensors
their plain versions) is held against `jax.grad` of the Pallas
`flash_attention_structured` in interpret mode, in fp32, at max abs error
<= 1e-4 * max |ref| per gradient. The CUDA kernels themselves are checked on
the card by `chip_smoke.py`.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reflectionflow_tpu.ops.pallas_attention import flash_attention_structured
from reflectionflow_tpu_torch.ops.attention import joint_attention
from reflectionflow_tpu_torch.ops.flash_attention import (
    FlashAttention, flash_attention_bwd, flash_attention_bwd_ref, flash_attention_fwd,
    flash_attention_ref, flash_bwd_dkv, flash_bwd_dq)

torch.set_num_threads(1)
REL_TOL = 1e-4

# L=256 is a multiple of the JAX blocks (64); 100 is not (the padded path)
CASES = [(256, 0, 0.0), (256, 64, -1e30), (256, 64, math.log(2.0)), (100, 0, 0.0), (100, 25, math.log(2.0))]


def _inputs(L, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, w = (rng.standard_normal((2, L, 2, 32)).astype(np.float32) for _ in range(4))
    return q, k, v, w


@pytest.mark.parametrize("L,cond_len,cross_bias", CASES)
def test_flash_grads_match_pallas_interpret(L, cond_len, cross_bias):
    q, k, v, w = _inputs(L)

    def loss(q, k, v):
        out = flash_attention_structured(q, k, v, main_len=L - cond_len, cross_bias=cross_bias,
                                         block_q=64, block_k=64, interpret=True)
        return jnp.sum(out * jnp.asarray(w))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = FlashAttention.apply(tq, tk, tv, L - cond_len, cross_bias)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (tq, tk, tv))
    for name, g, ww in zip("qkv", got, want):
        ww = np.asarray(ww)
        err = np.abs(g.numpy() - ww).max()
        assert err <= REL_TOL * np.abs(ww).max(), f"d{name}: {err} vs max {np.abs(ww).max()}"


@pytest.mark.parametrize("cond_len,cross_bias", [(0, 0.0), (48, -1e30), (48, math.log(0.5))])
def test_bwd_ref_matches_autograd_of_forward_ref(cond_len, cross_bias):
    """The plain backward is the gradient of the plain forward (fp32)."""
    q, k, v, w = (torch.from_numpy(x) for x in _inputs(160, seed=1))
    main_len = 160 - cond_len
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    out, lse = flash_attention_ref(qg, kg, vg, main_len, cross_bias)
    want = torch.autograd.grad(out, (qg, kg, vg), w)
    got = flash_attention_bwd_ref(q, k, v, out.detach(), lse.detach(), w, main_len, cross_bias)
    for g, ww in zip(got, want):
        torch.testing.assert_close(g, ww, atol=1e-5, rtol=1e-5)
    # the wrapper takes the plain version on CPU tensors and returns the input dtype
    got2 = flash_attention_bwd(q, k, v, out.detach(), lse.detach(), w, main_len, cross_bias)
    for g, g2 in zip(got, got2):
        assert g2.dtype == q.dtype and torch.equal(g, g2)


def test_bwd_ref_rounds_like_the_kernels():
    """With bf16 inputs, p and ds are rounded to bf16 before the products."""
    q, k, v, w = (torch.from_numpy(x).to(torch.bfloat16) for x in _inputs(64, seed=2))
    out, lse = flash_attention_ref(q.float(), k.float(), v.float())
    dq, dk, dv = flash_attention_bwd_ref(q, k, v, out, lse, w)
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(32), -1)
    want_dv = torch.einsum("bhqk,bqhd->bkhd", p.to(torch.bfloat16).float(), w.float())
    torch.testing.assert_close(dv, want_dv, atol=2e-5, rtol=1e-5)
    assert dq.dtype == dk.dtype == torch.float32


def test_joint_attention_pallas_is_differentiable():
    """joint_attention(impl="pallas") carries gradients to every stream, equal
    to those of the "xla" path."""
    q, k, v, w = (torch.from_numpy(x) for x in _inputs(96, seed=3))
    grads = {}
    for impl in ("pallas", "xla"):
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        outs = joint_attention(*([x[:, :64], x[:, 64:]] for x in xs), impl=impl)
        loss = sum((o * ww).sum() for o, ww in zip(outs, (w[:, :64], w[:, 64:])))
        grads[impl] = torch.autograd.grad(loss, xs)
    for a, b in zip(grads["pallas"], grads["xla"]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_kernel_wrappers_refuse_cpu_tensors_and_count_nothing():
    """K6a/K6b wrappers take CUDA tensors only; the CPU path never counts."""
    q, k, v, w = (torch.from_numpy(x) for x in _inputs(32, seed=4))
    out, lse = flash_attention_fwd(q, k, v)
    delta = (w * out).sum(-1).transpose(1, 2).contiguous()
    before = (flash_bwd_dq.launches, flash_bwd_dkv.launches)
    with pytest.raises(TypeError, match="bf16"):
        flash_bwd_dq(q, k, v, w, lse, delta, 32)
    with pytest.raises(TypeError, match="bf16"):
        flash_bwd_dkv(q, k, v, w, lse, delta, 32)
    flash_attention_bwd(q, k, v, out, lse, w)
    assert (flash_bwd_dq.launches, flash_bwd_dkv.launches) == before
