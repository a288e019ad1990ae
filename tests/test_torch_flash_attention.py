"""K1 (flash-attention forward) of the PyTorch port against the JAX package.

The port's plain version of K1 (`reflectionflow_tpu_torch.ops.flash_attention`,
what a CPU tensor runs) is held against the Pallas kernel in interpret mode,
out and lse, in fp32 at 2e-5. The CUDA kernel itself is checked on the card
by `chip_smoke.py`.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reflectionflow_tpu.ops.attention import joint_attention as jax_joint_attention
from reflectionflow_tpu.ops.pallas_attention import flash_attention, flash_chunk_fwd
from reflectionflow_tpu_torch.ops.attention import check_impl, joint_attention, sdpa
from reflectionflow_tpu_torch.ops.flash_attention import flash_attention_fwd

torch.set_num_threads(1)
TOL = 2e-5

# L=1024 is a multiple of the TPU kernel's 512 block; 700 leaves a ragged tail
CASES = [
    (1024, None, 0.0),
    (700, None, 0.0),
    (700, 600, -1e30),
    (1024, 900, math.log(0.5)),
]


def _qkv(L, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, L, 2, 32)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("L,main_len,cross_bias", CASES)
def test_k1_plain_matches_pallas_interpret(L, main_len, cross_bias):
    q, k, v = _qkv(L)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_out = flash_attention(jq, jk, jv, main_len=main_len, cross_bias=cross_bias, interpret=True)
    if main_len is None:
        _, want_lse = flash_chunk_fwd(jq, jk, jv, interpret=True)
    else:
        _, want_lse = flash_chunk_fwd(jq, jk, jv, interpret=True, main_len=main_len,
                                      cross_bias=cross_bias, q_offset=0, k_offset=0)
    out, lse = flash_attention_fwd(*map(torch.from_numpy, (q, k, v)), main_len, cross_bias)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=TOL, rtol=0)
    # port lse is (B, H, L); the JAX chunk entry returns (B, L, H, 1)
    np.testing.assert_allclose(lse.numpy().transpose(0, 2, 1), np.asarray(want_lse)[..., 0],
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_joint_attention_matches_jax(impl):
    """Two streams through joint_attention: per-stream splits agree with the
    JAX package's (Pallas in interpret mode for "pallas")."""
    q, k, v = _qkv(160, seed=1)
    split = lambda x: [x[:, :100], x[:, 100:]]  # noqa: E731
    jax_impl = "pallas_interpret" if impl == "pallas" else "xla"
    want = jax_joint_attention(*(list(map(jnp.asarray, split(x))) for x in (q, k, v)), impl=jax_impl)
    got = joint_attention(*(list(map(torch.from_numpy, split(x))) for x in (q, k, v)), impl=impl)
    assert [g.shape[1] for g in got] == [100, 60]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=0)


def test_sdpa_dense_bias_matches_structural_k1():
    """The "xla" path's dense bias and K1's structural (main_len, cross_bias)
    describe the same attention."""
    q, k, v = map(torch.from_numpy, _qkv(96, seed=2))
    main_len, c = 64, math.log(2.0)
    pos = torch.arange(96)
    bias = torch.where((pos[:, None] >= main_len) != (pos[None, :] >= main_len), c, 0.0)
    want = sdpa(q, k, v, bias=bias[None, None])
    got, _ = flash_attention_fwd(q, k, v, main_len, c)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=0)


@pytest.mark.parametrize("impl", ["pallas_interpret", "ring_pallas_interpret"])
def test_unported_impls_raise(impl):
    with pytest.raises(NotImplementedError):
        check_impl(impl)


@pytest.mark.parametrize("impl", ["ring", "ring_pallas"])
def test_ring_impls_are_accepted(impl):
    """The ring impls are ported (ops.ring_attention); without
    set_ring_context, joint_attention refuses them."""
    check_impl(impl)
    q = torch.zeros((1, 8, 1, 16))
    with pytest.raises(ValueError, match="set_ring_context"):
        joint_attention([q], [q], [q], impl=impl)


@pytest.mark.parametrize("impl", ["pallas_nr", "pallas_int8"])
def test_serving_impls_are_accepted(impl):
    """The serving attention impls are ported (K9, K8); their interpret modes
    still raise."""
    check_impl(impl)
    with pytest.raises(NotImplementedError, match="interpret"):
        check_impl(impl + "_interpret")


def test_k1_wrapper_has_no_silent_fallback():
    """A tensor on a device that is neither CPU nor CUDA is refused, never sent
    to the plain version; CPU calls do not count as kernel launches."""
    before = flash_attention_fwd.launches
    q = torch.zeros((1, 8, 1, 128), device="meta")
    with pytest.raises(NotImplementedError):
        flash_attention_fwd(q, q, q)
    flash_attention_fwd(*[torch.zeros((1, 8, 1, 128))] * 3)
    assert flash_attention_fwd.launches == before

