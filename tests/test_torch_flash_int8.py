"""K8 (flash attention with an int8 Q.K^T) of the PyTorch port against the JAX
package.

The K quantizer of the port's plain version is held against a numpy
transcription of the TPU kernel's K preparation (codes equal on >= 99.9% of
elements and never more than 1 apart, since the column sums may run in
another order; scales rtol 1e-6), and the whole plain version against the
Pallas kernel in interpret mode (max |diff| <= 1e-3, fp32) in every
structural-bias mode and at a ragged L. The CUDA kernel itself is checked on
the card by `chip_smoke.py`.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reflectionflow_tpu.ops.pallas_attention import flash_attention_int8 as jax_flash_attention_int8
from reflectionflow_tpu_torch.ops.flash_attention_int8 import flash_attention_int8, quantize_k_ref

torch.set_num_threads(1)
B, H, D = 2, 2, 32

CASES = {  # (L, main_len, cross_bias)
    "plain": (96, None, 0.0),
    "cond_c_factor": (96, 64, math.log(2.0)),
    "cond_masked": (96, 64, -1e30),
    "ragged": (77, 50, math.log(0.5)),
}


def _qkv(L, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, L, H, D)).astype(np.float32) for _ in range(3))
    k += 0.5 * rng.standard_normal((1, 1, H, D)).astype(np.float32)  # a mean for centring to remove
    return q, k, v


def _numpy_k_prep(k):
    """pallas_attention.py:263-270 per (batch, head) on an unpadded stripe."""
    L = k.shape[1]
    codes, scales = np.zeros((B, H, L, D), np.int32), np.zeros((B, H, L), np.float32)
    for b in range(B):
        for h in range(H):
            kf = k[b, :, h].astype(np.float32)
            mean = np.sum(kf, axis=0, keepdims=True, dtype=np.float32) * np.float32(1.0 / L)
            kc = kf - mean
            amax = np.maximum(np.max(np.abs(kc), axis=1, keepdims=True), np.float32(1e-12))
            codes[b, h] = np.rint(kc * (np.float32(127.0) / amax))
            scales[b, h] = (amax * np.float32(1.0 / 127.0))[:, 0]
    return codes, scales


def test_k_quantizer_matches_the_tpu_kernel():
    _, k, _ = _qkv(300, seed=3)
    want_codes, want_scales = _numpy_k_prep(k)
    codes, scales = quantize_k_ref(torch.from_numpy(k))
    assert codes.dtype == torch.int8 and scales.dtype == torch.float32
    diff = np.abs(codes.numpy().astype(np.int32) - want_codes)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())
    np.testing.assert_allclose(scales.numpy(), want_scales, rtol=1e-6, atol=0)


@pytest.mark.parametrize("case", list(CASES))
def test_k8_plain_matches_pallas_interpret(case):
    L, main_len, cross_bias = CASES[case]
    q, k, v = _qkv(L, seed=len(case))
    want = jax_flash_attention_int8(*map(jnp.asarray, (q, k, v)), main_len=main_len,
                                    cross_bias=cross_bias, block_q=32, block_k=32, interpret=True)
    got = flash_attention_int8(*map(torch.from_numpy, (q, k, v)), main_len=main_len,
                               cross_bias=cross_bias)
    assert got.shape == (B, L, H, D) and got.dtype == torch.float32
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-3


def test_k8_wrapper_has_no_silent_fallback():
    """A tensor on a device that is neither CPU nor CUDA is refused, never sent
    to the plain version; CPU calls do not count as kernel launches; an input
    that requires grad is refused (the kernel has no backward)."""
    before = flash_attention_int8.launches
    x = torch.zeros((1, 8, 1, 128), device="meta")
    with pytest.raises(NotImplementedError):
        flash_attention_int8(x, x, x)
    q, k, v = map(torch.from_numpy, _qkv(8))
    flash_attention_int8(q, k, v)
    assert flash_attention_int8.launches == before
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention_int8(q.requires_grad_(True), k, v)
