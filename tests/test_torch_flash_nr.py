"""K9 (flash attention with the QK-norm and split RoPE fused in) of the PyTorch
port against the JAX package.

The port's plain version (`reflectionflow_tpu_torch.ops.flash_attention_nr`,
what a CPU tensor runs) is held against the Pallas kernel in interpret mode in
fp32 at 3e-5, the JAX package's own bound for this kernel against its unfused
composition. The CUDA kernel itself is checked on the card by
`chip_smoke.py`.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reflectionflow_tpu.ops.pallas_attention import flash_attention_nr as jax_flash_attention_nr
from reflectionflow_tpu_torch.ops.flash_attention_nr import flash_attention_nr

torch.set_num_threads(1)
TOL = 3e-5
B, H, D = 2, 2, 32

# (L, txt_len, main_len, cross_bias): the double layout [txt 16 | img 24 | cond 8] with
# c_factor 2 and with the union mask off, the single layout (txt_len 0), a ragged L
CASES = {
    "double_c_factor": (48, 16, 40, math.log(2.0)),
    "double_masked": (48, 16, 40, -1e30),
    "single": (48, 0, None, 0.0),
    "ragged": (37, 16, 29, math.log(2.0)),
}


def _inputs(L, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, L, H, D)).astype(np.float32) for _ in range(3))
    scq, sck = ((1.0 + 0.1 * rng.standard_normal((2, D))).astype(np.float32) for _ in range(2))
    ang = rng.uniform(0.0, 6.28, (L, D // 2))
    cos = np.concatenate([np.cos(ang)] * 2, axis=-1).astype(np.float32)
    sin = np.concatenate([np.sin(ang)] * 2, axis=-1).astype(np.float32)
    return q, k, v, cos, sin, scq, sck


@pytest.mark.parametrize("case", list(CASES))
def test_k9_plain_matches_pallas_interpret(case):
    L, txt_len, main_len, cross_bias = CASES[case]
    arrays = _inputs(L, seed=len(case))
    want = jax_flash_attention_nr(*map(jnp.asarray, arrays), txt_len=txt_len, main_len=main_len,
                                  cross_bias=cross_bias, block_q=16, block_k=16, interpret=True)
    got = flash_attention_nr(*map(torch.from_numpy, arrays), txt_len=txt_len, main_len=main_len,
                             cross_bias=cross_bias)
    assert got.shape == (B, L, H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_k9_txt_rows_take_scale_row_0():
    """Only rows below txt_len read scale row 0: changing row 0 with
    txt_len=0 changes nothing."""
    q, k, v, cos, sin, scq, sck = map(torch.from_numpy, _inputs(24, seed=9))
    base = flash_attention_nr(q, k, v, cos, sin, scq, sck, txt_len=0)
    scq2, sck2 = scq.clone(), sck.clone()
    scq2[0], sck2[0] = 3.0, -2.0
    torch.testing.assert_close(flash_attention_nr(q, k, v, cos, sin, scq2, sck2, txt_len=0), base,
                               rtol=0, atol=0)
    assert not torch.equal(flash_attention_nr(q, k, v, cos, sin, scq2, sck2, txt_len=8), base)


def test_k9_wrapper_has_no_silent_fallback():
    """A tensor on a device that is neither CPU nor CUDA is refused, never sent
    to the plain version; CPU calls do not count as kernel launches; an input
    that requires grad is refused (the kernel has no backward)."""
    before = flash_attention_nr.launches
    x = torch.zeros((1, 8, 1, 128), device="meta")
    t = torch.zeros((8, 128), device="meta")
    s = torch.ones((2, 128), device="meta")
    with pytest.raises(NotImplementedError):
        flash_attention_nr(x, x, x, t, t, s, s)
    args = list(map(torch.from_numpy, _inputs(8, seed=1)))
    flash_attention_nr(*args)
    assert flash_attention_nr.launches == before
    args[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention_nr(*args)
