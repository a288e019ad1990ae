"""K2–K5 (fused QK-norm+RoPE and act-quant) of the PyTorch port against the JAX
package.

The port's plain versions (`reflectionflow_tpu_torch.ops.fused_quant.*_ref`,
what a CPU tensor runs) are held against the Pallas kernels of
`reflectionflow_tpu/ops/pallas_quant.py` in interpret mode, on the same seeded
numpy inputs, some read through strided views as the serving forward passes
them. Tolerances:
  * K2 (fp32): atol 3e-5, rtol 1e-4 (the bound of the JAX package's own test);
  * K3, K4: scales within rtol 1e-5; int8 values within 1, at most 0.1% of them
    differing (sums and tanh in another order can move a value across a .5
    rounding boundary);
  * K5: bit-exact (absmax and one division per element, no reduction order).
The CUDA kernels themselves are checked on the card by `chip_smoke.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reflectionflow_tpu.ops import pallas_quant as pq
from reflectionflow_tpu_torch.models.flux.dit import _rms_fast
from reflectionflow_tpu_torch.models.flux.rope import apply_rope_split
from reflectionflow_tpu_torch.ops import fused_quant as fq

torch.set_num_threads(1)
B, L = 2, 64


def _int8_close(got, want):
    (q, s), (wq, ws) = got, want
    np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=1e-5)
    d = np.abs(q.numpy().astype(np.int32) - np.asarray(wq).astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())


def _panel(rng, width, strided, scale=2.0):
    """(B, L, width) fp32 input, and its port view: the same values, read
    from the middle of a wider panel when `strided`."""
    x = (rng.standard_normal((B, L, width)) * scale + 0.3).astype(np.float32)
    if not strided:
        return x, torch.from_numpy(x)
    wide = np.zeros((B, L, width + 96), np.float32)
    wide[..., 64:64 + width] = x
    return x, torch.from_numpy(wide)[..., 64:64 + width]


@pytest.mark.parametrize("strided", [False, True], ids=["contiguous", "strided"])
def test_k3_adaln_quant_plain_matches_pallas(strided):
    rng = np.random.default_rng(0)
    W = 256
    x, tx = _panel(rng, W, strided)
    mod = (rng.standard_normal((B, 6 * W)) * 0.3).astype(np.float32)
    shift, scale = mod[:, W:2 * W], mod[:, 4 * W:5 * W]
    tmod = torch.from_numpy(mod)  # shift/scale as strided chunks of the modulation output
    want = pq.adaln_quant(jnp.asarray(x), jnp.asarray(shift), jnp.asarray(scale), block_rows=8,
                          interpret=True)
    got = fq.adaln_quant(tx, tmod[:, W:2 * W], tmod[:, 4 * W:5 * W])
    assert got[0].dtype == torch.int8 and got[1].shape == (B, L, 1)
    _int8_close(got, want)


@pytest.mark.parametrize("strided", [False, True], ids=["contiguous", "strided"])
def test_k4_gelu_quant_plain_matches_pallas(strided):
    x, tx = _panel(np.random.default_rng(1), 512, strided)
    _int8_close(fq.gelu_quant(tx), pq.gelu_quant(jnp.asarray(x), block_rows=8, interpret=True))


@pytest.mark.parametrize("strided", [False, True], ids=["contiguous", "strided"])
def test_k5_rowquant_plain_matches_pallas_bit_exact(strided):
    x, tx = _panel(np.random.default_rng(2), 256, strided)
    x[0, 3] = 0.0  # an all-zero row takes the 1e-12 floor
    if strided:
        tx[0, 3] = 0.0
    q, s = fq.rowquant(tx)
    wq, ws = pq.rowquant(jnp.asarray(x), block_rows=8, interpret=True)
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ws))


def _tables(rng, D):
    ang = rng.uniform(0.0, 6.28, (L, D // 2))
    cos = np.concatenate([np.cos(ang), np.cos(ang)], -1).astype(np.float32)
    sin = np.concatenate([np.sin(ang), np.sin(ang)], -1).astype(np.float32)
    return cos, sin


@pytest.mark.parametrize("D", [32, 128])
@pytest.mark.parametrize("strided", [False, True], ids=["contiguous", "strided"])
def test_k2_norm_rope_plain_matches_pallas(D, strided):
    rng = np.random.default_rng(3)
    x, tx = _panel(rng, 3 * D, strided, scale=1.5)
    scale = (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    cos, sin = _tables(rng, D)
    want = pq.norm_rope(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(cos), jnp.asarray(sin), D,
                        block_rows=8, interpret=True)
    got = fq.norm_rope(tx, torch.from_numpy(scale), torch.from_numpy(cos), torch.from_numpy(sin))
    assert got.shape == (B, L, 3 * D) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5, rtol=1e-4)


def test_k2_plain_is_the_serving_chain():
    """K2's plain version == the unfused serving chain _rms_fast -> apply_rope_split
    (fp32), the identity the JAX package's own test pins for its kernel."""
    rng = np.random.default_rng(4)
    D = 128
    x = torch.from_numpy((rng.standard_normal((B, L, 2 * D)) * 2).astype(np.float32))
    scale = torch.from_numpy((1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32))
    cos, sin = map(torch.from_numpy, _tables(rng, D))
    want = apply_rope_split(_rms_fast(x.unflatten(-1, (2, D)), scale), cos, sin).flatten(-2)
    torch.testing.assert_close(fq.norm_rope(x, scale, cos, sin), want, atol=3e-5, rtol=1e-4)


def _args(name, device):
    x = torch.zeros((1, 8, 128), device=device)
    if name == "adaln_quant":
        return x, torch.zeros((1, 128), device=device), torch.zeros((1, 128), device=device)
    if name == "norm_rope":
        return (x, torch.ones(128, device=device), torch.ones((8, 128), device=device),
                torch.zeros((8, 128), device=device))
    return (x,)


@pytest.mark.parametrize("name", ["norm_rope", "adaln_quant", "gelu_quant", "rowquant"])
def test_wrapper_has_no_silent_fallback(name):
    """A tensor on a device that is neither CPU nor CUDA is refused, never sent
    to the plain version; CPU calls do not count as kernel launches."""
    fn = getattr(fq, name)
    before = fn.launches
    with pytest.raises(NotImplementedError):
        fn(*_args(name, "meta"))
    fn(*_args(name, "cpu"))
    assert fn.launches == before
