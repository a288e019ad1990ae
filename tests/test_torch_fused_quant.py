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
The CUDA kernels themselves are checked on the card by `chip_smoke.py`; no
test here runs one. The tests below the JAX parity tests emulate, step by step
in fp32 torch, the arithmetic the kernels use in place of the plain version's
(K3–K5's row-quant epilogue, K2's summation order, K4's GELU form) and hold it
to the plain version: bit for bit where the kernel must be (the epilogue, the
sum of squares), within K4's own limits for the GELU. The file takes ≈ 10 s on
one CPU core.
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


# ---------------------------------------------------------------------------
# the kernels' arithmetic, emulated on the CPU
# ---------------------------------------------------------------------------

_MAGIC = 12582912.0  # 1.5 * 2^23, as in csrc/act_quant.cu
_WINDOW = 2.0 ** -15


def _byte_perm(x, y, selector):
    """CUDA's __byte_perm on int64 tensors holding 32-bit words."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(src[(selector >> (4 * k)) & 7] << (8 * k) for k in range(4))


def _epilogue(y):
    """csrc/act_quant.cu's row-quant epilogue in fp32: inv = RN(1/s), t = RN(y inv),
    r = RN(t + 1.5 2^23), d = t - (r - 1.5 2^23); the low byte of r where |d| <
    1/2 - 2^-15, else the exact division; bytes packed four to a word by byte
    permutes. Returns (q int8, s, which elements took the exact path)."""
    s = y.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) * (1.0 / 127.0)
    inv = 1.0 / s
    t = y * inv
    r = t + _MAGIC
    d = t - (r - _MAGIC)
    near = ~(d.abs() < 0.5 - _WINDOW)
    words = r.view(torch.int32).long() & 0xFFFFFFFF
    exact = torch.round(y / s).to(torch.int8).view(torch.uint8).long()
    words = torch.where(near, exact, words).unflatten(-1, (-1, 4))
    packed = _byte_perm(_byte_perm(words[..., 0], words[..., 1], 0x0040),
                        _byte_perm(words[..., 2], words[..., 3], 0x0040), 0x5410)
    q = packed.to(torch.int32).unsqueeze(-1).view(torch.uint8).view(torch.int8).flatten(-2)
    return q, s, near


def _quotient_rows(rng):
    """1 536 rows of 1 024 fp32 values: normal rows over ten decades of scale;
    rows of exact k + 1/2 ties of their own step, and of neighbours a few ulps
    away; all-zero rows; rows under the 1e-12 floor."""
    R, W = 1536, 1024
    scale = 10.0 ** rng.uniform(-5, 5, (R, 1))
    y = (rng.standard_normal((R, W)) * scale).astype(np.float32)
    ties = y[:512]
    amax = np.abs(ties).max(-1, keepdims=True)
    s = (np.maximum(amax, np.float32(1e-12)) * np.float32(1.0 / 127.0)).astype(np.float32)
    k = rng.integers(-127, 127, ties.shape).astype(np.float32) + np.float32(0.5)
    near = (k * s).astype(np.float32)
    ulps = rng.integers(-3, 4, ties.shape)
    near = np.where(ulps > 0, np.nextafter(near, np.float32(np.inf)), near)
    near = np.where(ulps < 0, np.nextafter(near, np.float32(-np.inf)), near)
    keep = np.abs(ties) == amax  # each row's amax element stays
    y[:512] = np.where(keep, ties, near)
    y[512:520] = 0.0
    y[520:528] *= np.float32(1e-20)
    return torch.from_numpy(y)


def test_k3_k5_epilogue_emulation_is_bit_exact():
    """K3–K5's epilogue, step by step, gives the plain version's int8 values and
    scales bit for bit on 1.5 M quotients, exact k + 1/2 ties among them."""
    y = _quotient_rows(np.random.default_rng(5))
    q, s, near = _epilogue(y)
    wq, ws = fq._row_quant(y)
    torch.testing.assert_close(s, ws, rtol=0, atol=0)
    assert torch.equal(q, wq), (q != wq).sum().item()
    quot = y / ws
    ties = quot == torch.floor(quot) + 0.5
    assert ties.sum() > 1000 and bool(near[ties].all())  # every tie takes the exact path
    assert 0 < near[528:].float().mean() < 1e-3  # normal rows: ~2 * 2^-15 of them
    assert torch.equal(q[512:520], torch.zeros_like(q[512:520]))
    top = y.abs() == y.abs().amax(dim=-1, keepdim=True)
    assert bool((q[:512][top[:512]].abs() == 127).all())  # each row's amax element maps to +-127


def test_k2_sum_sq_order_is_the_kernels_lanes():
    """_sum_sq equals, bit for bit, K2's sum of squares as its lanes compute it:
    lane i sums elements 8i..8i+7 in sequence, then each lane adds its xor
    partner at distances 8, 4, 2, 1 (all 16 lanes end with the same value)."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4096, 128)) * 10.0 ** rng.uniform(-3, 3, (4096, 1))
    xf = torch.from_numpy(x.astype(np.float32))
    lanes = (xf * xf).unflatten(-1, (16, 8))
    acc = lanes[..., 0]
    for j in range(1, 8):
        acc = acc + lanes[..., j]
    idx = torch.arange(16)
    for o in (8, 4, 2, 1):
        acc = acc + acc[:, idx ^ o]
    assert torch.equal(acc, acc[:, :1].expand_as(acc))
    assert torch.equal(fq._sum_sq(xf)[:, 0], acc[:, 0])


def test_k4_gelu_form_meets_k4_limits():
    """K4's GELU, x / (1 + 2^a) with the kernel's fp32 constants, evaluated in
    fp32, against the plain tanh-GELU: the quantized rows meet K4's limits on
    the card (scales rtol 1e-5; int8 within 1 on at most 0.1% of values)."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy((rng.standard_normal((256, 4096)) * 2.0).astype(np.float32))
    x = x.to(torch.bfloat16).float()
    k_a = torch.tensor(-2.0 * 0.7978845608028654 * 1.4426950408889634, dtype=torch.float32)
    k_b = torch.tensor(-2.0 * 0.7978845608028654 * 0.044715 * 1.4426950408889634, dtype=torch.float32)
    a = x * (k_b * (x * x) + k_a)
    y = x * (1.0 / (1.0 + torch.exp2(a)))
    _int8_close(fq._row_quant(y), [t.numpy() for t in fq.gelu_quant_ref(x)])
