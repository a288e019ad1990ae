"""`jax.random`'s raw threefry keys, bit for bit, in torch integer ops.

Counterpart of `jax._src.prng` / `jax._src.random` (JAX 0.9, raw uint32 keys,
`jax_threefry_partitionable` on, 32-bit mode), so that a seed draws in the port
what it draws in the JAX package: the same latents, training draws, LoRA
init and sampled tokens.

A key is a pair of uint32 words held as a tuple of two Python ints:
`tuple(int(w) for w in np.asarray(jax_key))` is the same key. Keys are split
and folded on the host; a draw hashes its counters as uint32 words held in
int64 tensors on `device` (masked to 32 bits after every add and shift), so
the same function runs on the CPU and on the card.

Bits and uniforms are JAX's bit for bit. `normal` is `sqrt(2) * erf_inv(u)`
with XLA's `erf_inv` (Giles' single-precision polynomial on -log1p(-x^2),
not `torch.special.erfinv`); its log1p and sqrt are torch's, so a normal can
differ from XLA's by a few fp32 ulps (`tests/test_torch_threefry.py` states
the measured maximum).
"""

from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
Key = tuple[int, int]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def prng_key(seed: int) -> Key:
    """`jax.random.PRNGKey(seed)` in JAX's default 32-bit mode: the seed is cast
    to int32 first, so the high word is 0 and the low word is seed mod 2^32
    (`prng.threefry_seed` on the int32 seed)."""
    return (0, int(seed) & MASK)


def as_key(key) -> Key:
    """A key from any (2,) sequence of uint32 words (a JAX key's `np.asarray`)."""
    hi, lo = (int(w) for w in key)
    return (hi & MASK, lo & MASK)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block, 20 rounds (`prng._threefry2x32_lowering`), on
    Python ints or int64 tensors holding uint32 words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & MASK, (x2 + ks[1]) & MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & MASK
    return x[0], x[1]


def split(key: Key, num: int = 2) -> list[Key]:
    """`jax.random.split(key, num)`: key i is the block of counter (0, i)
    (`prng._threefry_split_foldlike`)."""
    k1, k2 = as_key(key)
    return [threefry2x32(k1, k2, 0, i) for i in range(num)]


def fold_in(key: Key, data: int) -> Key:
    """`jax.random.fold_in(key, data)`: the block of counter
    `threefry_seed(data)` = (0, data mod 2^32) (`prng._threefry_fold_in`)."""
    k1, k2 = as_key(key)
    return threefry2x32(k1, k2, 0, int(data) & MASK)


def _shape(shape) -> tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(int(s) for s in shape)


def random_bits(key: Key, shape, bit_width: int = 32, device=None) -> torch.Tensor:
    """`jax.random.bits`: uint words of `bit_width` bits as int64, shape `shape`
    (`prng._threefry_random_bits_partitionable`): the block of the flat index
    as a 64-bit counter, `bits1 ^ bits2` for 32 bits, its low bits for 8 or 16."""
    if bit_width not in (8, 16, 32):
        raise ValueError(f"bit_width must be 8, 16 or 32, got {bit_width}")
    shape = _shape(shape)
    k1, k2 = as_key(key)
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(k1, k2, idx >> 32, idx & MASK)
    bits = b1 ^ b2
    if bit_width < 32:
        bits = bits & ((1 << bit_width) - 1)
    return bits.reshape(shape)


def uniform(key: Key, shape, dtype=torch.float32, minval: float = 0.0, maxval: float = 1.0,
            device=None) -> torch.Tensor:
    """`jax.random.uniform` in float32 or bfloat16 (`random._uniform`): the
    mantissa bits OR 1.0, minus 1, scaled, then `max(minval, .)`."""
    if dtype == torch.float32:
        bits = random_bits(key, shape, 32, device)
        floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    elif dtype == torch.bfloat16:
        # 7 mantissa bits < 8: JAX draws 8 bits and widens them to 16.
        bits = random_bits(key, shape, 8, device)
        floats = ((bits >> 1) | 0x3F80).to(torch.int16).view(torch.bfloat16) - 1.0
    else:
        raise ValueError(f"uniform draws float32 or bfloat16, got {dtype}")
    lo = torch.tensor(minval, dtype=dtype, device=floats.device)
    hi = torch.tensor(maxval, dtype=dtype, device=floats.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


_ERF_INV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
                -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERF_INV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
                -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 `erf_inv` (chlo `materializeErfInvF32`): Giles' polynomial
    on w = -log1p(-x^2), with +-inf at +-1. Other float dtypes go through
    float32 and back, as XLA upcasts them."""
    dtype = x.dtype
    x = x.to(torch.float32)
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = None
    for c_lt, c_ge in zip(_ERF_INV_LT5, _ERF_INV_GE5):
        c = torch.where(lt, torch.tensor(c_lt, dtype=torch.float32, device=x.device),
                        torch.tensor(c_ge, dtype=torch.float32, device=x.device))
        p = c if p is None else c + p * w
    out = torch.where(x.abs() == 1.0, x * math.inf, p * x)
    return out.to(dtype)


def normal(key: Key, shape, dtype=torch.float32, device=None) -> torch.Tensor:
    """`jax.random.normal` (`random._normal_real`): u uniform on
    [nextafter(-1, 0), 1), then `sqrt(2) * erf_inv(u)`, in `dtype`."""
    lo = torch.nextafter(torch.tensor(-1.0, dtype=torch.float32), torch.tensor(0.0)).item()
    if dtype == torch.bfloat16:
        lo = -1.0 + 2.0 ** -8  # nextafter(-1, 0) in bfloat16
    u = uniform(key, shape, dtype, lo, 1.0, device)
    return torch.tensor(math.sqrt(2), dtype=dtype, device=u.device) * erf_inv(u)


def gumbel(key: Key, shape, dtype=torch.float32, device=None) -> torch.Tensor:
    """`jax.random.gumbel` in its default "low" mode: -log(-log(u)), u uniform
    on [tiny, 1) (`random._gumbel`)."""
    tiny = torch.finfo(dtype).tiny
    return -torch.log(-torch.log(uniform(key, shape, dtype, tiny, 1.0, device)))


def categorical(key: Key, logits: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """`jax.random.categorical(key, logits, axis)` with replacement: the argmax
    of `logits` plus Gumbel noise of its shape and dtype (`random.categorical`)."""
    g = gumbel(key, logits.shape, logits.dtype, logits.device)
    return torch.argmax(g + logits, dim=axis)
