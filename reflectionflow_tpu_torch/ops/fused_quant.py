"""K2–K5: the fused prologues of the W8A8 serving linears, with their plain
PyTorch versions.

Counterpart of `reflectionflow_tpu/ops/pallas_quant.py`:

  * K3 `adaln_quant`: non-affine LayerNorm, ·(1 + scale) + shift, per-token int8;
  * K4 `gelu_quant`: tanh-GELU, per-token int8;
  * K5 `rowquant`: per-token int8;
  * K2 `norm_rope`: per-head RMS QK-norm × scale, then the half-split RoPE.

K3–K5 are `csrc/act_quant.cu` (one source, one shared row-quant epilogue),
K2 is `csrc/norm_rope.cu`; both are CUDA C++ for sm_90a, built by
`ops/kernel_build.py`, and their source notes say what bounds them and how the
design answers that.

Dispatch, as for K1: a CUDA tensor launches the kernel or the wrapper raises;
a CPU tensor takes the plain version (`*_ref`), which is also what
`chip_smoke.py` holds each kernel against. Inputs may be strided views (the
serving forward passes slices of its matmul panels); each kernel reads them
through their strides. Each wrapper counts its launches in `.launches`.

Row quant (all three act-quant kernels): s = max(amax, 1e-12) · fp32(1/127)
and q = round-half-even(y / s) in fp32; returns (q int8 (B, L, W), s fp32
(B, L, 1)).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

HEAD_DIM = 128
EPS = 1e-6
_OP = {"adaln": 0, "gelu": 1, "row": 2}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _row_quant(y: torch.Tensor):
    # / 127 as the product with fp32(1/127), which is what the compiled JAX
    # kernels compute (XLA rewrites the division by a constant)
    s = y.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) * (1.0 / 127.0)
    return torch.round(y / s).to(torch.int8), s


def adaln_quant_ref(x, shift, scale, eps: float = EPS):
    """x (B, L, W); shift/scale (B, W). LayerNorm statistics, modulation and
    quantization all in fp32, as the TPU kernel."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mu * mu
    r = 1.0 / torch.sqrt(var.clamp_min(0.0) + eps)
    y = ((xf - mu) * r) * (1.0 + scale.float()[:, None, :]) + shift.float()[:, None, :]
    return _row_quant(y)


def gelu_quant_ref(x):
    return _row_quant(F.gelu(x.float(), approximate="tanh"))


def rowquant_ref(x):
    return _row_quant(x.float())


_HEAD_LANES = 16  # K2's lanes per head


def _sum_sq(xf: torch.Tensor) -> torch.Tensor:
    """Sum of squares over the last axis (a head) in K2's order: D/16
    consecutive values per lane in sequence, then the 16 lanes' xor-shuffle
    tree. The kernel and this version then agree bit for bit; for D not a
    multiple of 16 (tiny test configs) a plain sum."""
    sq = xf * xf
    D = sq.shape[-1]
    if D % _HEAD_LANES:
        return sq.sum(dim=-1, keepdim=True)
    lanes = sq.unflatten(-1, (_HEAD_LANES, D // _HEAD_LANES))
    acc = lanes[..., 0]
    for j in range(1, D // _HEAD_LANES):
        acc = acc + lanes[..., j]
    while acc.shape[-1] > 1:
        half = acc.shape[-1] // 2
        acc = acc[..., :half] + acc[..., half:]
    return acc


def norm_rope_ref(x, scale, cos, sin, eps: float = EPS):
    """x (B, L, n_heads * D) panel; scale (D,); cos/sin (L, D) split-layout
    tables. Per head: fp32 mean of squares, the normed value rounded to x's
    dtype and times `scale`, then the rotation in the dtype the operands
    promote to (all bf16 on the serving path, as the TPU kernel)."""
    D = scale.shape[0]
    half = D // 2
    xf = x.unflatten(-1, (-1, D)).float()
    r = 1.0 / torch.sqrt(_sum_sq(xf) / D + eps)
    xn = (xf * r).to(x.dtype) * scale
    x1, x2 = xn[..., :half], xn[..., half:]
    c, s = cos[:, None, :], sin[:, None, :]
    out = torch.cat([x1 * c[..., :half] - x2 * s[..., :half],
                     x2 * c[..., half:] + x1 * s[..., half:]], dim=-1)
    return out.to(x.dtype).flatten(-2)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _device_kind(x, name: str) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"{name} has no kernel for device {x.device}")
    return x.device.type


def _check(name: str, t, device, shape) -> None:
    """bf16 on `device`, of `shape`, unit last stride, 16-byte aligned rows."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name} must be bf16, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:-1]) or t.data_ptr() % 16:
        raise ValueError(f"{name} needs unit last stride and 16-byte aligned rows, "
                         f"got strides {t.stride()}")


def _fn(source: str, symbol: str, argtypes):
    from .kernel_build import load

    fn = getattr(load(source), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ACT_QUANT_ARGS = [_I, _P, _LL, _LL, _P, _LL, _P, _LL, _P, _P, _I, _I, _I, ctypes.c_float, _P]
_NORM_ROPE_ARGS = [_P, _LL, _LL, _P, _P, _LL, _P, _LL, _P, _I, _I, _I, ctypes.c_float, _P]


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _act_quant_launch(op: str, x, shift=None, scale=None, eps: float = EPS):
    B, L, W = x.shape
    _check("x", x, x.device, (B, L, W))
    if W % 8 or W > 8 * 4 * 1024 or B * L >= 2**31:
        raise ValueError(f"act_quant takes W % 8 == 0, W <= 32768 and B*L < 2^31, got {tuple(x.shape)}")
    if op == "adaln":
        _check("shift", shift, x.device, (B, W))
        _check("scale", scale, x.device, (B, W))
    q = torch.empty((B, L, W), dtype=torch.int8, device=x.device)
    s = torch.empty((B, L, 1), dtype=torch.float32, device=x.device)
    fn = _fn("act_quant.cu", "act_quant_bf16", _ACT_QUANT_ARGS)
    with torch.cuda.device(x.device):
        err = fn(_OP[op], x.data_ptr(), x.stride(0), x.stride(1),
                 None if shift is None else shift.data_ptr(), 0 if shift is None else shift.stride(0),
                 None if scale is None else scale.data_ptr(), 0 if scale is None else scale.stride(0),
                 q.data_ptr(), s.data_ptr(), B, L, W, float(eps), _stream(x.device))
    if err != 0:
        raise RuntimeError(f"act_quant ({op}) launch failed with cudaError {err}")
    return q, s


def adaln_quant(x, shift, scale, eps: float = EPS):
    """K3: x (B, L, W); shift/scale (B, W) -> (q int8 (B, L, W), s fp32 (B, L, 1))."""
    if _device_kind(x, "adaln_quant") == "cpu":
        return adaln_quant_ref(x, shift, scale, eps)
    out = _act_quant_launch("adaln", x, shift, scale, eps)
    adaln_quant.launches += 1
    return out


def gelu_quant(x):
    """K4: tanh-GELU then per-token int8. x (B, L, W)."""
    if _device_kind(x, "gelu_quant") == "cpu":
        return gelu_quant_ref(x)
    out = _act_quant_launch("gelu", x)
    gelu_quant.launches += 1
    return out


def rowquant(x):
    """K5: per-token int8. x (B, L, W)."""
    if _device_kind(x, "rowquant") == "cpu":
        return rowquant_ref(x)
    out = _act_quant_launch("row", x)
    rowquant.launches += 1
    return out


def norm_rope(x, scale, cos, sin, eps: float = EPS):
    """K2: x (B, L, n_heads * D) q or k panel; scale (D,); cos/sin (L, D).
    Returns the normed and rotated panel, contiguous, in x's dtype."""
    if _device_kind(x, "norm_rope") == "cpu":
        return norm_rope_ref(x, scale, cos, sin, eps)
    B, L, HD = x.shape
    if HD % HEAD_DIM or scale.shape != (HEAD_DIM,):
        raise NotImplementedError(f"norm_rope is built for head_dim {HEAD_DIM}, got x {tuple(x.shape)} "
                                  f"and scale {tuple(scale.shape)}")
    _check("x", x, x.device, (B, L, HD))
    _check("scale", scale, x.device, (HEAD_DIM,))
    _check("cos", cos, x.device, (L, HEAD_DIM))
    _check("sin", sin, x.device, (L, HEAD_DIM))
    out = torch.empty((B, L, HD), dtype=x.dtype, device=x.device)
    fn = _fn("norm_rope.cu", "norm_rope_bf16_d128", _NORM_ROPE_ARGS)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), x.stride(0), x.stride(1), scale.data_ptr(), cos.data_ptr(),
                 cos.stride(0), sin.data_ptr(), sin.stride(0), out.data_ptr(), B, L,
                 HD // HEAD_DIM, float(eps), _stream(x.device))
    if err != 0:
        raise RuntimeError(f"norm_rope launch failed with cudaError {err}")
    norm_rope.launches += 1
    return out


adaln_quant.launches = gelu_quant.launches = rowquant.launches = norm_rope.launches = 0
