"""K9: flash attention with the serving QK-norm and split RoPE fused in, and
its plain PyTorch version.

Counterpart of `reflectionflow_tpu/ops/pallas_attention.py::flash_attention_nr`
over `_flash_fwd_nr_kernel` (K9), the attention of `attn_impl="pallas_nr"` in
the serving layout. It takes the RAW per-head q/k/v projections of the joint
sequence; per row of q and of k it applies the RMS QK-norm (fp32, eps 1e-6)
with norm-scale row 0 for positions below `txt_len` and row 1 after, rounds
once to the input dtype, rotates in the half-split RoPE layout, and then runs
K1's attention (structural `main_len` / `cross_bias` bias). Serving only: no
backward, and an input that requires grad raises.

The kernel is `csrc/flash_fwd_nr.cu` on the Hopper pipeline of
`csrc/flash_fwd_sm90.cuh` (CUDA C++ for sm_90a: TMA, wgmma, warp
specialisation; built by `ops/kernel_build.py`); its source notes say what
bounds it and how the design answers that. Dispatch as K1: a CUDA tensor
launches the kernel or the wrapper raises; a CPU tensor takes
`flash_attention_nr_ref`, which is also what `chip_smoke.py` holds the kernel
against. TMA reads q, k and v at their own strides, so the wrapper checks its
terms (`_check_layout`) on every tensor not on the CPU, before the device
check.
"""

from __future__ import annotations

import ctypes

import torch

from .flash_attention import HEAD_DIM, _check_cuda_inputs, _check_layout, flash_attention_ref

EPS = 1e-6


def norm_rot_ref(x, cos, sin, scale, txt_len: int, eps: float = EPS):
    """x (B, L, H, D) raw q or k; cos/sin (L, D) split tables; scale (2, D).
    fp32 mean of squares, x * rsqrt(var + eps) * scale row in fp32, one cast to
    x's dtype, then the rotation in the dtype the operands promote to (all bf16
    on the serving path, as the TPU kernel)."""
    L, D = x.shape[1], x.shape[-1]
    half = D // 2
    xf = x.float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    txt = (torch.arange(L, device=x.device) < txt_len)[:, None]
    sc = torch.where(txt, scale[0].float(), scale[1].float())[None, :, None, :]
    xn = (xf * r * sc).to(x.dtype)
    x1, x2 = xn[..., :half], xn[..., half:]
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * c[..., :half] - x2 * s[..., :half],
                      x2 * c[..., half:] + x1 * s[..., half:]], dim=-1)


def flash_attention_nr_ref(q, k, v, cos, sin, scale_q, scale_k, txt_len: int = 0,
                           main_len: int | None = None, cross_bias: float = 0.0,
                           eps: float = EPS):
    """Plain version: the transform of q and k (`norm_rot_ref`), cast to v's
    dtype, then K1's plain attention. Returns (B, L, H, D) in v's dtype."""
    qn = norm_rot_ref(q, cos, sin, scale_q, txt_len, eps).to(v.dtype)
    kn = norm_rot_ref(k, cos, sin, scale_k, txt_len, eps).to(v.dtype)
    return flash_attention_ref(qn, kn, v, main_len, cross_bias)[0]


def _bind():
    from .kernel_build import load

    fn = load("flash_fwd_nr.cu").flash_fwd_nr_bf16_d128
    if fn.argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = ([p, p, p, p, ll, p, ll, p, p, p, p, i, i, i] + [ll] * 9
                       + [i, i, ctypes.c_float, ctypes.c_float, p])
        fn.restype = ctypes.c_int
    return fn


def _check_table(name, t, device, L):
    if t.device != device or t.dtype != torch.bfloat16 or tuple(t.shape) != (L, HEAD_DIM):
        raise ValueError(f"{name} must be a bf16 ({L}, {HEAD_DIM}) tensor on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if t.stride(1) != 1 or t.stride(0) % 8 or t.data_ptr() % 16:
        raise ValueError(f"{name} needs unit last stride and 16-byte aligned rows, "
                         f"got strides {t.stride()}")


def flash_attention_nr(q, k, v, cos, sin, scale_q, scale_k, txt_len: int = 0,
                       main_len: int | None = None, cross_bias: float = 0.0,
                       eps: float = EPS):
    """Raw (B, L, H, D) q/k/v, (L, D) split tables, (2, D) norm scales ->
    (B, L, H, D). CUDA tensors launch K9 (bf16, D = 128: K9a prepares K, K9b
    attends; one call counts one launch in `flash_attention_nr.launches`); CPU
    tensors take the plain version."""
    if any(t.requires_grad for t in (q, k, v, cos, sin, scale_q, scale_k)):
        raise RuntimeError("flash_attention_nr is serving-only: it has no backward")
    L = q.shape[1]
    main_len = L if main_len is None else int(main_len)
    if q.device.type == "cpu":
        return flash_attention_nr_ref(q, k, v, cos, sin, scale_q, scale_k, txt_len, main_len,
                                      cross_bias, eps)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_layout(name, t)  # TMA's terms, before the device check
    if q.device.type != "cuda":
        raise NotImplementedError(f"flash_fwd_nr has no kernel for device {q.device}")
    _check_cuda_inputs(q, k, v, main_len)
    for name, t in (("cos", cos), ("sin", sin)):
        _check_table(name, t, q.device, L)
    scales = []
    for name, t in (("scale_q", scale_q), ("scale_k", scale_k)):
        if t.device != q.device or tuple(t.shape) != (2, HEAD_DIM):
            raise ValueError(f"{name} must be a (2, {HEAD_DIM}) tensor on {q.device}, "
                             f"got {tuple(t.shape)} on {t.device}")
        scales.append(t.float().contiguous())
    B, L, H, D = q.shape
    kn = torch.empty((B, L, H, D), dtype=q.dtype, device=q.device)
    out = torch.empty((B, L, H, D), dtype=q.dtype, device=q.device)
    fn = _bind()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(), cos.stride(0),
                 sin.data_ptr(), sin.stride(0), scales[0].data_ptr(), scales[1].data_ptr(),
                 kn.data_ptr(), out.data_ptr(), B, L, H, *q.stride()[:3], *k.stride()[:3],
                 *v.stride()[:3], int(txt_len), main_len, float(cross_bias), float(eps), stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd_nr launch failed with cudaError {err}")
    flash_attention_nr.launches += 1
    return out


flash_attention_nr.launches = 0
