"""Flash attention: K1 (forward), K6a and K6b (backward), and their plain
PyTorch versions.

Counterpart of `reflectionflow_tpu/ops/pallas_attention.py`:
`flash_attention` / `flash_attention_structured` and their custom VJP, over
`_flash_fwd_kernel` (K1), `_flash_dq_kernel` (K6a) and `_flash_dkv_kernel`
(K6b). The kernels are `csrc/flash_fwd.cu` and `csrc/flash_bwd.cu` (CUDA C++
for sm_90a, built by `ops/kernel_build.py`); their source notes say what
bounds them and how the design answers that. `FlashAttention` is the
`torch.autograd.Function` that joins them: K1 forward, K6a + K6b backward.

Dispatch: a CUDA tensor goes to the kernel, or the wrapper raises. A CPU
tensor goes to the plain version (`flash_attention_ref`,
`flash_attention_bwd_ref`), the same function written in plain PyTorch in
fp32; it is also what `chip_smoke.py` holds the kernels against.

Semantics (all as the TPU kernels): scale 1/sqrt(D); tokens at or past
`main_len` form the cond segment and (cond x main) logits get `cross_bias`
(applied only when non-zero; -1e30 masks); the forward returns the
normalised output in the input dtype and the fp32 logsumexp rows, here laid
out (B, H, L); the backward recomputes the probabilities from them.
"""

from __future__ import annotations

import ctypes
import math

import torch

HEAD_DIM = 128


def flash_attention_ref(q, k, v, main_len: int | None = None, cross_bias: float = 0.0):
    """Plain version: (B, L, H, D) q/k/v -> (out (B, L, H, D) in q.dtype,
    lse (B, H, L) fp32), computed in fp32."""
    B, L, H, D = q.shape
    main_len = L if main_len is None else main_len
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(D))
    if cross_bias != 0.0:
        pos = torch.arange(L, device=q.device)
        cross = (pos[:, None] >= main_len) != (pos[None, :] >= main_len)
        logits = logits + torch.where(cross, cross_bias, 0.0)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype), lse


def flash_attention_bwd_ref(q, k, v, out, lse, do, main_len: int | None = None,
                            cross_bias: float = 0.0):
    """Plain version of K6a + K6b: (dq, dk, dv) in fp32 for (B, L, H, D)
    q/k/v/out/do and (B, H, L) lse. Computed in fp32 with p and ds rounded to
    q's dtype where the kernels round them (before dS.K, P^T.dO, dS^T.Q)."""
    B, L, H, D = q.shape
    main_len = L if main_len is None else main_len
    scale = 1.0 / math.sqrt(D)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if cross_bias != 0.0:
        pos = torch.arange(L, device=q.device)
        cross = (pos[:, None] >= main_len) != (pos[None, :] >= main_len)
        logits = logits + torch.where(cross, cross_bias, 0.0)
    p = torch.exp(logits - lse.float()[..., None])
    del logits
    delta = (dof * out.float()).sum(-1).transpose(1, 2)  # (B, H, L)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    del dp
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).float(), dof)
    del p
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    return dq, dk, dv


def _check_cuda_inputs(q, k, v, main_len, *more):
    for name, x in (("q", q), ("k", k), ("v", v), *more):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"flash_fwd takes bf16 {name}, got {x.dtype}")
        if x.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(x.shape)} != q shape {tuple(q.shape)}")
        if x.stride(-1) != 1 or any(st % 8 for st in x.stride()[:3]) or x.data_ptr() % 16:
            raise ValueError(f"{name} needs unit last stride and 16-byte aligned rows, "
                             f"got strides {x.stride()}")
    if q.dim() != 4 or q.shape[-1] != HEAD_DIM:
        raise NotImplementedError(f"flash_fwd is built for (B, L, H, {HEAD_DIM}), got {tuple(q.shape)}")
    B, L, H, _ = q.shape
    if B * H > 65535 or L < 1:
        raise ValueError(f"B*H={B * H} and L={L} outside the kernel's grid")
    if not 0 <= main_len <= L:
        raise ValueError(f"main_len={main_len} outside [0, {L}]")


def _bind():
    from .kernel_build import load

    lib = load("flash_fwd.cu")
    fn = lib.flash_fwd_bf16_d128
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 9
                       + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _bind_bwd(name: str, n_ptr: int):
    from .kernel_build import load

    fn = getattr(load("flash_bwd.cu"), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 3
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_attention_fwd(q, k, v, main_len: int | None = None, cross_bias: float = 0.0):
    """(B, L, H, D) q/k/v -> (out (B, L, H, D), lse (B, H, L) fp32).

    CUDA tensors launch K1 (bf16, D = 128); CPU tensors take the plain
    version. `flash_attention_fwd.launches` counts kernel launches."""
    L = q.shape[1]
    main_len = L if main_len is None else int(main_len)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, main_len, cross_bias)
    if q.device.type != "cuda":
        raise NotImplementedError(f"flash_fwd has no kernel for device {q.device}")
    _check_cuda_inputs(q, k, v, main_len)
    B, L, H, D = q.shape
    fn = _bind()
    out = torch.empty((B, L, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                 B, L, H, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 main_len, float(cross_bias), stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed with cudaError {err}")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def _check_bwd_inputs(q, k, v, do, lse, delta, main_len):
    _check_cuda_inputs(q, k, v, main_len, ("do", do))
    B, L, H, _ = q.shape
    for name, x in (("lse", lse), ("delta", delta)):
        if x.device != q.device or x.dtype != torch.float32 or x.shape != (B, H, L) \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous fp32 (B, H, L) tensor on {q.device}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")


def _launch_bwd(fn, q, k, v, do, lse, delta, outs, main_len, cross_bias):
    B, L, H, _ = q.shape
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                       *do.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                 delta.data_ptr(), *(o.data_ptr() for o in outs), B, L, H, strides,
                 main_len, float(cross_bias), stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed with cudaError {err}")


def flash_bwd_dq(q, k, v, do, lse, delta, main_len: int, cross_bias: float = 0.0):
    """K6a: dQ (B, L, H, 128) bf16 from q/k/v/dO and the fp32 (B, H, L) lse
    and delta = rowsum(dO * O). CUDA tensors only; `.launches` counts launches."""
    _check_bwd_inputs(q, k, v, do, lse, delta, main_len)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bwd(_bind_bwd("flash_bwd_dq_bf16_d128", 7), q, k, v, do, lse, delta, (dq,),
                main_len, cross_bias)
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, main_len: int, cross_bias: float = 0.0):
    """K6b: (dK, dV), each (B, L, H, 128) bf16; inputs as `flash_bwd_dq`."""
    _check_bwd_inputs(q, k, v, do, lse, delta, main_len)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch_bwd(_bind_bwd("flash_bwd_dkv_bf16_d128", 8), q, k, v, do, lse, delta, (dk, dv),
                main_len, cross_bias)
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, out, lse, do, main_len: int | None = None,
                        cross_bias: float = 0.0):
    """(dq, dk, dv) of `flash_attention_fwd` for the cotangent `do`, from its
    saved out and lse. CUDA tensors run K6a and K6b (delta = rowsum(dO * O) is
    a PyTorch reduction before them, as the JAX package leaves it to XLA); CPU
    tensors take `flash_attention_bwd_ref`."""
    L = q.shape[1]
    main_len = L if main_len is None else int(main_len)
    if q.device.type == "cpu":
        grads = flash_attention_bwd_ref(q, k, v, out, lse, do, main_len, cross_bias)
        return tuple(g.to(x.dtype) for g, x in zip(grads, (q, k, v)))
    if q.device.type != "cuda":
        raise NotImplementedError(f"flash_bwd has no kernel for device {q.device}")
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = flash_bwd_dq(q, k, v, do, lse, delta, main_len, cross_bias)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, main_len, cross_bias)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """K1 forward; K6a + K6b backward from the saved q, k, v, out and lse."""

    @staticmethod
    def forward(ctx, q, k, v, main_len: int, cross_bias: float):
        out, lse = flash_attention_fwd(q, k, v, main_len, cross_bias)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.main_len, ctx.cross_bias = main_len, cross_bias
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(), ctx.main_len,
                                         ctx.cross_bias)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, main_len: int | None = None, cross_bias: float = 0.0):
    """Entry used by `ops.attention.joint_attention(impl="pallas")`: the
    normalised output, differentiable through `FlashAttention`."""
    main_len = q.shape[1] if main_len is None else int(main_len)
    return FlashAttention.apply(q, k, v, main_len, float(cross_bias))
