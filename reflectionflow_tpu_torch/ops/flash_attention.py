"""Flash attention: K1 (forward), K6a and K6b (backward), the ring-chunk
kernels K7a/K7b/K7c, and their plain PyTorch versions.

Counterpart of `reflectionflow_tpu/ops/pallas_attention.py`:
`flash_attention` / `flash_attention_structured` and their custom VJP, over
`_flash_fwd_kernel` (K1), `_flash_dq_kernel` (K6a) and `_flash_dkv_kernel`
(K6b); and `flash_chunk_fwd` / `flash_chunk_bwd`, the same three bodies on one
ring chunk with ring-global offsets (K7a, K7b, K7c), which
`ops.ring_attention` runs. The kernels are `csrc/flash_fwd.cu` and
`csrc/flash_bwd.cu` (CUDA C++ for sm_90a, built by `ops/kernel_build.py`).
K1 runs on the Hopper pipeline of `csrc/flash_fwd_sm90.cuh` and K6a/K6b on
its backward counterpart `csrc/flash_bwd_sm90.cuh` (TMA, wgmma, warp
specialisation); K7a/K7b/K7c keep the earlier `mma.sync` bodies. The
source notes say what bounds each kernel and how the design answers that.
`FlashAttention` is the `torch.autograd.Function` that joins K1 forward and
K6a + K6b backward.

Dispatch: a CUDA tensor goes to the kernel, or the wrapper raises. A CPU
tensor given to `flash_attention_fwd`, `flash_attention_bwd`,
`flash_chunk_fwd` or `flash_chunk_bwd` goes to the plain version
(`flash_attention_ref`, `flash_attention_bwd_ref`, ...), the same function
written in plain PyTorch in fp32; it is also what `chip_smoke.py` holds the
kernels against. The four backward kernel entries (`flash_bwd_dq`,
`flash_bwd_dkv`, `flash_chunk_bwd_dq`, `flash_chunk_bwd_dkv`) take CUDA
tensors only: after their dtype, shape and layout checks they raise
`NotImplementedError` for any other device.

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


def _add_cross_bias(logits, main_len, cross_bias, q_offset, k_offset):
    """(B, H, Lq, Lk) logits + cross_bias where the query at global position
    q_offset + i and the key at k_offset + j lie on opposite sides of main_len."""
    if cross_bias == 0.0:
        return logits
    Lq, Lk = logits.shape[-2:]
    qpos = torch.arange(Lq, device=logits.device) + q_offset
    kpos = torch.arange(Lk, device=logits.device) + k_offset
    cross = (qpos[:, None] >= main_len) != (kpos[None, :] >= main_len)
    return logits + torch.where(cross, cross_bias, 0.0)


def flash_attention_ref(q, k, v, main_len: int | None = None, cross_bias: float = 0.0,
                        q_offset: int = 0, k_offset: int = 0):
    """Plain version: (B, L, H, D) q/k/v -> (out (B, L, H, D) in q.dtype,
    lse (B, H, L) fp32), computed in fp32. The offsets are the global
    positions of the first query and the first key (a ring chunk's)."""
    B, L, H, D = q.shape
    main_len = L if main_len is None else main_len
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(D))
    logits = _add_cross_bias(logits, main_len, cross_bias, q_offset, k_offset)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype), lse


def flash_attention_bwd_ref(q, k, v, out, lse, do, main_len: int | None = None,
                            cross_bias: float = 0.0):
    """Plain version of K6a + K6b: (dq, dk, dv) in fp32 for (B, L, H, D)
    q/k/v/out/do and (B, H, L) lse. Computed in fp32 with p and ds rounded to
    q's dtype where the kernels round them (before dS.K, P^T.dO, dS^T.Q)."""
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2)  # (B, H, L)
    return _bwd_ref(q, k, v, do, lse, delta, q.shape[1] if main_len is None else main_len,
                    cross_bias, 0, 0)


def _bwd_ref(q, k, v, do, lse, delta, main_len, cross_bias, q_offset, k_offset):
    D = q.shape[-1]
    scale = 1.0 / math.sqrt(D)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    logits = _add_cross_bias(logits, main_len, cross_bias, q_offset, k_offset)
    p = torch.exp(logits - lse.float()[..., None])
    del logits
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = (p * (dp - delta.float()[..., None])).to(q.dtype).float()
    del dp
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).float(), dof)
    del p
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    return dq, dk, dv


def _check_layout(name, x):
    """What the kernels' copies need of a tensor they read at its own strides
    (cp.async rows, TMA tensor maps): a unit last stride, the other strides
    multiples of 8 elements (16 bytes) and a 16-byte aligned base."""
    if x.stride(-1) != 1 or any(st % 8 for st in x.stride()[:-1]) or x.data_ptr() % 16:
        raise ValueError(f"{name} needs unit last stride and 16-byte aligned rows, "
                         f"got strides {x.stride()}")


def _check_cuda_inputs(q, k, v, main_len, *more):
    """Raise on what the kernels do not take; main_len=None skips its range
    check (a ring chunk's boundary is global)."""
    for name, x in (("q", q), ("k", k), ("v", v), *more):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"flash_fwd takes bf16 {name}, got {x.dtype}")
        if x.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(x.shape)} != q shape {tuple(q.shape)}")
        _check_layout(name, x)
    if q.dim() != 4 or q.shape[-1] != HEAD_DIM:
        raise NotImplementedError(f"flash_fwd is built for (B, L, H, {HEAD_DIM}), got {tuple(q.shape)}")
    B, L, H, _ = q.shape
    if B * H > 65535 or L < 1:
        raise ValueError(f"B*H={B * H} and L={L} outside the kernel's grid")
    if main_len is not None and not 0 <= main_len <= L:
        raise ValueError(f"main_len={main_len} outside [0, {L}]")


def _launch_fwd(name: str, q, k, v, ints, cross_bias):
    """Launch forward entry `name` of flash_fwd.cu -> (out, lse (B, H, L)).
    `ints` are its integer scalars after the strides: (main_len,) for K1,
    (main_len, q_offset, k_offset) for K7a."""
    from .kernel_build import load

    fn = getattr(load("flash_fwd.cu"), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 9
                       + [ctypes.c_int] * len(ints) + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    B, L, H, D = q.shape
    out = torch.empty((B, L, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                 B, L, H, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *ints, float(cross_bias), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with cudaError {err}")
    return out, lse


def _bind_bwd(name: str, n_ptr: int, n_int: int = 1):
    from .kernel_build import load

    fn = getattr(load("flash_bwd.cu"), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 3
                       + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * n_int
                       + [ctypes.c_float, ctypes.c_void_p])
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
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_layout(name, t)  # TMA's terms, before the device check
    if q.device.type != "cuda":
        raise NotImplementedError(f"flash_fwd has no kernel for device {q.device}")
    _check_cuda_inputs(q, k, v, main_len)
    out, lse = _launch_fwd("flash_fwd_bf16_d128", q, k, v, (main_len,), cross_bias)
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def _check_bwd_inputs(q, k, v, do, lse, delta, main_len):
    """The backward entries' checks: dtype, shape and layout first (so a
    meta tensor gets the error that names it), then the device, before any
    build or launch."""
    _check_cuda_inputs(q, k, v, main_len, ("do", do))
    B, L, H, _ = q.shape
    for name, x in (("lse", lse), ("delta", delta)):
        if x.device != q.device or x.dtype != torch.float32 or x.shape != (B, H, L) \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous fp32 (B, H, L) tensor on {q.device}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if q.device.type != "cuda":
        raise NotImplementedError(f"flash_bwd has no kernel for device {q.device}")


def _launch_bwd(fn, q, k, v, do, lse, delta, outs, ints, cross_bias):
    """Launch a backward entry; `ints` are its integer scalars after the
    strides: (main_len,) for K6, (main_len, q_offset, k_offset) for K7."""
    B, L, H, _ = q.shape
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                       *do.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                 delta.data_ptr(), *(o.data_ptr() for o in outs), B, L, H, strides,
                 *ints, float(cross_bias), stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed with cudaError {err}")


def flash_bwd_dq(q, k, v, do, lse, delta, main_len: int, cross_bias: float = 0.0):
    """K6a: dQ (B, L, H, 128) bf16 from q/k/v/dO and the fp32 (B, H, L) lse
    and delta = rowsum(dO * O). CUDA tensors only (another device raises
    NotImplementedError); `.launches` counts launches."""
    _check_bwd_inputs(q, k, v, do, lse, delta, main_len)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bwd(_bind_bwd("flash_bwd_dq_bf16_d128", 7), q, k, v, do, lse, delta, (dq,),
                (main_len,), cross_bias)
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, main_len: int, cross_bias: float = 0.0):
    """K6b: (dK, dV), each (B, L, H, 128) bf16; inputs as `flash_bwd_dq`."""
    _check_bwd_inputs(q, k, v, do, lse, delta, main_len)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch_bwd(_bind_bwd("flash_bwd_dkv_bf16_d128", 8), q, k, v, do, lse, delta, (dk, dv),
                (main_len,), cross_bias)
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


# ---------------------------------------------------------------------------
# Ring chunks (K7): the same kernels on one Q chunk against one K/V shard,
# with the ring-global start positions of both as runtime scalars.
# ---------------------------------------------------------------------------


def _chunk_modifiers(q, main_len, cross_bias, q_offset, k_offset):
    """(main_len, cross_bias, q_offset, k_offset) as the chunk kernels take
    them: the global boundary, bias and offsets only when main_len is given
    and the bias is non-zero, else the local length, 0 and 0 (the JAX chunk
    entries' rule)."""
    if main_len is not None and cross_bias != 0.0:
        return int(main_len), float(cross_bias), int(q_offset), int(k_offset)
    return q.shape[1], 0.0, 0, 0


def flash_chunk_fwd_ref(q, k, v, main_len: int | None = None, cross_bias: float = 0.0,
                        q_offset: int = 0, k_offset: int = 0):
    """Plain version of K7a: `flash_attention_ref` at the chunk's global
    offsets, its output (in q.dtype) returned as fp32."""
    main_len, cross_bias, q_offset, k_offset = _chunk_modifiers(q, main_len, cross_bias,
                                                                q_offset, k_offset)
    out, lse = flash_attention_ref(q, k, v, main_len, cross_bias, q_offset, k_offset)
    return out.float(), lse


def flash_chunk_bwd_ref(q, k, v, do, lse, delta, main_len: int | None = None,
                        cross_bias: float = 0.0, q_offset: int = 0, k_offset: int = 0):
    """Plain version of K7b + K7c: (dq, dk, dv) in fp32 from the ring-global
    (B, H, L) lse and delta rows, with p and ds rounded as in
    `flash_attention_bwd_ref`."""
    return _bwd_ref(q, k, v, do, lse, delta,
                    *_chunk_modifiers(q, main_len, cross_bias, q_offset, k_offset))


def _check_offsets(main_len, q_offset, k_offset):
    for name, x in (("main_len", main_len), ("q_offset", q_offset), ("k_offset", k_offset)):
        if not 0 <= x < 2**31:
            raise ValueError(f"{name}={x} outside the kernel's int32 range")


def flash_chunk_fwd(q, k, v, main_len: int | None = None, cross_bias: float = 0.0,
                    q_offset: int = 0, k_offset: int = 0):
    """Normalised attention over one ring chunk and its logsumexp rows:
    (B, L, H, D) q/k/v with equal local lengths -> (out (B, L, H, D) fp32,
    lse (B, H, L) fp32). `main_len` and `cross_bias` are the global cond
    boundary and bias; `q_offset` / `k_offset` the ring-global positions of
    this Q chunk and of the K/V shard it meets.

    CUDA tensors launch K7a (bf16, D = 128; its bf16 output is cast to fp32,
    as the JAX entry upcasts its kernel's); CPU tensors take
    `flash_chunk_fwd_ref`. `flash_chunk_fwd.launches` counts launches."""
    if q.device.type == "cpu":
        return flash_chunk_fwd_ref(q, k, v, main_len, cross_bias, q_offset, k_offset)
    if q.device.type != "cuda":
        raise NotImplementedError(f"flash_chunk_fwd has no kernel for device {q.device}")
    main_len, cross_bias, q_offset, k_offset = _chunk_modifiers(q, main_len, cross_bias,
                                                                q_offset, k_offset)
    _check_cuda_inputs(q, k, v, None)
    _check_offsets(main_len, q_offset, k_offset)
    out, lse = _launch_fwd("flash_chunk_fwd_bf16_d128", q, k, v, (main_len, q_offset, k_offset),
                           cross_bias)
    flash_chunk_fwd.launches += 1
    return out.float(), lse


flash_chunk_fwd.launches = 0


def flash_chunk_bwd_dq(q, k, v, do, lse, delta, main_len: int, cross_bias: float,
                       q_offset: int, k_offset: int):
    """K7b: the chunk's dQ (B, L, H, 128) bf16 from the ring-global fp32
    (B, H, L) lse and delta. CUDA tensors only, as `flash_bwd_dq`; the
    modifiers as `_chunk_modifiers` gives them. `.launches` counts launches."""
    _check_bwd_inputs(q, k, v, do, lse, delta, None)
    _check_offsets(main_len, q_offset, k_offset)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bwd(_bind_bwd("flash_chunk_bwd_dq_bf16_d128", 7, 3), q, k, v, do, lse, delta, (dq,),
                (main_len, q_offset, k_offset), cross_bias)
    flash_chunk_bwd_dq.launches += 1
    return dq


def flash_chunk_bwd_dkv(q, k, v, do, lse, delta, main_len: int, cross_bias: float,
                        q_offset: int, k_offset: int):
    """K7c: the chunk's (dK, dV), each (B, L, H, 128) bf16; inputs as
    `flash_chunk_bwd_dq`."""
    _check_bwd_inputs(q, k, v, do, lse, delta, None)
    _check_offsets(main_len, q_offset, k_offset)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch_bwd(_bind_bwd("flash_chunk_bwd_dkv_bf16_d128", 8, 3), q, k, v, do, lse, delta,
                (dk, dv), (main_len, q_offset, k_offset), cross_bias)
    flash_chunk_bwd_dkv.launches += 1
    return dk, dv


flash_chunk_bwd_dq.launches = 0
flash_chunk_bwd_dkv.launches = 0


def flash_chunk_bwd(q, k, v, do, lse, delta, main_len: int | None = None,
                    cross_bias: float = 0.0, q_offset: int = 0, k_offset: int = 0):
    """(dq, dk, dv) of one ring chunk in the input dtype, from the ring-global
    (B, H, L) fp32 lse and delta = rowsum(dO * O) rows; summed over the K/V
    shards they give the full-sequence gradients. Modifiers as
    `flash_chunk_fwd`. CUDA tensors run K7b and K7c; CPU tensors take
    `flash_chunk_bwd_ref`."""
    if q.device.type == "cpu":
        grads = flash_chunk_bwd_ref(q, k, v, do, lse, delta, main_len, cross_bias,
                                    q_offset, k_offset)
        return tuple(g.to(x.dtype) for g, x in zip(grads, (q, k, v)))
    if q.device.type != "cuda":
        raise NotImplementedError(f"flash_chunk_bwd has no kernel for device {q.device}")
    mods = _chunk_modifiers(q, main_len, cross_bias, q_offset, k_offset)
    dq = flash_chunk_bwd_dq(q, k, v, do, lse, delta, *mods)
    dk, dv = flash_chunk_bwd_dkv(q, k, v, do, lse, delta, *mods)
    return dq, dk, dv
