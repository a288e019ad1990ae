"""K1, the flash-attention forward, and its plain PyTorch version.

Counterpart of `reflectionflow_tpu/ops/pallas_attention.py`:
`flash_attention` / `flash_attention_structured` (forward only) over
`_flash_fwd_kernel`. The kernel is `csrc/flash_fwd.cu` (CUDA C++ for
sm_90a, built by `ops/kernel_build.py`); its source note says what bounds it
and how the design answers that.

Dispatch: a CUDA tensor goes to the kernel, or the wrapper raises. A CPU
tensor goes to `flash_attention_ref`, the same function written in plain
PyTorch in fp32; it is also what `chip_smoke.py` holds the kernel against.

Semantics (all as the TPU kernel): scale 1/sqrt(D); tokens at or past
`main_len` form the cond segment and (cond x main) logits get `cross_bias`
(applied only when non-zero; -1e30 masks); returns the normalised output in
the input dtype and the fp32 logsumexp rows, here laid out (B, H, L).
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


def _check_cuda_inputs(q, k, v, main_len):
    for name, x in (("q", q), ("k", k), ("v", v)):
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


def flash_attention(q, k, v, main_len: int | None = None, cross_bias: float = 0.0):
    """Entry used by `ops.attention.joint_attention(impl="pallas")`: the
    normalised output only."""
    return flash_attention_fwd(q, k, v, main_len, cross_bias)[0]
