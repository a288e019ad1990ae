"""K8: flash attention with an int8 Q.K^T, and its plain PyTorch version.

Counterpart of `reflectionflow_tpu/ops/pallas_attention.py::flash_attention_int8`
over `_flash_fwd_int8_kernel` (K8), the attention of `attn_impl="pallas_int8"`
(SageAttention-style):
  * K is mean-centred over the sequence and quantized per token
    (`quantize_k_ref`); the per-row q.mean(K) shift cancels in the softmax;
  * q is quantized per token with the softmax scale folded into its scale;
  * logits = int32(Q8 K8^T) * q_s * k_s, then the structural `main_len` /
    `cross_bias` bias, the softmax in fp32, p rounded to v's dtype for P.V.
Serving only: no backward, and an input that requires grad raises.

The kernel is `csrc/flash_fwd_int8.cu` (CUDA C++ for sm_90a, built by
`ops/kernel_build.py`): K8a quantizes K, K8b attends on the Hopper pipeline
of `csrc/flash_fwd_sm90.cuh` (TMA, wgmma, warp specialisation). Dispatch as
K1: a CUDA tensor launches the kernel or the wrapper raises; a CPU tensor
takes `flash_attention_int8_ref`, which is also what `chip_smoke.py` holds
the kernel against.

Quantizer rounding as the TPU kernel: factor = 127 / amax in fp32, codes =
round-half-even(x * factor), scales amax * fp32(1/127) for K and
amax * fp32(scale / 127) for q.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .flash_attention import HEAD_DIM, _check_cuda_inputs, _check_layout


def _codes(x: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
    # 127 / amax as one fp32 division (a Python scalar over a tensor would be
    # a reciprocal and a product in PyTorch)
    return torch.round(x * (amax.new_tensor(127.0) / amax))


def quantize_k_ref(k):
    """(B, L, H, D) K -> (codes int8 (B, H, L, D), scales fp32 (B, H, L)):
    centred by its mean over L, then per-token int8 (K8a's output layout)."""
    kf = k.float().transpose(1, 2)  # (B, H, L, D)
    kc = kf - kf.sum(dim=2, keepdim=True) * (1.0 / kf.shape[2])
    amax = kc.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12)
    return _codes(kc, amax).to(torch.int8), (amax * (1.0 / 127.0))[..., 0]


def flash_attention_int8_ref(q, k, v, main_len: int | None = None, cross_bias: float = 0.0):
    """Plain version: (B, L, H, D) q/k/v -> (B, L, H, D) in v's dtype. The
    int8 products are summed in fp32, which is exact here (|sum| < 2^24)."""
    B, L, H, D = q.shape
    main_len = L if main_len is None else main_len
    k8, ks = quantize_k_ref(k)
    qf = q.float().transpose(1, 2)  # (B, H, L, D)
    q_amax = qf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12)
    q_s = q_amax * (1.0 / math.sqrt(D) / 127.0)
    logits = torch.einsum("bhqd,bhkd->bhqk", _codes(qf, q_amax), k8.float())
    logits.mul_(q_s).mul_(ks[:, :, None, :])  # in place: the (B, H, L, L) logits are large
    if cross_bias != 0.0:
        pos = torch.arange(L, device=q.device)
        cross = (pos[:, None] >= main_len) != (pos[None, :] >= main_len)
        logits.add_(torch.where(cross, cross_bias, 0.0))
    p = logits.sub_(logits.amax(dim=-1, keepdim=True)).exp_()
    l_sum = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    out = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float()) / l_sum
    return out.transpose(1, 2).to(v.dtype)


_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGS = {
    "int8_prep_k_d128": [_P, _LL, _LL, _LL, _P, _P, _LL, _I, _I, _I, _F, _P],
    "flash_fwd_int8_d128": [_P] * 3 + [_LL] + [_P] * 2 + [_I] * 3 + [_LL] * 6 + [_I, _F, _F, _P],
}


def _bind(symbol: str):
    from .kernel_build import load

    fn = getattr(load("flash_fwd_int8.cu"), symbol)
    if fn.argtypes is None:
        fn.argtypes = _ARGS[symbol]
        fn.restype = ctypes.c_int
    return fn


def _launch(symbol: str, device, *args) -> None:
    with torch.cuda.device(device):
        err = _bind(symbol)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed with cudaError {err}")


def quantize_k(k):
    """K8a alone on a CUDA (B, L, H, 128) bf16 K -> (codes int8 (B, H, L, 128),
    scales fp32 (B, H, L)), the layout of `quantize_k_ref`; the scales are a
    view of rows padded to a multiple of 4 values (16 bytes), where K8b's TMA
    box of scales may start. The attention wrapper runs it inside each call; on
    its own it serves the check of the codes against the plain version."""
    if k.device.type != "cuda":
        raise NotImplementedError(f"int8_prep_k has no kernel for device {k.device}")
    _check_cuda_inputs(k, k, k, k.shape[1])
    B, L, H, D = k.shape
    k8 = torch.empty((B, H, L, D), dtype=torch.int8, device=k.device)
    ks = torch.empty((B, H, -(-L // 4) * 4), dtype=torch.float32, device=k.device)[..., :L]
    _launch("int8_prep_k_d128", k.device, k.data_ptr(), *k.stride()[:3], k8.data_ptr(),
            ks.data_ptr(), ks.stride(1), B, L, H, 1.0 / L)
    return k8, ks


def flash_attention_int8(q, k, v, main_len: int | None = None, cross_bias: float = 0.0):
    """(B, L, H, D) q/k/v -> (B, L, H, D). CUDA tensors launch K8 (bf16, D =
    128: K8a quantizes K into an int8 workspace, K8b attends; one call counts
    one launch in `flash_attention_int8.launches`); CPU tensors take the plain
    version."""
    if any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention_int8 is serving-only: it has no backward")
    L = q.shape[1]
    main_len = L if main_len is None else int(main_len)
    if q.device.type == "cpu":
        return flash_attention_int8_ref(q, k, v, main_len, cross_bias)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_layout(name, t)  # TMA's terms (q, v), K8a's rows (k), before the device check
    if q.device.type != "cuda":
        raise NotImplementedError(f"flash_fwd_int8 has no kernel for device {q.device}")
    _check_cuda_inputs(q, k, v, main_len)
    B, L, H, D = q.shape
    k8, ks = quantize_k(k)
    out = torch.empty((B, L, H, D), dtype=q.dtype, device=q.device)
    _launch("flash_fwd_int8_d128", q.device, q.data_ptr(), k8.data_ptr(), ks.data_ptr(),
            ks.stride(1), v.data_ptr(), out.data_ptr(), B, L, H, *q.stride()[:3],
            *v.stride()[:3], main_len, float(cross_bias), 1.0 / math.sqrt(HEAD_DIM) / 127.0)
    flash_attention_int8.launches += 1
    return out


flash_attention_int8.launches = 0
