"""The wrappers of the kernels on the Hopper pipelines (`csrc/flash_fwd_sm90.cuh`:
K1 `flash_attention_fwd`, K7a `flash_chunk_fwd`, K8 `flash_attention_int8`, K9
`flash_attention_nr`; `csrc/flash_bwd_sm90.cuh`: K6a `flash_bwd_dq`, K6b
`flash_bwd_dkv`, K7b `flash_chunk_bwd_dq`, K7c `flash_chunk_bwd_dkv`) read q, k,
v (and dO) through TMA tensor maps at the caller's strides. What TMA cannot
read must raise a ValueError that names the tensor before any launch and before
the device check (meta tensors stand in for CUDA ones: they hold no data and
reach the same checks), while CPU tensors of the same layout still go to the
plain version (for K6a/K6b/K7b/K7c, CUDA-only entries, through
`flash_attention_bwd` or `flash_chunk_bwd`).
"""

import math

import pytest
import torch

from reflectionflow_tpu_torch.ops.flash_attention import (
    flash_attention_bwd, flash_attention_fwd, flash_bwd_dkv, flash_bwd_dq, flash_chunk_bwd,
    flash_chunk_bwd_dkv, flash_chunk_bwd_dq, flash_chunk_fwd)
from reflectionflow_tpu_torch.ops.flash_attention_int8 import flash_attention_int8
from reflectionflow_tpu_torch.ops.flash_attention_nr import flash_attention_nr

SHAPE = (1, 8, 1, 128)

TMA_FAULTS = {  # (tensor the wrapper must name, its fault)
    "odd_row_stride": ("k", dict(strides=(8 * 132, 132, 128, 1))),
    "misaligned_base": ("v", dict(offset=1)),
    "strided_last_dim": ("q", dict(strides=(8 * 256, 256, 256, 2))),
}


def _tensor(device, strides=None, offset=0, seed=0):
    """A bf16 SHAPE tensor on `device` at the given strides and element offset
    of its storage (on the meta device data_ptr() is the byte offset)."""
    n = offset + 4 * math.prod(SHAPE)
    if device == "meta":
        base = torch.empty(n, dtype=torch.bfloat16, device="meta")
    else:
        base = torch.randn(n, generator=torch.Generator().manual_seed(seed)).to(torch.bfloat16)
    return base.as_strided(SHAPE, strides or torch.empty(SHAPE, device="meta").stride(), offset)


def _k9(q, k, v):
    L, dev = q.shape[1], q.device
    cos = torch.ones((L, 128), dtype=torch.bfloat16, device=dev)
    sin = torch.zeros((L, 128), dtype=torch.bfloat16, device=dev)
    scale = torch.ones((2, 128), device=dev)
    return flash_attention_nr(q, k, v, cos, sin, scale, scale)


def _k6(entry, pick):
    """K6a (pick 0: dQ) or K6b (pick 1: dK) on q, k, v and a cotangent do:
    the CUDA-only entry on meta tensors, `flash_attention_bwd` (the plain
    version) on CPU tensors."""
    def call(q, k, v, do=None):
        do = _tensor(q.device.type, seed=3) if do is None else do
        if q.device.type == "cpu":
            out, lse = flash_attention_fwd(q, k, v)
            return flash_attention_bwd(q, k, v, out, lse, do)[pick]
        B, L, H, _ = q.shape
        lse = torch.empty((B, H, L), device=q.device)
        grads = entry(q, k, v, do, lse, torch.empty_like(lse), L)
        return grads if pick == 0 else grads[0]
    return call


# a ring chunk's modifiers: global cond boundary, bias, q and k chunk starts (the boundary falls
# inside the K/V shard and past the Q chunk's end, so the two local boundaries differ)
CHUNK = (6, math.log(0.5), 0, 4)


def _k7a(q, k, v):
    return flash_chunk_fwd(q, k, v, *CHUNK)[0]


def _k7(entry, pick):
    """K7b (pick 0: dQ) or K7c (pick 1: dK) on q, k, v and a cotangent do: the
    CUDA-only entry on meta tensors, `flash_chunk_bwd` (the plain version) on
    CPU tensors, from the chunk's own lse and delta rows, with CHUNK's
    modifiers."""
    def call(q, k, v, do=None):
        do = _tensor(q.device.type, seed=3) if do is None else do
        if q.device.type == "cpu":
            out, lse = flash_chunk_fwd(q, k, v, *CHUNK)
            delta = (do.float() * out).sum(-1).transpose(1, 2)
            return flash_chunk_bwd(q, k, v, do, lse, delta, *CHUNK)[pick]
        B, L, H, _ = q.shape
        lse = torch.empty((B, H, L), device=q.device)
        grads = entry(q, k, v, do, lse, torch.empty_like(lse), *CHUNK)
        return grads if pick == 0 else grads[0]
    return call


WRAPPERS = {  # kernel -> (call on q, k, v returning the output, the wrapper that counts launches)
    "k1": (lambda q, k, v: flash_attention_fwd(q, k, v)[0], flash_attention_fwd),
    "k8": (flash_attention_int8, flash_attention_int8),
    "k9": (_k9, flash_attention_nr),
    "k6a": (_k6(flash_bwd_dq, 0), flash_bwd_dq),
    "k6b": (_k6(flash_bwd_dkv, 1), flash_bwd_dkv),
    "k7a": (_k7a, flash_chunk_fwd),
    "k7b": (_k7(flash_chunk_bwd_dq, 0), flash_chunk_bwd_dq),
    "k7c": (_k7(flash_chunk_bwd_dkv, 1), flash_chunk_bwd_dkv),
}


@pytest.mark.parametrize("fault", list(TMA_FAULTS))
@pytest.mark.parametrize("kernel", list(WRAPPERS))
def test_hopper_wrapper_checks_tma_terms(kernel, fault):
    """A stride that is not a multiple of 8 elements, a base off a 16-byte
    boundary or a strided last dim raises a ValueError naming the tensor, with
    no launch counted; the same layout on the CPU is served by the plain
    version, as its contiguous copy is."""
    name, kw = TMA_FAULTS[fault]
    call, wrapper = WRAPPERS[kernel]
    before = wrapper.launches
    meta = [_tensor("meta", **(kw if n == name else {})) for n in "qkv"]
    with pytest.raises(ValueError, match=f"^{name} needs"):
        call(*meta)
    cpu = [_tensor("cpu", **(kw if n == name else {}), seed=i) for i, n in enumerate("qkv")]
    out = call(*cpu)
    assert wrapper.launches == before
    assert out.shape == SHAPE and bool(torch.isfinite(out.float()).all())
    torch.testing.assert_close(out, call(*(t.contiguous() for t in cpu)))


@pytest.mark.parametrize("fault", list(TMA_FAULTS))
@pytest.mark.parametrize("kernel", ["k6a", "k6b", "k7b", "k7c"])
def test_backward_wrapper_checks_tma_terms_of_do(kernel, fault):
    """K6a/K6b/K7b/K7c read the cotangent dO through a tensor map too: each fault on
    dO raises a ValueError naming it, with no launch counted; the same dO on
    the CPU is served by the plain version, as its contiguous copy is."""
    _, kw = TMA_FAULTS[fault]
    call, wrapper = WRAPPERS[kernel]
    before = wrapper.launches
    with pytest.raises(ValueError, match="^do needs"):
        call(*(_tensor("meta") for _ in "qkv"), do=_tensor("meta", **kw))
    cpu = [_tensor("cpu", seed=i) for i in range(3)]
    do = _tensor("cpu", **kw, seed=3)
    out = call(*cpu, do=do)
    assert wrapper.launches == before
    assert out.shape == SHAPE and bool(torch.isfinite(out.float()).all())
    torch.testing.assert_close(out, call(*cpu, do=do.contiguous()))
