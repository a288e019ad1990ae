"""The wrappers of the kernels on the Hopper pipeline (`csrc/flash_fwd_sm90.cuh`:
K1 `flash_attention_fwd`, K8 `flash_attention_int8`, K9 `flash_attention_nr`)
read q, k and v through TMA tensor maps at the caller's strides. What TMA
cannot read must raise a ValueError that names the tensor before any launch
and before the device check (meta tensors stand in for CUDA ones: they hold no
data and reach the same checks), while CPU tensors of the same layout still go
to the plain version.
"""

import math

import pytest
import torch

from reflectionflow_tpu_torch.ops.flash_attention import flash_attention_fwd
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


WRAPPERS = {  # kernel -> (call on q, k, v returning the output, the wrapper that counts launches)
    "k1": (lambda q, k, v: flash_attention_fwd(q, k, v)[0], flash_attention_fwd),
    "k8": (flash_attention_int8, flash_attention_int8),
    "k9": (_k9, flash_attention_nr),
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
