"""Joint multi-stream attention.

Counterpart of `reflectionflow_tpu/ops/attention.py`. One attention over the
concatenated token streams ([txt | img] for FLUX t2i), outputs re-split per
stream. `impl` keeps the reference's names:

  * "xla"    -> `sdpa`, this package's plain PyTorch attention;
  * "pallas" -> `ops.flash_attention`: kernel K1 forward and K6a/K6b
    backward (hand-written CUDA); CPU tensors take their plain versions;
  * "pallas_int8" -> `ops.flash_attention_int8`: kernel K8 (int8 Q.K^T,
    serving only);
  * "pallas_nr" -> K1 here; the DiT sends its serving (split-layout)
    attention to K9 (`ops.flash_attention_nr`) before it reaches this
    function, as the JAX package does;
  * "ring" / "ring_pallas" -> `ops.ring_attention` over the mesh axis that
    `set_ring_context` names, with dense or flash-kernel (K7) chunks: a ring
    of ranks on a `parallel.mesh.RankMesh` (every rank of the axis line
    calls the attention), a ring of one process's devices on a
    `parallel.mesh.Mesh`.

The Pallas interpret modes of the reference have no counterpart and raise.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .flash_attention import flash_attention
from .flash_attention_int8 import flash_attention_int8
from .ring_attention import ring_attention

PALLAS_IMPLS = ("pallas", "pallas_nr", "pallas_int8")
RING_IMPLS = ("ring", "ring_pallas")

# Sequence-parallel (ring) context: the mesh and axis the concatenated
# sequence splits over when `impl="ring*"`. Static run configuration, set once
# before the calls, as in the JAX package (no mesh threads through the models).
_RING_CTX: dict = {"mesh": None, "axis": "seq"}


def set_ring_context(mesh, axis: str = "seq") -> None:
    """Configure the mesh and axis ring attention splits the sequence over:
    a `parallel.mesh.RankMesh` (one ring of ranks a line along `axis`, each
    rank running its own chunk; every rank of the mesh sets it) or a
    one-process `parallel.mesh.Mesh` (one ring over its devices along
    `axis`). Call before the first call with `impl="ring*"`;
    `set_ring_context(None)` clears it."""
    _RING_CTX["mesh"] = mesh
    _RING_CTX["axis"] = axis


def check_impl(impl: str) -> None:
    """Raise for an attention impl the port does not have."""
    if impl == "xla" or impl in PALLAS_IMPLS or impl in RING_IMPLS:
        return
    if impl.endswith("interpret"):
        raise NotImplementedError(
            f"attn_impl={impl!r}: Pallas interpret mode has no CUDA counterpart; "
            "use 'pallas' (K1 on CUDA tensors, its plain version on CPU tensors)")
    raise ValueError(f"unknown attn_impl {impl!r}")


def cond_attention_bias(total_len: int, cond_len: int, union_cond_attn: bool = True,
                        c_factor: float | None = None, device=None) -> torch.Tensor | None:
    """The (1, 1, L, L) fp32 additive bias of the "xla" path for a cond segment
    of the last `cond_len` tokens, or None. `c_factor` adds log(c_factor) to the
    (cond x main) logits and takes precedence over the union mask;
    `union_cond_attn=False` sets them to -inf."""
    if cond_len == 0:
        return None
    if c_factor is not None:
        fill = float(np.log(np.float32(c_factor)))
    elif not union_cond_attn:
        fill = float("-inf")
    else:
        return None
    is_cond = torch.arange(total_len, device=device) >= total_len - cond_len
    cross = is_cond[:, None] != is_cond[None, :]
    return torch.where(cross, fill, 0.0).to(torch.float32)[None, None]


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         bias: torch.Tensor | None = None) -> torch.Tensor:
    """Scaled dot-product attention on (B, L, H, D) q/k/v; fp32 logits and
    softmax, probabilities cast to q's dtype before P.V (as the reference)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def joint_attention(
    streams_q: list[torch.Tensor],
    streams_k: list[torch.Tensor],
    streams_v: list[torch.Tensor],
    bias: torch.Tensor | None = None,
    impl: str = "xla",
    cond_len: int = 0,
    cross_bias: float = 0.0,
) -> list[torch.Tensor]:
    """Attention over concatenated (B, L_i, H, D) streams; returns per-stream
    outputs. The cond-stream modifier is dense `bias` on the "xla" path and
    structural (`cond_len`, `cross_bias`) on the pallas and ring paths."""
    check_impl(impl)
    lens = [s.shape[1] for s in streams_q]
    q = torch.cat(streams_q, dim=1) if len(streams_q) > 1 else streams_q[0]
    k = torch.cat(streams_k, dim=1) if len(streams_k) > 1 else streams_k[0]
    v = torch.cat(streams_v, dim=1) if len(streams_v) > 1 else streams_v[0]
    if impl in RING_IMPLS:
        # sequence parallelism over the set_ring_context axis; the ring rebuilds
        # global positions for the structural modifiers from its topology
        if bias is not None:
            raise NotImplementedError(
                "impl='ring' takes the structural modifier form (cond_len/cross_bias), "
                "not a dense bias")
        if _RING_CTX["mesh"] is None:
            raise ValueError("impl='ring' requires ops.attention.set_ring_context(mesh, axis)")
        out = ring_attention(q, k, v, _RING_CTX["mesh"], axis=_RING_CTX["axis"],
                             impl="pallas" if impl == "ring_pallas" else "xla",
                             main_len=q.shape[1] - cond_len if cond_len else None,
                             cross_bias=cross_bias)
    elif impl in PALLAS_IMPLS:
        if bias is not None:
            raise ValueError(f"impl={impl!r} takes the structural (cond_len, cross_bias) form")
        attend = flash_attention_int8 if impl == "pallas_int8" else flash_attention
        out = attend(q, k, v, main_len=q.shape[1] - cond_len, cross_bias=cross_bias)
    else:
        out = sdpa(q, k, v, bias=bias)
    return list(torch.split(out, lens, dim=1))
