"""Ring attention: sequence parallelism over a mesh axis, forward and backward.

Counterpart of `reflectionflow_tpu/ops/ring_attention.py`. Q, K and V are
split along the sequence into p contiguous chunks, one per device along the
ring axis of the mesh (`parallel.mesh`). Each Q chunk stays where it is while
the K/V chunks rotate around the ring; the partial results merge with the
online-softmax recurrence over their logsumexp rows. The backward is a second
ring pass that recomputes each chunk's probabilities from the forward's
ring-global logsumexp rows and accumulates dK/dV on the rotating shards, so
after p rotations each shard's gradient is home.

Local chunks run through the flash chunk kernels (`impl="pallas"`:
`ops.flash_attention.flash_chunk_fwd` / `flash_chunk_bwd`, K7a/K7b/K7c on
CUDA tensors, their plain versions on CPU tensors) or dense PyTorch
(`impl="xla"`). The structural cond-stream modifiers (`main_len`,
`cross_bias`) compare ring-global positions, reconstructed per chunk from the
ring topology: the Q chunk of slot i starts at i * L / p, and the K/V shard it
holds after r rotations started at ((i - r) mod p) * L / p.

Two rings run the same chunk math in the same order:
  * over a `parallel.mesh.RankMesh` (serving and training on a mesh of
    ranks, one process a device): each rank of a line along the ring axis
    runs the chunk of its coordinate s on its own device, a rotation is
    `parallel.collectives.ring_shift` (JAX's `lax.ppermute`: NCCL point to
    point, or through host memory under gloo), and s enters the offsets as
    JAX's `lax.axis_index` does;
  * over a one-process `parallel.mesh.Mesh`: one process drives the ring over
    a list of `torch.device`s, in which a device may repeat: on one card the p
    shards run one after another, and a rotation is a list permutation plus
    `.to(next_device, non_blocking=True)`, which copies nothing when the next
    device is the same.

Divergences from the JAX module, which is one program over a `shard_map`:
the port has no sharded tensor. Both rings take the global (B, L, H, D)
q/k/v (on a mesh of ranks every rank of the line holds it) and join the
output and the input gradients into global tensors (the rank ring with an
all-gather over the line); on a one-process mesh of several axes one ring
runs where JAX runs one a row (`parallel/mesh.py`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..parallel import collectives
from ..parallel.mesh import RankMesh
from .flash_attention import flash_chunk_bwd, flash_chunk_fwd

# ---------------------------------------------------------------------------
# local chunk math (one Q chunk x one K/V shard)
# ---------------------------------------------------------------------------


def _xla_chunk_fwd(q, k, v, scale, bias=None):
    """Normalized chunk attention and its logsumexp. q/k/v (B, L, H, D);
    returns (out fp32 (B, L, H, D), lse fp32 (B, H, L)). bias: optional
    (Lq, Lk) fp32 additive logits bias (-1e30 masks)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-20)
    out = torch.einsum("bhqk,bkhd->bqhd", (p / l).to(v.dtype), v)
    return out.float(), (m + torch.log(l))[..., 0]


def _xla_chunk_bwd(q, k, v, g, lse, delta, scale, bias=None):
    """Chunk gradients from the ring-global (B, H, L) fp32 lse and delta."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias
    p = torch.exp(logits - lse[..., None])  # (B, H, Lq, Lk)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(g.dtype), g)
    dp = torch.einsum("bqhd,bkhd->bhqk", g.float(), v.float())
    ds = (p * (dp - delta[..., None])).to(q.dtype)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale
    return dq, dk, dv


def _merge(out, lse, out2, lse2):
    """Merge two normalized partial results via their (B, H, L) logsumexp rows."""
    m = torch.maximum(lse, lse2)
    a, b = torch.exp(lse - m), torch.exp(lse2 - m)
    den = a + b

    def rows(x):  # (B, H, L) -> (B, L, H, 1), out's layout
        return x.transpose(1, 2)[..., None]

    return (out * rows(a) + out2 * rows(b)) / rows(den), m + torch.log(den)


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------


class _Ring:
    """The static layout of one ring call over a one-process mesh: its
    devices, chunk length and the chunk functions with their per-rotation
    modifier arguments. This process runs every slot (`slots`); a rotation
    moves each slot's tensor to the next slot's device."""

    def __init__(self, devices, impl, L, D, main_len, cross_bias):
        self.devices, self.p, self.impl = devices, len(devices), impl
        self.slots = list(range(self.p))
        self.Lc = L // self.p
        self.scale = float(D) ** -0.5
        self.main_len, self.cross_bias = main_len, float(cross_bias)
        self.modifiers = main_len is not None and self.cross_bias != 0.0

    def offsets(self, i, r):
        """Ring-global (q_start, k_start) of slot i at rotation step r."""
        return i * self.Lc, ((i - r) % self.p) * self.Lc

    def mod_kwargs(self, i, r):
        if not self.modifiers:
            return {}
        q_off, k_off = self.offsets(i, r)
        if self.impl == "pallas":
            return {"main_len": self.main_len, "cross_bias": self.cross_bias,
                    "q_offset": q_off, "k_offset": k_off}
        # the XLA chunk path materialises the (Lq, Lk) bias from global positions
        pos = torch.arange(self.Lc, device=self.devices[i])
        cross = ((q_off + pos)[:, None] >= self.main_len) != ((k_off + pos)[None, :] >= self.main_len)
        return {"bias": torch.where(cross, self.cross_bias, 0.0).to(torch.float32)}

    def chunk_fwd(self, q, k, v, i, r):
        if self.impl == "pallas":
            return flash_chunk_fwd(q, k, v, **self.mod_kwargs(i, r))
        return _xla_chunk_fwd(q, k, v, self.scale, **self.mod_kwargs(i, r))

    def chunk_bwd(self, q, k, v, g, lse, delta, i, r):
        if self.impl == "pallas":
            return flash_chunk_bwd(q, k, v, g, lse, delta, **self.mod_kwargs(i, r))
        return _xla_chunk_bwd(q, k, v, g, lse, delta, self.scale, **self.mod_kwargs(i, r))

    def split(self, x):
        """x's chunks along the sequence (dim 1) of this process's slots, each
        on its slot's device."""
        return [c.to(d, non_blocking=True) for c, d in zip(x.split(self.Lc, dim=1), self.devices)]

    def split_rows(self, x):
        """The same for (B, H, L) rows, contiguous as the kernels take them."""
        return [c.to(d, non_blocking=True).contiguous()
                for c, d in zip(x.split(self.Lc, dim=2), self.devices)]

    def rotate(self, *lists):
        """One ring step of each list: slot i's tensor moves to slot i + 1."""
        return tuple([xs[i - 1].to(self.devices[i], non_blocking=True) for i in range(self.p)]
                     for xs in lists)

    def gather(self, xs, like):
        """The slots' chunks joined along the sequence on `like`'s device, in
        its dtype."""
        return torch.cat([x.to(like.device, like.dtype, non_blocking=True) for x in xs], dim=1)


class _RankRing(_Ring):
    """One ring of ranks: this rank's line along the ring axis of a
    `RankMesh`. It runs one slot, its seq coordinate s, on its own device; a
    rotation is `collectives.ring_shift` over the line's process group, and
    the chunks' results are joined over the group (`all_gather_dim`), so
    every rank of the line ends with the global tensors."""

    def __init__(self, mesh, axis, device, impl, L, D, main_len, cross_bias):
        p = mesh.axis_size(axis)
        super().__init__([device] * p, impl, L, D, main_len, cross_bias)
        self.group = mesh.group(axis)
        s = mesh.coords[axis]
        if p > 1 and dist.get_group_rank(self.group, dist.get_rank()) != s:
            raise RuntimeError(f"rank {dist.get_rank()} sits at {axis}={s} of {mesh} but at "
                               f"{dist.get_group_rank(self.group, dist.get_rank())} of its {axis} group")
        self.slots = [s]

    def split(self, x):
        return [x.split(self.Lc, dim=1)[self.slots[0]]]

    def split_rows(self, x):
        return [x.split(self.Lc, dim=2)[self.slots[0]].contiguous()]

    def rotate(self, *lists):
        if self.p == 1:
            return lists
        moved = collectives.ring_shift([xs[0] for xs in lists], self.group)
        return tuple([x] for x in moved)

    def gather(self, xs, like):
        x = xs[0].to(like.dtype)
        return x if self.p == 1 else collectives.all_gather_dim(x, 1, self.group)


class _RingAttention(torch.autograd.Function):
    """Forward: each slot's Q chunk against the p K/V shards that rotate past
    it, merged per Q chunk. Backward: the second ring pass, dK/dV carried
    home by the last rotation. The slots are all p on a one-process mesh,
    this rank's one on a mesh of ranks; the chunk math and its order are
    the same."""

    @staticmethod
    def forward(ctx, q, k, v, ring: _Ring):
        qs, k_rot, v_rot = ring.split(q), ring.split(k), ring.split(v)
        parts = [ring.chunk_fwd(qs[j], k_rot[j], v_rot[j], i, 0) for j, i in enumerate(ring.slots)]
        for r in range(1, ring.p):
            k_rot, v_rot = ring.rotate(k_rot, v_rot)
            for j, i in enumerate(ring.slots):
                out2, lse2 = ring.chunk_fwd(qs[j], k_rot[j], v_rot[j], i, r)
                parts[j] = _merge(*parts[j], out2, lse2)
        out = ring.gather([o for o, _ in parts], q)
        ctx.save_for_backward(q, k, v, out, *(lse for _, lse in parts))
        ctx.ring = ring
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, *lses = ctx.saved_tensors
        ring = ctx.ring
        g = g.contiguous()
        delta = (g.float() * out.float()).sum(-1).transpose(1, 2)  # (B, H, L)
        qs, gs = ring.split(q), ring.split(g)
        deltas = ring.split_rows(delta)
        k_rot, v_rot = ring.split(k), ring.split(v)
        dq = [torch.zeros(x.shape, dtype=torch.float32, device=x.device) for x in qs]
        dk_rot = [torch.zeros(x.shape, dtype=torch.float32, device=x.device) for x in k_rot]
        dv_rot = [torch.zeros(x.shape, dtype=torch.float32, device=x.device) for x in v_rot]
        for r in range(ring.p):
            for j, i in enumerate(ring.slots):
                dq_c, dk_c, dv_c = ring.chunk_bwd(qs[j], k_rot[j], v_rot[j], gs[j], lses[j],
                                                  deltas[j], i, r)
                dq[j] += dq_c.float()
                dk_rot[j] += dk_c.float()
                dv_rot[j] += dv_c.float()
            # each dK/dV shard rotates with its K/V shard: after p rotations it is home
            if r + 1 < ring.p:
                dk_rot, dv_rot, k_rot, v_rot = ring.rotate(dk_rot, dv_rot, k_rot, v_rot)
            else:
                dk_rot, dv_rot = ring.rotate(dk_rot, dv_rot)
        return ring.gather(dq, q), ring.gather(dk_rot, k), ring.gather(dv_rot, v), None


def ring_attention(
    q: torch.Tensor,  # (B, L, H, D)
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    axis: str = "data",
    impl: str = "xla",
    main_len: int | None = None,
    cross_bias: float = 0.0,
) -> torch.Tensor:
    """Differentiable full (non-causal) attention over a sequence split across
    the devices along `axis` of `mesh`; returns (B, L, H, D) on q's device in
    q's dtype. `impl`: "xla" dense chunks | "pallas" flash chunk kernels. The
    ring size must divide L.

    `mesh` is a one-process `parallel.mesh.Mesh` (this process runs every
    slot over `mesh.axis_devices(axis)`) or a `parallel.mesh.RankMesh`
    (every rank of this rank's line along `axis` calls it with the same
    global q/k/v, as shard_map's in-spec takes a replicated array; the rank
    runs the chunk of its `axis` coordinate and the line joins the results).

    Cond-stream modifiers: tokens at global position >= `main_len` are the
    cond stream; `cross_bias` is added to cross (cond, main) logits (-1e30
    reproduces `union_cond_attn=False`, log(c_factor) reproduces `c_factor`),
    applied only when `main_len` is given and the bias is non-zero. With
    `impl="pallas"` the chunk offsets enter the kernels as runtime scalars;
    `impl="xla"` materialises each chunk's (Lq, Lk) bias instead."""
    B, L, H, D = q.shape
    p = mesh.shape[axis]
    if L % p:
        raise ValueError(
            f"ring size {p} must divide the sequence length {L} — "
            "pad the sequence to a multiple of the ring"
        )
    if impl not in ("xla", "pallas"):
        raise ValueError(f"ring chunk impl must be 'xla' or 'pallas', got {impl!r}")
    if isinstance(mesh, RankMesh):
        ring = _RankRing(mesh, axis, q.device, impl, L, D, main_len, cross_bias)
    else:
        ring = _Ring(mesh.axis_devices(axis), impl, L, D, main_len, cross_bias)
    return _RingAttention.apply(q, k, v, ring)
