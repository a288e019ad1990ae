"""The collectives of the rank mesh: one home for every cross-rank call.

The TPU program leaves its collectives to XLA's SPMD partitioner (a psum
after each row-sharded matmul, an all-gather where a sharded array is read
on the host). The port runs one process per device under
`torch.distributed`, so it places them itself, and every one of them goes
through this module:

  * `all_reduce_sum` — a sum in place: the check of
    `parallel/dryrun.py::dryrun_multihost`, a W8A8 row-sharded linear's int32
    accumulators (`parallel/specs.py::RowParallelLinear`);
  * `row_sum` and `col_copy` — Megatron's two operators, which autograd
    sees: the sum after each row-sharded linear (forward all-reduce, backward
    identity) and the copy before the column-sharded linears that share one
    input (forward identity, backward all-reduce of the input's gradient);
    without a gradient to track they are `all_reduce_sum` and nothing;
  * `all_reduce_max` — a max in place: a row-sharded W8A8 linear's per-token
    activation amax and per-channel weight amax, taken over the whole row;
  * `all_gather_dim` — the ranks' shards of a tensor joined along one dim:
    FSDP's gather on use (`parallel/specs.py::shard_fsdp_params`);
  * `reduce_gradients` — the training step's one bucketed all-reduce: every
    gradient (and the loss) in one flat fp32 buffer, averaged over "data"
    and summed over "model" where a rank holds a partial sum, within the
    ranks of one "seq" coordinate (the ranks of a seq line hold the same
    gradients);
  * `ring_shift` — `lax.ppermute` along a ring: each rank of a group sends
    its tensors to the next group rank and receives the previous one's (ring
    attention's K/V rotation, `ops/ring_attention.py`), counted with the
    bytes it sends;
  * `all_gather_batch` — a batch-leading tensor gathered over the "data"
    axis in rank order (`parallel/mesh.py::gather_candidates`);
  * `broadcast` — a tensor from one rank of a group (`replicate_params`, the
    velocity cache's step decision under tensor parallelism);
  * `broadcast_object` — a picklable host value from rank 0 (the search
    loops' file reads and host-model answers, `distributed.RankZero`).

`COUNTS` counts the calls of each, as the kernels' wrappers count their
launches, and `host_copies` the collectives that went through host memory:
gloo takes CPU tensors, so a CUDA tensor under a gloo group is copied to the
host, reduced or gathered there and copied back. That is how two ranks that
share one card run (NCCL refuses two ranks on one GPU); it is counted and
never chosen in place of NCCL, whose groups take the CUDA tensor itself. A
group of one rank runs no collective and counts none.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

COUNTS = {"all_reduce_sum": 0, "all_reduce_max": 0, "all_gather_batch": 0, "all_gather_dim": 0,
          "broadcast": 0, "broadcast_object": 0, "grad_all_reduce": 0, "ring_shift": 0,
          "ring_shift_bytes": 0, "host_copies": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def group_size(group=None) -> int:
    """Ranks in `group` (the world for None); 1 without a process group."""
    if not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def _staged(x: torch.Tensor, group) -> bool:
    """A CUDA tensor under a gloo group goes through host memory."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _all_reduce(x: torch.Tensor, op, group, key: str) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    COUNTS[key] += 1
    if _staged(x, group):
        COUNTS["host_copies"] += 1
        host = x.detach().cpu()
        dist.all_reduce(host, op=op, group=group)
        return x.copy_(host)
    dist.all_reduce(x, op=op, group=group)
    return x


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum `x` over the ranks of `group`, in place; returns `x`."""
    return _all_reduce(x, dist.ReduceOp.SUM, group, "all_reduce_sum")


def all_reduce_max(x: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise max of `x` over the ranks of `group`, in place; returns `x`."""
    return _all_reduce(x, dist.ReduceOp.MAX, group, "all_reduce_max")


class _RowSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _ColCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad.clone(), ctx.group), None


def row_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over `group` of each rank's partial `x` (a row-sharded
    linear's output). Under autograd a new tensor whose gradient passes to
    every rank's `x` unchanged; otherwise `x` summed in place."""
    if group_size(group) == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _RowSum.apply(x, group)
    return all_reduce_sum(x, group)


def col_copy(x: torch.Tensor, group=None) -> torch.Tensor:
    """`x`, the replicated input of the column-sharded linears that read it;
    in the backward the gradients that those linears give `x` on each rank
    are summed over `group`. Nothing without a gradient to track."""
    if group_size(group) == 1 or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _ColCopy.apply(x, group)


def all_gather_dim(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The ranks' `x` (equal shapes) concatenated along `dim` in group rank
    order, as a new tensor on `x`'s device."""
    n = group_size(group)
    if n == 1:
        return x
    COUNTS["all_gather_dim"] += 1
    staged = _staged(x, group)
    src = x.detach().cpu() if staged else x.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    if staged:
        COUNTS["host_copies"] += 1
        out = out.to(x.device)
    return out


def reduce_gradients(grads: list[torch.Tensor], partial: list[bool], mesh,
                     extras: list[torch.Tensor] = ()) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """One bucketed all-reduce over the data x model ranks of `mesh` (a
    `RankMesh`) that share this rank's "seq" coordinate (`mesh.grad_group`):
    `grads` and the scalars `extras` (a rank's loss) go into one flat fp32
    buffer, and each comes back averaged over "data"; a gradient marked
    `partial` (a rank's share of a tensor cut over "model") is also summed
    over "model", the others (replicated, the same on every rank of a model
    group) and the extras averaged. The ranks of a "seq" line compute the
    same gradients (ring attention joins its output and its input
    gradients over the line), so "seq" enters neither the sum nor the
    scale: a (data, seq) step is the data-only step. Every rank gets the
    same bits. Returns (grads, extras), new tensors in the gradients'
    dtypes."""
    dp, tp = mesh.axis_size("data"), mesh.axis_size("model")
    if dp * tp == 1:
        return list(grads), list(extras)
    tensors = [*grads, *extras]
    scales = [1.0 / (dp if p else dp * tp) for p in partial] + [1.0 / (dp * tp)] * len(extras)
    flat = torch.cat([(t.detach().float() * s).reshape(-1) for t, s in zip(tensors, scales)])
    group = mesh.grad_group
    COUNTS["grad_all_reduce"] += 1
    if _staged(flat, group):
        COUNTS["host_copies"] += 1
        host = flat.cpu()
        dist.all_reduce(host, op=dist.ReduceOp.SUM, group=group)
        flat = host.to(flat.device)
    else:
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view(t.shape).to(t.dtype))
        i += t.numel()
    return out[:len(grads)], out[len(grads):]


def ring_shift(xs: list[torch.Tensor], group) -> list[torch.Tensor]:
    """One step of a ring over `group` (JAX's `lax.ppermute` with the perm
    i -> i + 1): this rank, group rank i of p, sends each tensor of `xs` to
    group rank (i + 1) mod p and receives the same shapes from (i - 1) mod p;
    returns the received tensors on `xs`' devices. Every send and receive is
    posted before any is waited on, so every rank of the ring may call it at
    once. NCCL moves the CUDA tensors themselves; a CUDA tensor under gloo
    goes through host memory (one host copy counted per call). Counts one
    call and the bytes this rank sends."""
    n = group_size(group)
    if n == 1:
        return list(xs)
    me = dist.get_group_rank(group, dist.get_rank()) if group is not None else dist.get_rank()
    nxt = dist.get_global_rank(group, (me + 1) % n) if group is not None else (me + 1) % n
    prv = dist.get_global_rank(group, (me - 1) % n) if group is not None else (me - 1) % n
    staged = _staged(xs[0], group)
    srcs = [x.detach().cpu() if staged else x.detach().contiguous() for x in xs]
    outs = [torch.empty_like(s) for s in srcs]
    ops = [dist.P2POp(dist.isend, s, nxt, group) for s in srcs]
    ops += [dist.P2POp(dist.irecv, o, prv, group) for o in outs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    COUNTS["ring_shift"] += 1
    COUNTS["ring_shift_bytes"] += sum(s.numel() * s.element_size() for s in srcs)
    if staged:
        COUNTS["host_copies"] += 1
        outs = [o.to(x.device) for o, x in zip(outs, xs)]
    return outs


def all_gather_batch(x: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' `x` (equal shapes) concatenated on dim 0 in group rank order."""
    n = group_size(group)
    if n == 1:
        return x
    COUNTS["all_gather_batch"] += 1
    staged = _staged(x, group)
    src = x.detach().cpu() if staged else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=0)
    if staged:
        COUNTS["host_copies"] += 1
        out = out.to(x.device)
    return out


def broadcast(x: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """`x` of group rank `src` on every rank of `group`, in place; returns `x`."""
    if group_size(group) == 1:
        return x
    COUNTS["broadcast"] += 1
    root = dist.get_global_rank(group, src) if group is not None else src
    if _staged(x, group):
        COUNTS["host_copies"] += 1
        host = x.detach().cpu()
        dist.broadcast(host, src=root, group=group)
        return x.copy_(host)
    dist.broadcast(x, src=root, group=group)
    return x


def broadcast_object(obj, group=None):
    """Group rank 0's `obj` (picklable) on every rank of `group`. Objects go
    through host memory on every backend (NCCL pickles onto the device
    first), and are not counted as host copies."""
    if group_size(group) == 1:
        return obj
    COUNTS["broadcast_object"] += 1
    box = [obj]
    root = dist.get_global_rank(group, 0) if group is not None else 0
    dist.broadcast_object_list(box, src=root, group=group)
    return box[0]
