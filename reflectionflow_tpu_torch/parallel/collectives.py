"""The collectives of the rank mesh: one home for every cross-rank call.

The TPU program leaves its collectives to XLA's SPMD partitioner (a psum
after each row-sharded matmul, an all-gather where a sharded array is read
on the host). The port runs one process per device under
`torch.distributed`, so it places them itself, and every one of them goes
through this module:

  * `all_reduce_sum` — the tensor-parallel DiT's sum after each row-sharded
    linear (`parallel/specs.py::RowParallelLinear`) and the check of
    `parallel/dryrun.py::dryrun_multihost`;
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

COUNTS = {"all_reduce_sum": 0, "all_gather_batch": 0, "broadcast": 0, "broadcast_object": 0,
          "host_copies": 0}


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


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum `x` over the ranks of `group`, in place; returns `x`."""
    if group_size(group) == 1:
        return x
    COUNTS["all_reduce_sum"] += 1
    if _staged(x, group):
        COUNTS["host_copies"] += 1
        host = x.detach().cpu()
        dist.all_reduce(host, op=dist.ReduceOp.SUM, group=group)
        return x.copy_(host)
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


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
