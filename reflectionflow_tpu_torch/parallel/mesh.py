"""Meshes: of ranks (serving and training), and of one process's devices (the ring).

Counterpart of `reflectionflow_tpu/parallel/mesh.py`. The workload's scale
axis is candidates: N parallel trajectories a prompt. Two forms:

  * `RankMesh`, what `make_mesh` returns under an initialised process group
    (`parallel/distributed.py`): a grid of ranks, one process per device,
    with named axes and a process group per axis. "data" shards candidates
    (`candidate_sharding` / `shard_batch` give this rank's contiguous slice of
    a batch-leading tensor, as `P("data")`; `gather_candidates` is the
    all-gather JAX's host read of a sharded array does), "model" shards the
    DiT's heads and MLP hidden (`parallel/specs.py`), "seq" splits the joint
    sequence of each attention over a ring of ranks (`ops.ring_attention`,
    through `ops.attention.set_ring_context(mesh, "seq")`). "seq" composes
    with the others: ("seq",), ("data", "seq") and ("model", "seq"). The
    candidate helpers key on "data" alone, so the ranks of a seq line read
    the same rows; under ("model", "seq") each rank's ring runs over its own
    TP-cut heads, the function JAX's one program computes. `replicate_params`
    broadcasts weights from rank 0; `pad_candidates` is JAX's.
  * `Mesh`, a numpy object array of `torch.device`s that one process drives
    (a device may appear more than once): ring attention
    (`ops.ring_attention`, through `ops.attention.set_ring_context`) splits a
    sequence over one of its axes, one contiguous chunk per slot, run one
    after another on one card and with peer copies across cards. It is what
    `make_mesh` returns with `devices=`, or with no process group.

Divergences: a JAX `Mesh` holds distinct devices and one program runs on all
of them, with XLA placing the collectives. Here each rank runs the program
on its own slice and the collectives are the port's own
(`parallel/collectives.py`). On a one-process `Mesh` of more than one axis
the ring runs once, over the devices along its axis at index 0 of the others
(`Mesh.axis_devices`), where JAX runs one ring a row: the output is the
same.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from . import collectives


class Mesh:
    """`devices`: an array of `torch.device`s, one axis per name;
    `shape[name]` is the size of that axis, as `jax.sharding.Mesh.shape`."""

    def __init__(self, devices, axis_names: tuple[str, ...]):
        arr = np.array(devices, dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = torch.device(arr[idx])
        if arr.ndim != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"devices of shape {arr.shape} need as many distinct axis names, "
                             f"got {axis_names}")
        self.devices = arr
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along `axis`, at index 0 of every other axis (the
        ring's order: shard i lives on the i-th). One ring for the whole
        mesh, where JAX runs one a row of the other axes: the same output
        (the module docstring's divergence)."""
        arr = np.moveaxis(self.devices, self.axis_names.index(axis), 0)
        return list(arr.reshape(arr.shape[0], -1)[:, 0])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def _fill_shape(shape, n: int) -> tuple[int, ...]:
    """`shape` with a -1 taking what the others leave of n (None: (n,))."""
    if shape is None or tuple(shape) == (-1,):
        return (n,)
    known = int(np.prod([s for s in shape if s > 0]))
    return tuple(n // known if s == -1 else int(s) for s in shape)


class RankMesh:
    """A grid of the world's ranks with named axes, row-major (rank r sits at
    `np.unravel_index(r, shape)`), and one process group per axis line this
    rank lies on. Every rank builds it, with the same shape, in the same
    order (`dist.new_group` is collective)."""

    def __init__(self, shape: tuple[int, ...], axis_names: tuple[str, ...]):
        world, rank = dist.get_world_size(), dist.get_rank()
        shape = tuple(int(s) for s in shape)
        if int(np.prod(shape)) != world or min(shape) < 1:
            raise ValueError(f"mesh shape {shape} needs {int(np.prod(shape))} ranks, the world has "
                             f"{world}")
        if len(axis_names) != len(shape) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh shape {shape} needs as many distinct axis names, got {axis_names}")
        self.axis_names = tuple(axis_names)
        self.ranks = np.arange(world).reshape(shape)
        self.rank = rank
        self.size = world
        self.coords = {a: int(c) for a, c in zip(self.axis_names, np.unravel_index(rank, shape))}
        self.world_group = dist.group.WORLD
        self.groups: dict[str, object] = {}
        for i, axis in enumerate(self.axis_names):
            lines = np.moveaxis(self.ranks, i, -1).reshape(-1, shape[i])
            for line in lines:
                # every rank creates every group; a line of one rank needs none
                group = dist.new_group([int(r) for r in line]) if shape[i] > 1 else None
                if rank in line:
                    self.groups[axis] = group
        # the gradient bucket's group: the data x model ranks of this rank's seq coordinate
        sp = self.axis_size("seq")
        self.grad_group = self.world_group if world > sp else None
        if sp > 1 and world > sp:
            for plane in np.moveaxis(self.ranks, self.axis_names.index("seq"), 0).reshape(sp, -1):
                group = dist.new_group([int(r) for r in plane])
                if rank in plane:
                    self.grad_group = group

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.ranks.shape))

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def group(self, axis: str):
        """The process group of this rank's line along `axis`. None for an
        axis of one rank or an absent axis, where no collective runs: a
        caller checks `axis_size` first (the collectives read None as the
        world)."""
        return self.groups.get(axis)

    def __repr__(self) -> str:
        return f"RankMesh({self.shape}, rank={self.rank}, coords={self.coords})"


def make_mesh(shape: tuple[int, ...] | None = None, axis_names: tuple[str, ...] = ("data",),
              devices=None) -> "Mesh | RankMesh":
    """Under an initialised process group (and without `devices`): a
    `RankMesh` over the world's ranks, default 1-D on "data". Otherwise a
    one-process `Mesh`, default 1-D over every visible CUDA device on the
    "data" axis. A -1 in `shape` takes what the others leave. `devices` (a
    list, which may repeat a device) replaces the visible CUDA devices;
    without it and without a process group, a machine with no CUDA device
    raises, and the CPU is never chosen."""
    if devices is None and dist.is_initialized():
        shape = _fill_shape(shape, dist.get_world_size())
        return RankMesh(shape, axis_names[: len(shape)])
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("make_mesh found no CUDA device; pass devices= explicitly "
                               "(e.g. [torch.device('cpu')] * 4)")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    shape = _fill_shape(shape, len(devices))
    size = int(np.prod(shape))
    if size > len(devices) or size < 1:
        raise ValueError(f"mesh shape {shape} needs {size} devices, {len(devices)} given")
    arr = np.empty(size, dtype=object)
    arr[:] = devices[:size]
    return Mesh(arr.reshape(shape), axis_names[: len(shape)])


# -- candidate sharding over "data" (JAX :36-60) -----------------------------


def pad_candidates(n: int, mesh) -> int:
    """Smallest multiple of the data-axis size >= n."""
    d = mesh.shape.get("data", 1)
    return ((n + d - 1) // d) * d


def candidate_sharding(mesh: RankMesh, n: int) -> slice:
    """This rank's contiguous rows of an n-row batch along "data" (JAX's
    `P("data")`); n must divide by the data axis. The other axes do not
    enter: the ranks of a "model" or "seq" line read the same rows."""
    d = mesh.axis_size("data")
    if n % d:
        raise ValueError(f"batch {n} does not divide by the data axis {d} (pad_candidates)")
    per = n // d
    i = mesh.coords.get("data", 0)
    return slice(i * per, (i + 1) * per)


def shard_batch(tree, mesh: RankMesh):
    """This rank's slice along "data" of every batch-leading tensor (or list)
    in a tensor, list, tuple or dict tree; None leaves stay None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: shard_batch(v, mesh) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(shard_batch(v, mesh) for v in tree)
    return tree[candidate_sharding(mesh, len(tree))]


def gather_candidates(x: torch.Tensor, mesh: RankMesh) -> torch.Tensor:
    """Every rank's slice along "data", concatenated in data order: the whole
    batch on every rank."""
    if mesh.axis_size("data") == 1:
        return x
    return collectives.all_gather_batch(x, mesh.group("data"))


def replicated(x: torch.Tensor, mesh: RankMesh) -> torch.Tensor:
    """`x` of rank 0 on every rank of the mesh, in place."""
    return collectives.broadcast(x, 0, mesh.world_group if mesh.size > 1 else None)


@torch.no_grad()
def replicate_params(module: torch.nn.Module, mesh: RankMesh) -> torch.nn.Module:
    """Every parameter and buffer of `module` as rank 0 holds it, on every
    rank (one broadcast each); returns `module`."""
    for t in (*module.parameters(), *module.buffers()):
        replicated(t.data, mesh)
    return module
