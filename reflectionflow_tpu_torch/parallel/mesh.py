"""Device mesh.

Counterpart of `reflectionflow_tpu/parallel/mesh.py::make_mesh`: a grid of
devices with named axes. Ring attention (`ops.ring_attention`, reached
through `ops.attention.set_ring_context`) splits a sequence over one axis of
it, one contiguous chunk per device along that axis.

Divergence: a JAX `Mesh` holds distinct devices and one program runs on all
of them. Here the mesh is a numpy object array of `torch.device`s that one
process drives, and a device may appear more than once: the same ring runs
its shards one after another on one card (or on the CPU), and with peer
copies across cards where there are several. Data parallelism, tensor
parallelism and a multi-process `torch.distributed` form are not ported.
"""

from __future__ import annotations

import numpy as np
import torch


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
        ring's order: shard i lives on the i-th)."""
        arr = np.moveaxis(self.devices, self.axis_names.index(axis), 0)
        return list(arr.reshape(arr.shape[0], -1)[:, 0])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def make_mesh(shape: tuple[int, ...] | None = None, axis_names: tuple[str, ...] = ("data",),
              devices=None) -> Mesh:
    """Default: a 1-D mesh over every visible CUDA device on the "data" axis.
    A -1 in `shape` takes what the others leave. `devices` (a list, which may
    repeat a device) replaces the visible CUDA devices; without it, a machine
    with no CUDA device raises, and the CPU is never chosen."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("make_mesh found no CUDA device; pass devices= explicitly "
                               "(e.g. [torch.device('cpu')] * 4)")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    if shape is None or tuple(shape) == (-1,):
        shape = (len(devices),)
    known = int(np.prod([s for s in shape if s > 0]))
    shape = tuple(len(devices) // known if s == -1 else int(s) for s in shape)
    size = int(np.prod(shape))
    if size > len(devices) or size < 1:
        raise ValueError(f"mesh shape {shape} needs {size} devices, {len(devices)} given")
    arr = np.empty(size, dtype=object)
    arr[:] = devices[:size]
    return Mesh(arr.reshape(shape), axis_names[: len(shape)])
