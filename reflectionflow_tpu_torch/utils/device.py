"""Device placement of the colocated models.

Counterpart of `reflectionflow_tpu/utils/device.py` (`on_device`,
`quantize_blocks`, `pin`) as `torch.device` placement: a model is built,
quantized and kept on its device, and its calls run there. The entry points
run on `cuda` unless the caller asks for the CPU; without CUDA an unpinned
call raises, naming device="cpu". `verifier_args.device_index` /
`reflection_args.device_index` put a model on `cuda:<index>`.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn


def default_device(device: str | torch.device | None = None) -> torch.device:
    """`device`, or cuda when it is None; cuda without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r}: CUDA is not available; pass device=\"cpu\" "
                           "(--device cpu on the command line) to run on the CPU")
    return dev


def placement(device: str | torch.device | None, device_index: int | None) -> torch.device:
    """The device a colocated model is built on: `device_index` pins it to
    `cuda:<index>`, else `default_device(device)`."""
    if device_index is not None:
        if device is not None and torch.device(device).type != "cuda":
            raise ValueError(f"device_index={device_index} places on cuda, but device={device!r}")
        return default_device(f"cuda:{device_index}")
    return default_device(device)


@contextlib.contextmanager
def on_device(device_index: int | None):
    """Yields `cuda:<device_index>` with it made the current CUDA device, or
    None (and changes nothing) when unpinned."""
    if device_index is None:
        yield None
        return
    dev = default_device(f"cuda:{device_index}")
    with torch.cuda.device(dev):
        yield dev


def quantize_blocks(blocks: nn.ModuleList, min_size: int) -> nn.ModuleList:
    """Put every linear of a stack of blocks on W8A8 (`ops.quant.QuantLinear`),
    in place, when its weight stacked over the blocks has at least `min_size`
    elements: the JAX package's `quantize_dit_params` of a `blocks` tree."""
    from ..ops.quant import QuantLinear

    for block in blocks:
        for name, mod in list(block.named_modules()):
            if isinstance(mod, nn.Linear) and mod.weight.numel() * len(blocks) >= min_size:
                block.set_submodule(name, QuantLinear.from_linear(mod, act_quant=True))
    return blocks


def pin(dev: torch.device | None, *modules):
    """Move each module or tensor to `dev` (unchanged when dev is None); returns
    them in order, a single one bare."""
    out = tuple(modules) if dev is None else tuple(m.to(dev) for m in modules)
    return out[0] if len(out) == 1 else out
