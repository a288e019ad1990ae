"""The safetensors file format, read and written with the standard library
and torch (the port's machine has no `safetensors` package).

Layout: an 8-byte little-endian header length N, N bytes of JSON
({name: {"dtype", "shape", "data_offsets": [begin, end]}, optional
"__metadata__": {str: str}}), padded with spaces to a multiple of 8, then the
tensors' raw little-endian bytes, each at its offsets from the end of the
header.
"""

from __future__ import annotations

import json
import os
import struct

import torch

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def save_file(tensors: dict[str, torch.Tensor], path: str | os.PathLike,
              metadata: dict[str, str] | None = None) -> None:
    """Write `tensors` (any device; stored contiguous, as they are) to `path`."""
    header: dict = {"__metadata__": dict(metadata)} if metadata else {}
    blobs, offset = [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        if t.dtype not in _NAMES:
            raise TypeError(f"{name}: dtype {t.dtype} has no safetensors code")
        data = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for data in blobs:
            f.write(data)


def load_file(path: str | os.PathLike) -> dict[str, torch.Tensor]:
    """Read every tensor of `path` into CPU tensors."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        body = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        dtype = _DTYPES[info["dtype"]]
        raw = bytearray(body[begin:end])
        t = torch.frombuffer(raw, dtype=dtype) if raw else torch.empty(0, dtype=dtype)
        out[name] = t.reshape(info["shape"])
    return out
