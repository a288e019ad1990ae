"""Derives the BC7 partition and anchor tables that Pillow's BcnDecode.c
uses (BC6H's 32 two-region shapes are BC7's first 32) by decoding crafted
blocks with PIL, and writes them as
`reflectionflow_tpu_torch/csrc/host/bcn_tables.h`:

    python tests/data/torch_jpeg/make_bcn_tables.py

  * a mode-1 block (two subsets) whose first endpoints are black in subset
    0 and white in subset 1, with every index 0, paints partition p's map;
    a mode-2 block (three subsets, first endpoints black / red / green) the
    three-subset map; the second endpoints differ in blue;
  * the same blocks with one index bit set, for every bit of the index
    field, show which pixel each bit belongs to: a pixel with one bit fewer
    than the others is an anchor (pixel 0 always; the two-subset anchor; the
    three-subset anchors of subsets 1 and 2).

`tests/test_torch_dds.py` runs `derive()` and holds the committed header to
it. Takes about a second.
"""

import io
import os
import struct

import numpy as np
from PIL import Image

HEADER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "..", "reflectionflow_tpu_torch", "csrc",
                      "host", "bcn_tables.h")


def dds_dx10(blocks: np.ndarray, dxgi: int, w: int, h: int) -> bytes:
    """A DDS file (DX10 header) of `blocks` ((n, 16) uint8), w x h pixels."""
    head = struct.pack("<4s7I44x", b"DDS ", 124, 0x1007, h, w, 0, 0, 0)
    pf = struct.pack("<2I4s5I", 32, 0x4, b"DX10", 0, 0, 0, 0, 0)
    caps = struct.pack("<4I4x", 0x1000, 0, 0, 0)
    return head + pf + caps + struct.pack("<5I", dxgi, 3, 0, 1, 0) + blocks.tobytes()


def set_bits(block: bytearray, at: int, n: int, value: int) -> int:
    for k in range(n):
        if (value >> k) & 1:
            block[(at + k) >> 3] |= 1 << ((at + k) & 7)
    return at + n


def decode_blocks(blocks: list) -> np.ndarray:
    """PIL's decode of BC7 blocks laid out in one row -> (n, 16, 4) RGBA."""
    arr = np.frombuffer(b"".join(bytes(b) for b in blocks), np.uint8).reshape(-1, 16)
    n = arr.shape[0]
    im = Image.open(io.BytesIO(dds_dx10(arr, 98, 4 * n, 4)))  # BC7_UNORM
    px = np.asarray(im.convert("RGBA")).reshape(4, n, 4, 4)
    return px.transpose(1, 0, 2, 3).reshape(n, 16, 4)


def mode1_block(p: int, index_bit: int = -1) -> bytearray:
    """Mode 1: index 0 black in subset 0, white in subset 1; any other index
    moves blue."""
    b = bytearray(16)
    at = set_bits(b, 0, 2, 0b10)
    at = set_bits(b, at, 6, p)
    for channel in ((0, 0, 63, 63), (0, 0, 63, 63), (0, 63, 63, 0)):
        for e in channel:
            at = set_bits(b, at, 6, e)
    at += 2  # p-bits
    if index_bit >= 0:
        set_bits(b, at + index_bit, 1, 1)
    return b


def mode2_block(p: int, index_bit: int = -1) -> bytearray:
    """Mode 2: index 0 black in subset 0, red in subset 1, green in subset 2;
    any other index adds blue (5-bit endpoints)."""
    b = bytearray(16)
    at = set_bits(b, 0, 3, 0b100)
    at = set_bits(b, at, 6, p)
    for channel in range(3):
        for subset in range(3):
            v = 31 if (channel, subset) in ((0, 1), (1, 2)) else 0
            at = set_bits(b, at, 5, v)
            at = set_bits(b, at, 5, 31 if channel == 2 else v)
    if index_bit >= 0:
        set_bits(b, at + index_bit, 1, 1)
    return b


def _anchors(blocks, n_bits: int, base: np.ndarray) -> list:
    """Each index bit's pixel -> the pixels holding fewer bits than the most."""
    px = decode_blocks(blocks)
    owner = [int(np.flatnonzero((px[q] != base).any(axis=1))[0]) for q in range(n_bits)]
    counts = np.bincount(owner, minlength=16)
    assert sorted(owner) == owner, "index bits out of pixel order"
    return [i for i in range(16) if counts[i] < counts.max()]


def derive() -> str:
    p2, p3, a2, a3a, a3b = [], [], [], [], []
    maps1 = decode_blocks([mode1_block(p) for p in range(64)])
    maps2 = decode_blocks([mode2_block(p) for p in range(64)])
    for p in range(64):
        subset = (maps1[p, :, 0] > 128).astype(int)
        p2.append(sum(int(s) << i for i, s in enumerate(subset)))
        reduced = _anchors([mode1_block(p, q) for q in range(46)], 46, maps1[p])
        assert reduced[0] == 0 and len(reduced) == 2, (p, reduced)
        a2.append(reduced[1])
        rgb = maps2[p, :, :2]
        subset3 = np.where(rgb[:, 0] > 128, 1, np.where(rgb[:, 1] > 128, 2, 0))
        p3.append(sum(int(s) << (2 * i) for i, s in enumerate(subset3)))
        reduced = _anchors([mode2_block(p, q) for q in range(29)], 29, maps2[p])
        assert reduced[0] == 0, (p, reduced)
        # an anchor that is not in its subset reduces nothing in BcnDecode.c: 0 stands for none
        a3a.append(next((i for i in reduced[1:] if subset3[i] == 1), 0))
        a3b.append(next((i for i in reduced[1:] if subset3[i] == 2), 0))

    def table(ctype: str, name: str, values, fmt: str, per_line: int) -> str:
        rows = [", ".join(fmt.format(v) for v in values[i:i + per_line]) for i in range(0, len(values), per_line)]
        return f"constexpr {ctype} {name}[64] = {{\n    " + ",\n    ".join(rows) + "};\n"

    return ("// The BC7 partition and anchor tables of Pillow 12.1's BcnDecode.c (BC6H's\n"
            "// two-region shapes are the first 32), derived from PIL's decodes by\n"
            "// tests/data/torch_jpeg/make_bcn_tables.py, which writes this file.\n"
            "// kPartition2[p] bit i: pixel i's subset; kPartition3[p] bits 2i, 2i + 1:\n"
            "// its subset; kAnchor2: the second subset's anchor pixel; kAnchor3a / b:\n"
            "// the anchors of subsets 1 and 2 of three (0: none).\n\n"
            "#pragma once\n\n#include <cstdint>\n\nnamespace {\n\n"
            + table("uint16_t", "kPartition2", p2, "0x{:04x}", 8) + "\n"
            + table("uint32_t", "kPartition3", p3, "0x{:08x}", 6) + "\n"
            + table("uint8_t", "kAnchor2", a2, "{:2d}", 16) + "\n"
            + table("uint8_t", "kAnchor3a", a3a, "{:2d}", 16) + "\n"
            + table("uint8_t", "kAnchor3b", a3b, "{:2d}", 16) + "\n}  // namespace\n")


if __name__ == "__main__":
    with open(HEADER, "w") as f:
        f.write(derive())
