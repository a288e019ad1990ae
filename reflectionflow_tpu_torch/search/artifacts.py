"""Filesystem artifact contract.

Counterpart of `reflectionflow_tpu/search/artifacts.py`: the same directory
and JSONL layout per prompt index,

    {output_root}/{index:05d}/
        metadata.jsonl
        samples/                  {round}_round@{seed}.png   (stage 1)
        midimg/                   {round}_round@{seed}.png   (reflection rounds)
        samples_lastround/        {i:05d}.png
        samples_path_bestround/   {i:05d}.png  (best per chain)
        samples_best/             {i:05d}.png  (global best)
        best_img_detailedscore.jsonl
        best_img_meta.jsonl
        search_state.json         (resume manifest)

and `save_image` writes PNG with the standard library (zlib + struct), so the
port needs no imaging package. `load_image` reads JPEG (sequential or
progressive; grey, YCbCr, RGB, CMYK, YCCK) and PNG (every colour type and bit
depth, interlaced or not) with the port's own decoders
(`train/data.py::decode_image`), as PIL's `Image.open(...).convert("RGB")`
does.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from dataclasses import dataclass

import numpy as np

_PNG_COLOR_TYPE = {1: 0, 3: 2, 4: 6}  # channels -> grey, RGB, RGBA


def round_image_name(round_idx: int, seed: int) -> str:
    return f"{round_idx}_round@{seed}.png"


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))


def encode_png(image: np.ndarray) -> bytes:
    """uint8 (H, W), (H, W, 3) or (H, W, 4) -> PNG bytes (8-bit, no filter)."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise TypeError(f"PNG encoding takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    if img.ndim != 3 or img.shape[2] not in _PNG_COLOR_TYPE:
        raise ValueError(f"PNG encoding takes (H, W[, 1|3|4]) images, got {image.shape}")
    h, w, c = img.shape
    # each scanline starts with filter type 0 (None)
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOR_TYPE[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _png_chunk(b"IEND", b""))


def save_image(path: str, image: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(image))


def load_image(path: str) -> np.ndarray:
    """A JPEG or PNG file -> (H, W, 3) uint8 RGB."""
    from ..train.data import decode_image

    with open(path, "rb") as f:
        return decode_image(f.read())


@dataclass
class PromptDirs:
    root: str

    @classmethod
    def create(cls, output_root: str, prompt_index: int, stage2: bool = False,
               make: bool = True) -> "PromptDirs":
        """The prompt's directories, made unless `make` is False (a rank that
        does not write)."""
        d = cls(os.path.join(output_root, f"{prompt_index:05d}"))
        if not make:
            return d
        os.makedirs(d.samples, exist_ok=True)
        if stage2:
            for sub in (d.midimg, d.samples_lastround, d.samples_bestround, d.samples_best):
                os.makedirs(sub, exist_ok=True)
        return d

    @property
    def samples(self):
        return os.path.join(self.root, "samples")

    @property
    def midimg(self):
        return os.path.join(self.root, "midimg")

    @property
    def samples_lastround(self):
        return os.path.join(self.root, "samples_lastround")

    @property
    def samples_bestround(self):
        return os.path.join(self.root, "samples_path_bestround")

    @property
    def samples_best(self):
        return os.path.join(self.root, "samples_best")

    @property
    def metadata(self):
        return os.path.join(self.root, "metadata.jsonl")

    @property
    def detailed_scores(self):
        return os.path.join(self.root, "best_img_detailedscore.jsonl")

    @property
    def best_meta(self):
        return os.path.join(self.root, "best_img_meta.jsonl")

    def append_metadata(self, datapoint: dict) -> None:
        with open(self.metadata, "a") as f:
            f.write(json.dumps(datapoint) + "\n")

    def append_detailed_scores(self, evaluation: list[dict], filenames: list[str]) -> None:
        with open(self.detailed_scores, "a") as f:
            f.write(json.dumps({"evaluation": evaluation, "filenames_batch": filenames}) + "\n")

    def append_best_meta(self, search_round: int, reflections=None, refined_prompt=None,
                         filenames=None) -> None:
        with open(self.best_meta, "a") as f:
            if reflections is not None:
                f.write(f"reflections{search_round}: " + json.dumps(reflections) + "\n")
            if refined_prompt is not None:
                f.write(f"refined_prompt{search_round}: " + json.dumps(refined_prompt) + "\n")
            if filenames is not None:
                f.write(f"filenames_batch{search_round}: " + json.dumps(filenames) + "\n")


def load_geneval_metadata(path: str, start: int = 0, end: int | None = None) -> list[dict]:
    """Rows [start:end] of a GenEval `evaluation_metadata.jsonl` ({"prompt", "tag", ...})."""
    from ..utils.jsonl import read_jsonl

    return read_jsonl(path)[start:end]
