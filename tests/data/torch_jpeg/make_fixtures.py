"""Writes the JPEG fixtures of this directory and their manifest with PIL.

    python tests/data/torch_jpeg/make_fixtures.py

Each image is a seeded smooth procedural RGB image with mild noise. The
manifest records each file's encode settings, the sha256 of PIL's decode
(`Image.open(...).convert("RGB")`, (H, W, 3) uint8 bytes) and the sha256 of
PIL's bicubic `Image.resize` chains that the GenRef data path runs on them
(a chain "1024x1024,512x512" resizes to 1024x1024, then that to 512x512).
`tests/test_torch_jpeg.py` checks the committed bytes against the manifest
with PIL; `chip_smoke.py` phase 5e holds the port's decoder and resize to it.
"""

import hashlib
import io
import json
import os

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))

# name, (W, H), seed, save options, resize chains
FIXTURES = [
    ("good_a_1024_q75_420.jpg", (1024, 1024), 1, {"quality": 75, "subsampling": 2}, ["512x512"]),
    ("good_b_1024_q75_420.jpg", (1024, 1024), 2, {"quality": 75, "subsampling": 2}, ["512x512"]),
    ("bad_1024x768_q75_420.jpg", (1024, 768), 3, {"quality": 75, "subsampling": 2},
     ["1024x1024", "1024x1024,512x512", "683x512"]),
    ("good_c_1024_q90_444_rst.jpg", (1024, 1024), 4,
     {"quality": 90, "subsampling": 0, "restart_marker_blocks": 7}, ["512x512"]),
    ("grey_33x17_q85.jpg", (33, 17), 5, {"quality": 85, "mode": "L"}, ["16x16"]),
    ("odd_17x9_q75_422.jpg", (17, 9), 6, {"quality": 75, "subsampling": 1}, ["8x8", "40x21"]),
    ("odd_67x45_q95_420_opt.jpg", (67, 45), 7, {"quality": 95, "subsampling": 2, "optimize": True},
     ["32x32"]),
    ("odd_50x31_q60_420_rst.jpg", (50, 31), 8,
     {"quality": 60, "subsampling": 2, "restart_marker_blocks": 2}, ["25x16"]),
    ("progressive_32x32.jpg", (32, 32), 9, {"quality": 75, "progressive": True}, []),
]


def procedural(w: int, h: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    f = rng.uniform(0.004, 0.03, (3, 2))
    ph = rng.uniform(0, 2 * np.pi, (3, 2))
    img = np.stack([128 + 70 * np.sin(xx * f[c, 0] + ph[c, 0]) * np.cos(yy * f[c, 1] + ph[c, 1])
                    + 40 * np.sin((xx + yy) * f[c, 0] * 0.5) for c in range(3)], axis=-1)
    img += rng.normal(0.0, 6.0, img.shape)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def resize_chain(img: Image.Image, chain: str) -> np.ndarray:
    for step in chain.split(","):
        img = img.resize(tuple(int(v) for v in step.split("x")))
    return np.asarray(img)


def main() -> None:
    manifest = {}
    for name, (w, h), seed, opts, chains in FIXTURES:
        opts = dict(opts)
        mode = opts.pop("mode", "RGB")
        img = Image.fromarray(procedural(w, h, seed)).convert(mode)
        buf = io.BytesIO()
        img.save(buf, format="JPEG", **opts)
        data = buf.getvalue()
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        entry = {"size": [w, h], "mode": mode, "seed": seed, "save": opts,
                 "file_sha256": hashlib.sha256(data).hexdigest()}
        if opts.get("progressive"):
            entry["raises"] = "NotImplementedError"
        else:
            dec = Image.open(io.BytesIO(data)).convert("RGB")
            entry["decode_sha256"] = sha(np.asarray(dec))
            entry["resize_sha256"] = {c: sha(resize_chain(dec, c)) for c in chains}
        manifest[name] = entry
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
