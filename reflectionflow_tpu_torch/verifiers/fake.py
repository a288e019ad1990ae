"""Deterministic fake verifiers, the hermetic test seam.

Counterpart of `reflectionflow_tpu/verifiers/fake.py`, bit for bit: scores
are a sha256 of (image bytes, prompt), reproducible across processes and
packages, sensitive to image content and free of network and models.
`quality_fn` lets a test inject a ground-truth scorer.
"""

from __future__ import annotations

import hashlib
import time
from typing import Callable

import numpy as np

from .base import Verifier
from .schemas import axes_for_tag


def _stable_unit(image: np.ndarray, prompt: str, salt: str = "") -> float:
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(image).tobytes())
    h.update(prompt.encode())
    h.update(salt.encode())
    return int(h.hexdigest()[:12], 16) / float(16**12)


class FakeVerifier(Verifier):
    """Grading-shaped scores in [0, 10], input order preserved. `delay_s`
    sleeps once per score call (a remote verifier's latency)."""

    name = "fake"

    def __init__(
        self,
        quality_fn: Callable[[np.ndarray, str], float] | None = None,
        delay_s: float = 0.0,
        **_,
    ):
        self.quality_fn = quality_fn
        self.delay_s = delay_s

    def score(self, images, prompts, tag=None, max_new_tokens=None):
        if self.delay_s:
            time.sleep(self.delay_s)
        outputs = []
        for img, prompt in zip(images, prompts):
            if self.quality_fn is not None:
                base = float(self.quality_fn(img, prompt))
            else:
                base = _stable_unit(img, prompt) * 10.0
            out = {}
            for axis in axes_for_tag(tag):
                val = base if axis == "overall_score" else (base + _stable_unit(img, prompt, axis) - 0.5)
                out[axis] = {"score": round(val, 4), "explanation": "fake"}
            outputs.append(out)
        return outputs


class FakeNvilaVerifier(Verifier):
    """Yes/no + logit outputs in the nvila ranking convention."""

    name = "fake_nvila"
    output_kind = "yes_no"

    def __init__(self, yes_threshold: float = 0.5, quality_fn=None, **_):
        self.yes_threshold = yes_threshold
        self.quality_fn = quality_fn

    def score(self, images, prompts, tag=None, max_new_tokens=None):
        outputs = []
        for img, prompt in zip(images, prompts):
            u = (
                float(self.quality_fn(img, prompt))
                if self.quality_fn is not None
                else _stable_unit(img, prompt)
            )
            label = "yes" if u >= self.yes_threshold else "no"
            outputs.append({"label": label, "score": round(4.0 * u, 4)})
        return outputs
