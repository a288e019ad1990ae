"""Reflection generators.

Counterpart of `reflectionflow_tpu/reflect/generator.py`:
  * `openai`: any OpenAI-compatible endpoint (a local server included);
  * `fake`: deterministic strings for hermetic tests.
The colocated Qwen2.5-VL reflector (`local_qwen`) needs the Qwen model,
ROADMAP slice 4b, item 17: asking for it raises.

Every backend keeps input order and never drops an entry (a failed request
gives an empty reflection, not a shorter list).
"""

from __future__ import annotations

import abc
import hashlib
from typing import Sequence

import numpy as np

LOCAL_QWEN_NOT_PORTED = (
    "reflection_args.name 'local_qwen' (LocalQwenReflector) needs the Qwen2.5-VL model, "
    "ROADMAP slice 4b, item 17; the port serves 'fake' and 'openai'")


class Reflector(abc.ABC):
    @abc.abstractmethod
    def generate(
        self,
        images: Sequence[np.ndarray],
        original_prompts: Sequence[str],
        current_prompts: Sequence[str],
        prev_reflections: Sequence[str] | None = None,
        evaluations: Sequence[str] | None = None,
        max_new_tokens: int | None = None,
    ) -> list[str]:
        ...


class FakeReflector(Reflector):
    def generate(self, images, original_prompts, current_prompts, prev_reflections=None, evaluations=None,
                 max_new_tokens=None):
        out = []
        for img, prompt in zip(images, original_prompts):
            h = hashlib.sha1(np.ascontiguousarray(img).tobytes() + prompt.encode()).hexdigest()[:8]
            out.append(f"The image misses details of '{prompt}'; emphasize them next round (ref {h}).")
        return out


class OpenAIReflector(Reflector):
    def __init__(self, **kw):
        from ..verifiers.openai_backend import OpenAICompatVerifier

        self.backend = OpenAICompatVerifier(**kw)

    def generate(self, images, original_prompts, current_prompts, prev_reflections=None, evaluations=None,
                 max_new_tokens=None):
        return self.backend.generate_reflections(
            images, original_prompts, current_prompts, prev_reflections, evaluations, max_new_tokens
        )


def load_reflector(backend: str, **kw) -> Reflector:
    if backend == "fake":
        return FakeReflector()
    if backend == "openai":
        return OpenAIReflector(**kw)
    if backend == "local_qwen":
        raise NotImplementedError(LOCAL_QWEN_NOT_PORTED)
    raise ValueError(f"unknown reflector backend: {backend}")
