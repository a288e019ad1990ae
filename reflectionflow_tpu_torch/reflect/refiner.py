"""Prompt refiners, as `reflectionflow_tpu/reflect/refiner.py`: the fake one
for tests and the OpenAI-compatible one."""

from __future__ import annotations

import abc
from typing import Sequence

import numpy as np


class Refiner(abc.ABC):
    @abc.abstractmethod
    def refine(
        self,
        images: Sequence[np.ndarray],
        original_prompts: Sequence[str],
        current_prompts: Sequence[str],
        reflections: Sequence[str] | None = None,
        evaluations: Sequence[str] | None = None,
        max_new_tokens: int | None = None,
    ) -> list[str]:
        ...


class FakeRefiner(Refiner):
    """Deterministic, idempotent refinement for tests."""

    def refine(self, images, original_prompts, current_prompts, reflections=None, evaluations=None,
               max_new_tokens=None):
        out = []
        for orig, cur in zip(original_prompts, current_prompts):
            refined = cur if cur.startswith(orig) else orig
            if "highly detailed" not in refined:
                refined = f"{refined}, highly detailed"
            out.append(refined)
        return out


class OpenAIRefiner(Refiner):
    def __init__(self, **kw):
        from ..verifiers.openai_backend import OpenAICompatVerifier

        self.backend = OpenAICompatVerifier(**kw)

    def refine(self, images, original_prompts, current_prompts, reflections=None, evaluations=None,
               max_new_tokens=None):
        return self.backend.refine_prompt(
            images, original_prompts, current_prompts, reflections, evaluations, max_new_tokens
        )


def load_refiner(backend: str, **kw) -> Refiner:
    if backend == "fake":
        return FakeRefiner()
    if backend == "openai":
        return OpenAIRefiner(**kw)
    raise ValueError(f"unknown refiner backend: {backend}")
