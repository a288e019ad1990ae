"""Reflection generators.

Counterpart of `reflectionflow_tpu/reflect/generator.py`:
  * `openai`: any OpenAI-compatible endpoint (a local server included);
  * `local_qwen`: the colocated Qwen2.5-VL generator (`models.qwen_vl`);
  * `fake`: deterministic strings for hermetic tests.

Every backend keeps input order and never drops an entry (a failed request
gives an empty reflection, not a shorter list).
"""

from __future__ import annotations

import abc
import hashlib
from typing import Sequence

import numpy as np

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


# The default user message: the reference's local-reflection message shape,
# one image and a text naming the prompt. A finetuned Reflection-Generator has
# a training-time input format: pass `template` / `system` (config:
# reflection_args.template / system_prompt). Fields: {original_prompt}
# {current_prompt} {prev_reflection} {evaluation}.
DEFAULT_TEMPLATE = (
    'Generate reflections to improve the input image according to the prompt. '
    'The prompt is: "{original_prompt}"'
)
DEFAULT_SYSTEM = "You are a helpful assistant."


class LocalQwenReflector(Reflector):
    """The colocated Qwen2.5-VL reflection generator: one batched decode of a
    round's candidates (`models.qwen_vl.generate.QwenVLGenerator`)."""

    def __init__(self, model, max_new_tokens: int = 256, template: str | None = None,
                 system: str | None = None):
        self.model = model  # models.qwen_vl.generate.QwenVLGenerator
        self.max_new_tokens = max_new_tokens
        self.template = template or DEFAULT_TEMPLATE
        self.system = DEFAULT_SYSTEM if system is None else system
        self.template.format(**self._fields("p", "p", "", ""))  # unknown {fields} raise here, not mid-round

    @staticmethod
    def _fields(orig, cur, refl, ev):
        return {"original_prompt": orig, "current_prompt": cur, "prev_reflection": refl or "",
                "evaluation": ev or ""}

    def generate(self, images, original_prompts, current_prompts, prev_reflections=None, evaluations=None,
                 max_new_tokens=None):
        n = len(original_prompts)
        prev_reflections = prev_reflections or [""] * n
        evaluations = evaluations or [""] * n
        for name, seq in (("images", images), ("current_prompts", current_prompts),
                          ("prev_reflections", prev_reflections), ("evaluations", evaluations)):
            if len(seq) != n:  # zip would truncate the batch
                raise ValueError(f"{name} has {len(seq)} entries, expected {n}")
        prompts = [self.template.format(**self._fields(orig, cur, refl, ev))
                   for orig, cur, refl, ev in zip(original_prompts, current_prompts, prev_reflections, evaluations)]
        return self.model.generate(images=list(images), prompts=prompts,
                                   max_new_tokens=max_new_tokens or self.max_new_tokens,
                                   system=self.system or None)


def load_reflector(backend: str, **kw) -> Reflector:
    if backend == "fake":
        return FakeReflector()
    if backend == "openai":
        return OpenAIReflector(**kw)
    if backend == "local_qwen":
        return LocalQwenReflector(**kw)
    raise ValueError(f"unknown reflector backend: {backend}")
