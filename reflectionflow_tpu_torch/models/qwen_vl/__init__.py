"""Qwen2.5-VL: the LM, the vision tower, the combined model, the reward head
and the reflection generator."""


def load_generator(model_path: str | None, **kw):
    from .generate import QwenVLGenerator

    return QwenVLGenerator.from_pretrained(model_path, **kw)
