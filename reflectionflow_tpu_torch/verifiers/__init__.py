"""Verifiers of the port: the fake ones and the OpenAI-compatible backend.

The model verifiers (`qwen_rm` / `image_verifier`, `nvila`, `nvila_jax`)
need the Qwen2.5-VL and NVILA models, ROADMAP slice 4b, item 17: asking for
one raises `NotImplementedError`, never a silent fallback."""

from .base import RankingRule, Verifier, select_topk  # noqa: F401
from .fake import FakeNvilaVerifier, FakeVerifier  # noqa: F401

MODEL_VERIFIERS_NOT_PORTED = (
    "the Qwen2.5-VL / NVILA verifier models are ROADMAP slice 4b, item 17; the port serves "
    "verifier_args.name 'fake', 'fake_nvila' and 'openai'")


def load_verifier(name: str, **kw) -> Verifier:
    """Factory mirroring the JAX package's verifier dispatch."""
    if name == "fake":
        return FakeVerifier(**kw)
    if name == "fake_nvila":
        return FakeNvilaVerifier(**kw)
    if name == "openai":
        from .openai_backend import OpenAICompatVerifier

        return OpenAICompatVerifier(**kw)
    if name in ("qwen_rm", "image_verifier", "nvila", "nvila_jax"):
        raise NotImplementedError(f"verifier {name!r}: {MODEL_VERIFIERS_NOT_PORTED}")
    raise ValueError(f"unknown verifier: {name}")
