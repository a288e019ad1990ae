"""Verifiers of the port: the fake ones, the OpenAI-compatible backend, the
colocated Qwen2.5-VL reward model (`qwen_rm` / `image_verifier`) and the
native NVILA yes/no verifiers (`nvila`, `nvila_jax`)."""

from .base import RankingRule, Verifier, select_topk  # noqa: F401
from .fake import FakeNvilaVerifier, FakeVerifier  # noqa: F401


def load_verifier(name: str, **kw) -> Verifier:
    """Factory mirroring the JAX package's verifier dispatch."""
    if name == "fake":
        return FakeVerifier(**kw)
    if name == "fake_nvila":
        return FakeNvilaVerifier(**kw)
    if name == "openai":
        from .openai_backend import OpenAICompatVerifier

        return OpenAICompatVerifier(**kw)
    if name in ("qwen_rm", "image_verifier"):
        from .qwen_verifier import QwenRewardVerifier

        return QwenRewardVerifier(**kw)
    if name == "nvila":
        from .nvila import NvilaVerifier

        return NvilaVerifier(**kw)
    if name == "nvila_jax":
        from .nvila import NvilaJaxVerifier

        return NvilaJaxVerifier(**kw)
    raise ValueError(f"unknown verifier: {name}")
