"""Verifiers of the port: the fake ones, the OpenAI-compatible backend and the
colocated Qwen2.5-VL reward model (`qwen_rm` / `image_verifier`).

The NVILA verifiers (`nvila`, `nvila_jax`) are the next slice (ROADMAP queue
1, slice 4b's rest): asking for one raises `NotImplementedError`, never a
silent fallback."""

from .base import RankingRule, Verifier, select_topk  # noqa: F401
from .fake import FakeNvilaVerifier, FakeVerifier  # noqa: F401

NVILA_NOT_PORTED = (
    "the NVILA verifier models are ROADMAP slice 4b's rest (item 17); the port serves "
    "verifier_args.name 'fake', 'fake_nvila', 'openai' and 'qwen_rm' / 'image_verifier'")


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
    if name in ("nvila", "nvila_jax"):
        raise NotImplementedError(f"verifier {name!r}: {NVILA_NOT_PORTED}")
    raise ValueError(f"unknown verifier: {name}")
