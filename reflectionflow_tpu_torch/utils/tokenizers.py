"""Tokenizer loading with a hermetic fallback.

Copy of `reflectionflow_tpu/utils/tokenizers.py` without the transformers
branch.

Real runs load HF tokenizers from a local snapshot directory (no network).
When no tokenizer files exist (unit tests, synthetic benchmarks) the
`HashTokenizer` provides deterministic ids with the right padding/EOS
contract so every downstream path is exercisable hermetically.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np


@dataclass
class HashTokenizer:
    vocab_size: int = 32128
    pad_token_id: int = 0
    eos_token_id: int = 1
    append_eos: bool = True

    def __call__(self, texts: list[str], max_length: int) -> dict[str, np.ndarray]:
        B = len(texts)
        ids = np.full((B, max_length), self.pad_token_id, dtype=np.int32)
        mask = np.zeros((B, max_length), dtype=np.int32)
        for b, text in enumerate(texts):
            toks = []
            for word in text.lower().split():
                h = int(hashlib.sha1(word.encode()).hexdigest()[:8], 16)
                toks.append(2 + h % (self.vocab_size - 2))
            if self.append_eos:
                toks = toks[: max_length - 1] + [self.eos_token_id]
            else:
                toks = toks[:max_length]
            ids[b, : len(toks)] = toks
            mask[b, : len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def load_tokenizer(path: str | None, kind: str, vocab_size: int, eos_token_id: int):
    """kind: 't5' | 'clip'. A T5 snapshot with `spiece.model` loads the
    pure-python sentencepiece unigram (`utils.spm`); everything else gets the
    HashTokenizer (hermetic tests, synthetic weights). The reference's first
    choice, a transformers fast tokenizer, is not used: the port runs where
    transformers is not installed."""
    if path is not None and kind == "t5":
        import os

        from .spm import SPMTokenizer

        spiece = os.path.join(path, "spiece.model")
        if os.path.exists(spiece):
            return SPMTokenizer(spiece, eos_token_id=eos_token_id)
    return HashTokenizer(vocab_size=vocab_size, eos_token_id=eos_token_id)
