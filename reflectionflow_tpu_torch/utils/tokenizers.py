"""Tokenizer loading with a hermetic fallback.

Counterpart of `reflectionflow_tpu/utils/tokenizers.py`, whose first choice,
a transformers tokenizer, is replaced by the pure-Python readers of the same
snapshot files: `utils/spm.py` for T5 and `utils/bpe.py` for CLIP.

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
    pure-Python sentencepiece unigram (`utils.spm`), a CLIP one with
    `vocab.json` + `merges.txt` the pure-Python byte-level BPE (`utils.bpe`);
    anything else gets the HashTokenizer (hermetic tests, synthetic weights)."""
    if path is not None:
        import os

        if kind == "t5" and os.path.exists(os.path.join(path, "spiece.model")):
            from .spm import SPMTokenizer

            return SPMTokenizer(os.path.join(path, "spiece.model"), eos_token_id=eos_token_id)
        if kind == "clip" and all(os.path.exists(os.path.join(path, f)) for f in ("vocab.json", "merges.txt")):
            from .bpe import CLIPBPETokenizer

            return CLIPBPETokenizer.from_dir(path)
    return HashTokenizer(vocab_size=vocab_size, eos_token_id=eos_token_id)
