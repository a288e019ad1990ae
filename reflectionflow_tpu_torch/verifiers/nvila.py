"""NVILA yes/no verifiers.

Counterpart of `reflectionflow_tpu/verifiers/nvila.py`. The model answers
yes/no to "does this image match the prompt", and ranking puts the yes answers
first (higher yes-logit first), then the no answers (lower no-logit first):
`output_kind = "yes_no"`. Both names serve the port's native NVILA model
(`models/nvila/`), candidates scored as one batch:
  * `nvila_jax`: a VILA bundle directory (`model_path`); the label is the
    greedy first token, and a first token that is neither "yes" nor "no"
    compares the two logits;
  * `nvila`: the hub name `model_name`, resolved to its local snapshot under
    `cache_dir` (never fetched); the reference's label rule, "yes" only when
    the greedy answer is "yes". The reference decodes a whole answer through
    `trust_remote_code`; the port reads the first token (ROADMAP queue 3).
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from .base import Verifier

DEFAULT_MODEL = "Efficient-Large-Model/NVILA-Lite-2B-Verifier"


def resolve_snapshot(model_name: str, cache_dir: str | None = None) -> str:
    """A local directory as it is; a hub name to its snapshot in the hub cache
    layout `models--{org}--{name}/snapshots/<rev>/` (the revision `refs/main`
    names, else the newest snapshot) under `cache_dir`, else $HF_HUB_CACHE,
    else $HF_HOME/hub, else ~/.cache/huggingface/hub (the hub library's
    order). Raises FileNotFoundError when there is none: nothing is
    downloaded."""
    if os.path.isdir(model_name):
        return model_name
    cache = cache_dir or os.environ.get("HF_HUB_CACHE") or os.path.join(
        os.environ.get("HF_HOME") or os.path.expanduser("~/.cache/huggingface"), "hub")
    repo = os.path.join(cache, "models--" + model_name.replace("/", "--"))
    snapshots = os.path.join(repo, "snapshots")
    ref = os.path.join(repo, "refs", "main")
    if os.path.exists(ref):
        with open(ref) as f:
            path = os.path.join(snapshots, f.read().strip())
        if os.path.isdir(path):
            return path
    revs = sorted((os.path.join(snapshots, r) for r in os.listdir(snapshots)) if os.path.isdir(snapshots) else (),
                  key=os.path.getmtime)
    if not revs:
        raise FileNotFoundError(f"no local snapshot of {model_name!r} under {repo} (the port never downloads; "
                                "place the VILA bundle there or pass its directory)")
    return revs[-1]


class NvilaJaxVerifier(Verifier):
    """The native NVILA verifier: tower + projector + Qwen2 LM, one batch per
    call. Output per image: {"label": "yes" | "no", "score": that label's logit}."""

    name = "nvila_jax"
    output_kind = "yes_no"

    def __init__(self, model=None, model_path: str | None = None, quantize: str | None = None,
                 quantize_min_size: int = 1 << 18, device_index: int | None = None,
                 device: str | torch.device | None = None, tokenizer=None, **_):
        """Either `model_path` (a VILA bundle, loaded on `device`, default cuda,
        or on `cuda:<device_index>`) or a built `NvilaModel` (scored where it
        lies). `quantize="int8"` puts the LM's and the tower's block linears on
        W8A8 in place, each whose weight stacked over the blocks has at least
        `quantize_min_size` elements."""
        from ..utils.device import on_device, placement, quantize_blocks

        if model is None and model_path is None:
            raise ValueError(f"{self.name} needs model_path (a VILA bundle dir) or a NvilaModel")
        dev = placement(device, device_index) if model is None else model.device
        with on_device(dev.index if dev.type == "cuda" else None):
            if model is None:
                from ..utils.hf_loader import load_nvila

                model = load_nvila(model_path, device=dev)
            if quantize == "int8":
                quantize_blocks(model.llm.model.layers, quantize_min_size)
                quantize_blocks(model.vision_tower.vision_model.encoder.layers, quantize_min_size)
        if tokenizer is not None:
            model.tokenizer = tokenizer
        if model.tokenizer is None:
            raise ValueError(f"{self.name} needs the bundle's llm/ tokenizer files or a tokenizer")
        self.model = model
        self.yes_id = model.tokenizer.encode("yes", add_special_tokens=False)[0]
        self.no_id = model.tokenizer.encode("no", add_special_tokens=False)[0]

    def _is_yes(self, first: int, logits: np.ndarray) -> bool:
        return first == self.yes_id or (first != self.no_id and logits[self.yes_id] >= logits[self.no_id])

    def score(self, images: Sequence[np.ndarray], prompts: Sequence[str], tag=None, max_new_tokens=None):
        logits = self.model.first_token_logits(images, prompts)  # (B, vocab)
        first = np.argmax(logits, axis=-1)
        outputs = []
        for i in range(len(images)):
            yes = self._is_yes(int(first[i]), logits[i])
            outputs.append({"label": "yes" if yes else "no",
                            "score": float(logits[i, self.yes_id if yes else self.no_id])})
        return outputs


class NvilaVerifier(NvilaJaxVerifier):
    """The reference's `nvila` verifier on the native model: the hub snapshot of
    `model_name` from the local cache, "yes" only when the greedy first token is
    "yes", else "no" with the no-logit."""

    name = "nvila"

    def __init__(self, model_name: str = DEFAULT_MODEL, cache_dir: str | None = None, **kw):
        super().__init__(model_path=resolve_snapshot(model_name, cache_dir), **kw)

    def _is_yes(self, first: int, logits: np.ndarray) -> bool:
        return first == self.yes_id
