"""Verifier interface and ranking rules.

Counterpart of `reflectionflow_tpu/verifiers/base.py`. A verifier maps
(images, prompts) to one score dict per image, always in input order. Two
ranking conventions exist and both are kept:
  * score-based (openai / reward model): a higher `choice_of_metric` wins;
  * nvila yes/no: "yes" images first (higher yes-logit first), then "no"
    images (lower no-logit first).
Ranking keys are "smaller sorts first" tuples, so one code path serves both.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Sequence

import numpy as np


class Verifier(abc.ABC):
    """Scores images against a prompt. Results are in input order."""

    name: str = "base"
    # which RankingRule convention this verifier's outputs follow
    output_kind: str = "score"  # "score" | "yes_no"

    @abc.abstractmethod
    def score(
        self,
        images: Sequence[np.ndarray],  # each (H, W, 3) uint8
        prompts: Sequence[str],
        tag: str | None = None,
        max_new_tokens: int | None = None,
    ) -> list[dict]:
        ...


@dataclass(frozen=True)
class RankingRule:
    """Turns a verifier output dict into a sortable key (smaller = better)."""

    kind: str = "score"  # "score" | "yes_no"
    choice_of_metric: str = "overall_score"

    def metric_value(self, output: dict) -> float:
        x = output[self.choice_of_metric]
        if isinstance(x, dict):
            return float(x["score"])
        return float(x)

    def key(self, output: dict):
        if self.kind == "yes_no":
            if output["label"] == "yes":
                return (0, -float(output["score"]))
            return (1, float(output["score"]))
        return (-self.metric_value(output),)


def select_topk(outputs: list[dict], k: int, rule: RankingRule) -> list[int]:
    """Indices of the top-k outputs (best first), repeated with wraparound
    when k exceeds the candidate count."""
    if not outputs:
        raise ValueError("select_topk: empty candidate list (missing previous-round images?)")
    order = sorted(range(len(outputs)), key=lambda i: rule.key(outputs[i]))
    picked = order[:k]
    while len(picked) < k:
        picked = picked + picked[: k - len(picked)]
    return picked[:k]
