"""Search-state bookkeeping: candidate chains across rounds and the resume
manifest.

Counterpart of `reflectionflow_tpu/search/state.py`, with the same
`search_state.json`. Round 1 starts one chain per candidate; later rounds
append each new image to the chain that holds its parent (the top-k image it
was conditioned on). Best per chain and the global best follow the
verifier's ranking rule. `SearchManifest` is saved after every round, so a
killed run resumes at the round after the last one completed.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

from ..verifiers.base import RankingRule


@dataclass
class Chains:
    rule: RankingRule
    # chain key -> {"images": [...], "outputs": [...]}
    chains: dict[str, dict] = field(default_factory=dict)

    def init_round(self, image_names: list[str], outputs: list[dict]) -> None:
        for name, out in zip(image_names, outputs):
            entry = self.chains.setdefault(name, {"images": [], "outputs": []})
            entry["images"].append(name)
            entry["outputs"].append(out)

    def update(self, parent_names: list[str], image_names: list[str], outputs: list[dict]) -> None:
        """Append each new image to the (first) chain containing its parent."""
        for parent, name, out in zip(parent_names, image_names, outputs):
            for entry in self.chains.values():
                if parent in entry["images"]:
                    entry["images"].append(name)
                    entry["outputs"].append(out)
                    break
            else:
                # an unknown parent starts a new chain
                self.chains[name] = {"images": [name], "outputs": [out]}

    def best_per_chain(self) -> list[str]:
        best = []
        for entry in self.chains.values():
            idx = min(range(len(entry["outputs"])), key=lambda i: self.rule.key(entry["outputs"][i]))
            best.append(entry["images"][idx])
        return best

    def global_best(self) -> tuple[str, dict]:
        flat = [
            (img, out)
            for entry in self.chains.values()
            for img, out in zip(entry["images"], entry["outputs"])
        ]
        img, out = min(flat, key=lambda t: self.rule.key(t[1]))
        return img, out

    # -- resume -------------------------------------------------------------

    def to_json(self) -> dict:
        return {"chains": self.chains, "rule": {"kind": self.rule.kind, "choice_of_metric": self.rule.choice_of_metric}}

    @classmethod
    def from_json(cls, data: dict) -> "Chains":
        rule = RankingRule(**data["rule"])
        return cls(rule=rule, chains=data["chains"])


@dataclass
class SearchManifest:
    """Per-prompt resumable state, saved after every round."""

    prompt_index: int
    original_prompt: str
    round_done: int = 0
    updated_prompts: list[str] = field(default_factory=list)
    reflections: list[str] = field(default_factory=list)
    chains: dict = field(default_factory=dict)
    tag: str | None = None

    @staticmethod
    def path(root_dir: str) -> str:
        return os.path.join(root_dir, "search_state.json")

    def save(self, root_dir: str) -> None:
        with open(self.path(root_dir), "w") as f:
            json.dump(self.__dict__, f)

    @classmethod
    def load(cls, root_dir: str) -> "SearchManifest | None":
        p = cls.path(root_dir)
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return cls(**json.load(f))
