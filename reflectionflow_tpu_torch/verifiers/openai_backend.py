"""OpenAI-compatible HTTP verifier / refiner / reflector backend.

Counterpart of `reflectionflow_tpu/verifiers/openai_backend.py`, with the
same request payloads, retry loop and order-preserving thread map: results
come back in input order, and a failed request yields a -inf-score sentinel
(a score) or the unchanged input (a refinement, a reflection) instead of a
shorter list. Plain `urllib`, structured outputs through the
`response_format` json_schema parameter with the schemas of `schemas.py`.

One difference: images go into the data URL as PNG bytes from the port's own
writer (`search/artifacts.encode_png`), which differ from PIL's bytes for the
same pixels.
"""

from __future__ import annotations

import base64
import concurrent.futures as cf
import json
import os
import time
import urllib.request

import numpy as np

from ..search.artifacts import encode_png
from ..utils.jsonl import recover_json_from_text
from .base import Verifier
from .prompts import load_prompt
from .schemas import schema_for_tag


def _img_to_data_url(img: np.ndarray) -> str:
    return "data:image/png;base64," + base64.b64encode(encode_png(img)).decode()


class OpenAICompatVerifier(Verifier):
    name = "openai"

    def __init__(
        self,
        model_name: str = "gpt-4o-2024-11-20",
        base_url: str | None = None,
        api_key: str | None = None,
        max_workers: int = 4,
        max_retries: int = 5,
        retry_delay_s: float = 2.0,
        seed: int = 1994,
        verifier_prompt: str = "verifier_prompt.txt",
        geneval_prompts: str = "geneval_detailed_verifier_prompt.json",
        refine_prompt: str = "refine_prompt.txt",
        reflexion_prompt: str = "reflexion_prompt.txt",
        **_,
    ):
        self.model_name = model_name
        self.base_url = (base_url or os.environ.get("OPENAI_BASE_URL", "https://api.openai.com/v1")).rstrip("/")
        self.api_key = api_key or os.environ.get("API_KEY") or os.environ.get("OPENAI_API_KEY", "")
        self.max_workers = max_workers
        self.max_retries = max_retries
        self.retry_delay_s = retry_delay_s
        self.seed = seed
        self.system_prompt = load_prompt(verifier_prompt)
        self.tag_prompts = json.loads(load_prompt(geneval_prompts))
        self.refine_system = load_prompt(refine_prompt)
        self.reflexion_system = load_prompt(reflexion_prompt)

    # -- low-level ----------------------------------------------------------

    def _post(self, payload: dict) -> dict:
        req = urllib.request.Request(
            f"{self.base_url}/chat/completions",
            data=json.dumps(payload).encode(),
            headers={
                "Content-Type": "application/json",
                "Authorization": f"Bearer {self.api_key}",
            },
        )
        with urllib.request.urlopen(req, timeout=120) as resp:
            return json.loads(resp.read())

    def _chat(self, messages: list[dict], schema=None, max_new_tokens=None) -> str:
        payload: dict = {"model": self.model_name, "messages": messages, "seed": self.seed}
        if max_new_tokens:
            payload["max_tokens"] = max_new_tokens
        if schema is not None:
            payload["response_format"] = {
                "type": "json_schema",
                "json_schema": {"name": schema.__name__, "schema": schema.model_json_schema()},
            }
        last_err = None
        for attempt in range(self.max_retries):
            try:
                out = self._post(payload)
                return out["choices"][0]["message"]["content"]
            except Exception as e:  # noqa: BLE001 — network retry loop
                last_err = e
                time.sleep(self.retry_delay_s * (1 + attempt))
        raise RuntimeError(f"chat request failed after {self.max_retries} retries: {last_err}")

    def _map_ordered(self, fn, items):
        """Concurrent map that keeps input order and replaces failures with
        None (callers substitute sentinels)."""
        with cf.ThreadPoolExecutor(max_workers=min(self.max_workers, max(1, len(items)))) as ex:
            futures = [ex.submit(fn, it) for it in items]
            results = []
            for fut in futures:  # in submission order, not completion order
                try:
                    results.append(fut.result())
                except Exception as e:  # noqa: BLE001 — one failed request must not drop the batch
                    print(f"[openai_backend] request failed: {e}")
                    results.append(None)
        return results

    # -- verifier -----------------------------------------------------------

    def score(self, images, prompts, tag=None, max_new_tokens=None):
        schema = schema_for_tag(tag)
        system = self.tag_prompts.get(tag, self.system_prompt) if tag else self.system_prompt

        def one(args):
            img, prompt = args
            messages = [
                {"role": "system", "content": system},
                {
                    "role": "user",
                    "content": [
                        {"type": "text", "text": prompt},
                        {"type": "image_url", "image_url": {"url": _img_to_data_url(img)}},
                    ],
                },
            ]
            text = self._chat(messages, schema=schema, max_new_tokens=max_new_tokens)
            return schema.model_validate(recover_json_from_text(text)).model_dump()

        results = self._map_ordered(one, list(zip(images, prompts)))
        sentinel = {a: {"score": float("-inf"), "explanation": "request failed"} for a in schema.field_names()}
        return [r if r is not None else dict(sentinel) for r in results]

    # -- refiner ------------------------------------------------------------

    def refine_prompt(self, images, original_prompts, current_prompts, reflections=None, evaluations=None,
                      max_new_tokens=None) -> list[str]:
        def one(args):
            img, orig, cur, refl, ev = args
            user: list = [{"type": "text", "text": f"Original prompt: {orig}\nCurrent prompt: {cur}"}]
            if refl:
                user.append({"type": "text", "text": f"Reflection: {refl}"})
            if ev:
                user.append({"type": "text", "text": f"Evaluation: {ev}"})
            user.append({"type": "image_url", "image_url": {"url": _img_to_data_url(img)}})
            messages = [{"role": "system", "content": self.refine_system}, {"role": "user", "content": user}]
            return self._chat(messages, max_new_tokens=max_new_tokens).strip()

        items = [
            (img, o, c, (reflections or [None] * len(images))[i], (evaluations or [None] * len(images))[i])
            for i, (img, o, c) in enumerate(zip(images, original_prompts, current_prompts))
        ]
        results = self._map_ordered(one, items)
        return [r if r is not None else c for r, c in zip(results, current_prompts)]

    # -- reflector ----------------------------------------------------------

    def generate_reflections(self, images, original_prompts, current_prompts, prev_reflections=None,
                             evaluations=None, max_new_tokens=None) -> list[str]:
        def one(args):
            img, orig, cur, refl, ev = args
            user: list = [
                {"type": "text", "text": f"Original prompt: {orig}\nCurrent prompt: {cur}"},
            ]
            if refl:
                user.append({"type": "text", "text": f"Previous reflection: {refl}"})
            if ev:
                user.append({"type": "text", "text": f"Evaluation: {ev}"})
            user.append({"type": "image_url", "image_url": {"url": _img_to_data_url(img)}})
            messages = [{"role": "system", "content": self.reflexion_system}, {"role": "user", "content": user}]
            return self._chat(messages, max_new_tokens=max_new_tokens).strip()

        items = [
            (img, o, c, (prev_reflections or [None] * len(images))[i], (evaluations or [None] * len(images))[i])
            for i, (img, o, c) in enumerate(zip(images, original_prompts, current_prompts))
        ]
        results = self._map_ordered(one, items)
        return [r if r is not None else "" for r in results]
