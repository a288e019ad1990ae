"""JSONL IO, as `reflectionflow_tpu/utils/jsonl.py`: one JSON object per
line, UTF-8, non-ASCII kept as is; and the best-effort JSON recovery the
OpenAI-compatible backend applies to model replies."""

from __future__ import annotations

import json
import os
from typing import Any, Iterable, Iterator


def read_jsonl(path: str | os.PathLike) -> list[dict]:
    return list(iter_jsonl(path))


def iter_jsonl(path: str | os.PathLike) -> Iterator[dict]:
    """The rows of `path` one at a time (blank lines skipped)."""
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


def write_jsonl(path: str | os.PathLike, rows: Iterable[dict], append: bool = False) -> None:
    os.makedirs(os.path.dirname(str(path)) or ".", exist_ok=True)
    with open(path, "a" if append else "w", encoding="utf-8") as f:
        for row in rows:
            f.write(json.dumps(row, ensure_ascii=False) + "\n")


def append_jsonl(path: str | os.PathLike, row: dict) -> None:
    write_jsonl(path, [row], append=True)


def recover_json_from_text(text: str) -> Any:
    """Best-effort JSON extraction from LLM output (code fences, prefix text):
    the whole string, then each fenced chunk, then the largest {...} / [...]
    span."""
    text = text.strip()
    for candidate in _json_candidates(text):
        try:
            return json.loads(candidate)
        except (json.JSONDecodeError, ValueError):
            continue
    raise ValueError(f"no JSON object found in: {text[:200]!r}")


def _json_candidates(text: str):
    yield text
    if "```" in text:
        for chunk in text.split("```"):
            chunk = chunk.strip()
            if chunk.startswith("json"):
                chunk = chunk[4:].strip()
            yield chunk
    for open_c, close_c in (("{", "}"), ("[", "]")):
        start, end = text.find(open_c), text.rfind(close_c)
        if 0 <= start < end:
            yield text[start : end + 1]
