"""JSONL writing, as `reflectionflow_tpu/utils/jsonl.py`: one JSON object per
line, UTF-8, non-ASCII kept as is."""

from __future__ import annotations

import json
import os
from typing import Iterable


def write_jsonl(path: str | os.PathLike, rows: Iterable[dict], append: bool = False) -> None:
    os.makedirs(os.path.dirname(str(path)) or ".", exist_ok=True)
    with open(path, "a" if append else "w", encoding="utf-8") as f:
        for row in rows:
            f.write(json.dumps(row, ensure_ascii=False) + "\n")


def append_jsonl(path: str | os.PathLike, row: dict) -> None:
    write_jsonl(path, [row], append=True)
