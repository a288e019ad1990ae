"""Prompt asset loader, as `reflectionflow_tpu/verifiers/prompts`. The assets
are this package's own copies and live next to this file; a user override may
be given as an absolute path."""

import os

_DIR = os.path.dirname(__file__)


def load_prompt(name_or_path: str) -> str:
    path = name_or_path if os.path.isabs(name_or_path) else os.path.join(_DIR, name_or_path)
    with open(path, "r", encoding="utf-8") as f:
        return f.read()
