"""Reflection-output parsing.

Counterpart of `reflectionflow_tpu/reflect/parsing.py`: finetuned reflection
models emit numbered, bulleted sections ("1. Missing objects:\n- ..."); these
helpers turn that into a dict per section, or into one flat instruction
string with "None" sections dropped (the form appended to the FLUX prompt).
"""

from __future__ import annotations


def parse_reflection_sections(reflection: str) -> dict[str, list[str]]:
    """'1. Title:  content\n- item' blocks -> {title: [items]}."""
    result: dict[str, list[str]] = {}
    for section in reflection.split("\n\n"):
        if ":" not in section:
            continue
        title, content = section.split(":", 1)
        if "." in title:
            title = title.split(".", 1)[1]
        title = title.strip()
        if not title:
            continue
        items = [item.strip() for item in content.split("\n-") if item.strip()]
        result[title] = items
    return result


def flatten_reflection(reflection: str) -> str:
    """Concatenate all section items, skipping sections whose items contain
    'None' (nothing to fix): the string fed to the FLUX prompt."""
    parts: list[str] = []
    for items in parse_reflection_sections(reflection).values():
        if any("None" in item for item in items):
            continue
        parts.append(" ".join(items))
    return "".join(parts) if parts else reflection.strip()


def flatten_reflections(reflections: list[str]) -> list[str]:
    return [flatten_reflection(r) for r in reflections]
