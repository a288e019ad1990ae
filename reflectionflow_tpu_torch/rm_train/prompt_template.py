"""Reward-model prompt templates.

Counterpart of `reflectionflow_tpu/rm_train/prompt_template.py`: the template
types none / simple / video_score / detailed / detailed_special with the
per-dimension descriptions; the image verifier's `detailed_special` ends with
the `<|VQ_reward|>` special token, and the Qwen verifier scores a video clip
with `video_score`."""

from __future__ import annotations

DIMENSION_DESCRIPTIONS = {
    "VQ": "the visual quality of the image: sharpness, lighting, composition, and freedom from artifacts",
    "TA": "how faithfully the image matches the text caption: objects, attributes, counts, and relations",
    "MQ": "the motion quality: coherence and plausibility of any implied or depicted motion",
    "Overall": "the overall quality, weighting caption fidelity and visual quality together",
}

SPECIAL_TOKEN = "<|VQ_reward|>"


def build_prompt(prompt: str, dims: list[str] | None = None, template_type: str = "detailed_special") -> str:
    dims = dims or ["VQ"]
    if template_type == "none":
        return prompt
    if template_type == "simple":
        return f"Rate the quality of the image generated for this caption: {prompt}"
    if template_type == "video_score":
        # one named dimension rated 1.0-5.0 over the clip's frames, given the generation prompt
        d = dims[0]
        return (
            "You are an expert judge of AI-generated videos. Watch the frames "
            f"of the given video and rate its {d} — "
            f"{DIMENSION_DESCRIPTIONS.get(d, d)}. Output one float from 1.0 "
            "(bad) to 5.0 (perfect, indistinguishable from a real video).\n"
            f'The text prompt used for generation is "{prompt}".'
        )
    dim_lines = "\n".join(f"- {d}: {DIMENSION_DESCRIPTIONS.get(d, d)}" for d in dims)
    body = (
        "You are presented with a generated image and its text caption. "
        "Assess the image along the following dimensions:\n"
        f"{dim_lines}\n"
        f"Caption: {prompt}\n"
        "Provide your assessment as a scalar reward."
    )
    if template_type == "detailed":
        return body
    if template_type == "detailed_special":
        return body + SPECIAL_TOKEN
    raise ValueError(f"unknown template_type {template_type}")
