"""NVILA (VILA family) VLM, the NVILA yes/no verifier's model: `siglip.py`
(the vision tower) and `model.py` (projector, Qwen2 LM glue, first-token
scoring). A released VILA bundle loads through `utils.hf_loader.load_nvila`."""

from .model import NvilaModel, NvilaProjector, Qwen2CausalLM, downsample_tokens, nvila_logits, preprocess_images
from .siglip import SiglipVisionModel, siglip_apply

__all__ = ["NvilaModel", "NvilaProjector", "Qwen2CausalLM", "SiglipVisionModel", "downsample_tokens",
           "nvila_logits", "preprocess_images", "siglip_apply"]
