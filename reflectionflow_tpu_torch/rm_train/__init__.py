"""The Image-Verifier (reward model) trainer: losses, GSB data and the LoRA step."""

from .losses import convert_A_B_to_chosen_rejected, pairwise_accuracy, reward_loss  # noqa: F401
