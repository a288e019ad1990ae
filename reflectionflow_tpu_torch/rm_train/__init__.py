"""The reward-model trainer's checkpoint reader (the trainer is ROADMAP item 22)."""
