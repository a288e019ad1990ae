"""Flow-matching Euler schedule with resolution-dependent dynamic shifting.

Copy of `reflectionflow_tpu/sampler/scheduler.py` (numpy only). Semantics of
diffusers' FlowMatchEulerDiscreteScheduler as the FLUX sampler drives it:
sigmas = linspace(1, 1/n, n), time-shifted by exp(mu) where mu depends on
the image token count, terminal sigma 0, Euler update
x <- x + (sigma_next - sigma) * v.

Everything is precomputed on the host; the denoise loop walks the
(sigma, sigma_next) pairs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def calculate_shift(
    image_seq_len: int,
    base_seq_len: int = 256,
    max_seq_len: int = 4096,
    base_shift: float = 0.5,
    max_shift: float = 1.15,
) -> float:
    """mu for dynamic shifting (linear in token count; FLUX defaults)."""
    m = (max_shift - base_shift) / (max_seq_len - base_seq_len)
    b = base_shift - m * base_seq_len
    return image_seq_len * m + b


def time_shift(mu: float, sigmas: np.ndarray) -> np.ndarray:
    """sigma' = e^mu / (e^mu + (1/sigma - 1))."""
    return np.exp(mu) / (np.exp(mu) + (1.0 / sigmas - 1.0))


@dataclass(frozen=True)
class FlowMatchSchedule:
    sigmas: np.ndarray  # (n+1,) with terminal 0
    timesteps: np.ndarray  # (n,) in [0, 1] — feed to the DiT

    @property
    def num_steps(self) -> int:
        return len(self.timesteps)

    @staticmethod
    def create(num_steps: int, image_seq_len: int, use_dynamic_shifting: bool = True, shift: float = 3.0) -> "FlowMatchSchedule":
        sigmas = np.linspace(1.0, 1.0 / num_steps, num_steps, dtype=np.float64)
        if use_dynamic_shifting:
            mu = calculate_shift(image_seq_len)
            sigmas = time_shift(mu, sigmas)
        else:
            sigmas = shift * sigmas / (1.0 + (shift - 1.0) * sigmas)
        sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
        return FlowMatchSchedule(sigmas=sigmas, timesteps=sigmas[:-1].copy())

    def step_deltas(self) -> np.ndarray:
        """(n,) Euler increments sigma_{i+1} - sigma_i."""
        return self.sigmas[1:] - self.sigmas[:-1]
