"""Training-time diffusion timestep samplers (port of
vibevoice_tpu/schedule/timestep_sampler.py).

The reference defines them and never imports them: training draws its
timesteps uniformly (finetune/loss.py), as in the JAX package. They are
public surface; each draws from an explicit ``torch.Generator``, so its
numbers are torch's, not JAX's.
"""

from __future__ import annotations

from typing import Sequence

import torch


class UniformSampler:
    """Uniform over [0, num_timesteps), int32 (JAX's randint dtype)."""

    def __init__(self, num_timesteps: int):
        self.num_timesteps = num_timesteps

    def sample(self, generator: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
        return torch.randint(0, self.num_timesteps, tuple(shape), generator=generator,
                             device=generator.device, dtype=torch.int32)


class LogitNormalSampler:
    """Logit-normal over the unit interval, discretised to timesteps, int32
    (weights mid-schedule steps more heavily; arXiv 2403.03206 §3.1)."""

    def __init__(self, num_timesteps: int, loc: float = 0.0, scale: float = 1.0):
        self.num_timesteps = num_timesteps
        self.loc = loc
        self.scale = scale

    def sample(self, generator: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
        z = self.loc + self.scale * torch.randn(tuple(shape), generator=generator,
                                                device=generator.device)
        u = torch.sigmoid(z)
        return (u * self.num_timesteps).to(torch.int32).clamp(0, self.num_timesteps - 1)
