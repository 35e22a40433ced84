"""Radix neuron (port of ``repro/core/neuron.py``: ``radix_membrane``, ``radix_fire``).

``radix_membrane`` is the Horner accumulation over time steps
(``acc = (acc << 1) + I_t``, the "<<" block of the paper's Fig. 2);
``radix_fire`` the ReLU + requantize output stage.
"""

from __future__ import annotations

import torch

from repro_torch.core import encoding

__all__ = ["radix_membrane", "radix_fire"]


def radix_membrane(per_step_currents: torch.Tensor) -> torch.Tensor:
    """Horner accumulation over axis 0 (MSB first) -> int32
    ``sum_t I_t * 2^(T-1-t)``."""
    return encoding.decode(per_step_currents)


def radix_fire(acc: torch.Tensor, num_steps: int, requant_mult) -> torch.Tensor:
    """ReLU + requantize a membrane to a level in ``[0, 2^T - 1]``:
    ``clip(floor(f32(acc) * mult), 0, 2^T - 1)`` (floor = hardware truncation)."""
    lvl = encoding.max_level(num_steps)
    mult = torch.as_tensor(requant_mult, dtype=torch.float32, device=acc.device)
    q = torch.floor(acc.to(torch.float32) * mult)
    return torch.clamp(q, 0, lvl).to(
        torch.uint8 if num_steps <= 8 else torch.int32)
