"""Seeded weights, made on the device in a few large calls.

flax's default initializers, as the port's `train/steps.py:init_params`
draws them leaf by leaf on the host: every Dense and Conv kernel
lecun-normal (a normal truncated at ±2σ, rescaled to variance 1/fan_in),
biases 0, BatchNorm scale 1 and bias 0 with running statistics 0 and 1,
PVConv coefficients 1. Here one draw of uniforms on the device, from a
generator seeded with the run's seed, covers every kernel: the inverse of
the truncated normal's distribution function maps them to the same
distribution. The result is a state dict that the program's model and
the reference's model both load.
"""
from __future__ import annotations

import math

import torch

_TRUNC_STD = 0.87962566103423978  # std of the standard normal truncated at ±2


def seeded_state(model: torch.nn.Module, seed: int, device: torch.device) -> dict:
    """A state dict for `model` (its names and shapes): lecun-normal kernels
    from one device draw seeded with `seed`, the rest at flax's defaults."""
    state = {k: v.detach() for k, v in model.state_dict().items()}
    kernels = [k for k, v in state.items() if k.endswith("weight") and v.dim() >= 2]
    total = sum(state[k].numel() for k in kernels)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    u = torch.rand(total, generator=gen, device=device, dtype=torch.float64)
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))  # Φ(-2)
    z = torch.special.ndtri(lo + u * (1.0 - 2.0 * lo)).float()
    out, offset = {}, 0
    for name, value in state.items():
        if name in kernels:
            n = value.numel()
            std = math.sqrt(1.0 / value[0].numel()) / _TRUNC_STD
            out[name] = (z[offset:offset + n] * std).view(value.shape).to(value.dtype)
            offset += n
        elif name.endswith("running_var") or name.endswith("coefficient") or (
                name.endswith("weight") and value.dim() == 1):
            out[name] = torch.ones(value.shape, dtype=value.dtype, device=device)
        elif value.is_floating_point():
            out[name] = torch.zeros(value.shape, dtype=value.dtype, device=device)
        else:
            out[name] = value.to(device)
    return out
