"""Point sampling: furthest point sampling, row gather and random choice,
twin of `rift_tpu/ops/sampling.py`.

The reference's furthest point sampling is a `lax.scan` over the samples,
not a Pallas kernel; here it is the same sequential loop in plain PyTorch,
batched over the leading axes. The squared distance is written out term
by term, (dx·dx + dy·dy) + dz·dz, so that the card and the CPU round it
alike, and the next sample is the first maximum of the running minimum, as
`jnp.argmax` picks it.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def furthest_point_sample(coords: Tensor, num_samples: int,
                          start_idx: Tensor | int = 0) -> Tensor:
    """coords [..., n, 3] -> indices int64 [..., num_samples]: sample k + 1
    is the point farthest from samples 0..k (the first such point on
    ties), sample 0 is `start_idx`. Past n samples the order repeats the
    farthest point of a set whose distances are all 0, which is index 0
    after the first n, as in the reference."""
    batch_shape = coords.shape[:-2]
    n = coords.shape[-2]
    pts = coords.reshape(-1, n, coords.shape[-1])
    b = pts.shape[0]
    last = torch.as_tensor(start_idx, device=coords.device).to(torch.int64)
    last = last.expand(batch_shape).reshape(b).clone()
    min_d2 = torch.full((b, n), float("inf"), dtype=pts.dtype, device=pts.device)
    rows = torch.arange(b, device=pts.device)
    out = torch.empty((b, num_samples), dtype=torch.int64, device=pts.device)
    for k in range(num_samples):
        out[:, k] = last
        d = pts - pts[rows, last][:, None, :]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        min_d2 = torch.minimum(min_d2, d2)
        last = torch.argmax(min_d2, dim=-1)
    return out.reshape(batch_shape + (num_samples,))


def gather(features: Tensor, indices: Tensor) -> Tensor:
    """features [..., n, c], indices int [..., m] -> rows [..., m, c]."""
    idx = indices.to(torch.int64)
    return torch.gather(features, -2, idx[..., None].expand(idx.shape + (features.shape[-1],)))


def random_choice(generator: torch.Generator, n: int, num_samples: int) -> Tensor:
    """`num_samples` indices of range(n) drawn from `generator`: without
    replacement when n >= num_samples, with replacement otherwise (the
    reference's rule; its draws come from a JAX key, these from a torch
    generator, so the two streams differ)."""
    device = generator.device
    if n >= num_samples:
        return torch.randperm(n, generator=generator, device=device)[:num_samples]
    return torch.randint(0, n, (num_samples,), generator=generator, device=device)
