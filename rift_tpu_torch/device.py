"""The device rule of every entry point: `None` means the CUDA card."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """`device=None` -> `cuda`, raising when no CUDA device is present.

    There is no silent fallback to the CPU: a caller who wants the plain
    PyTorch path asks for it with `device="cpu"`.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "rift_tpu_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch path")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


def nvidia_smi() -> str | None:
    """The first card's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` gives them (e.g.
    'NVIDIA H100 80GB HBM3, 700.00 W'), or None where nvidia-smi is not
    there or reports no card."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out[0].strip() if out else None
