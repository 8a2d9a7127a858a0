"""Device resolution for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU. Asking for
(or defaulting to) ``cuda`` on a host without a usable GPU raises: the port
never drops to the CPU on its own.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``. Returns a ``torch.device``; raises
    RuntimeError when a CUDA device is asked for and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (--device cpu) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def card_name_and_power() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them (first card), the
    label every number measured on it is kept beside."""
    import subprocess

    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    )
    return proc.stdout.strip().splitlines()[0]
