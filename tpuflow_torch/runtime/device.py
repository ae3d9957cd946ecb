"""Device resolution for the port: CUDA unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """'cuda' / 'cuda:N' / 'cpu' (or a torch.device) -> torch.device.  A CUDA
    request without a visible GPU raises instead of falling back."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "No CUDA device is visible; pass device='cpu' to run the plain "
                "PyTorch versions of the kernels on the CPU."
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"Unsupported device {device!r}: expected 'cuda' or 'cpu'")
    return dev


def device_name(device: torch.device) -> str:
    """The card's name for CUDA devices, 'cpu' otherwise."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"
