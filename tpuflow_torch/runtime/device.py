"""Device resolution for the port: CUDA unless the caller asks for the CPU.

`DeviceManager` is the JAX package's (tpuflow/runtime/device.py) on torch:
'auto' and 'cuda' mean the card and raise without one (the JAX version
falls back to the CPU with a warning), 'cpu' means the CPU, and 'tpu' is
refused."""

from __future__ import annotations

from typing import Dict, List, Optional

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


class DeviceManager:
    """Resolve and describe compute devices (the reference's
    config/device_manager.py contract)."""

    @staticmethod
    def get_device(requested: str = "auto") -> torch.device:
        requested = (requested or "auto").lower()
        if requested == "tpu":
            raise ValueError("device 'tpu': this package runs on CUDA cards or the CPU ('auto', 'cuda', 'cpu')")
        return resolve_device("cuda" if requested == "auto" else requested)

    @staticmethod
    def devices(platform: Optional[str] = None) -> List[torch.device]:
        """The devices of a platform: 'cpu' the CPU; anything else the
        visible cards, or the CPU where there is none (as jax.devices()
        falls back to the default backend's)."""
        n = torch.cuda.device_count() if platform != "cpu" else 0
        return [torch.device("cuda", i) for i in range(n)] or [torch.device("cpu")]

    @staticmethod
    def get_device_info(requested: str = "auto") -> Dict:
        dev = DeviceManager.get_device(requested)
        if dev.type == "cpu":
            return {"device": "cpu", "device_count": 1, "devices": ["cpu"]}
        n = torch.cuda.device_count()
        memory = []
        for i in range(n):
            free, total = torch.cuda.mem_get_info(i)
            memory.append({"bytes_in_use": total - free, "bytes_limit": total})
        return {
            "device": "cuda",
            "device_count": n,
            "devices": [f"cuda:{i} {torch.cuda.get_device_name(i)}" for i in range(n)],
            "memory": memory,
        }

    @staticmethod
    def print_device_info(requested: str = "auto") -> None:
        info = DeviceManager.get_device_info(requested)
        print(f"Device: {info['device']} x{info['device_count']}")
        for d in info["devices"]:
            print(f"  {d}")
        for m in info.get("memory", []):
            used = m["bytes_in_use"] / 1024**2
            limit = m["bytes_limit"] / 1024**2
            print(f"  memory: {used:.0f} / {limit:.0f} MB")
