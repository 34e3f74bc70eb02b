"""What the apps share: the device to run on."""

from __future__ import annotations

import torch


def app_device(name: str) -> torch.device:
    """The torch device of --device: a CUDA device needs a card (an app does
    not carry on on the CPU without one)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available "
                           f"(--device cpu runs the plain versions)")
    return dev


def sync(dev: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
