"""Where the port runs: the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device (``cuda`` with its index filled in);
    asking for CUDA without a GPU raises (the port never falls back to the
    CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
