"""Device resolution shared by the port's entry points, and the binding of
a rank to its card."""

import os
from typing import Optional, Union

import torch
import torch.distributed as dist


def resolve_device(device: Union[str, torch.device, None] = "cuda") -> torch.device:
    """Resolve `device` ("cuda", "cuda:N", "cpu" or a torch.device).

    A CUDA request with no visible card raises: entry points never drop to
    the CPU on their own, the caller asks for it with `device="cpu"`.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


def bind_card(device) -> Optional[int]:
    """Make this rank's card the current one, so that "cuda" resolves to it:
    `LOCAL_RANK` when the launcher set it (torchrun does), else the world
    rank modulo the cards visible, as torch's DeviceMesh picks. Returns the
    card, or None for the CPU or a device that names its card ("cuda:k"),
    which is used as given."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return None
    local = os.environ.get("LOCAL_RANK")
    card = int(local) if local is not None else dist.get_rank() % torch.cuda.device_count()
    torch.cuda.set_device(card)
    return card
