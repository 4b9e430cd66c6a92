"""Device resolution for the port's entry points."""

from __future__ import annotations

import functools

import torch


def resolve(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller says.

    Raises when CUDA is asked for (explicitly or by default) and no card
    is present: nothing moves to the CPU behind the caller's back.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    return dev


def pin(device) -> torch.device:
    """``device`` as a ``torch.device``, a bare ``cuda`` pinned to the
    current card, so that equal devices compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors on CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count
