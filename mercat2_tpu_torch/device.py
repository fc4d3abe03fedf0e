"""Device selection. Nothing picks a device silently: callers name one."""

from __future__ import annotations

import torch

__all__ = ["NoCudaError", "require_cuda", "resolve_device"]


class NoCudaError(RuntimeError):
    """A CUDA device was asked for and there is none."""


def require_cuda() -> torch.device:
    """The CUDA device, or :class:`NoCudaError` when there is none.

    The port has no CPU fallback for its kernels: a run that asks for the
    card and finds none stops here rather than counting on the host.
    """
    if not torch.cuda.is_available():
        raise NoCudaError(
            "mercat2_tpu_torch needs a CUDA device, but "
            "torch.cuda.is_available() is False (no GPU, or PyTorch built "
            "without CUDA). Pass device='cpu' explicitly to run the plain "
            "PyTorch path."
        )
    return torch.device("cuda")


def resolve_device(name: str | torch.device) -> torch.device:
    """``torch.device(name)``; a CUDA name must find a card."""
    dev = torch.device(name)
    if dev.type == "cuda":
        require_cuda()
    return dev
