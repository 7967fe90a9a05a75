"""Device resolution for the port's entry points."""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device="cuda") -> torch.device:
    """Entry points default to the card. A CUDA device without a usable
    card raises; only an explicit CPU device runs on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev


@contextlib.contextmanager
def full_f32():
    """Run float32 matmuls and cuDNN convolutions in full f32 (TF32 off)
    inside the block, whatever the caller set globally, and restore the
    caller's settings after it. Also usable as a decorator."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        with torch.backends.cudnn.flags(
                enabled=torch.backends.cudnn.enabled,
                benchmark=torch.backends.cudnn.benchmark,
                deterministic=torch.backends.cudnn.deterministic,
                allow_tf32=False):
            yield
    finally:
        torch.set_float32_matmul_precision(prev)
