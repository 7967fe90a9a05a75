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


def to_device(t, device, dtype=None) -> torch.Tensor:
    """Copy host data to `device` without blocking the host. A plain copy
    from pageable memory to a card synchronizes the stream, so it would
    wait for every kernel queued before it; a pinned staging copy does
    not (PyTorch's pinned-memory cache keeps the buffer until the copy has
    run). Data already on a card is moved with a plain `.to`."""
    device = torch.device(device)
    t = torch.as_tensor(t, dtype=dtype)
    if t.device.type != "cpu" or device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


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
