"""Separable 3D gaussian gradient magnitude (torch port of
garmentnets_tpu/ops/gaussian.py).

scipy.ndimage.gaussian_gradient_magnitude with mode='nearest' over the last
three axes: for each direction, a derivative-of-gaussian correlation along
it and gaussian correlations along the other two, applied D, then H, then
W with edge-replicated borders; then sqrt of the sum of squares.

- `ggm_plain`: the plain PyTorch version (the CPU path and the kernel's
  reference).
- `gaussian_gradient_magnitude`: the hand-written CUDA kernel
  (kernels/ggm.py, csrc/ggm.cu) for a CUDA tensor, the plain version for a
  CPU tensor.
"""
from __future__ import annotations

import numpy as np
import torch


def _gaussian_kernel1d(sigma: float, order: int, radius: int) -> np.ndarray:
    """scipy.ndimage._gaussian_kernel1d replica in float64 (returned in
    correlation orientation, i.e. already reversed for use as a sliding dot
    product)."""
    sigma2 = sigma * sigma
    x = np.arange(-radius, radius + 1)
    phi_x = np.exp(-0.5 / sigma2 * x ** 2)
    phi_x = phi_x / phi_x.sum()
    if order == 0:
        kernel = phi_x
    else:
        q = np.zeros(order + 1)
        q[0] = 1
        D = np.diag(np.ones(order), 1)            # D @ q(x) = q'(x)
        P = np.diag(np.ones(order), -1) / sigma2  # P @ q(x) = q(x) * x / sigma2
        Q_deriv = D - P
        for _ in range(order):
            q = Q_deriv.dot(q)
        q = (x[:, None] ** np.arange(order + 1)).dot(q)
        kernel = q * phi_x
    return kernel[::-1].copy()


def ggm_taps(sigma: float, truncate: float = 4.0):
    """(k0, k1): the gaussian and first-derivative taps of radius
    int(truncate * sigma + 0.5), float64."""
    radius = int(truncate * sigma + 0.5)
    return (_gaussian_kernel1d(sigma, 0, radius),
            _gaussian_kernel1d(sigma, 1, radius))


def _correlate_axis(x: torch.Tensor, taps: np.ndarray,
                    axis: int) -> torch.Tensor:
    """Correlate x with 1D taps along `axis`, edge-replicate borders, as
    out = 0 + w0*x0 + w1*x1 + ... in f32."""
    r = (len(taps) - 1) // 2
    n = x.shape[axis]
    idx = torch.arange(-r, n + r, device=x.device).clamp_(0, n - 1)
    xp = x.index_select(axis, idx)
    out = torch.zeros_like(x)
    for i, w in enumerate(taps):
        out = out + np.float32(w).item() * xp.narrow(axis, i, n)
    return out


def ggm_plain(volume: torch.Tensor, sigma: float,
              truncate: float = 4.0) -> torch.Tensor:
    """volume [..., D, H, W] -> |grad(G_sigma * volume)|."""
    k0, k1 = ggm_taps(sigma, truncate)
    nd = volume.dim()
    axes = (nd - 3, nd - 2, nd - 1)
    acc = torch.zeros_like(volume)
    for d_axis in axes:
        g = volume
        for axis in axes:
            g = _correlate_axis(g, k1 if axis == d_axis else k0, axis)
        acc = acc + g * g
    return torch.sqrt(acc)


def gaussian_gradient_magnitude(volume: torch.Tensor, sigma: float,
                                truncate: float = 4.0) -> torch.Tensor:
    """[B, D, H, W] -> |grad|: the CUDA kernel on the card, the plain
    version on the CPU."""
    if volume.is_cuda:
        from garmentnets_tpu_torch.kernels.ggm import ggm_cuda
        k0, k1 = ggm_taps(sigma, truncate)
        return ggm_cuda(volume.contiguous(), k0, k1)
    return ggm_plain(volume, sigma, truncate)

