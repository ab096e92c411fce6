"""Dot-product-free inner smoothers: damped Jacobi-Richardson, Chebyshev,
and the power iteration that bounds their spectrum.

The counterparts of the reference's `solvers/smoothers.py`
(`richardson_fixed`, `chebyshev_fixed`, `power_lambda_max`): a fixed
number of operator applications with no reductions (the power iteration
takes one norm an iteration, on the device), so none of them syncs with
the host.
"""

from __future__ import annotations

from typing import Callable

import torch


def richardson_fixed(A: Callable, b: torch.Tensor, Minv: Callable, iters: int, omega=0.9):
    """x_{k+1} = x_k + omega Minv (b - A x_k), x_0 = omega Minv b; `iters`
    applications of Minv in all."""
    x = omega * Minv(b)
    for _ in range(max(0, iters - 1)):
        x = x + omega * Minv(b - A(x))
    return x


def chebyshev_fixed(A: Callable, b: torch.Tensor, Minv: Callable, iters: int, lam_min, lam_max):
    """Chebyshev semi-iteration for SPD Minv A with spectrum in [lam_min,
    lam_max] (the classic three-term recurrence, x_0 = 0)."""
    theta = 0.5 * (lam_max + lam_min)
    delta = 0.5 * (lam_max - lam_min)
    sigma1 = theta / delta
    x = Minv(b) / theta
    x_old = torch.zeros_like(x)
    rho_old = 1.0 / sigma1
    for _ in range(max(0, iters - 1)):
        z = Minv(b - A(x))
        rho = 1.0 / (2.0 * sigma1 - rho_old)
        # x_{k+1} = x_k + rho (2 / delta) z + rho rho_old (x_k - x_{k-1})
        x, x_old = x + rho * (2.0 / delta) * z + rho * rho_old * (x - x_old), x
        rho_old = rho
    return x


def power_lambda_max(A: Callable, Minv: Callable, v0: torch.Tensor, iters: int = 8):
    """Estimate lam_max of Minv A by `iters` power iterations from v0; a 0-d
    tensor, or [B] for B columns v0 [n, B] (one estimate a column; no host
    sync)."""
    if v0.dim() == 2:
        norm = lambda x: torch.sqrt(torch.sum(x * x, dim=0))  # noqa: E731
    else:
        norm = lambda x: torch.sqrt(torch.sum(x * x))  # noqa: E731
    v = v0 / norm(v0)
    lam = torch.ones(v0.shape[1:], dtype=v0.dtype, device=v0.device)
    for _ in range(iters):
        w = Minv(A(v))
        lam = norm(w)
        v = w / torch.clamp(lam, min=1e-30)
    return lam
