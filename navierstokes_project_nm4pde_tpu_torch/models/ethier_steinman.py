"""Ethier-Steinman manufactured solution on the cube [-1, 1]^3 (PyTorch
callables).

The counterpart of the reference's `models/ethier_steinman.py`: an exact
unsteady Navier-Stokes solution with a = pi/4, b = pi/2, nu = 1e-2
(ref: include/Convergence3D.hpp:51-148),

  u1 = -a e^{-nu b^2 t} (e^{ax} sin(ay+bz) + e^{az} cos(ax+by))
  u2 = -a e^{-nu b^2 t} (e^{ay} sin(az+bx) + e^{ax} cos(ay+bz))
  u3 = -a e^{-nu b^2 t} (e^{az} sin(ax+by) + e^{ay} cos(az+bx))
  p  = -a^2/2 e^{-2 nu b^2 t} (2 sin(ax+by)cos(az+bx)e^{a(y+z)}
       + 2 sin(ay+bz)cos(ax+by)e^{a(x+z)} + 2 sin(az+bx)cos(ay+bz)e^{a(x+y)}
       + e^{2ax} + e^{2ay} + e^{2az})

Dirichlet data are the exact velocity on tags {0, 1, 2, 4, 5}; tag 3, the
y = +1 face, is a Neumann face with h = nu (grad u) n - p n and the
outward normal (0, 1, 0) (ref: src/Convergence3D.cpp:303-380; the
reference's formulas are those of this face).  The velocity gradient (for
h and for the H1 error) is forward-mode autodiff of the exact velocity
(`torch.func.jacfwd`).  u0 and p0 are the exact fields at t = 0.
"""

from __future__ import annotations

import math

import torch

from navierstokes_project_nm4pde_tpu_torch.models.base import ProblemSpec

A = math.pi / 4.0
B = math.pi / 2.0
NU = 1e-2


def exact_velocity(x: torch.Tensor, t: float) -> torch.Tensor:
    """x: [..., 3] -> [..., 3]."""
    a, b = A, B
    decay = math.exp(-NU * b * b * t)
    X, Y, Z = x[..., 0], x[..., 1], x[..., 2]
    u1 = -a * decay * (torch.exp(a * X) * torch.sin(a * Y + b * Z)
                       + torch.exp(a * Z) * torch.cos(a * X + b * Y))
    u2 = -a * decay * (torch.exp(a * Y) * torch.sin(a * Z + b * X)
                       + torch.exp(a * X) * torch.cos(a * Y + b * Z))
    u3 = -a * decay * (torch.exp(a * Z) * torch.sin(a * X + b * Y)
                       + torch.exp(a * Y) * torch.cos(a * Z + b * X))
    return torch.stack([u1, u2, u3], dim=-1)


def exact_pressure(x: torch.Tensor, t: float) -> torch.Tensor:
    """x: [..., 3] -> [...]."""
    a, b = A, B
    decay2 = math.exp(-2.0 * NU * b * b * t)
    X, Y, Z = x[..., 0], x[..., 1], x[..., 2]
    t1 = 2.0 * torch.sin(a * X + b * Y) * torch.cos(a * Z + b * X) * torch.exp(a * (Y + Z))
    t2 = 2.0 * torch.sin(a * Y + b * Z) * torch.cos(a * X + b * Y) * torch.exp(a * (X + Z))
    t3 = 2.0 * torch.sin(a * Z + b * X) * torch.cos(a * Y + b * Z) * torch.exp(a * (X + Y))
    t4 = torch.exp(2 * a * X) + torch.exp(2 * a * Y) + torch.exp(2 * a * Z)
    return -(a * a) / 2.0 * decay2 * (t1 + t2 + t3 + t4)


def exact_velocity_gradient(x: torch.Tensor, t: float) -> torch.Tensor:
    """[..., 3, 3] with entries du_c/dx_d, by forward-mode autodiff."""
    flat = x.reshape(-1, 3)
    jac = torch.func.vmap(torch.func.jacfwd(lambda q: exact_velocity(q, t)))(flat)
    return jac.reshape(x.shape[:-1] + (3, 3)).to(x.dtype)


def neumann_h(x: torch.Tensor, t: float, normal=(0.0, 1.0, 0.0)) -> torch.Tensor:
    """h = nu (grad u) n - p n with the outward normal of the tag-3 face."""
    n = torch.as_tensor(normal, dtype=x.dtype, device=x.device)
    g = exact_velocity_gradient(x, t)
    p = exact_pressure(x, t)
    return NU * torch.einsum("...cd,d->...c", g, n) - p[..., None] * n


def EthierSteinmanProblem() -> ProblemSpec:
    return ProblemSpec(
        dim=3,
        nu=NU,
        dirichlet={tag: exact_velocity for tag in (0, 1, 2, 4, 5)},
        neumann_tag=3,
        neumann_value=neumann_h,
        u0=lambda x: exact_velocity(x, 0.0),
        p0=lambda x: exact_pressure(x, 0.0),
    )
