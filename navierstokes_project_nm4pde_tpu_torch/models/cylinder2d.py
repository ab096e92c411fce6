"""DFG 2D flow-past-a-cylinder problem (PyTorch callables).

The counterpart of the reference's `models/cylinder2d.py`: channel
2.2 x 0.41, cylinder r=0.05 at (0.2, 0.2), nu = 1e-3, parabolic inlet
4 u_m y (H-y) / H^2 with u_m = 1.5 (Re = (2/3) u_m D / nu) and four test
cases:

  case 1: zero inflow
  case 2: the profile times sin(pi t / 8)   (time-ramped, the default)
  case 3: the steady profile
  case 4: the steady profile with the correct constant mean 2 u_m / 3

For cases 1-3 `mean_velocity` keeps the reference's `getMeanVelocity`
switch verbatim, its case-2/3 swap of the sin factor included (case 2's
mean is constant, case 3's ramped; ref: include/NavierStokes2D.hpp:64-75),
so that the drag and lift coefficients are normalised as the reference
normalises them.  Tags: 0 inlet, 1 outlet (natural), 2 walls, 3 cylinder.
"""

from __future__ import annotations

import math

import torch

from navierstokes_project_nm4pde_tpu_torch.models.base import ProblemSpec

H = 0.41
U_M = 1.5
NU = 1e-3
DIAMETER = 0.1
PROBE_A = (0.45, 0.2)
PROBE_B = (0.55, 0.2)


def _inlet_profile(test_case: int, u_m: float):
    def g(x: torch.Tensor, t: float) -> torch.Tensor:
        y = x[:, 1]
        para = 4.0 * u_m * y * (H - y) / (H * H)
        if test_case == 1:
            ux = torch.zeros_like(y)
        elif test_case == 2:
            ux = para * math.sin(math.pi * t / 8.0)
        else:  # 3 and 4: steady
            ux = para
        return torch.stack([ux, torch.zeros_like(ux)], dim=1)

    return g


def _mean_velocity(test_case: int, u_m: float):
    def U(t: float) -> float:
        if test_case == 1:
            return 0.0
        if test_case == 3:
            # the reference's quirk: a steady inlet, a sin-ramped normalisation
            return 2.0 * u_m * math.sin(t * math.pi / 8.0) / 3.0
        return 2.0 * u_m / 3.0

    return U


def _zero(x: torch.Tensor, t: float) -> torch.Tensor:
    return torch.zeros_like(x)


def Cylinder2DProblem(test_case: int = 2, nu: float = NU, u_m: float = U_M) -> ProblemSpec:
    return ProblemSpec(
        dim=2,
        nu=nu,
        dirichlet={0: _inlet_profile(test_case, u_m), 2: _zero, 3: _zero},
        obstacle_tag=3,
        probe_points=(PROBE_A, PROBE_B),
        mean_velocity=_mean_velocity(test_case, u_m),
        diameter=DIAMETER,
    )
