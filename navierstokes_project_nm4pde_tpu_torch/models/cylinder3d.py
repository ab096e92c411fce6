"""DFG 3D flow-past-a-cylinder problem (PyTorch callables).

The counterpart of the reference's `models/cylinder3d.py`: duct
2.5 x 0.41 x 0.41, cylinder r=0.05 at x=0.5, inlet profile
16 u_m y z (H-y)(H-z) / H^4 (times sin(pi t / 8) in case 3), u_m = 9,
mean velocity 4 u_m / 9; no-slip walls (tag 2) and obstacle (tag 3).
"""

from __future__ import annotations

import math

import torch

from navierstokes_project_nm4pde_tpu_torch.models.base import ProblemSpec

H = 0.41
U_M = 9.0
NU = 1e-3
DIAMETER = 0.1
PROBE_A = (0.45, 0.2, 0.205)
PROBE_B = (0.55, 0.2, 0.205)


def _inlet_profile(test_case: int, u_m: float):
    def g(x: torch.Tensor, t: float) -> torch.Tensor:
        y, z = x[:, 1], x[:, 2]
        para = 16.0 * u_m * y * z * (H - y) * (H - z) / (H**4)
        if test_case == 1:
            ux = torch.zeros_like(y)
        elif test_case == 3:
            ux = para * math.sin(math.pi * t / 8.0)
        else:
            ux = para
        zero = torch.zeros_like(ux)
        return torch.stack([ux, zero, zero], dim=1)

    return g


def _mean_velocity(test_case: int, u_m: float):
    def U(t: float) -> float:
        if test_case == 1:
            return 0.0
        if test_case == 3:
            return 4.0 * u_m * math.sin(t * math.pi / 8.0) / 9.0
        return 4.0 * u_m / 9.0

    return U


def _zero(x: torch.Tensor, t: float) -> torch.Tensor:
    return torch.zeros_like(x)


def Cylinder3DProblem(test_case: int = 2, nu: float = NU, u_m: float = U_M) -> ProblemSpec:
    return ProblemSpec(
        dim=3,
        nu=nu,
        dirichlet={0: _inlet_profile(test_case, u_m), 2: _zero, 3: _zero},
        obstacle_tag=3,
        probe_points=(PROBE_A, PROBE_B),
        mean_velocity=_mean_velocity(test_case, u_m),
        diameter=DIAMETER,
        span=H,
    )
