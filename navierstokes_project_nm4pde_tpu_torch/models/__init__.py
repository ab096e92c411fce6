"""Models layer of the PyTorch port: the solver and the benchmark problem."""

from navierstokes_project_nm4pde_tpu_torch.models.base import (  # noqa: F401
    NavierStokesSolver,
    ProblemSpec,
    State,
    StepDiagnostics,
    state_from_numpy,
    state_to_numpy,
)
from navierstokes_project_nm4pde_tpu_torch.models.cylinder3d import (  # noqa: F401
    Cylinder3DProblem,
)
