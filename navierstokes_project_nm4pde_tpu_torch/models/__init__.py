"""Models layer of the PyTorch port: the solver and the benchmark problems."""

from navierstokes_project_nm4pde_tpu_torch.models.base import (  # noqa: F401
    NavierStokesSolver,
    ProblemSpec,
    State,
    StepDiagnostics,
    state_from_numpy,
    state_to_numpy,
)
from navierstokes_project_nm4pde_tpu_torch.models.cylinder2d import (  # noqa: F401
    Cylinder2DProblem,
)
from navierstokes_project_nm4pde_tpu_torch.models.cylinder3d import (  # noqa: F401
    Cylinder3DProblem,
)
from navierstokes_project_nm4pde_tpu_torch.models.ethier_steinman import (  # noqa: F401
    EthierSteinmanProblem,
)
