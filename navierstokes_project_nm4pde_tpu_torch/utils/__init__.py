"""Host utilities of the PyTorch port: the Strouhal number, timers, the
convergence table, profiling helpers and rank-0 printing."""

from navierstokes_project_nm4pde_tpu_torch.utils.logging import is_main_process, pcout  # noqa: F401
from navierstokes_project_nm4pde_tpu_torch.utils.profiling import annotate, trace  # noqa: F401
from navierstokes_project_nm4pde_tpu_torch.utils.signal import strouhal_number  # noqa: F401
from navierstokes_project_nm4pde_tpu_torch.utils.tables import ConvergenceTable  # noqa: F401
from navierstokes_project_nm4pde_tpu_torch.utils.timers import Timer  # noqa: F401
