"""Host utilities of the PyTorch port: the Strouhal number, timers, the
convergence table, spans of the program's phases on the profiler's clock
(`profiling`) and rank-0 printing."""

from navierstokes_project_nm4pde_tpu_torch.utils.logging import is_main_process, pcout  # noqa: F401
from navierstokes_project_nm4pde_tpu_torch.utils.profiling import setup_phase, span  # noqa: F401
from navierstokes_project_nm4pde_tpu_torch.utils.signal import strouhal_number  # noqa: F401
from navierstokes_project_nm4pde_tpu_torch.utils.tables import ConvergenceTable  # noqa: F401
from navierstokes_project_nm4pde_tpu_torch.utils.timers import Timer  # noqa: F401
