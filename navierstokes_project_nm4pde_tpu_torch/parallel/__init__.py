"""Ensembles and multi-device runs of the PyTorch port: many runs advanced
as one batch, and one run's cells or members split over local ranks."""

from navierstokes_project_nm4pde_tpu_torch.parallel.ensemble import (  # noqa: F401
    ensemble_state_from_numpy,
    ensemble_state_to_numpy,
    run_ensemble,
)
from navierstokes_project_nm4pde_tpu_torch.parallel.launch import launch  # noqa: F401
from navierstokes_project_nm4pde_tpu_torch.parallel.sharding import (  # noqa: F401
    cell_partitioning,
    make_device_mesh,
    shard_solver,
)
