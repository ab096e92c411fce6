"""Ensembles of the PyTorch port: many runs advanced as one batch."""

from navierstokes_project_nm4pde_tpu_torch.parallel.ensemble import (  # noqa: F401
    ensemble_state_from_numpy,
    ensemble_state_to_numpy,
    run_ensemble,
)
