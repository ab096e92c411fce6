"""Run configuration of the port: the reference's dataclasses (numpy-only,
no jax), re-exported so that a caller of the port imports from the port
alone."""

from navierstokes_project_nm4pde_tpu.config import (  # noqa: F401
    NumericsConfig,
    PrecondConfig,
    RunConfig,
    SolverConfig,
    TimeConfig,
)
