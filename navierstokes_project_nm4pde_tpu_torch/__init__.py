"""PyTorch/CUDA port of the incompressible Navier-Stokes engine.

A second package beside the JAX reference (`navierstokes_project_nm4pde_tpu`),
written for one NVIDIA H100.  It imports nothing of the JAX package: it
keeps its own copies of the host modules it needs (`config.py`, `mesh/`,
`fem/` and the CLI's flag and config helpers) and ports the device side:
plain PyTorch functions on tensors on a `device` that defaults to the card
(`device.py pick_device`; "cpu" runs the kernels' plain versions), plus
hand-written CUDA kernels: the per-step macro-element block build and
block matvec of the single run (`csrc/macro_kernels.cu`), the element-slot
reduce and gather of the Reynolds-sweep ensemble
(`csrc/ensemble_kernels.cu`), and two measurement probes
(`csrc/probe_kernels.cu`).

The module layout mirrors the reference (`config.py`, `mesh/`, `fem/`,
`ops/`, `solvers/`, `precond/`, `models/`, `parallel/`, `io/`, `cli.py`)
so each function's counterpart is easy to find.  Nothing here imports jax.
"""

__version__ = "0.1.0"
