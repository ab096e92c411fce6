"""PyTorch/CUDA port of the incompressible Navier-Stokes engine.

A second package beside the JAX reference (`navierstokes_project_nm4pde_tpu`),
written for one NVIDIA H100.  It reuses the reference's numpy-only host
modules (config, mesh, FEM spaces and geometry) and ports the device side:
plain PyTorch functions on tensors with an explicit `device`, plus
hand-written CUDA kernels: the per-step macro-element block build and
block matvec of the single run (`csrc/macro_kernels.cu`), the element-slot
reduce and gather of the Reynolds-sweep ensemble
(`csrc/ensemble_kernels.cu`), and two measurement probes
(`csrc/probe_kernels.cu`).

The module layout mirrors the reference (`ops/`, `solvers/`, `precond/`,
`models/`, `parallel/`, `io/`, `cli.py`) so each function's counterpart
is easy to find.  Nothing here
imports jax.
"""

__version__ = "0.1.0"
