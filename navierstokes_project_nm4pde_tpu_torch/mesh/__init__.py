"""Meshes of the port: its own copies of the JAX package's mesh container,
DFG generators, Gmsh reader and meshkit bindings (numpy only)."""

from navierstokes_project_nm4pde_tpu_torch.mesh.core import Mesh  # noqa: F401
from navierstokes_project_nm4pde_tpu_torch.mesh.generators import (  # noqa: F401
    cylinder_channel_2d,
    cylinder_duct_3d,
)
from navierstokes_project_nm4pde_tpu_torch.mesh.msh_io import read_msh  # noqa: F401
