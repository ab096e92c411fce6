"""Meshes of the port: the reference's generators and Gmsh reader
(numpy-only, no jax), re-exported so that a caller of the port imports
from the port alone."""

from navierstokes_project_nm4pde_tpu.mesh import (  # noqa: F401
    Mesh,
    cylinder_duct_3d,
    read_msh,
)
