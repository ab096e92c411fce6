"""The port's own copies of the JAX package's host modules, against the JAX
package: `config.py`, `mesh/` (generators, reordering, the Gmsh reader),
`fem/` (reference elements, quadrature, the Taylor-Hood space, cell and
boundary geometry) and the CLI's `_common_flags` / `_build_config`.

Both sides run the same numpy code on the same inputs, so every array is
held equal exactly.  The mesh is the small DFG duct
`cylinder_duct_3d(lc=0.25, nz=3)`, as generated and after its RCM reorder.

`jax_config` builds the JAX package's RunConfig equal to a port
RunConfig, so that the tests that run both solvers hand each package a
configuration of its own classes.
"""

import argparse
import dataclasses

import numpy as np
import pytest

from navierstokes_project_nm4pde_tpu import cli as jcli
from navierstokes_project_nm4pde_tpu import config as jconfig
from navierstokes_project_nm4pde_tpu.fem import geometry as jgeometry
from navierstokes_project_nm4pde_tpu.fem import quadrature as jquad
from navierstokes_project_nm4pde_tpu.fem import reference as jref
from navierstokes_project_nm4pde_tpu.fem import space as jspace
from navierstokes_project_nm4pde_tpu.mesh import cylinder_duct_3d as jax_duct
from navierstokes_project_nm4pde_tpu.mesh import read_msh as jax_read_msh
from navierstokes_project_nm4pde_tpu.mesh.msh_io import write_msh, write_msh_v41
from navierstokes_project_nm4pde_tpu_torch import cli as tcli
from navierstokes_project_nm4pde_tpu_torch import config as tconfig
from navierstokes_project_nm4pde_tpu_torch.fem import geometry as tgeometry
from navierstokes_project_nm4pde_tpu_torch.fem import quadrature as tquad
from navierstokes_project_nm4pde_tpu_torch.fem import reference as tref
from navierstokes_project_nm4pde_tpu_torch.fem import space as tspace
from navierstokes_project_nm4pde_tpu_torch.mesh import Mesh
from navierstokes_project_nm4pde_tpu_torch.mesh import cylinder_duct_3d as port_duct
from navierstokes_project_nm4pde_tpu_torch.mesh import read_msh as port_read_msh

MESH_FIELDS = ("coords", "cells", "bface_verts", "bface_tag")
SPACE_FIELDS = (
    "edges", "cells_u", "cells_p", "unode_coords", "bface_cell", "bface_local",
    "bface_unodes", "bface_pnodes",
)
GEOM_FIELDS = ("J", "Jinv", "detJ")
BOUNDARY_FIELDS = ("tag", "cell", "phi_u", "grad_u", "phi_p", "jxw", "normal", "points")


def jax_config(cfg):
    """The JAX package's RunConfig with the fields of the port's `cfg`."""
    d = dataclasses.asdict(cfg)
    return jconfig.RunConfig(
        time=jconfig.TimeConfig(**d.pop("time")),
        solver=jconfig.SolverConfig(**d.pop("solver")),
        precond=jconfig.PrecondConfig(**d.pop("precond")),
        numerics=jconfig.NumericsConfig(**d.pop("numerics")),
        **d,
    )


@pytest.fixture(scope="module", params=["generated", "rcm"])
def meshes(request):
    """(JAX mesh, port mesh, JAX space, port space) of the small duct."""
    jm, tm = jax_duct(lc=0.25, nz=3), port_duct(lc=0.25, nz=3)
    if request.param == "rcm":
        jm, tm = jm.reorder_spatial("rcm"), tm.reorder_spatial("rcm")
    assert isinstance(tm, Mesh) and not isinstance(jm, Mesh)
    return jm, tm, jspace.build_taylor_hood(jm), tspace.build_taylor_hood(tm)


@pytest.mark.parametrize("field", MESH_FIELDS)
def test_mesh_copy_matches_reference(meshes, field):
    jm, tm, _, _ = meshes
    np.testing.assert_array_equal(getattr(tm, field), getattr(jm, field))


@pytest.mark.parametrize("field", SPACE_FIELDS)
def test_taylor_hood_copy_matches_reference(meshes, field):
    _, _, js, ts = meshes
    np.testing.assert_array_equal(getattr(ts, field), getattr(js, field))
    assert (ts.n_dofs, ts.n_unodes, ts.n_pnodes) == (js.n_dofs, js.n_unodes, js.n_pnodes)


@pytest.mark.parametrize("field", GEOM_FIELDS + BOUNDARY_FIELDS)
def test_geometry_copy_matches_reference(meshes, field):
    _, _, js, ts = meshes
    jg, tg = jgeometry.cell_geometry(js), tgeometry.cell_geometry(ts)
    if field in GEOM_FIELDS:
        ref, out = getattr(jg, field), getattr(tg, field)
    else:
        ref = getattr(jgeometry.boundary_tables(js, jg, degree=4), field)
        out = getattr(tgeometry.boundary_tables(ts, tg, degree=4), field)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("dim", [2, 3])
def test_reference_elements_and_rules_match_reference(dim):
    for degree in (1, 2, 4, 5):
        for rule in ("cell_rule", "face_rule"):
            jp, jw = getattr(jquad, rule)(dim, degree)
            tp, tw = getattr(tquad, rule)(dim, degree)
            np.testing.assert_array_equal(tp, jp)
            np.testing.assert_array_equal(tw, jw)
    pts, _ = tquad.cell_rule(dim, 5)
    for fn in ("p1_shape", "p2_shape", "p2_grad"):
        np.testing.assert_array_equal(getattr(tref, fn)(pts, dim), getattr(jref, fn)(pts, dim))
    assert tref.n_p2_nodes(dim) == jref.n_p2_nodes(dim)


def test_default_run_config_matches_reference():
    assert dataclasses.asdict(tconfig.RunConfig()) == dataclasses.asdict(jconfig.RunConfig())
    assert tconfig.TimeConfig(dt=2e-4, t_end=4.0).n_steps == jconfig.TimeConfig(dt=2e-4, t_end=4.0).n_steps
    with pytest.raises(ValueError):  # the same validation
        tconfig.PrecondConfig(f_recycle=2, f_iters=4)


def _parse(mod, argv):
    p = argparse.ArgumentParser()
    mod._common_flags(p, dt=0.01, t_end=0.5, precond="asimple")
    p.add_argument("--test-case", type=int, default=2)
    p.add_argument("--onehot", action="store_true")
    return p, p.parse_args(argv)


@pytest.mark.parametrize("argv", [
    [],
    ["--fast"],
    ["--fast", "--onehot", "--dt", "2e-4", "--maxiter", "25", "--steps-per-chunk", "8",
     "--dtype", "float64", "--test-case", "3", "--output-dir", "out"],
    ["--precond", "simple", "--stepper", "projection", "--scheme", "bdf2", "--rtol", "1e-8",
     "--tol-mode", "b", "--restart", "20", "--f-iters", "3", "--s-iters", "7",
     "--f-solver", "chebyshev", "--s-solver", "mg2_cg", "--no-precise-dots", "--output-every", "5"],
])
def test_cli_build_config_matches_reference(argv):
    (jp, ja), (tp, ta) = _parse(jcli, argv), _parse(tcli, argv)
    assert vars(ta) == vars(ja)
    assert sorted(tp._option_string_actions) == sorted(jp._option_string_actions)
    ref = jcli._build_config(ja, None)
    out = tcli._build_config(ta, None)
    assert isinstance(out, tconfig.RunConfig)
    assert dataclasses.asdict(out) == dataclasses.asdict(ref)


def test_jax_config_helper_round_trips():
    cfg = tconfig.RunConfig(time=tconfig.TimeConfig(dt=1e-3, stepper="projection"))
    jc = jax_config(cfg)
    assert isinstance(jc, jconfig.RunConfig)
    assert dataclasses.asdict(jc) == dataclasses.asdict(cfg)


@pytest.mark.parametrize("fmt", ["v2-ascii", "v2-binary", "v41-ascii", "v41-binary"])
def test_read_msh_copy_matches_reference(tmp_path, fmt):
    """A small duct written by the JAX package's writers, read by both
    readers."""
    mesh = jax_duct(lc=0.3, nz=2)
    path = str(tmp_path / "duct.msh")
    version, kind = fmt.split("-")
    writer = write_msh if version == "v2" else write_msh_v41
    writer(mesh, path, binary=kind == "binary")
    ref, out = jax_read_msh(path), port_read_msh(path)
    assert isinstance(out, Mesh)
    for field in MESH_FIELDS:
        np.testing.assert_array_equal(getattr(out, field), getattr(ref, field))
