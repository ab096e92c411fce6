"""The port's own copies of the JAX package's host modules, against the JAX
package: `config.py`, `mesh/` (generators, reordering, the Gmsh reader and
writers), `utils/logging.py` (rank-0 printing),
`fem/` (reference elements, quadrature, the Taylor-Hood space, cell and
boundary geometry), the CLI's `_common_flags` / `_build_config`, and the
output modules `io/csvlog.py` (all its logs), `io/vtu.py` (VTU, PVTU and
PVD files, byte for byte), `utils/signal.py` (`strouhal_number`) and
`utils/tables.py` (`ConvergenceTable`), and the generators `cube_mesh` and
`rectangle_mesh`.

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
import torch

from navierstokes_project_nm4pde_tpu import cli as jcli
from navierstokes_project_nm4pde_tpu import config as jconfig
from navierstokes_project_nm4pde_tpu.fem import geometry as jgeometry
from navierstokes_project_nm4pde_tpu.fem import quadrature as jquad
from navierstokes_project_nm4pde_tpu.fem import reference as jref
from navierstokes_project_nm4pde_tpu.fem import space as jspace
from navierstokes_project_nm4pde_tpu.io import csvlog as jcsvlog
from navierstokes_project_nm4pde_tpu.io import vtu as jvtu
from navierstokes_project_nm4pde_tpu.mesh import cube_mesh as jax_cube
from navierstokes_project_nm4pde_tpu.mesh import cylinder_duct_3d as jax_duct
from navierstokes_project_nm4pde_tpu.mesh import rectangle_mesh as jax_rectangle
from navierstokes_project_nm4pde_tpu.mesh import read_msh as jax_read_msh
from navierstokes_project_nm4pde_tpu.mesh.msh_io import write_msh, write_msh_v41
from navierstokes_project_nm4pde_tpu.utils import logging as jlogging
from navierstokes_project_nm4pde_tpu.utils import signal as jsignal
from navierstokes_project_nm4pde_tpu.utils import tables as jtables
from navierstokes_project_nm4pde_tpu_torch import cli as tcli
from navierstokes_project_nm4pde_tpu_torch import config as tconfig
from navierstokes_project_nm4pde_tpu_torch.fem import geometry as tgeometry
from navierstokes_project_nm4pde_tpu_torch.fem import quadrature as tquad
from navierstokes_project_nm4pde_tpu_torch.fem import reference as tref
from navierstokes_project_nm4pde_tpu_torch.fem import space as tspace
from navierstokes_project_nm4pde_tpu_torch.io import csvlog as tcsvlog
from navierstokes_project_nm4pde_tpu_torch.io import vtu as tvtu
from navierstokes_project_nm4pde_tpu_torch.mesh import Mesh, cube_mesh, rectangle_mesh
from navierstokes_project_nm4pde_tpu_torch.mesh import cylinder_duct_3d as port_duct
from navierstokes_project_nm4pde_tpu_torch.mesh import read_msh as port_read_msh
from navierstokes_project_nm4pde_tpu_torch.mesh import msh_io as port_msh_io
from navierstokes_project_nm4pde_tpu_torch.utils import logging as tlogging
from navierstokes_project_nm4pde_tpu_torch.utils import signal as tsignal
from navierstokes_project_nm4pde_tpu_torch.utils import tables as ttables

MESH_FIELDS = ("coords", "cells", "bface_verts", "bface_tag")
SPACE_FIELDS = (
    "edges", "cells_u", "cells_p", "unode_coords", "bface_cell", "bface_local",
    "bface_unodes", "bface_pnodes",
)
GEOM_FIELDS = ("J", "Jinv", "detJ")
BOUNDARY_FIELDS = ("tag", "cell", "phi_u", "grad_u", "phi_p", "jxw", "normal", "points")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's small-duct runs in one torch thread per test process: the
    test runner's parallel workers would otherwise each start a thread per
    core, and their spinning threads then slow every small op many times
    over.  Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@pytest.mark.parametrize("fmt", ["v2-ascii", "v2-binary", "v41-ascii", "v41-binary"])
def test_write_msh_copy_writes_the_reference_files(tmp_path, fmt):
    """The port's copies of the writers (`write_msh`, `write_msh_v41` and the
    binary forms behind them) write the JAX writers' files byte for byte,
    from the port's mesh of the same duct, and read back into it."""
    version, kind = fmt.split("-")
    ref, out = tmp_path / "jax.msh", tmp_path / "port.msh"
    (write_msh if version == "v2" else write_msh_v41)(jax_duct(lc=0.3, nz=2), str(ref), binary=kind == "binary")
    writer = port_msh_io.write_msh if version == "v2" else port_msh_io.write_msh_v41
    mesh = port_duct(lc=0.3, nz=2)
    writer(mesh, str(out), binary=kind == "binary")
    assert out.read_bytes() == ref.read_bytes()
    back, ref_back = port_read_msh(str(out)), jax_read_msh(str(ref))
    for field in MESH_FIELDS:
        np.testing.assert_array_equal(getattr(back, field), getattr(ref_back, field))


def test_logging_copy_prints_on_rank_zero_only(capsys, monkeypatch):
    """Without a process group both packages' `pcout` print and
    `is_main_process` is true; on a rank other than 0 the port's prints
    nothing (the reference's on a process other than 0)."""
    assert tlogging.is_main_process() and jlogging.is_main_process()
    tlogging.pcout("port", 1)
    jlogging.pcout("port", 1)
    assert capsys.readouterr().out == "port 1\nport 1\n"
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
    assert not tlogging.is_main_process()
    tlogging.pcout("rank 1")
    assert capsys.readouterr().out == ""


def _tree(root):
    return {p.relative_to(root).as_posix(): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


def test_csvlog_copy_writes_the_reference_files(tmp_path):
    """Every log of the CSV logger, twice (a header only once), from the
    same numpy diagnostics: the same files byte for byte."""
    rng = np.random.default_rng(0)
    t, it = np.arange(1, 5) * 2e-4, rng.integers(5, 30, 4).astype(np.int32)
    cols = [rng.normal(size=4) for _ in range(6)]
    for mod, name in ((jcsvlog, "jax"), (tcsvlog, "port")):
        log = mod.CSVLogger(str(tmp_path / name))
        for _ in range(2):
            log.log_gmres(t, (t * 1e4).astype(int), it)
            log.log_coefficients(np.arange(1, 5), cols[0], cols[1])
            log.log_forces("forces_results_3D_2case.csv", t, *cols[:4], t_prec=cols[4], t_solve=cols[5])
            log.log_forces("forces_plain.csv", t, *cols[:4])
            log.log_table("ensemble.csv", "Re,nu", [(20.0, 5e-4), (300.0, 3e-5)])
            log.log_convergence([0.5, 0.25], cols[0][:2], cols[1][:2])
    ref = _tree(tmp_path / "jax")
    assert len(ref) == 6
    assert _tree(tmp_path / "port") == ref


def test_vtu_copy_writes_the_reference_files(meshes, tmp_path):
    """A VTU snapshot (with and without the partitioning field), a
    multi-piece PVTU record and a PVD index: the same bytes."""
    _, _, js, ts = meshes
    rng = np.random.default_rng(1)
    u, p = rng.normal(size=(ts.n_unodes, 3)), rng.normal(size=ts.n_pnodes)
    part = (np.arange(ts.cells_u.shape[0]) % 3).astype(np.int32)
    for mod, space, name in ((jvtu, js, "jax"), (tvtu, ts, "port")):
        d = tmp_path / name
        d.mkdir()
        mod.write_vtu(str(d / "a.vtu"), space, u, p)
        mod.write_vtu(str(d / "b.vtu"), space, u, p, partitioning=part)
        mod.write_vtu_with_pvtu_record(str(d), "c", space, u, p, partitioning=part)
        mod.write_pvd(str(d / "s.pvd"), [(0.1, "a.vtu"), (0.2, "b.vtu")])
    ref = _tree(tmp_path / "jax")
    assert len(ref) >= 5
    assert _tree(tmp_path / "port") == ref


@pytest.mark.parametrize("n", [4, 64, 1000])
def test_strouhal_copy_matches_reference(n):
    t = np.arange(n) * 1e-3
    lift = np.sin(2 * np.pi * 3.0 * t) + 0.1 * np.random.default_rng(n).normal(size=n)
    ref = jsignal.strouhal_number(lift, 1e-3, diameter=0.1, velocity=2.0)
    out = tsignal.strouhal_number(lift, 1e-3, diameter=0.1, velocity=2.0)
    assert (np.isnan(out) and np.isnan(ref)) or out == ref


@pytest.mark.parametrize("n", [1, 2, 4, 16])
def test_cube_mesh_copy_matches_reference(n):
    """The convergence ladder's cubes (Kuhn tets, one tag a face)."""
    jm, tm = jax_cube(n), cube_mesh(n)
    assert isinstance(tm, Mesh)
    for field in MESH_FIELDS:
        np.testing.assert_array_equal(getattr(tm, field), getattr(jm, field))


@pytest.mark.parametrize("args", [(8, 4, 2.0, 1.0), (3, 5, 1.0, 0.41)])
def test_rectangle_mesh_copy_matches_reference(args):
    nx, ny, lx, ly = args
    jm, tm = jax_rectangle(nx, ny, lx=lx, ly=ly, x0=0.5), rectangle_mesh(nx, ny, lx=lx, ly=ly, x0=0.5)
    for field in MESH_FIELDS:
        np.testing.assert_array_equal(getattr(tm, field), getattr(jm, field))


@pytest.mark.parametrize("errors", [
    {"L2": [0.2419, 0.0309, 0.0039, 4.9e-4], "H1": [2.106, 0.5253, 0.1314, 0.0329]},
    {"L2": [1.0, 0.5]},
])
def test_convergence_table_copy_matches_reference(errors):
    """Rows, rates and the printed table of the same errors."""
    tables = [jtables.ConvergenceTable(), ttables.ConvergenceTable()]
    for i in range(len(next(iter(errors.values())))):
        for t in tables:
            t.add_row(2.0 / 2 ** (i + 1), **{k: v[i] for k, v in errors.items()})
    ref, out = tables
    assert out.rows == ref.rows
    assert out.rates() == ref.rates()
    assert out.format() == ref.format()
