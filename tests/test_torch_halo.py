"""The PyTorch port's owned+halo plan and operator against the JAX
package's, on local CPU ranks under torch.distributed (gloo).

  * `build_halo_plan`: every array equals the reference's exactly, for 2,
    4 and 8 devices (the port vectorises the reference's per-slot loop),
    and each rank's kernel C plan sums the slots of the reference's
    reduce table in its order;
  * `halo_apply_system` on 2 and 4 ranks equals the JAX
    `halo_apply_system` on as many devices (the 8 virtual CPU devices of
    tests/conftest.py), with convection (and on 2, without), to 1e-12 of max |ref|
    (tests/test_halo.py's setting: cube_mesh(3), Morton order), and the
    port's unsharded `apply_system`.

The projection step is in tests/test_torch_halo_step.py.  Each launch
spawns fresh interpreters (a few seconds each), so the launches are
shared through a module-scoped fixture, and every launch has a timeout.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_project_nm4pde_tpu.fem.geometry import cell_geometry as jax_geometry
from navierstokes_project_nm4pde_tpu.fem.space import build_taylor_hood as jax_taylor_hood
from navierstokes_project_nm4pde_tpu.mesh import cube_mesh as jax_cube
from navierstokes_project_nm4pde_tpu.ops import operators as jops
from navierstokes_project_nm4pde_tpu.parallel import make_device_mesh as jax_device_mesh
from navierstokes_project_nm4pde_tpu.parallel.halo import build_halo_plan as jax_halo_plan
from navierstokes_project_nm4pde_tpu.parallel.halo import halo_apply_system as jax_halo_apply
from navierstokes_project_nm4pde_tpu.parallel.halo import shard_vectors as jax_shard_vectors
from navierstokes_project_nm4pde_tpu.parallel.halo import to_natural as jax_to_natural
from navierstokes_project_nm4pde_tpu.parallel.sharding import _pad_cells as jax_pad_cells
from navierstokes_project_nm4pde_tpu.parallel.sharding import shard_operator as jax_shard_operator
from navierstokes_project_nm4pde_tpu_torch.fem.geometry import cell_geometry
from navierstokes_project_nm4pde_tpu_torch.fem.space import build_taylor_hood
from navierstokes_project_nm4pde_tpu_torch.mesh import cube_mesh
from navierstokes_project_nm4pde_tpu_torch.ops import operators as ops
from navierstokes_project_nm4pde_tpu_torch.ops.onehot import build_onehot_plans
from navierstokes_project_nm4pde_tpu_torch.parallel import launch, make_device_mesh
from navierstokes_project_nm4pde_tpu_torch.parallel.halo import (
    build_halo_plan,
    halo_apply_system,
    owned_block,
    to_natural,
)
from navierstokes_project_nm4pde_tpu_torch.parallel.sharding import _pad_cells, shard_operator
from test_torch_port_copies import one_torch_thread  # noqa: F401 (autouse)

TIMEOUT = 300  # seconds a collective may wait before its rank raises
NU, DT = 0.01, 0.05


def port_cube():
    """(space, op) of tests/test_halo.py's cube in the port."""
    tsp = build_taylor_hood(cube_mesh(3).reorder_spatial("morton"))
    top, _ = ops.build_operator(tsp, cell_geometry(tsp), np.asarray(tsp.dirichlet_mask([0])), torch.float64, "cpu")
    return tsp, top


def cube_ops():
    """(JAX space, JAX op, port space, port op) of tests/test_halo.py's cube."""
    jsp = jax_taylor_hood(jax_cube(3).reorder_spatial("morton"))
    jop = jops.build_operator(jsp, jax_geometry(jsp), np.asarray(jsp.dirichlet_mask([0])), dtype=jnp.float64)
    return (jsp, jop, *port_cube())


def cube_fields(space, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(space.n_unodes, 3)), rng.normal(size=space.n_pnodes),
            rng.normal(size=(space.n_unodes, 3)))


# ----------------------------------------------------------------------
# rank functions (each runs on every rank of a launch)
# ----------------------------------------------------------------------
def _apply_rank(rank, world, device, seed):
    space, op = port_cube()
    u, p, w = cube_fields(space, seed)
    group = make_device_mesh()
    plan = build_halo_plan(_pad_cells(op, world), world, n_vertices=space.mesh.n_vertices)
    op_sh = shard_operator(op, group)
    conv = ops.convection_setup(op_sh, torch.as_tensor(w), with_diag=False)  # this rank's cells
    T = torch.as_tensor
    out = {}
    for name, c in (("conv", conv), ("stokes", None)):
        y_u, y_p = halo_apply_system(op_sh, plan, group, NU, DT, c, T(owned_block(plan.u, u, rank)),
                                     T(owned_block(plan.p, p, rank)))
        out[name] = (y_u.numpy(), y_p.numpy())
    return out


# ----------------------------------------------------------------------
# the plan
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_halo_plan_equals_reference(n_dev):
    jsp, jop, tsp, top = cube_ops()
    jp = jax_halo_plan(jax_pad_cells(jop, n_dev), n_dev, n_vertices=jsp.mesh.n_vertices)
    tp = build_halo_plan(_pad_cells(top, n_dev), n_dev, n_vertices=tsp.mesh.n_vertices)
    assert (tp.n_dev, tp.E_d) == (jp.n_dev, jp.E_d)
    for side in ("u", "p"):
        a, b = getattr(jp, side), getattr(tp, side)
        for f in ("cells_loc", "perm"):
            np.testing.assert_array_equal(getattr(b, f), np.asarray(getattr(a, f)), err_msg=f"{side}.{f}")
        # the reference's reduce table is each rank's slot plan of its
        # extended-local cells: the same slots, in the same order, a row
        table = np.asarray(a.table)
        for d in range(n_dev):
            plan = build_onehot_plans(b.cells_loc[d], b.n_ext, device="cpu").reduce
            perm, off = plan.perm.numpy(), plan.offsets.numpy()
            rows = [t[t < b.n_slots] for t in table[d]]
            assert [perm[off[r]:off[r + 1]].tolist() for r in range(b.n_ext)] == [t.tolist() for t in rows]
        assert len(b.send) == len(a.send)
        for x, y in zip(a.send, b.send):
            np.testing.assert_array_equal(y, np.asarray(x))
        for f in ("n_loc", "n_ext", "shifts", "halo_sizes", "n_slots", "n_rows"):
            assert getattr(b, f) == getattr(a, f), f"{side}.{f}"


# ----------------------------------------------------------------------
# halo_apply_system
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def applies():
    import os

    os.environ.setdefault("OMP_NUM_THREADS", "1")
    return {n: launch(_apply_rank, n, 0, device="cpu", timeout=TIMEOUT) for n in (2, 4)}


@pytest.mark.parametrize("n_dev,name", [(2, "conv"), (4, "conv"), (2, "stokes")])
def test_halo_apply_matches_reference(applies, n_dev, name):
    jsp, jop, tsp, top = cube_ops()
    u, p, w = cube_fields(tsp)
    dmesh = jax_device_mesh(n_dev)
    plan = jax_halo_plan(jax_pad_cells(jop, n_dev), n_dev, n_vertices=jsp.mesh.n_vertices)
    op_sh = jax_shard_operator(jop, dmesh)
    conv = jops.convection_setup(op_sh, jnp.asarray(w)) if name == "conv" else None
    u_sh, p_sh = jax_shard_vectors(plan, dmesh, jnp.asarray(u), jnp.asarray(p))
    y_u, y_p = jax_halo_apply(op_sh, plan, dmesh, NU, DT, conv, u_sh, p_sh)
    ref_u, ref_p = np.asarray(jax_to_natural(plan.u, y_u)), np.asarray(jax_to_natural(plan.p, y_p))
    tplan = build_halo_plan(_pad_cells(top, n_dev), n_dev, n_vertices=tsp.mesh.n_vertices)
    out_u = to_natural(tplan.u, np.concatenate([r[name][0] for r in applies[n_dev]]))
    out_p = to_natural(tplan.p, np.concatenate([r[name][1] for r in applies[n_dev]]))
    assert np.abs(out_u - ref_u).max() <= 1e-12 * np.abs(ref_u).max()
    assert np.abs(out_p - ref_p).max() <= 1e-12 * np.abs(ref_p).max()
    # and the unsharded port operator
    T = torch.as_tensor
    tconv = ops.convection_setup(top, T(w), fold=(NU, DT)) if name == "conv" else None
    yu, yp = ops.apply_system(top, NU, DT, tconv, T(u), T(p), mask_rows=False)
    np.testing.assert_allclose(out_u, yu.numpy(), rtol=1e-12, atol=1e-12 * np.abs(ref_u).max())
    np.testing.assert_allclose(out_p, yp.numpy(), rtol=1e-12, atol=1e-12 * np.abs(ref_p).max())
