"""The ensemble's per-member element product (`ops/onehot.py
member_product`, kernel G on the card) on the CPU, where its plain version
runs.

    y_e[e, i, c, b] = sum_j F_e[j, e, i, b] x_e[e, j, c, b]

Its two input modes, an element view x_e (here a channel slice of a wider
gathered view, read with its strides) and node rows u with the slot gather
fused in, are held against one `einsum` of the same product for P2
tetrahedra (nloc 10, 3 channels) and triangles (nloc 6, 2 channels) at
B = 1, 3 and 64 members: the same terms summed in another order, so within
1e-6 of max |einsum| in float32 and 1e-13 in float64.  The node-row mode
equals the element-view mode on the gathered view bit for bit.  Then
`apply_F` on a member ensemble (the small duct and the 2D channel) is the
same whether it is handed u alone (the node-row mode) or u with its
element view `gather_u(op, u)`, in float64 and in the preconditioners'
bfloat16 mode, and launches no kernel on the CPU.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from navierstokes_project_nm4pde_tpu_torch.mesh import cylinder_channel_2d, cylinder_duct_3d
from navierstokes_project_nm4pde_tpu_torch.models import (
    Cylinder2DProblem,
    Cylinder3DProblem,
    NavierStokesSolver,
)
from navierstokes_project_nm4pde_tpu_torch.ops import onehot as oh
from navierstokes_project_nm4pde_tpu_torch.ops import operators as ops

RTOL = {torch.float32: 1e-6, torch.float64: 1e-13}
# nloc -> channels a node: P2 tetrahedra carry 3 velocity components, P2
# triangles 2
CHANNELS = {10: 3, 6: 2}


def _inputs(nloc, B, dtype, seed=0):
    """F_e [nloc, E, nloc, B], node rows u [n, C, B], a cell table whose
    cells hold distinct nodes, and u's gathered element view, taken as the
    middle channel block of a [E, nloc, 3 C, B] stacked view."""
    rng = np.random.default_rng(seed)
    E, n, C = 37, 60, CHANNELS[nloc]
    cells = np.stack([rng.choice(n, nloc, replace=False) for _ in range(E)])
    F_e = torch.as_tensor(rng.normal(size=(nloc, E, nloc, B)), dtype=dtype)
    u = torch.as_tensor(rng.normal(size=(n, C, B)), dtype=dtype)
    wide = torch.cat([torch.zeros_like(u), u, torch.ones_like(u)], dim=1)
    x_e = wide[torch.as_tensor(cells)][:, :, C:2 * C]
    return F_e, u, oh.build_onehot_plans(cells, n, device="cpu"), x_e


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [1, 3, 64])
@pytest.mark.parametrize("nloc", [10, 6])
@pytest.mark.parametrize("mode", ["element view", "node rows"])
def test_member_product_matches_einsum(mode, nloc, B, dtype):
    F_e, u, plans, x_e = _inputs(nloc, B, dtype)
    assert not x_e.is_contiguous()
    ref = torch.einsum("jeib,ejcb->eicb", F_e, x_e)
    before = dict(oh.launch_counts)
    y = oh.member_product(F_e, x_e) if mode == "element view" else oh.member_product(F_e, u, plans)
    assert oh.launch_counts == before  # the CPU runs the plain version
    assert y.shape == ref.shape and y.dtype == dtype
    assert float((y - ref).abs().max()) <= RTOL[dtype] * float(ref.abs().max())
    if mode == "node rows":
        assert torch.equal(y, oh.member_product_plain(F_e, x_e))


def _solver(dim):
    if dim == 3:
        mesh, problem = cylinder_duct_3d(lc=0.25, nz=3), Cylinder3DProblem(test_case=2)
    else:
        mesh, problem = cylinder_channel_2d(lc=0.12), Cylinder2DProblem(test_case=2)
    return NavierStokesSolver(mesh, problem, chip_smoke.ensemble_config("float64"), device="cpu")


@pytest.fixture(scope="module", params=[3, 2], ids=["duct", "channel"])
def member_op(request):
    """A member ensemble's operator (3 members) and its folded convection."""
    op = _solver(request.param).op
    rng = np.random.default_rng(5)
    n, d, B = op.n_unodes, op.dim, 3
    w = torch.as_tensor(rng.normal(size=(n, d, B)))
    nu = torch.tensor([1e-3, 4e-3, 2e-2], dtype=torch.float64)
    dt = 2e-4
    conv = ops.convection_setup(op, w, fold=(nu, dt))
    assert conv.F_e.dim() == 4 and conv.F_e.shape[0] == {3: 10, 2: 6}[d]
    return op, nu, dt, conv, torch.as_tensor(rng.normal(size=(n, d, B)))


@pytest.mark.parametrize("lowp", [False, True], ids=["float64", "bfloat16"])
def test_apply_F_from_node_rows_equals_from_the_element_view(member_op, lowp):
    op, nu, dt, conv, u = member_op
    if lowp:
        u = u.to(torch.bfloat16)
    before = dict(oh.launch_counts)
    y_rows = ops.apply_F(op, nu, dt, conv, u)
    y_view = ops.apply_F(op, nu, dt, conv, u, u_e=ops.gather_u(op, u.to(op.MHAT.dtype)))
    assert oh.launch_counts == before
    assert y_rows.dtype == u.dtype and y_rows.shape == u.shape
    assert torch.equal(y_rows, y_view)
