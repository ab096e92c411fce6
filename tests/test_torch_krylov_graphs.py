"""The CG loop's in-place iteration bodies and the device-side stop mask,
on the CPU, and one system as the batch of one.

`solvers/krylov.py` runs each CG iteration as one function that updates
the loop's tensors in place: for one system the mask-free body, for B > 1
columns the masked body, which decides on the device which members
iterate, from float64 residuals and tolerances.  Here both bodies
are held bit for bit to copies of the loops they replaced (the host's
mask copied to the device every iteration; the functional single-vector
loop), on the small duct's frozen S1 and two-level preconditioner and on
a float64 system, with members stopping at different iterations and one
at maxiter; and each solver's call on one vector to its call on the B = 1
column.  And no CUDA graph engages off the card, with a process
group, or for the explicit-convection CG on F (`graphed_s` stays 0), and
a capture cut at the layers' spans (with a stand-in for the graphs)
replays those spans with the sizes of an eager iteration.  The graphed
loop itself runs only on the card:
`tests/test_torch_krylov_graphs_cuda.py`.
"""

import contextlib
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from navierstokes_project_nm4pde_tpu_torch.mesh import cylinder_duct_3d
from navierstokes_project_nm4pde_tpu_torch.models import Cylinder3DProblem, NavierStokesSolver
from navierstokes_project_nm4pde_tpu_torch.ops.banded import banded_matvec
from navierstokes_project_nm4pde_tpu_torch.ops.coarse import cho_w_solve_c, twolevel_apply_additive_g
from navierstokes_project_nm4pde_tpu_torch.parallel import run_ensemble
from navierstokes_project_nm4pde_tpu_torch.solvers import krylov
from navierstokes_project_nm4pde_tpu_torch.solvers.krylov import (
    SolveInfo,
    _cdot,
    _cnorm,
    _dot,
    _dot2,
    _host,
    _norm,
)
from navierstokes_project_nm4pde_tpu_torch.utils import profiling


# ----------------------------------------------------------------------
# The loops as they were: the host's mask copied to the device every
# iteration, and the functional single-vector loop
# ----------------------------------------------------------------------
def _host_mask_cg_columns(A, M, b, x, r, rtol, atol, maxiter, precise):
    B = b.shape[1]
    z = M(r)
    p = z
    rz, rr = _cdot(z, r, precise), _cdot(r, r, precise)
    res = _host(torch.sqrt(rr))
    bnorm = _host(_cnorm(b, precise))
    tol = np.maximum(rtol * bnorm, np.broadcast_to(np.asarray(atol, np.float64), (B,)))
    k = np.zeros(B, np.int64)
    active = (res > tol) & (k < maxiter)
    while active.any():
        on = torch.as_tensor(active, device=b.device)
        Ap = A(p)
        alpha = rz / _cdot(p, Ap, precise)
        x = torch.where(on, x + alpha * p, x)
        r_new = r - alpha * Ap
        z = M(r_new)
        rz_new, rr = _cdot(z, r_new, precise), _cdot(r_new, r_new, precise)
        p = torch.where(on, z + (rz_new / rz) * p, p)
        r = torch.where(on, r_new, r)
        rz = torch.where(on, rz_new, rz)
        res = np.where(active, _host(torch.sqrt(rr)), res)
        k = k + active
        active = (res > tol) & (k < maxiter)
    return x, r, SolveInfo(iters=k, residual=res)


def _functional_cg_vector(A, M, x, r, tol, maxiter, precise):
    z = M(r)
    p = z
    rz, rr = _dot2(z, r, precise)
    res = float(torch.sqrt(rr))
    j = 0
    while res > tol and j < maxiter:
        Ap = A(p)
        alpha = rz / _dot(p, Ap, precise)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new, rr = _dot2(z, r, precise)
        p = z + (rz_new / rz) * p
        rz = rz_new
        res = float(torch.sqrt(rr))
        j += 1
    return x, r, j, res


# ----------------------------------------------------------------------
# Operators: the small duct's frozen S1 and preconditioner, or a float64
# SPD matrix with a Jacobi preconditioner
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def duct():
    return NavierStokesSolver(
        cylinder_duct_3d(lc=0.25, nz=3), Cylinder3DProblem(test_case=2), chip_smoke.bench_config(), device="cpu",
    )


def _operators(kind, duct):
    if kind == "frozen S1":
        fz, cs = duct.proj_schur, duct.op.coarse
        solve_c = cho_w_solve_c(fz.cho_w)
        return (lambda v: banded_matvec(fz.band, v)), (lambda v: twolevel_apply_additive_g(cs, solve_c, fz.inv_d, v)), \
            fz.diag1.shape[0], fz.diag1.dtype, False
    n = 60
    rng = np.random.default_rng(5)
    Q = rng.standard_normal((n, n))
    K = torch.as_tensor(Q @ Q.T + n * np.diag(rng.uniform(0.5, 20.0, n)))
    inv = 1.0 / torch.diagonal(K)
    return (lambda v: K @ v), (lambda v: inv.reshape(-1, *(1,) * (v.dim() - 1)) * v), n, torch.float64, True


def _columns(n, B, dtype, seed):
    rng = np.random.default_rng(seed)
    b = torch.as_tensor(rng.standard_normal((n, B)) * np.logspace(-2, 2, B), dtype=dtype)
    x0 = torch.as_tensor(0.1 * rng.standard_normal((n, B)), dtype=dtype)
    return b, x0


@pytest.mark.parametrize("B", [1, 4, 9])
@pytest.mark.parametrize("kind", ["frozen S1", "float64 SPD"])
def test_the_device_mask_takes_the_host_masks_iterates_and_counts(duct, kind, B):
    A, M, n, dtype, precise = _operators(kind, duct)
    b, x0 = _columns(n, B, dtype, seed=B)
    # members stop at different iterations: each at its own share of its
    # first residual, over four decades; the last runs to maxiter
    maxiter = 25
    r0 = b - A(x0)
    atol = np.zeros(B)
    atol[: B - 1] = np.logspace(-1, -5, B - 1) * _host(_cnorm(r0, precise))[: B - 1]
    if B == 1:  # one vector's call: the mask-free body
        x, r, info = krylov._cg_loop(A, M, b[:, 0], x0[:, 0], r0[:, 0], 0.0, atol[0], maxiter, precise,
                                     "krylov.cg.iter")
        xo, ro, jo, reso = _functional_cg_vector(A, M, x0[:, 0], r0[:, 0], 0.0, maxiter, precise)
        io = SolveInfo(iters=jo, residual=reso)
    else:
        x, r, info = krylov._cg_loop(A, M, b, x0, r0, 0.0, atol, maxiter, precise, "krylov.cg.iter")
        xo, ro, io = _host_mask_cg_columns(A, M, b, x0, r0, 0.0, atol, maxiter, precise)
    assert torch.equal(x, xo) and torch.equal(r, ro)
    np.testing.assert_array_equal(info.iters, io.iters)
    np.testing.assert_array_equal(info.residual, io.residual)
    assert np.max(info.iters) == maxiter and (B == 1 or len(set(info.iters.tolist())) > 1)
    # the caller's guess and right-hand side are left as they were
    assert torch.equal(x0, _columns(n, B, dtype, seed=B)[1])


@pytest.mark.parametrize("kind", ["frozen S1", "float64 SPD"])
def test_the_single_vector_loop_takes_the_functional_loops_iterates(duct, kind):
    A, M, n, dtype, precise = _operators(kind, duct)
    b, x0 = _columns(n, 1, dtype, seed=3)
    b, x0 = b[:, 0], x0[:, 0]
    rng = np.random.default_rng(4)
    poolD = torch.as_tensor(rng.standard_normal((2, n)), dtype=dtype)
    poolW = A(poolD.T.contiguous()).T.contiguous()
    x_proj, r_proj = _projection(A, b, x0, poolD, poolW, precise)
    tol = 1e-6 * float(_norm(b, precise))
    for maxiter in (4, 40):
        x, info, harvest = krylov.cg_recycled(A, b, M, x0, poolD, poolW, rtol=1e-6, maxiter=maxiter, precise=precise)
        xo, ro, jo, reso = _functional_cg_vector(A, M, x_proj, r_proj, tol, maxiter, precise)
        assert torch.equal(x, xo) and info.iters == jo and info.residual == reso
        assert torch.equal(harvest, torch.stack([xo - x_proj, r_proj - ro]))
    assert 4 < info.iters < 40


def _projection(A, b, x0, poolD, poolW, precise):
    """cg_recycled's iterate and residual after its projection on the pool."""
    k = poolD.shape[0]
    r = b - A(x0)
    S = torch.cat([poolW, r[None, :]], dim=0)
    G = krylov._matvec_dots(S, S.T, precise)
    wn = torch.sqrt(torch.clamp(torch.diagonal(G)[:k], min=0.0))
    sc = torch.where(wn > 0, 1.0 / wn, torch.zeros_like(wn))
    eye = torch.eye(k, dtype=b.dtype)
    Gn = G[:k, :k] * sc[:, None] * sc[None, :] + 1e-5 * eye
    Gn = torch.where((eye > 0) & (wn == 0)[:, None], torch.ones_like(Gn), Gn)
    c = torch.linalg.solve_ex(Gn, G[:k, k] * sc).result
    Dn, Wn = poolD * sc[:, None], poolW * sc[:, None]
    x = x0 + c @ Dn
    r = r - c @ Wn
    c2 = torch.linalg.solve_ex(Gn, krylov._matvec_dots(Wn, r, precise)).result
    return x + c2 @ Dn, r - c2 @ Wn


@pytest.mark.parametrize("method", ["cg", "cg_recycled", "gcr_recycled", "gmres_fixed"])
def test_one_vector_is_the_batch_of_one(method):
    """Each solver's call on one vector b [n] and on its B = 1 column [n, 1]
    (the operators the same products on either) give the same iterate, bit
    for bit, and the same counts."""
    n, k = 60, 3
    rng = np.random.default_rng(7)
    Q = rng.standard_normal((n, n))
    K = torch.as_tensor(Q @ Q.T + n * np.diag(rng.uniform(0.5, 20.0, n)))
    inv = 1.0 / torch.diagonal(K)

    def A(v):  # [n], [n, K] or [n, K, 1]: one matrix product on [n, -1]
        return (K @ v.reshape(n, -1)).reshape(v.shape)

    def M(v):
        return inv.reshape(-1, *(1,) * (v.dim() - 1)) * v

    b = torch.as_tensor(rng.standard_normal(n))
    x0 = torch.as_tensor(0.1 * rng.standard_normal(n))
    poolD = torch.as_tensor(rng.standard_normal((k, n)))
    poolD[-1] = 0.0  # a zero pool row is ignored
    poolW = A(poolD.T.contiguous()).T.contiguous()
    kw = dict(rtol=1e-8, precise=True)
    if method == "cg":
        (xv, iv), (xc, ic) = krylov.cg(A, b, M, x0, **kw), krylov.cg(A, b[:, None], M, x0[:, None], **kw)
        rest_v, rest_c = (), ()
    elif method == "cg_recycled":
        xv, iv, hv = krylov.cg_recycled(A, b, M, x0, poolD, poolW, **kw)
        xc, ic, hc = krylov.cg_recycled(A, b[:, None], M, x0[:, None], poolD[..., None], poolW[..., None], **kw)
        rest_v, rest_c = (hv,), (hc[..., 0],)
    elif method == "gcr_recycled":
        xv, iv, Dv = krylov.gcr_recycled(A, b, M, poolD, tol_mode="b", max_narrow=12, **kw)
        xc, ic, Dc = krylov.gcr_recycled(A, b[:, None], M, poolD[..., None], tol_mode="b", max_narrow=12, **kw)
        rest_v, rest_c = (Dv,), (Dc[..., 0],)
    else:
        xv, xc = krylov.gmres_fixed(A, b, M, iters=8), krylov.gmres_fixed(A, b[:, None], M, iters=8)
        iv = ic = None
        rest_v, rest_c = (), ()
    assert xv.shape == (n,) and xc.shape == (n, 1)
    assert torch.equal(xv, xc[:, 0])
    assert all(torch.equal(u, v) for u, v in zip(rest_v, rest_c))
    if iv is not None:
        assert isinstance(iv.iters, int) and isinstance(iv.residual, float) and iv.iters > 1
        assert iv.iters == int(ic.iters[0]) and iv.residual == float(ic.residual[0])


# ----------------------------------------------------------------------
# Where graphs engage: the pressure CG on the frozen S1, on the card, with
# no process group
# ----------------------------------------------------------------------
def test_no_graph_engages_on_the_cpu(duct):
    assert duct._s_graphs(duct.proj_schur) == {}
    _, d = duct.run(2)
    np.testing.assert_array_equal(d.graphed_s, [0, 0])
    assert d.graphed_s.dtype == np.int64 and np.all(d.iters_s > 0)


def test_an_ensemble_on_the_cpu_replays_nothing():
    s = NavierStokesSolver(
        cylinder_duct_3d(lc=0.25, nz=3), Cylinder3DProblem(test_case=2), chip_smoke.ensemble_config(), device="cpu",
    )
    _, d = run_ensemble(s, np.array([1e-3, 2e-3, 4e-3]), 2)
    assert d.graphed_s.shape == d.iters_s.shape == (3, 2) and not d.graphed_s.any()
    assert s._cg_graphs.replays == 0


def test_a_process_group_or_a_step_schur_keeps_the_eager_loop(duct, monkeypatch):
    # as if on the card: the cache engages only without a process group
    monkeypatch.setattr(duct, "device", torch.device("cuda"))
    assert duct._s_graphs(duct.proj_schur)["graphs"] is duct._cg_graphs
    monkeypatch.setattr(duct.op, "group", object())
    assert duct._s_graphs(duct.proj_schur) == {}
    monkeypatch.setattr(duct.op, "group", None)
    assert duct._s_graphs(None) == {}  # proj_schur="step": no frozen S1


def test_the_explicit_convection_cg_on_f_replays_nothing(monkeypatch):
    """With the cache engaged (as on the card), the pressure CG is handed
    it and the explicit-convection CG on F, whose operator changes every
    step, is not."""
    from navierstokes_project_nm4pde_tpu_torch.models import base

    cfg = chip_smoke.bench_config()
    cfg = dataclasses.replace(cfg, time=dataclasses.replace(cfg.time, convection="explicit"))
    s = NavierStokesSolver(cylinder_duct_3d(lc=0.25, nz=3), Cylinder3DProblem(test_case=2), cfg, device="cpu")
    cache = object()
    monkeypatch.setattr(s, "_s_graphs", lambda fz: {"graphs": cache} if fz is not None else {})
    handed = []

    def spy(solve):
        def call(A, b, *args, **kw):
            handed.append((b.shape[0], kw.pop("graphs", None)))
            return solve(A, b, *args, **kw)
        return call

    monkeypatch.setattr(base, "cg", spy(base.cg))
    monkeypatch.setattr(base, "cg_recycled", spy(base.cg_recycled))
    _, d = s.run(2)
    n_p, n_u = s.proj_schur.diag1.shape[0], s.proj_schur.inv1.shape[0] * 3
    assert np.all(d.iters_f > 0) and not d.graphed_s.any()
    assert handed == [(n_u, None), (n_p, cache)] * 2


def test_inv_d_is_made_once_and_the_cache_is_the_solvers(duct, monkeypatch):
    fz = duct.proj_schur
    assert torch.equal(fz.inv_d, 1.0 / fz.diag1)
    monkeypatch.setattr(duct, "device", torch.device("cuda"))
    assert duct._s_graphs(fz) == {"graphs": duct._cg_graphs}


def test_the_graphed_paths_bookkeeping_with_a_stand_in_graph(duct, monkeypatch):
    """`CGGraphs` on the CPU with a stand-in for the captured graph (a
    replay runs the body on the static tensors): captured once per key,
    loaded with each solve's state, a replay an iteration, and outputs
    that later solves leave alone."""
    def capture(self, body, state):
        static = [t.clone() for t in state]
        return SimpleNamespace(replay=lambda: body(static)), static

    monkeypatch.setattr(krylov.CGGraphs, "_capture", capture)
    monkeypatch.setattr(krylov.torch.cuda, "device", lambda dev: contextlib.nullcontext())
    A, M, n, dtype, precise = _operators("frozen S1", duct)
    graphs = krylov.CGGraphs()
    kept = []
    for seed in range(3):
        b, x0 = _columns(n, 4, dtype, seed)
        xe, ie = krylov.cg(A, b, M, x0, rtol=1e-5, maxiter=25, precise=precise)
        n0 = graphs.replays
        xg, ig = krylov.cg(A, b, M, x0, rtol=1e-5, maxiter=25, precise=precise, graphs=graphs)
        assert torch.equal(xg, xe) and graphs.replays - n0 == ie.iters.max() > 0
        np.testing.assert_array_equal(ig.iters, ie.iters)
        np.testing.assert_array_equal(ig.residual, ie.residual)
        kept.append((xg, xg.clone()))
    assert len(graphs._graphs) == 1
    assert all(torch.equal(a, b) for a, b in kept)


class _StandInGraph:
    """Stands for a captured graph on the CPU: replaying it runs nothing."""

    def capture_begin(self, pool):
        pass

    def capture_end(self):
        pass

    def replay(self):
        pass


@pytest.mark.parametrize("loop", ["masked", "single"])
@pytest.mark.parametrize("form", ["additive", "v11"])
def test_a_capture_is_cut_at_the_layers_spans_and_a_replay_records_them(duct, monkeypatch, form, loop):
    """`_Cuts` ends a graph at each span given sizes and captures the
    span's work as a graph of its own; under a profiler a replay records
    the layers' spans with the sizes an eager iteration records, in the
    same order."""
    monkeypatch.setattr(duct, "config", dataclasses.replace(
        duct.config, precond=dataclasses.replace(duct.config.precond, mg2_form=form)))
    A, M = duct._pressure_operators(duct.proj_schur)
    n = duct.proj_schur.diag1.shape[0]
    b, x0 = _columns(n, 4 if loop == "masked" else 1, duct.dtype, seed=2)
    r = b - A(x0)
    z = M(r)
    rz, rr = _cdot(z, r, False), _cdot(r, r, False)
    if loop == "masked":
        state = [x0, r, z, rz, torch.sqrt(rr).double(), torch.zeros(4, dtype=torch.int64),
                 torch.zeros(4, dtype=torch.float64)]
        body = lambda st: krylov._cg_masked_iter(A, M, st, maxiter=25, precise=False)  # noqa: E731
    else:
        state = [t[:, 0].clone() for t in (x0, r, z)] + [rz[0].clone(), torch.sqrt(rr[0])]
        body = lambda st: krylov._cg_single_iter(A, M, st, precise=False)  # noqa: E731
    def traced(run):
        profiling.reset()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            run()
        names = [e.name[len(profiling.PREFIX):] for e in sorted(prof.events(), key=lambda e: e.time_range.start)
                 if e.name.startswith(profiling.PREFIX)]
        return names, {name: profiling.sizes(name) for name in set(names)}

    eager = traced(lambda: body([t.clone() for t in state]))
    cuts = krylov._Cuts(None, graph=_StandInGraph)
    with profiling.cutting(cuts.span):
        cuts.begin()
        body([t.clone() for t in state])
        cuts.end()
    assert eager == traced(cuts.replay)
    order = [name for name, _, _ in cuts.parts]
    layers = ["schur.banded_matvec", "precond.coarse_solve"]
    if form == "v11":  # M = Jacobi, S, the coarse solve, S
        layers = ["schur.banded_matvec", "schur.banded_matvec", "precond.coarse_solve", "schur.banded_matvec"]
    assert eager[0] == layers and order == [None, *(x for layer in layers for x in (layer, None))]
