"""The pressure CG replayed as CUDA graphs against the same CG run
eagerly, on the card.

`solvers/krylov.py CGGraphs` captures one CG iteration on the frozen S1
and its two-level preconditioner once per loop and shape, cut at the
layers' spans, and replays it each iteration.  Every form of those
operators the projection step builds is held here: the banded S1 and
the ELL SpMV (`schur_spmv`), the additive and the V(1,1) preconditioner
(`mg2_form`, the latter applying S inside M), the Cholesky factor and
the dense inverse (`coarse_solve`), in float32 and float64; the frozen
factor is applied by the hand-written `coarse_solve` kernel, whose path
every coarse solve's span records.  The replay
runs exactly the kernels of the eager iteration, so iterates, residuals
and iteration counts must be equal bit for bit, over successive solves
with other right-hand sides, and every iteration of a graphed solve is
one replay; under a profiler a replay records the layers' spans and
sizes as the eager iteration does.  The eager reference is the same
Krylov function called without the cache.

These tests need an NVIDIA card and skip without one.  They import
nothing of JAX, so on the card they run without the repository's JAX
test configuration:

    python -m pytest --noconftest -q tests/test_torch_krylov_graphs_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from navierstokes_project_nm4pde_tpu_torch.mesh import cylinder_duct_3d
from navierstokes_project_nm4pde_tpu_torch.models import Cylinder3DProblem, NavierStokesSolver
from navierstokes_project_nm4pde_tpu_torch.parallel import run_ensemble
from navierstokes_project_nm4pde_tpu_torch.solvers import krylov
from navierstokes_project_nm4pde_tpu_torch.utils import profiling

MAXITER = 25
# the forms of the frozen pressure operators: config changes, and whether
# S is the banded matvec
FORMS = {
    "banded": ({}, True),
    "ell": ({"numerics": dict(schur_spmv="ell")}, False),
    "coarse_solve=inv": ({"numerics": dict(coarse_solve="inv")}, True),
    "mg2_form=v11": ({"precond": dict(mg2_form="v11")}, True),
}
CASES = [(form, dtype) for dtype in ("float32", "float64") for form in FORMS]
LAYERS = ("schur.banded_matvec", "precond.coarse_solve")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; off the card no CG graph engages")


def _solver(config):
    return NavierStokesSolver(
        cylinder_duct_3d(lc=0.25, nz=3), Cylinder3DProblem(test_case=2), config, device="cuda",
    )


_SOLVERS: dict = {}


def _duct(form="banded", dtype="float32"):
    """A small duct's solver on the card (the benchmark duct's settings,
    with `form`'s changes), built when a test first asks for it (never at
    import)."""
    _card()
    if (form, dtype) not in _SOLVERS:
        s = _solver(chip_smoke.with_changes(chip_smoke.bench_config(dtype), FORMS[form][0]))
        assert (s.proj_schur.band is not None) == FORMS[form][1]
        assert (s.proj_schur.inv_c is not None) == (form == "coarse_solve=inv")
        _SOLVERS[form, dtype] = s
    return _SOLVERS[form, dtype]


def _operators(s):
    return s._pressure_operators(s.proj_schur)


def _system(s, B, seed):
    """b [n_p, B] over four decades, a guess, and per-member absolute
    targets over four decades of the first residual (the last member runs
    to maxiter)."""
    A, _ = _operators(s)
    n = s.proj_schur.diag1.shape[0]
    rng = np.random.default_rng(seed)
    b = torch.as_tensor(rng.standard_normal((n, B)) * np.logspace(-2, 2, B), dtype=s.dtype, device=s.device)
    x0 = torch.as_tensor(0.1 * rng.standard_normal((n, B)), dtype=s.dtype, device=s.device)
    r0 = krylov._host(krylov._cnorm(b - A(x0), False))
    atol = np.zeros(B)
    atol[: B - 1] = np.logspace(-1, -5, max(B - 1, 1))[: B - 1] * r0[: B - 1]
    return b, x0, atol


@pytest.mark.parametrize("form, dtype, B", [("banded", "float32", 1), ("banded", "float32", 64)]
                         + [(form, dtype, 4) for form, dtype in CASES])
def test_graphed_batched_cg_equals_eager_over_three_solves(form, dtype, B):
    duct = _duct(form, dtype)
    A, M = _operators(duct)
    graphs = krylov.CGGraphs()
    profiling.reset()
    for seed in range(3):
        b, x0, atol = _system(duct, B, 10 * B + seed)
        xe, ie = krylov.cg(A, b, M, x0, rtol=0.0, atol=atol, maxiter=MAXITER, precise=False)
        n0 = graphs.replays
        xg, ig = krylov.cg(A, b, M, x0, rtol=0.0, atol=atol, maxiter=MAXITER, precise=False, graphs=graphs)
        assert torch.equal(xg, xe)
        np.testing.assert_array_equal(ig.iters, ie.iters)
        np.testing.assert_array_equal(ig.residual, ie.residual)
        assert graphs.replays - n0 == ie.iters.max() == MAXITER
        assert B == 1 or len(set(ie.iters.tolist())) > 1
    assert len(graphs._graphs) == 1 and "setup.krylov_graphs" in profiling.setup_seconds()


@pytest.mark.parametrize("form, dtype", CASES)
def test_graphed_recycled_cg_equals_eager_over_three_solves(form, dtype):
    duct = _duct(form, dtype)
    A, M = _operators(duct)
    graphs = krylov.CGGraphs()
    n = duct.proj_schur.diag1.shape[0]
    rng = np.random.default_rng(7)
    poolD = torch.as_tensor(rng.standard_normal((2, n)), dtype=duct.dtype, device=duct.device)
    poolW = A(poolD.T.contiguous()).T.contiguous()
    for seed in range(3):
        b, x0, _ = _system(duct, 1, 100 + seed)
        b, x0 = b[:, 0], x0[:, 0]
        kw = dict(rtol=1e-6, maxiter=MAXITER, precise=False)
        xe, ie, he = krylov.cg_recycled(A, b, M, x0, poolD, poolW, **kw)
        n0 = graphs.replays
        xg, ig, hg = krylov.cg_recycled(A, b, M, x0, poolD, poolW, graphs=graphs, **kw)
        assert torch.equal(xg, xe) and torch.equal(hg, he) and ig == ie
        assert graphs.replays - n0 == ie.iters > 0
        poolD, poolW = torch.stack([he[0], poolD[0]]), torch.stack([he[1], poolW[0]])  # the step's recycling
    # the capture's cuts: the loop starts with A(p), so no graph before the first span
    (cuts, _), = graphs._graphs.values()
    mv, coarse = "schur.banded_matvec", "precond.coarse_solve"
    layers = {"ell": [coarse], "mg2_form=v11": [mv, mv, coarse, mv]}.get(form, [mv, coarse])
    expected = [x for layer in layers for x in (layer, None)]
    assert [name for name, _, _ in cuts.parts] == (expected if form != "ell" else [None, *expected])


@pytest.mark.parametrize("form, dtype", CASES)
def test_a_replay_records_the_layers_spans_and_sizes_as_an_eager_iteration(form, dtype, monkeypatch, tmp_path):
    """Under a profiler, a graphed solve records the same layer spans with
    the same sizes as its eager twin, and the benchmark's roofline readers
    find each layer's kernels inside its spans in both traces."""
    from types import SimpleNamespace

    from nsbench.metrics import coarse_solve_roofline, schur_matvec_roofline
    from nsbench.trace import Trace

    monkeypatch.setattr(profiling, "PREFIX", "nsbench.program.")  # as the benchmark's readers set it
    duct = _duct(form, dtype)
    A, M = _operators(duct)
    graphs = krylov.CGGraphs()
    b, x0, atol = _system(duct, 4, 3)
    kw = dict(rtol=0.0, atol=atol, maxiter=MAXITER, precise=False)
    krylov.cg(A, b, M, x0, graphs=graphs, **kw)  # the capture, outside the trace
    recorded, shares = {}, {}
    for graphed in (False, True):
        profiling.reset()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function("nsbench.run"):
                krylov.cg(A, b, M, x0, graphs=graphs if graphed else None, **kw)
                torch.cuda.synchronize()
        prof.export_chrome_trace(str(tmp_path / f"{graphed}.json"))
        ctx = SimpleNamespace(trace=Trace.from_file(str(tmp_path / f"{graphed}.json")))
        recorded[graphed] = {name: profiling.sizes(name) for name in LAYERS}
        shares[graphed] = (schur_matvec_roofline.read(ctx), coarse_solve_roofline.read(ctx))
    assert recorded[True] == recorded[False]
    impls = {c.get("impl") for c in recorded[True]["precond.coarse_solve"]}
    assert impls == ({None} if form == "coarse_solve=inv" else {"kernel"})
    m = MAXITER + 1  # the applications of A and of M: the start's and one an iteration
    assert len(recorded[True]["precond.coarse_solve"]) == m
    assert len(recorded[True]["schur.banded_matvec"]) == {"ell": 0, "mg2_form=v11": 3 * m}.get(form, m)
    for graphed in (False, True):
        matvec, coarse = shares[graphed]
        assert coarse is not None and coarse > 0
        assert (matvec is None) == (form == "ell") and (form == "ell" or matvec > 0)


@pytest.mark.parametrize("form, dtype", CASES)
def test_a_graphed_ensemble_equals_its_eager_run(monkeypatch, form, dtype):
    """Three ensemble steps (element passes by kernels C and D, which
    repeat exactly) with the pressure CG graphed and eager: equal states
    and counts, and every lockstep S iteration a replay."""
    _card()
    nus = np.array([1e-3, 2e-3, 3e-3, 5e-3])
    config = chip_smoke.with_changes(chip_smoke.ensemble_config(dtype), FORMS[form][0])

    def run(graphed):
        s = _solver(config)
        if not graphed:
            monkeypatch.setattr(s, "_s_graphs", lambda fz: {})
        return run_ensemble(s, nus, 3)

    (sg, dg), (se, de) = run(True), run(False)
    assert torch.equal(sg.u, se.u) and torch.equal(sg.p, se.p)
    np.testing.assert_array_equal(dg.iters_s, de.iters_s)
    np.testing.assert_array_equal(dg.iters_f, de.iters_f)
    np.testing.assert_array_equal(dg.graphed_s, np.broadcast_to(de.iters_s.max(axis=0), de.iters_s.shape))
    assert not de.graphed_s.any() and dg.graphed_s.min() > 0


def test_a_single_run_replays_every_pressure_iteration_and_no_velocity_one():
    """The duct's recycled CG, and the explicit-convection CG on F, whose
    operator changes every step and is never graphed."""
    _, d = _duct().run(3)
    np.testing.assert_array_equal(d.graphed_s, d.iters_s)
    cfg = chip_smoke.bench_config()
    cfg = dataclasses.replace(cfg, time=dataclasses.replace(cfg.time, convection="explicit"))
    _, d = _solver(cfg).run(3)
    assert np.all(d.iters_f > 0) and np.all(d.iters_s > 0)
    np.testing.assert_array_equal(d.graphed_s, d.iters_s)


@pytest.mark.parametrize("proj_schur", ["frozen", "step"])
def test_every_coarse_solve_of_a_run_records_its_path(proj_schur):
    """Under a profiler, two steps of the duct: on the frozen S1 every
    coarse solve, eager or replayed, is the `coarse_solve` kernel and no
    cuBLAS triangular solve runs; a per-step S~ (proj_schur="step") keeps
    `torch.cholesky_solve`."""
    if proj_schur == "frozen":
        s = _duct()
    else:
        _card()
        s = _solver(chip_smoke.with_changes(chip_smoke.bench_config(), {"numerics": dict(proj_schur="step")}))
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        s.run(2)
        torch.cuda.synchronize()
    calls = profiling.sizes("precond.coarse_solve")
    impl = {"frozen": "kernel", "step": "cholesky_solve"}[proj_schur]
    assert calls and {c["impl"] for c in calls} == {impl}
    kernels = {e.key for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA}
    assert any("coarse_trimv" in k for k in kernels) == (proj_schur == "frozen")
    assert any("trsv" in k for k in kernels) == (proj_schur == "step")


def test_a_capture_leaves_only_its_static_tensors_allocated():
    """The capture's cuBLAS workspaces (one a stream) are dropped again: after
    a graphed solve and an eager cuBLAS call, the allocated bytes exceed
    those before by the graph's static tensors alone."""
    duct = _duct()
    A, M = _operators(duct)
    graphs = krylov.CGGraphs()
    b, x0, atol = _system(duct, 64, 5)
    krylov.cg(A, b, M, x0, rtol=0.0, atol=atol, maxiter=MAXITER, precise=False)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    x, _ = krylov.cg(A, b, M, x0, rtol=0.0, atol=atol, maxiter=MAXITER, precise=False, graphs=graphs)
    y = A(b)  # an eager cuBLAS call on the current stream
    del x, y
    torch.cuda.synchronize()
    (_, static), = graphs._graphs.values()
    held = sum(t.numel() * t.element_size() for t in static)
    assert torch.cuda.memory_allocated() - before <= held + 64 * 1024
