"""The upstream solver's cell, `cyl3d_upstream_142k.mono`: its committed
configuration is the `cylinder3d` entry point's defaults field by field;
the harness finds its limits, its speed metrics and its per-layer metrics;
on the small duct a sound run is correct and a run with the timed path
broken underneath is not; its three readers read hand-worked values on a
hand-made trace and nothing where the program has no such spans; a traced
run on the CPU opens the spans, and on the card reads each metric."""

import dataclasses
import inspect
import json
import time
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
from conftest import small_run

from nsbench import harness, program_spans
from nsbench.roofline import HBM_BYTES_PER_S
from nsbench.trace import Trace

CELL = "cyl3d_upstream_142k.mono"
CONFIG = "cyl3d_upstream_142k"
# the host's pace spread its wall metrics past half their bound between processes: timed on the device
SPEED = {"device_ms_per_step", "peak_mem_gib", "setup_s"}
NEW = ("precond_launches_per_apply", "precond_idle_share", "schur_ell_roofline")
SIBLINGS = ("device_idle_share", "launches_per_step", "krylov_iters_per_step", "host_syncs_per_step",
            "krylov_idle_share", "element_pass_roofline")
LAYER = {"setup_solver_s", *NEW, *(f"{name}.device" for name in SIBLINGS)}


def _defaults():
    from navierstokes_project_nm4pde_tpu_torch import cli

    return cli._parser().parse_args(["cylinder3d"]), cli


def test_the_configuration_is_the_entry_points_defaults():
    args, cli = _defaults()
    cfg = harness.load_named("configs", CONFIG)
    assert cfg["name"] == CONFIG and cfg["reduced"] == [] and len(cfg["source"]) <= 200
    rc = dataclasses.asdict(cli._build_config(args, None))
    assert cfg["run_config"].keys() == rc.keys()
    for part, value in rc.items():
        assert cfg["run_config"][part] == value, part
    assert harness.run_config(cfg) == cli._build_config(args, None)
    assert cfg["mesh"] == dict(generator="cylinder_duct_3d", lc=args.lc, nz=args.nz)
    # the problem _run_cylinder(dim=3) builds at the defaults: no --nu, no --u-m
    from navierstokes_project_nm4pde_tpu_torch.models import Cylinder3DProblem

    pp = cfg["problem"]["program"]
    assert pp["factory"] == "Cylinder3DProblem" and args.nu is None and args.u_m is None
    sig = inspect.signature(Cylinder3DProblem).parameters
    assert pp["args"] == dict(test_case=args.test_case, nu=sig["nu"].default, u_m=sig["u_m"].default)
    assert cfg["problem"] == harness.load_named("configs", "dfg3d_2z_965k")["problem"]
    # the mesh's 142,692 unknowns: 3 (vertices + edges) velocity and a pressure a vertex
    coords, cells = harness.mesh_arrays(cfg)[:2]
    edges = np.unique(np.sort(cells[:, [[i, j] for i in range(4) for j in range(i + 1, 4)]].reshape(-1, 2), 1), axis=0)
    assert 4 * coords.shape[0] + 3 * edges.shape[0] == 142_692


def test_the_cell_finds_its_limits_and_metrics(bench):
    cell = harness.find_cell(bench, CELL)
    assert cell["chips"] == 1 and cell["config"]["name"] == CONFIG
    assert cell["traffic"] == harness.load_named("traffic", "single_perturbed")
    assert cell["limits"]["limits"] == dict(mom=3e-4, mom_row=5e-3, div=3e-6, c_d=1e-5, c_l=5e-6, delta_p=1.5e-5)
    assert {m["name"] for m in cell["end_to_end"]} == SPEED
    assert {m["name"] for m in cell["per_layer"]} == LAYER
    for m in cell["per_layer"]:
        assert hasattr(harness.load_reader(m["name"]), "read")
    # the other cells read none of the new metrics
    for other in ("duct965k.single", "sweep47k.b64"):
        assert not {m["name"] for m in harness.find_cell(bench, other)["per_layer"]} & set(NEW)


def test_the_device_siblings_read_as_their_base_readers():
    import importlib

    for name in SIBLINGS:
        sib, base = harness.load_reader(f"{name}.device"), importlib.import_module(f"nsbench.metrics.{name}")
        if name == "element_pass_roofline":  # the harness's span, under the sibling's own name
            assert (sib.SPAN, sib.cost) == (base.SPAN, base.cost) and sib.NAME == f"{name}.device"
        else:
            assert sib.read is base.read


@pytest.mark.parametrize("seed", [2**31 + 7, 5])
def test_a_sound_run_on_the_small_duct_is_correct(small, bench, seed):
    r = small_run(bench, small, CELL, seed=seed)
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert set(r["metrics"]) == SPEED - {"device_ms_per_step"}  # read on the card only


@pytest.mark.parametrize("fault", ["unchanged", "node", "pressure", "drag"])
def test_a_broken_step_is_not_correct(small, bench, fault):
    r = small_run(bench, small, CELL, fault=fault)
    assert not r["correct"], r["checks"]


# ----------------------------------------------------------------------
# The readers on a hand-made trace
# ----------------------------------------------------------------------
def _ev(name, cat, ts, dur, tid=1, corr=None):
    e = dict(ph="X", name=name, cat=cat, ts=ts, dur=dur, pid=1, tid=tid)
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace(tmp_path, spans=True):
    """Two applications [100, 400] and [600, 800], each holding a Schur
    matvec; four launches, the third a graph of two kernels, the fourth
    outside every span."""
    ev = [
        _ev("nsbench.run", "user_annotation", 0, 1000),
        _ev("nsbench.step", "user_annotation", 0, 500),
        _ev("nsbench.step", "user_annotation", 500, 500),
        _ev("cudaLaunchKernel", "cuda_runtime", 160, 5, corr=1),
        _ev("cudaLaunchKernel", "cuda_runtime", 300, 5, corr=2),
        _ev("cudaGraphLaunch", "cuda_runtime", 660, 5, corr=3),
        _ev("cudaLaunchKernel", "cuda_runtime", 900, 5, corr=4),
        _ev("K1", "kernel", 170, 50, tid=7, corr=1),
        _ev("K2", "kernel", 310, 40, tid=7, corr=2),
        _ev("K3", "kernel", 670, 20, tid=7, corr=3),
        _ev("K3b", "kernel", 695, 10, tid=7, corr=3),
        _ev("K4", "kernel", 910, 30, tid=7, corr=4),
    ]
    if spans:
        ev += [
            _ev("nsbench.program.precond.apply", "user_annotation", 100, 300),
            _ev("nsbench.program.precond.apply", "user_annotation", 600, 200),
            _ev("nsbench.program.schur.ell_matvec", "user_annotation", 150, 50),
            _ev("nsbench.program.schur.ell_matvec", "user_annotation", 650, 50),
        ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    return Trace.from_file(str(p))


ELL = dict(rows=(10, 2), width=(4, 40), n_p=12, cols=1, vcols=1, itemsize=4, index_itemsize=8)


def _ctx(tr, monkeypatch, sizes=None):
    sizes = {"schur.ell_matvec": [ELL, ELL]} if sizes is None else sizes
    fake = SimpleNamespace(sizes=lambda name: list(sizes.get(name, [])), setup_seconds=dict)
    monkeypatch.setattr(program_spans, "profiling", fake)
    ctx = harness.Context(True)
    ctx.trace = tr
    return ctx


def test_the_schur_ell_bytes_by_hand():
    r = harness.load_reader("schur_ell_roofline")
    # slots 10*4 + 2*40 = 120: values 120*4 = 480, columns 120*8 = 960, p in and out 2*12*4 = 96
    assert r.cost(ELL) == (1536, 240, 4)
    # one set of values a column: values 120*3*8 = 2880, columns 960, p 2*12*3*8 = 576
    assert r.cost(dict(ELL, cols=3, vcols=3, itemsize=8)) == (4416, 720, 8)


def test_the_new_readers_by_hand(tmp_path, monkeypatch):
    ctx = _ctx(_trace(tmp_path), monkeypatch)
    # K1, K2 in the first application; K3 and K3b (one graph launch) in the second
    assert harness.load_reader("precond_launches_per_apply").read(ctx) == 2.0
    # 500 us inside the applications, 120 of them busy: 380 us idle of 1000
    assert abs(harness.load_reader("precond_idle_share").read(ctx) - 38.0) < 1e-9
    # K1 (50 us) and K3 + K3b (30 us) launched in the matvecs
    share = harness.load_reader("schur_ell_roofline").read(ctx)
    assert abs(share - 100.0 * 2 * (1536 / HBM_BYTES_PER_S) / 80e-6) < 1e-9


def test_the_element_pass_sibling_reads_its_own_span(tmp_path):
    ev = [
        _ev("nsbench.run", "user_annotation", 0, 1000),
        _ev("nsbench.element_pass_roofline.device", "user_annotation", 100, 100),
        _ev("cudaLaunchKernel", "cuda_runtime", 120, 5, corr=1),
        _ev("K1", "kernel", 150, 50, tid=7, corr=1),
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    ctx = harness.Context(True)
    ctx.trace = Trace.from_file(str(p))
    ctx.calls = {"element_pass_roofline.device": [(3.35e6, 0.0, 4)]}  # 1 us of bytes in 50 us
    assert abs(harness.load_reader("element_pass_roofline.device").read(ctx) - 2.0) < 1e-9
    ctx.calls = {"element_pass_roofline": [(3.35e6, 0.0, 4)]}  # the base's name: not this metric's span
    assert harness.load_reader("element_pass_roofline.device").read(ctx) is None


def test_the_new_readers_read_nothing_without_the_spans(tmp_path, monkeypatch):
    bare = _ctx(_trace(tmp_path, spans=False), monkeypatch)  # an older program's trace
    for name in NEW:
        assert harness.load_reader(name).read(bare) is None
    ctx = _ctx(_trace(tmp_path), monkeypatch, sizes={"schur.ell_matvec": [ELL]})
    assert harness.load_reader("schur_ell_roofline").read(ctx) is None  # 1 call, 2 spans
    monkeypatch.setattr(program_spans, "profiling", None)  # a program without spans of its own
    for name in NEW:
        assert harness.load_reader(name).read(ctx) is None


# ----------------------------------------------------------------------
# Traced runs
# ----------------------------------------------------------------------
def test_a_traced_run_on_the_cpu_opens_the_spans(small, bench):
    """The CPU has no device activity: the device readers read nothing and
    are left out, never 0; the program's spans opened in the traced block."""
    from navierstokes_project_nm4pde_tpu_torch.utils import profiling

    profiling.reset()
    r = small_run(bench, small, CELL, trace=True)
    assert r["correct"] and set(r["metrics"]) == {"krylov_iters_per_step.device"}
    apply_calls = profiling.sizes("precond.apply")
    assert apply_calls and len(profiling.sizes("precond.f_solve")) == 2 * len(apply_calls)
    assert len(profiling.sizes("schur.ell_matvec")) == 30 * len(apply_calls)


def test_a_traced_run_on_the_card_reads_every_metric(card, small, bench):
    with mock.patch.object(harness, "MIN_WINDOW_STEPS", 1):
        r = harness.run(CELL, 2**31 + 11, 0.3, True, time.perf_counter(), bench=bench, root=small,
                        log=lambda msg: None)
    assert r["correct"]
    assert set(r["metrics"]) == LAYER
    for name in NEW:
        assert 0.0 < r["metrics"][name]["value"]
    assert r["metrics"]["schur_ell_roofline"]["value"] <= 100.0
