"""The comparison that decides `correct` for the monolithic saddle-point
stepper, on the small duct under the `cylinder3d` entry point's defaults
(the upstream project's solver: BDF1, FGMRES(50) to 1e-6 of the warm
start's residual, the yosida block preconditioner): sound runs pass it;
the control (the reference in TF32 in the program's place) and runs with
the timed path broken underneath fail it; the float64 witness passes.  A
configuration that the check does not cover is refused when its cell is
found, before any mesh or step."""

import dataclasses
import json
import re

import pytest
from conftest import SMALL_MESH, small_run

from nsbench import harness
from nsbench.reference import check

CELL = "cyl3d_upstream.mono"
CONFIG = "cyl3d_upstream_small"
# Set from this small duct's readings (seeds 2**31 + 7, 5, 99, 11; the
# program's largest / the control's in TF32 / the float64 witness):
LIMITS = dict(
    mom=1e-4,  # 3.03e-5 / 7.4e-2 / 4.0e-7; one node off 4.5e-4, one pressure node 9.3e-3
    mom_row=1e-4,  # 3.08e-5 / 3.6e-2 / 3.4e-7; one node off 1.0e-3
    div=4e-6,  # 1.18e-6 (the solver's tolerance) / 3.1e-5 / 4.3e-8
    c_d=2e-6,  # 1.8e-7 / 1.4e-3 / 0; c_d altered 1.0e-3
    c_l=2e-6,  # 1.8e-7 / 2.1e-4 / 0
    delta_p=4e-6,  # 4.1e-7 / 3.1e-3 / 0
)


def mono_config(mesh: dict) -> dict:
    """The `cylinder3d` entry point's configuration at its defaults (the
    port's `cli._build_config`) on the DFG 3D-Z duct of `mesh`."""
    from navierstokes_project_nm4pde_tpu_torch import cli

    args = cli._parser().parse_args(["cylinder3d"])
    duct = harness.load_json(harness.ROOT / "configs" / "dfg3d_2z_965k.json")
    return dict(
        duct, name=CONFIG, source="the cylinder3d entry point's defaults", assumed=[],
        deployment="the upstream project's own solver on the DFG 3D-Z duct",
        mesh=dict(generator="cylinder_duct_3d", **mesh),
        run_config=dataclasses.asdict(cli._build_config(args, None)),
    )


def _with_cell(root, bench, cfg: dict) -> dict:
    """`bench` with a cell of configuration `cfg` under the small traffic
    mix, its files written under `root`."""
    (root / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    (root / "limits" / f"{CELL}.json").write_text(json.dumps(dict(limits=LIMITS)))
    cell = dict(name=CELL, config=cfg["name"], traffic="single_perturbed", chips=1, why="a test")
    return dict(bench, workloads=bench["workloads"] + [cell])


@pytest.fixture
def mono(small, bench):
    return _with_cell(small, bench, mono_config(SMALL_MESH))


def test_the_configuration_is_the_entry_points_monolithic_default(mono, small):
    rc = harness.find_cell(mono, CELL, small)["config"]["run_config"]
    assert rc["time"] == dict(rc["time"], stepper="monolithic", scheme="bdf1", convection="implicit", dt=2e-4)
    assert rc["solver"] == dict(rc["solver"], rtol=1e-6, restart=50, maxiter=200, tol_mode="r0")
    assert rc["precond"] == dict(rc["precond"], kind="yosida", f_iters=6, s_iters=30, f_solver="gmres", s_solver="cg")
    assert rc["numerics"]["dtype"] == "float32" and rc["numerics"]["precise_dots"]


@pytest.mark.parametrize("seed", [2**31 + 7, 5])
def test_a_sound_monolithic_run_is_correct(small, mono, seed):
    r = small_run(mono, small, CELL, seed=seed)
    assert r["correct"] and r["failed"] == 0, r["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "node", "pressure", "drag"])
def test_a_broken_monolithic_step_is_not_correct(small, mono, fault):
    """A step that returns its state unchanged; one answer altered where it
    is produced (a velocity node, a pressure node, or c_d)."""
    r = small_run(mono, small, CELL, fault=fault)
    assert not r["correct"], r["checks"]


def test_the_tf32_control_is_not_correct_and_the_float64_witness_is(small, mono):
    cell = harness.find_cell(mono, CELL, small)
    cfg, traffic = cell["config"], cell["traffic"]
    arrays = harness.mesh_arrays(cfg)
    prog = harness.Program(cfg, traffic, arrays, "cpu")
    state, first = harness.warm_up(prog, prog.advance, prog.initial_state(11, cfg, traffic), traffic)
    win = harness.Window(prog, prog.advance, state, 0.2, int(traffic["check_steps"]), 11)
    checker = harness.Checker(cfg, arrays, prog.labels(), "cpu")
    samples = harness.host_samples([first] + win.reservoir)
    assert checker.scheme.numbers is check.monolithic_numbers
    log = []
    tf32 = checker.control_numbers(samples, None, "tf32", log=log)
    assert not check.verdict(tf32, LIMITS), tf32
    f64 = checker.control_numbers(samples, None, "float64", log=log)
    assert check.verdict(f64, LIMITS), f64
    # each control step reached its tolerance, by GMRES's own measure
    assert len(log) == 2 * len(samples) and all(entry["info"][1] for entry in log), log


@pytest.mark.parametrize("part,key,value", [
    ("time", "scheme", "bdf2"),
    ("time", "convection", "explicit"),
    ("time", "convection", "imex"),
    ("time", "stepper", "fractional_step"),
    ("solver", "tol_mode", "abs"),
    ("mesh", "generator", "cylinder_channel_2d"),
])
def test_a_setting_the_check_does_not_cover_is_refused_before_any_step(small, bench, monkeypatch, part, key, value):
    cfg = mono_config(SMALL_MESH)
    (cfg["mesh"] if part == "mesh" else cfg["run_config"][part])[key] = value
    named = re.escape("dimension=2" if part == "mesh" else f"{part}.{key}={value!r}")

    def no_mesh(cfg):
        raise AssertionError("a mesh was built")

    monkeypatch.setattr(harness, "mesh_arrays", no_mesh)
    mono = _with_cell(small, bench, cfg)
    with pytest.raises(ValueError, match=named):
        harness.find_cell(mono, CELL, small)
    with pytest.raises(ValueError, match=named):
        small_run(mono, small, CELL)


def test_both_existing_cells_keep_the_projection_check(bench):
    assert check.SCHEMES["projection"] == (check.step_numbers, check.control_step)
    for w in bench["workloads"]:
        assert harness.find_cell(bench, w["name"])["config"]["run_config"]["time"]["stepper"] == "projection"
