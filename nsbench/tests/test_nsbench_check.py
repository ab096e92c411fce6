"""The comparison that decides `correct`: sound runs pass it, the control
(the reference in TF32 in the program's place) and the run with its timed
path broken underneath fail it; the seed fixes the inputs."""

import json

import numpy as np
import pytest
from conftest import small_run

from nsbench import harness
from nsbench.reference import check

FAULTS = {
    "duct965k.single": ["unchanged", "node", "pressure", "drag"],
    "sweep47k.b64": ["unchanged", "half", "node", "pressure", "drag"],
}


@pytest.mark.parametrize("workload", sorted(FAULTS))
def test_a_sound_run_is_correct(small, bench, workload):
    r = small_run(bench, small, workload)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("workload,fault", [(w, f) for w, fs in sorted(FAULTS.items()) for f in fs])
def test_a_broken_timed_path_is_not_correct(small, bench, workload, fault):
    """A step that returns its state unchanged; half the members left out;
    one answer altered where it is produced (a velocity node, a pressure
    node, or c_d)."""
    r = small_run(bench, small, workload, fault=fault)
    assert not r["correct"], r["checks"]


def _samples(small, bench, workload, seed):
    cell = harness.find_cell(bench, workload, small)
    cfg, traffic = cell["config"], cell["traffic"]
    arrays = harness.mesh_arrays(cfg)
    prog = harness.Program(cfg, traffic, arrays, "cpu")
    state, first = harness.warm_up(prog, prog.advance, prog.initial_state(seed, cfg, traffic), traffic)
    win = harness.Window(prog, prog.advance, state, 0.2, int(traffic["check_steps"]), seed)
    checker = harness.Checker(cfg, arrays, prog.labels(), "cpu")
    return cell, checker, harness.host_samples([first] + win.reservoir), prog.nus


@pytest.mark.parametrize("workload", sorted(FAULTS))
def test_the_tf32_control_is_not_correct_and_the_float64_witness_is(small, bench, workload):
    cell, checker, samples, nus = _samples(small, bench, workload, 11)
    limits = cell["limits"]["limits"]
    tf32 = checker.control_numbers(samples, nus, "tf32")
    assert not check.verdict(tf32, limits), tf32
    f64 = checker.control_numbers(samples, nus, "float64")
    assert check.verdict(f64, limits), f64


def test_the_same_seed_repeats_the_inputs_and_another_changes_them(bench):
    cfg = harness.find_cell(bench, "sweep47k.b64")["config"]
    traffic = harness.find_cell(bench, "sweep47k.b64")["traffic"]
    x = np.random.default_rng(0).uniform([0, 0, 0], [2.5, 0.41, 0.41], size=(500, 3))
    x[:5, 0] = 0.0  # inlet nodes
    seed = 2**31 + 99
    a = harness.perturbation(x, cfg, traffic, seed, 3)
    assert np.array_equal(a, harness.perturbation(x, cfg, traffic, seed, 3))
    assert not np.allclose(a, harness.perturbation(x, cfg, traffic, seed + 1, 3))
    assert np.all(a[:5] == 0.0)
    assert np.isclose(np.abs(a).max(), traffic["perturbation"]["amplitude"] * 4.0, rtol=1e-12)


def test_the_sweep_viscosities_follow_the_reynolds_numbers(bench):
    cell = harness.find_cell(bench, "sweep47k.b64")
    nus = harness.viscosities(cell["config"], cell["traffic"])
    assert len(nus) == 64
    assert np.allclose(4.0 * 0.1 / nus, np.linspace(20.0, 300.0, 64))
    duct = harness.find_cell(bench, "duct965k.single")
    assert harness.viscosities(duct["config"], duct["traffic"]) is None


def test_the_config_files_hold_the_source_settings(bench):
    """The run configurations as the sources set them (bench.py:128-231,
    scripts/bench_ensemble.py:47-61), with the CSV, VTU and checkpoint
    outputs off."""
    duct = json.load(open(harness.ROOT / "configs" / "dfg3d_2z_965k.json"))
    rc = duct["run_config"]
    assert rc["time"] == dict(rc["time"], dt=2e-4, stepper="projection", convection="implicit", scheme="bdf1")
    assert rc["solver"]["rtol"] == 1e-6 and rc["solver"]["restart"] == 8 and rc["solver"]["maxiter"] == 60
    assert rc["numerics"]["dtype"] == "float32" and rc["output_dir"] is None and rc["output_every"] == 0
    sweep = json.load(open(harness.ROOT / "configs" / "dfg3d_sweep_47k.json"))
    assert sweep["run_config"]["solver"]["maxiter"] == 25 and sweep["mesh"] == dict(generator="cylinder_duct_3d", lc=0.08, nz=6)
    assert duct["mesh"] == dict(generator="cylinder_duct_3d", lc=0.024, nz=14)
