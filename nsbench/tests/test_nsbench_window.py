"""The window's least number of steps (`harness.MIN_WINDOW_STEPS`) and the
host record in a run's `card`, on a fake step and a fake clock."""

import json
import subprocess
import types

import numpy as np
import pytest
from conftest import SMALL_MEMBERS, small_run

from nsbench import harness


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class Prog:
    def sync(self):
        pass


def fake_step(monkeypatch, step_s):
    """A fake clock in the harness and a step that advances it by
    `step_s(i)` seconds for its i-th call; the state is the step count."""
    clock = Clock()
    monkeypatch.setattr(harness, "time", types.SimpleNamespace(perf_counter=clock))

    def advance(state):
        clock.t += step_s(state)
        return state + 1, {"n": state + 1}

    return advance


def seconds_window(advance, state, seconds, k, seed, clock):
    """The window of `seconds` alone, with the same reservoir sampling."""
    rng = np.random.default_rng([seed, 1])
    reservoir, steps = [], 0
    t0 = clock()
    while True:
        pre = state
        state, d = advance(state)
        steps += 1
        if len(reservoir) < k:
            reservoir.append((pre, state, d))
        elif rng.random() < k / steps:
            reservoir[int(rng.integers(k))] = (pre, state, d)
        if clock() - t0 >= seconds:
            return steps, reservoir


def test_the_window_runs_past_its_seconds_until_the_least_count(monkeypatch):
    advance = fake_step(monkeypatch, lambda i: 0.25)
    win = harness.Window(Prog(), advance, 0, 1.0, 3, 2**31 + 5, min_steps=30)
    assert len(win.step_s) == 30 and win.state == 30
    assert win.seconds == pytest.approx(7.5) and win.seconds >= 1.0
    assert len(win.step_s) / win.seconds == pytest.approx(4.0)
    assert len(win.reservoir) == 3 and all(1 <= pre + 1 == post <= 30 for pre, post, _ in win.reservoir)


@pytest.mark.parametrize("min_steps", [1, 2, 4])
def test_the_seconds_govern_where_the_steps_come_first(monkeypatch, min_steps):
    advance = fake_step(monkeypatch, lambda i: 0.25)
    win = harness.Window(Prog(), advance, 0, 1.0, 3, 7, min_steps=min_steps)
    assert len(win.step_s) == 4 and win.seconds == pytest.approx(1.0)


@pytest.mark.parametrize("seed", [0, 12345, 2**31 + 11])
def test_past_the_least_count_the_window_and_its_sample_are_the_seconds_alone(monkeypatch, seed):
    def step_s(i):
        return 0.001 * (1 + (i * 7919) % 13)

    advance = fake_step(monkeypatch, step_s)
    clock = harness.time.perf_counter
    steps, reservoir = seconds_window(advance, 0, 5.0, 3, seed, clock)
    assert steps > harness.MIN_WINDOW_STEPS
    clock.t = 0.0
    win = harness.Window(Prog(), advance, 0, 5.0, 3, seed, harness.MIN_WINDOW_STEPS)
    assert len(win.step_s) == steps
    assert [r[:2] for r in win.reservoir] == [r[:2] for r in reservoir]


def test_a_run_holds_the_least_count(small, bench):
    # the sweep: the cell that reports steps_per_s (the duct is timed on the device)
    r = small_run(bench, small, "sweep47k.b64", seconds=1e-3, min_steps=6)
    assert r["correct"] and r["window"]["steps"] == 6 and r["attempted"] == 6 * SMALL_MEMBERS
    assert r["metrics"]["steps_per_s"]["value"] == pytest.approx(6 / r["window"]["seconds"])


def test_the_control_windows_hold_the_least_count_too(small, capsys, monkeypatch):
    from nsbench import control

    monkeypatch.setattr(harness, "MIN_WINDOW_STEPS", 5)
    cfg, traffic = small / "configs" / "dfg3d_2z_965k.json", small / "traffic" / "single_perturbed.json"
    args = ["--config", str(cfg), "--traffic", str(traffic), "--seeds", "11", "--seconds", "0.001",
            "--control-seeds", "0", "--device", "cpu"]
    assert control.main(args) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["window"]["steps"] == 5 and row["window"]["failed"] == 0


def _no_nvidia_smi(*args, **kwargs):
    raise FileNotFoundError("nvidia-smi")


def test_card_info_answers_without_nvidia_smi(monkeypatch):
    monkeypatch.setattr(harness.subprocess, "run", _no_nvidia_smi)
    info = harness.card_info()
    assert set(info) == {"host"} and set(info["host"]) <= {"affinity"}
    json.dumps(info)


def test_card_info_reads_the_card_and_the_window_cpu_seconds(monkeypatch):
    def nvidia_smi(cmd, **kwargs):
        assert "--query-gpu=name,power.limit" in cmd
        return subprocess.CompletedProcess(cmd, 0, stdout="NVIDIA Test, 700.00 W\n")

    monkeypatch.setattr(harness.subprocess, "run", nvidia_smi)
    cpu0 = harness.cpu_seconds()
    sum(i * i for i in range(10**5))
    info = harness.card_info(harness.cpu_seconds() - cpu0)
    assert info["name"] == "NVIDIA Test" and info["power_limit"] == "700.00 W"
    assert info["host"]["affinity"] == sorted(harness.os.sched_getaffinity(0))
    assert info["host"]["window_cpu_s"] >= 0
    json.dumps(info)
