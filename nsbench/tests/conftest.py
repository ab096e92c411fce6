"""Fixtures of the benchmark's own tests (run from the repo root:
`python -m pytest -q nsbench/tests`).  They run the port's CPU path on a
small duct; tests that need the card take the `card` fixture and skip
without one.  Nothing here imports JAX."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from nsbench import harness  # noqa: E402

SMALL_MESH = dict(lc=0.25, nz=3)  # 248 vertices, 792 cells
SMALL_MEMBERS = 4


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the benchmark's runs never fall back to the CPU")


@pytest.fixture(scope="session")
def bench():
    return harness.load_json(REPO / "BENCHMARK.json")


def small_root(tmp: Path, bench: dict) -> Path:
    """A copy of the benchmark's files with every configuration on the
    small duct, short warm-ups and traced blocks, and a sweep of
    SMALL_MEMBERS members."""
    for d in ("configs", "traffic", "limits"):
        (tmp / d).mkdir()
    shutil.copytree(harness.ROOT / "metrics", tmp / "metrics")
    for w in bench["workloads"]:
        c = harness.load_json(harness.ROOT / "configs" / f"{w['config']}.json")
        c["mesh"].update(SMALL_MESH)
        (tmp / "configs" / f"{w['config']}.json").write_text(json.dumps(c))
        t = harness.load_json(harness.ROOT / "traffic" / f"{w['traffic']}.json")
        t.update(warmup_steps=3, trace_steps=2, sync_steps=1)
        if t.get("reynolds"):
            t["reynolds"]["linspace"][2] = SMALL_MEMBERS
        (tmp / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(t))
        shutil.copy(harness.ROOT / "limits" / f"{w['name']}.json", tmp / "limits")
    return tmp


@pytest.fixture
def small(tmp_path, bench):
    return small_root(tmp_path, bench)


def small_run(bench, root, workload, seed=2**31 + 7, trace=False, fault=None, seconds=0.3, min_steps=1):
    """A run on the CPU, its window held to `min_steps` steps at least in
    place of the cells' MIN_WINDOW_STEPS (240 of the sweep's small CPU
    steps would take most of a minute)."""
    import time
    from unittest import mock

    with mock.patch.object(harness, "MIN_WINDOW_STEPS", min_steps):
        return harness.run(
            workload, seed, seconds, trace, time.perf_counter(), bench=bench, root=root,
            device="cpu", fault=fault, log=lambda msg: None,
        )
