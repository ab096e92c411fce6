"""The result line, the refusal without a card, and the module checks."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

from conftest import REPO, small_run

from nsbench import harness

REQUIRED = ["correct", "attempted", "failed", "metrics", "device"]
OPTIONAL = {"breakdown", "card", "window"}


def _keys_ok(r: dict, traced: bool):
    keys = list(r)
    assert keys[:5] == REQUIRED and keys[-1] == "checks"
    assert set(keys[5:-1]) <= OPTIONAL
    assert ("breakdown" in r) == traced
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}


def test_the_result_holds_the_contract_keys_in_order(small, bench):
    r = small_run(bench, small, "duct965k.single")
    _keys_ok(r, traced=False)
    # the duct's device_ms_per_step is read on the card only; off it, the rest
    assert set(r["metrics"]) == {"peak_mem_gib", "setup_s"}
    assert r["correct"] and r["failed"] == 0 and r["attempted"] == r["window"]["steps"] >= 1
    json.dumps(r)


def test_a_traced_run_reports_the_per_layer_metrics_it_finds(small, bench):
    r = small_run(bench, small, "sweep47k.b64", trace=True)
    _keys_ok(r, traced=True)
    # on the CPU only the program's counter has something to read: the
    # device readers return nothing and are left out, never 0
    assert set(r["metrics"]) == {"krylov_iters_per_step"}
    assert r["device"]["busy_s"] == 0.0


def _bench_cmd(cwd, extra_env=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(extra_env or {}))
    return subprocess.run(
        [sys.executable, "-m", "nsbench.run", "--workload", "duct965k.single", "--seed", str(2**31 + 3),
         "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=120,
    )


def test_a_run_without_a_card_fails_and_prints_no_result():
    res = _bench_cmd(REPO)
    assert res.returncode == 3 and res.stdout.strip() == ""
    assert "card" in res.stderr


def test_a_run_fails_where_only_the_benchmark_files_are(tmp_path):
    """A directory with BENCHMARK.json and nsbench/ alone: no program."""
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "nsbench", tmp_path / "nsbench", ignore=shutil.ignore_patterns("__pycache__"))
    res = _bench_cmd(tmp_path)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import types

    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "navierstokes_project_nm4pde_tpu_torch_x", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "navierstokes_project_nm4pde_tpu.ops", types.ModuleType("y"))
    assert harness.forbidden_modules() == ["navierstokes_project_nm4pde_tpu"]


def test_a_run_imports_neither_jax_nor_the_jax_package(tmp_path, bench):
    code = (
        "import sys, time; sys.path.insert(0, 'nsbench/tests'); sys.path.insert(0, '.');"
        "from pathlib import Path; from conftest import small_root, small_run;"
        "from nsbench import harness;"
        f"b = harness.load_json(Path('BENCHMARK.json')); root = small_root(Path({str(tmp_path)!r}), b);"
        "r = small_run(b, root, 'duct965k.single');"
        "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'navierstokes_project_nm4pde_tpu'}), r['correct'])"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[] True"


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_the_reference_imports_nothing_of_the_program_or_jax():
    files = sorted((REPO / "nsbench" / "reference").glob("*.py"))
    assert files
    for f in files:
        bad = _imports(f) & {"jax", "jaxlib", "flax", "navierstokes_project_nm4pde_tpu", "navierstokes_project_nm4pde_tpu_torch"}
        assert not bad, f"{f.name} imports {bad}"
    code = "import sys; sys.path.insert(0, '.'); import nsbench.reference.check, nsbench.reference.dfg3d; print(sorted(m for m in sys.modules if m.startswith('navierstokes') or m.split('.')[0] in ('jax', 'flax')))"
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.stdout.strip() == "[]", res.stderr[-2000:]
