"""The harness finds configurations, traffic mixes, limits and metric
readers by name, and a new file of each kind is picked up with no edit."""

import json
import re

from conftest import small_run

from nsbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_finds_its_files(bench):
    for w in bench["workloads"]:
        cell = harness.find_cell(bench, w["name"])
        assert cell["config"]["name"] == w["config"]
        assert set(cell["limits"]["limits"]) >= {"mom", "mom_row", "div", "c_d", "c_l", "delta_p"}
        e2e = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell["per_layer"]
        for m in cell["per_layer"]:
            assert hasattr(harness.load_reader(m["name"]), "read")
            assert m["moves"] in e2e  # a cell reports what each of its per-layer metrics moves


def test_per_layer_metrics_follow_their_workloads_lists(bench):
    duct = {m["name"] for m in harness.find_cell(bench, "duct965k.single")["per_layer"]}
    sweep = {m["name"] for m in harness.find_cell(bench, "sweep47k.b64")["per_layer"]}
    assert "macro_apply_roofline" in duct and "macro_apply_roofline" not in sweep
    assert "element_pass_roofline" in sweep and "element_pass_roofline" not in duct
    host = {"device_idle_share", "launches_per_step", "krylov_iters_per_step", "host_syncs_per_step", "krylov_graph_share"}
    assert host <= sweep and not host & duct  # the duct's step is timed on the device
    assert {"launches_per_step.device", "krylov_iters_per_step.device", "schur_matvec_roofline.device"} <= duct - sweep
    assert "setup_solver_s" in duct & sweep


def test_benchmark_json_keeps_the_contract_shapes(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in bench[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and len(c["source"]) <= 200
        assert c["file"].startswith("nsbench/") and json.load(open(harness.ROOT.parent / c["file"]))["name"] == c["name"]
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"} and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"} and UNIT.match(m["unit"])
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}


def test_new_files_of_each_kind_are_picked_up_without_an_edit(small, bench):
    """A cell that a later change adds as files only: a configuration, a
    traffic mix, its limits and a per-layer metric of its own."""
    cfg = json.loads((small / "configs" / "dfg3d_sweep_47k.json").read_text())
    cfg["name"] = "dfg3d_sweep_new"
    (small / "configs" / "dfg3d_sweep_new.json").write_text(json.dumps(cfg))
    t = json.loads((small / "traffic" / "sweep_re20_300_b64.json").read_text())
    t["reynolds"] = {"linspace": [50.0, 100.0, 2]}
    (small / "traffic" / "sweep_two.json").write_text(json.dumps(t))
    (small / "limits" / "sweep.new.json").write_text((small / "limits" / "sweep47k.b64.json").read_text())
    (small / "metrics" / "steps_traced.py").write_text(
        "def read(ctx):\n    return float(len(ctx.diags))\n"
    )
    bench = dict(bench)
    bench["workloads"] = bench["workloads"] + [
        {"name": "sweep.new", "config": "dfg3d_sweep_new", "traffic": "sweep_two", "chips": 1, "why": "a test"}
    ]
    bench["per_layer"] = bench["per_layer"] + [
        {"name": "steps_traced", "unit": "steps", "better": "higher", "source": "program_counter",
         "layer": "step driver", "moves": "steps_per_s", "workloads": ["sweep.new"]}
    ]
    r = small_run(bench, small, "sweep.new", trace=True)
    assert r["correct"] and r["metrics"]["steps_traced"]["value"] >= 1
    assert r["attempted"] == 2 * r["window"]["steps"]
