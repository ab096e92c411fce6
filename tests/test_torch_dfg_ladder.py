"""chip_smoke's checks of the DFG 3D-1Z ladder (`--only dfg_3d1z`,
`dfg_full`, `dfg_drift`, `dfg_3d_spread`), on the CPU, and the script that
makes their reference readings.

- `DFG_3D_JAX`, the JAX package's float64 readings on each rung, against
  the table of VALIDATION.md's DFG 3D-1Z section (the package's float32
  readings on a TPU v5e), parsed from the file: c_d and delta-p within one
  unit of the table's last printed digit, c_l within the rung's float32
  limit (the TPU's float32 reading is one such run);
- `dfg_3d_limits` / `dfg_3d_misses`: every rung has a reference drift (no
  rung falls back to VALIDATION.md's flat 0.2%); the check passes one card
  summary of each rung and the card's earlier drifts at 176,184 DoF, refuses the
  card's run with kernel B's output rounded to TF32 on every rung, sees
  each quantity moved just past its limit, holds c_l and delta-p to the
  published intervals exactly on the DFG_3D_PUBLISHED rungs, and holds a
  float64 run to DFG_3D_F64_TOL;
- tests/dfg3d_reference.py, the script of the reference's runs: both
  packages' float64 runs of 4 steps on the (0.25, 3) duct through it have
  equal F and S counts and coefficients within 1e-10 of max |value|.
"""

import re
from pathlib import Path

import pytest

import chip_smoke
import dfg3d_reference
from navierstokes_project_nm4pde_tpu_torch.validation.dfg3d_validate import PUBLISHED

REPO = Path(__file__).resolve().parents[1]
LADDER = list(chip_smoke.DFG_3D_LADDER)
IDS = [f"{lc}-{nz}" for lc, nz in LADDER]
KEYS = ("cd", "cl", "delta_p")
# the card's float32 summaries of each rung: (c_d, c_l, delta-p, drift) of
# `--only dfg_3d_spread`'s first run and of its run with kernel B's output
# rounded to TF32 (H100 80GB HBM3, 700 W)
CARD = {
    (0.08, 6): (5.649842707316081, -0.002865118576058497, 0.18279906223217646, 0.0016493961098592279),
    (0.05, 10): (5.828457037607829, 0.004655250821573039, 0.1734052123626073, 0.0020641961090204683),
    (0.04, 12): (5.9226071039835615, 0.008505732271199424, 0.172223665813605, 0.001773423747233831),
    (0.03, 16): (6.031044699350993, 0.00959491081070155, 0.17097170352935792, 0.0017544251565016552),
}
CARD_TF32 = {
    (0.08, 6): (5.623940537770589, -0.04169011697173119, 0.1827164829770724, 0.003298893369651767),
    (0.05, 10): (5.839934800465902, 0.01478033629556497, 0.17368164112170537, 0.0024720690033399125),
    (0.04, 12): (5.924242830276489, 0.006823911045988401, 0.17328859706719715, 0.0023828002389271567),
    (0.03, 16): (6.051510060628255, 0.016416887417435647, 0.17191767026980717, 0.0021709193926863282),
}
# the card's float32 drifts at 176,184 DoF under the flat 0.2% limit the
# per-rung check replaced (`--only dfg_3d1z` and `dfg_drift`)
EARLIER_DRIFTS = (0.002077, 0.001951, 0.001940)


def validation_table() -> dict:
    """VALIDATION.md's DFG 3D-1Z ladder: (lc, nz) -> {key: (value, digits
    after the point)}."""
    text = (REPO / "VALIDATION.md").read_text()
    section = text[text.index("## DFG 3D-1Z"):]
    rows = {}
    for m in re.finditer(r"^\| (0\.\d+), (\d+) \| \d+k \| ([^|]+)\| ([^|]+)\| ([^|]+)\|", section, re.M):
        cells = [c.strip().strip("*") for c in m.groups()[2:]]
        rows[(float(m.group(1)), int(m.group(2)))] = {
            k: (float(c), len(c.split(".")[1])) for k, c in zip(KEYS, cells)}
    return rows


def _summary(values) -> dict:
    cd, cl, dp, drift = values
    return dict(cd=cd, cl=cl, delta_p=dp, cd_drift_rel=drift, published=PUBLISHED)


def test_validation_table_parses_the_ladder():
    assert sorted(validation_table()) == sorted(LADDER)
    assert sorted(chip_smoke.DFG_3D_JAX) == sorted(LADDER) == sorted(chip_smoke.DFG_3D_ATOL)


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("rung", LADDER, ids=IDS)
def test_jax_readings_match_validation_table(rung, key):
    value, digits = validation_table()[rung][key]
    ref = chip_smoke.DFG_3D_JAX[rung][key]
    tol = chip_smoke.DFG_3D_ATOL[rung]["cl"] if key == "cl" else 10.0 ** -digits * (1 + 1e-9)
    assert abs(ref - value) <= tol, (ref, value, tol)


@pytest.mark.parametrize("rung", LADDER, ids=IDS)
def test_every_rung_has_a_reference_drift(rung):
    ref = chip_smoke.DFG_3D_JAX[rung]["cd_drift_rel"]
    lo, hi, _ = chip_smoke.dfg_3d_limits(rung)["cd_drift_rel"]
    assert isinstance(ref, float) and 0 < ref < 0.01
    assert hi - ref == pytest.approx(ref - lo) == pytest.approx(chip_smoke.DFG_3D_ATOL[rung]["cd_drift_rel"])


@pytest.mark.parametrize("rung", LADDER, ids=IDS)
def test_ladder_check_passes_a_card_summary(rung):
    assert chip_smoke.dfg_3d_misses("card", rung, _summary(CARD[rung])) == []


@pytest.mark.parametrize("drift", EARLIER_DRIFTS)
def test_drift_check_passes_earlier_card_drifts(drift):
    rung = (0.05, 10)
    assert chip_smoke.dfg_3d_misses("card", rung, {**_summary(CARD[rung]), "cd_drift_rel": drift}) == []


@pytest.mark.parametrize("rung", LADDER, ids=IDS)
def test_ladder_check_refuses_kernel_b_rounded_to_tf32(rung):
    """The card's run with kernel B's output rounded to TF32 misses c_d,
    delta-p and c_l on every rung."""
    misses = chip_smoke.dfg_3d_misses("tf32", rung, _summary(CARD_TF32[rung]))
    assert all(any(f"tf32 {k} " in m and "JAX" in m for m in misses) for k in ("cd", "delta_p", "cl")), misses


@pytest.mark.parametrize("key", ["cd", "delta_p", "cl", "cd_drift_rel"])
@pytest.mark.parametrize("rung", LADDER, ids=IDS)
def test_ladder_check_sees_a_planted_miss(rung, key):
    """Each quantity just inside its limit passes; moved one tolerance past
    the reference's on either side, it is a miss of that quantity."""
    ref = chip_smoke.DFG_3D_JAX[rung][key]
    lo, hi, _ = chip_smoke.dfg_3d_limits(rung)[key]
    s = _summary(CARD[rung])
    inside = {ref + 0.99 * (hi - ref), ref - 0.99 * (ref - lo)}
    if rung in chip_smoke.DFG_3D_PUBLISHED and key in PUBLISHED:
        inside = {v for v in inside if PUBLISHED[key][0] <= v <= PUBLISHED[key][1]}
    for v in inside:
        assert chip_smoke.dfg_3d_misses("planted", rung, {**s, key: v}) == [], v
    for v in (ref + 1.01 * (hi - ref), ref - 1.01 * (ref - lo)):
        misses = chip_smoke.dfg_3d_misses("planted", rung, {**s, key: v})
        assert misses and all(f"planted {key} " in m for m in misses), (v, misses)


@pytest.mark.parametrize("rung", chip_smoke.DFG_3D_PUBLISHED, ids=lambda r: f"{r[0]}-{r[1]}")
def test_published_intervals_are_held_exactly(rung):
    """On the DFG_3D_PUBLISHED rungs c_l and delta-p must lie inside the
    published intervals, to the edge: a reading 1e-7 past an edge is a
    miss of the published interval, one 1e-7 inside is not."""
    for key in ("cl", "delta_p"):
        for edge, side in zip(PUBLISHED[key], (-1, 1)):
            for step, missed in ((-1e-7, False), (1e-7, True)):
                misses = chip_smoke.dfg_3d_misses("edge", rung, {**_summary(CARD[rung]), key: edge + side * step})
                assert any(f"edge {key} " in m and "published" in m for m in misses) is missed, (key, edge, misses)


@pytest.mark.parametrize("rung", LADDER, ids=IDS)
def test_float64_run_is_held_to_its_own_tolerance(rung):
    """A float64 run's limits are DFG_3D_F64_TOL about the reference's,
    inside each float32 limit: the float32 card summary misses them."""
    tol = chip_smoke.DFG_3D_F64_TOL
    ref = chip_smoke.DFG_3D_JAX[rung]
    f32 = chip_smoke.dfg_3d_limits(rung)
    for key, (lo, hi, _) in chip_smoke.dfg_3d_limits(rung, "float64").items():
        half = tol * abs(ref[key]) if key in ("cd", "delta_p") else tol
        assert (lo, hi) == pytest.approx((ref[key] - half, ref[key] + half), rel=1e-15, abs=1e-18)
        assert f32[key][0] < lo < hi < f32[key][1]
    assert chip_smoke.dfg_3d_misses("f64", rung, {**_summary(CARD[rung]), **ref}, "float64") == []
    assert chip_smoke.dfg_3d_misses("f64", rung, _summary(CARD[rung]), "float64")


REFERENCE_FLAGS = ["--lc", "0.25", "--nz", "3", "--dt", "2e-3", "--t-ramp", "0.004", "--t-end", "0.008", "--chunk", "4"]


@pytest.fixture(scope="module")
def reference_runs():
    """tests/dfg3d_reference.py's float64 runs of both packages (4 steps on
    the (0.25, 3) duct): {pkg: (summary, traces)}."""
    return {pkg: dfg3d_reference.run(pkg, "float64", REFERENCE_FLAGS) for pkg in ("jax", "port")}


def test_reference_script_counts_match(reference_runs):
    (js, jt), (ps, pt) = reference_runs["jax"], reference_runs["port"]
    assert (js["pkg"], js["dtype"], ps["pkg"], js["n_steps"], ps["n_steps"]) == ("jax", "float64", "port", 4, 4)
    assert len(jt["c_d"]) == 4 and dfg3d_reference.compare(pt, jt)["counts_equal"]


@pytest.mark.parametrize("key", ["c_d", "c_l", "delta_p"])
def test_reference_script_runs_both_packages_alike(reference_runs, key):
    c = dfg3d_reference.compare(reference_runs["port"][1], reference_runs["jax"][1])[key]
    assert c["of_max"] <= 1e-10 and 1 <= c["step"] <= 4, c
