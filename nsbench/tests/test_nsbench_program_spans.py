"""The readers of the program's own spans: the two rooflines' bytes against
hand-worked counts, a hand-made trace holding `nsbench.program.*` spans
(the benchmark's own readers and idle gaps read what they read without
them; the new readers and the phase table read their hand-worked
values), and the phase table of a small run on the CPU."""

import json
from types import SimpleNamespace

from conftest import small_run  # noqa: F401  (puts the repo on sys.path)

from nsbench import harness, phases, program_spans, roofline
from nsbench.trace import Trace


def test_coarse_solve_bytes_by_hand():
    r = harness.load_reader("coarse_solve_roofline")
    # chol: two reads of the lower triangle 2*100*101/2*4 = 40400, rc in and out 2*100*3*4 = 2400
    assert r.cost(dict(nc=100, cols=3, factors=1, itemsize=4, form="chol")) == (42800, 2 * 100 * 100 * 3, 4)
    # inv, one factor a member: 64*100*100*8 = 5120000, rc 2*100*64*8 = 102400
    assert r.cost(dict(nc=100, cols=64, factors=64, itemsize=8, form="inv")) == (5222400, 2 * 100 * 100 * 64, 8)


def test_schur_matvec_bytes_by_hand():
    r = harness.load_reader("schur_matvec_roofline")
    z = dict(blocks=2, rows=128, width=256, n_rows=248, cols=4, itemsize=4)
    # band 2*128*256*4 = 262144, p in and out 2*248*4*4 = 7936, tiles 4*2*256/128 = 16
    assert r.cost(z) == (270096, 2 * 2 * 128 * 256 * 4, 4)


def _ev(name, cat, ts, dur, tid=1, corr=None):
    e = dict(ph="X", name=name, cat=cat, ts=ts, dur=dur, pid=1, tid=tid)
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace(tmp_path):
    """test_the_trace_reading_by_hand's trace with program spans added."""
    ev = [
        _ev("nsbench.run", "user_annotation", 0, 1000),
        _ev("nsbench.step", "user_annotation", 0, 500),
        _ev("nsbench.step", "user_annotation", 500, 500),
        _ev("nsbench.macro_apply_roofline", "user_annotation", 100, 100),
        _ev("cudaLaunchKernel", "cuda_runtime", 120, 5, corr=1),
        _ev("cudaLaunchKernel", "cuda_runtime", 300, 5, corr=2),
        _ev("aten::item", "cpu_op", 380, 70),
        _ev("A", "kernel", 150, 100, tid=7, corr=1),
        _ev("B", "kernel", 310, 90, tid=7, corr=2),
        _ev("copy", "gpu_memcpy", 380, 20, tid=7),
        _ev("nsbench.program.step.f_solve", "user_annotation", 50, 410),
        _ev("nsbench.program.krylov.fgmres.iter", "user_annotation", 100, 190),
        _ev("nsbench.program.precond.coarse_solve", "user_annotation", 110, 20),
        _ev("nsbench.program.schur.banded_matvec", "user_annotation", 295, 15),
        _ev("nsbench.program.host_read", "user_annotation", 375, 80),
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    return Trace.from_file(str(p))


COARSE = dict(nc=100, cols=1, factors=1, itemsize=4, form="chol")
BAND = dict(blocks=2, rows=128, width=256, n_rows=248, cols=1, itemsize=4)


def _ctx(tr, monkeypatch, sizes=None, setup=None):
    sizes = {"precond.coarse_solve": [COARSE], "schur.banded_matvec": [BAND]} if sizes is None else sizes
    fake = SimpleNamespace(sizes=lambda name: list(sizes.get(name, [])), setup_seconds=lambda: dict(setup or {}))
    monkeypatch.setattr(program_spans, "profiling", fake)
    ctx = harness.Context(True)
    ctx.trace = tr
    return ctx


def test_program_spans_leave_the_benchmarks_readings_as_they_were(tmp_path, monkeypatch):
    tr = _trace(tmp_path)
    ctx = _ctx(tr, monkeypatch)
    assert tr.window_s() == 1000e-6 and tr.steps() == 2 and tr.kernel_count() == 2
    assert abs(tr.busy_s() - 190e-6) < 1e-12
    assert abs(tr.span_device_s("macro_apply_roofline") - 100e-6) < 1e-12
    assert tr.top_kernels() == [["A", 100e-6], ["B", 90e-6]]
    assert abs(harness.load_reader("device_idle_share").read(ctx) - 81.0) < 1e-9
    assert harness.load_reader("launches_per_step").read(ctx) == 1.0
    idle = dict(tr.idle_gaps())
    # the same 810 us of gaps; the two that begin inside program spans name them
    assert abs(sum(idle.values()) - 810e-6) < 1e-12
    assert abs(idle["step"] - 150e-6) < 1e-12
    assert abs(idle["program.krylov.fgmres.iter"] - 60e-6) < 1e-12
    assert abs(idle["program.host_read: aten::item"] - 600e-6) < 1e-12


def test_the_new_readers_by_hand(tmp_path, monkeypatch):
    tr = _trace(tmp_path)
    ctx = _ctx(tr, monkeypatch, setup={"setup.operator": 1.5, "setup.macro": 2.0})
    # [100, 290] holds 190 us, kernel A covers 100 of it: 90 us idle of 1000
    assert abs(harness.load_reader("krylov_idle_share").read(ctx) - 9.0) < 1e-9
    # A (100 us) was launched inside the coarse solve; 42800 -> 41200 bytes at one column
    coarse = harness.load_reader("coarse_solve_roofline").read(ctx)
    assert abs(coarse - 100.0 * (41200 / 3.35e12) / 100e-6) < 1e-9
    # B (90 us) inside the matvec: 262144 + 1984 + 16 bytes
    band = harness.load_reader("schur_matvec_roofline").read(ctx)
    assert abs(band - 100.0 * (264144 / 3.35e12) / 90e-6) < 1e-9
    assert harness.load_reader("setup_solver_s").read(ctx) == 3.5


def test_the_readers_read_nothing_they_cannot_match(tmp_path, monkeypatch):
    tr = _trace(tmp_path)
    ctx = _ctx(tr, monkeypatch, sizes={"precond.coarse_solve": [COARSE, COARSE]})
    assert harness.load_reader("coarse_solve_roofline").read(ctx) is None  # 2 calls, 1 span
    assert harness.load_reader("schur_matvec_roofline").read(ctx) is None  # no record
    assert harness.load_reader("setup_solver_s").read(ctx) is None  # no phase
    monkeypatch.setattr(program_spans, "profiling", None)  # a program without spans
    for name in ("setup_solver_s", "krylov_idle_share", "coarse_solve_roofline", "schur_matvec_roofline"):
        assert harness.load_reader(name).read(ctx) is None


def test_the_phase_table_by_hand(tmp_path, monkeypatch):
    tr = _trace(tmp_path)
    _ctx(tr, monkeypatch)
    rows = phases.table(tr)
    k = rows["krylov.fgmres.iter"]  # two steps: each number is half the trace's
    assert k["calls"] == 0.5 and k["launches"] == 0.5 and k["host_reads"] == 0.0
    assert abs(k["host_ms"] - 0.095) < 1e-12 and abs(k["device_ms"] - 0.05) < 1e-12
    assert abs(k["idle_ms"] - 0.045) < 1e-12
    f = rows["step.f_solve"]  # [50, 460]: both launches and the read
    assert f["launches"] == 1.0 and f["host_reads"] == 0.5 and abs(f["device_ms"] - 0.095) < 1e-12
    assert abs(phases.step_coverage(tr) - 0.41) < 1e-12


def test_the_phase_table_of_a_small_run(small, bench):
    out = phases.run("sweep47k.b64", 2**31 + 7, device="cpu", root=small, bench=bench)
    rows = out["rows"]
    assert all(rows[p]["calls"] == 1.0 for p in ("step.guess", "step.f_solve", "step.s_solve", "run.host_copy"))
    assert out["coverage"] > 0.9 and out["sites"]["host_read"] >= 10
    assert "setup.operator" in out["setup"]
