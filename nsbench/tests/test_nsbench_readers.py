"""The per-layer readers: each roofline's bytes on a small plan against
hand-worked counts, and the trace reading on a hand-made trace."""

import json
from types import SimpleNamespace

import torch

from nsbench import harness, roofline
from nsbench.trace import Trace


def test_macro_apply_bytes_by_hand():
    r = harness.load_reader("macro_apply_roofline")
    mp = SimpleNamespace(U=8)
    FtT, u = torch.zeros(3, 8, 8), torch.zeros(10, 3)
    # FtT 3*8*8*4 = 768, u in and out 2*10*3*4 = 240, slots 3*8*4 = 96
    assert r.cost((mp, FtT, u), {}) == (1104, 2 * 3 * 64 * 3, 4)


def test_macro_build_bytes_by_hand():
    r = harness.load_reader("macro_build_roofline")
    mp = SimpleNamespace(U=8, lidx=torch.zeros(2, 3, 10, dtype=torch.int32))
    F_e = torch.zeros(5, 10, 10, dtype=torch.float64)
    # F_e 5*100*8 = 4000, FtT 2*64*8 = 1024, lidx 2*3*10*4 = 240
    assert r.cost((mp, F_e), {}) == (5264, 500, 8)


def test_element_pass_bytes_by_hand():
    r = harness.load_reader("element_pass_roofline")
    conv = SimpleNamespace(F_e=torch.zeros(10, 6, 10, 4))  # [j, E, i, B]
    u = torch.zeros(20, 3, 4)
    # F_e 2400*4 = 9600, u in and out 2*240*4 = 1920, cells 6*10*4 = 240
    assert r.cost((None, None, None, conv, u), {}) == (11760, 6 * 2400, 4)
    assert r.cost((None, None, None, SimpleNamespace(F_e=None), u), {}) is None


def test_share_is_bound_over_device_time():
    calls = [(3.35e9, 0.0, 4), (0.0, 67e9, 4)]  # 1 ms each
    assert abs(roofline.share_percent(calls, 4e-3) - 50.0) < 1e-9
    assert roofline.share_percent([], 1.0) is None and roofline.share_percent(calls, 0.0) is None


def _ev(name, cat, ts, dur, tid=1, corr=None):
    e = dict(ph="X", name=name, cat=cat, ts=ts, dur=dur, pid=1, tid=tid)
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_the_trace_reading_by_hand(tmp_path):
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
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    tr = Trace.from_file(str(p))
    assert tr.window_s() == 1000e-6 and tr.steps() == 2 and tr.kernel_count() == 2
    assert abs(tr.busy_s() - 190e-6) < 1e-12  # [150, 250] and [310, 400]
    assert abs(tr.span_device_s("macro_apply_roofline") - 100e-6) < 1e-12  # kernel A only
    idle = dict(tr.idle_gaps())
    # [0, 150] and [250, 310] begin in a step, [400, 1000] in its aten::item
    assert abs(idle["step"] - 210e-6) < 1e-12 and abs(idle["step: aten::item"] - 600e-6) < 1e-12
    assert tr.top_kernels() == [["A", 100e-6], ["B", 90e-6]]
    ctx = harness.Context(True)
    ctx.trace = tr
    assert abs(harness.load_reader("device_idle_share").read(ctx) - 81.0) < 1e-9
    assert harness.load_reader("launches_per_step").read(ctx) == 1.0


class _KinetoEvent:
    def __init__(self, device, start, end, span=False):
        self.device, self.start, self.end, self.span = device, start, end, span

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self.device else DeviceType.CPU

    def is_user_annotation(self):
        return self.span

    def start_ns(self):
        return self.start

    def end_ns(self):
        return self.end


def test_device_busy_is_the_union_of_the_device_activity():
    from nsbench.trace import device_busy_s

    events = [
        _KinetoEvent(True, 100, 300),  # a kernel
        _KinetoEvent(True, 250, 400),  # another, overlapping the first
        _KinetoEvent(True, 500, 550),  # a copy
        _KinetoEvent(True, 550, 560),  # a memset
        _KinetoEvent(True, 0, 10_000, span=True),  # a span on the device's row, not work
        _KinetoEvent(False, 0, 5_000),  # a runtime call on the host
    ]
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: events)))
    assert abs(device_busy_s(prof) - 360e-9) < 1e-18  # [100, 400] and [500, 560]


def test_a_cell_times_its_window_on_one_clock(bench):
    """device_ms_per_step profiles the window, so a cell that reports it
    reports no metric of the window's host clock."""
    both = json.loads(json.dumps(bench))
    for m in both["end_to_end"]:
        if m["name"] in ("steps_per_s", "device_ms_per_step"):
            m["workloads"] = ["duct965k.single", "sweep47k.b64"]
    try:
        harness.find_cell(both, "duct965k.single")
    except ValueError as e:
        assert "device_ms_per_step" in str(e) and "steps_per_s" in str(e)
    else:
        raise AssertionError("a cell timed on both clocks was found")
    assert harness.find_cell(bench, "duct965k.single")["name"] == "duct965k.single"


def test_the_device_time_readers_read_as_their_base_readers():
    ctx = harness.Context(True)
    ctx.diags = [dict(iters_f=[5, 7], iters_s=[3, 2]), dict(iters_f=[4], iters_s=[4])]
    import importlib

    for name in ("krylov_iters_per_step", "launches_per_step", "coarse_solve_roofline", "schur_matvec_roofline"):
        dev = harness.load_reader(f"{name}.device")
        assert dev.read is importlib.import_module(f"nsbench.metrics.{name}").read
    assert harness.load_reader("krylov_iters_per_step.device").read(ctx) == 9.0
