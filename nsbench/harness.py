"""The benchmark's harness: one run of one cell.

A cell (`workloads` in BENCHMARK.json) names a configuration and a traffic
mix; each is a data file found by its name (`configs/<name>.json`,
`traffic/<name>.json`), and each per-layer metric a reader found by its
name (`metrics/<name>.py`).  The limits of the cell's correctness check
are `limits/<cell>.json`.  Nothing here names a cell, a configuration or
a metric.

A run: set-up (the mesh from the configuration, the program's solver,
the seeded initial state, the traffic's warm-up steps), then a window of
`seconds` in which each call of the program's entry point advances one
step and ends with the diagnostics' copy to the host and a device
synchronise (under the profiler's device activity where the cell reports
`device_ms_per_step`); with `trace`, then a profiled block of steps in the
benchmark's host spans and a count of host syncs; then the check of a
seeded sample of the window's steps against the plain reference, and one
JSON line.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import resource
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
# Top-level module names that no run may hold once its window has closed
# (compared whole: the program's name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "navierstokes_project_nm4pde_tpu")


class NoCard(RuntimeError):
    """The run asks for more cards than this machine has."""


class Forbidden(RuntimeError):
    """A forbidden module was imported."""


# ----------------------------------------------------------------------
# Finding the cell's files by name
# ----------------------------------------------------------------------
def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_named(kind: str, name: str, root: Path = ROOT) -> dict:
    """The data file `<kind>/<name>.json` under `root`, or the file at
    `name` where it is a path ending in `.json`."""
    return load_json(Path(name) if name.endswith(".json") else root / kind / f"{name}.json")


def refuse_uncovered(cfg: dict) -> None:
    """Raise ValueError, naming the setting, for a configuration whose
    stepper, scheme, convection or dimension the correctness check
    (`reference/check.py`) does not cover; reads no mesh."""
    from nsbench import meshgen
    from nsbench.reference import check

    rc = cfg["run_config"]
    check.refuse_uncovered(rc["time"], rc["solver"], meshgen.DIMENSION.get(cfg["mesh"]["generator"]))


# End-to-end metrics read from the window's host clock.  A cell that
# reports device_ms_per_step runs its window under the profiler, which
# loads the host, and so reports none of them.
HOST_TIMED = {"steps_per_s", "step_ms_p95"}


def find_cell(bench: dict, name: str, root: Path = ROOT) -> dict:
    """The cell `name` with its configuration, traffic, limits and the
    per-layer metrics it reports (those whose `workloads` lists it, or
    that have no list and move an end-to-end metric it reports); raises
    ValueError where the check does not cover its configuration."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    config = load_named("configs", w["config"], root)
    refuse_uncovered(config)
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    if "device_ms_per_step" in e2e_names and e2e_names & HOST_TIMED:
        raise ValueError(
            f"cell {name!r} reports device_ms_per_step, whose window runs under the profiler, "
            f"beside {sorted(e2e_names & HOST_TIMED)}, which read that window's host clock"
        )
    layer = [
        m for m in bench["per_layer"]
        if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)
    ]
    return dict(
        name=name, chips=int(w["chips"]),
        config=config,
        traffic=load_named("traffic", w["traffic"], root),
        limits=load_json(root / "limits" / f"{name}.json"),
        end_to_end=e2e, per_layer=layer,
    )


def load_reader(name: str, root: Path = ROOT):
    """The per-layer metric reader `metrics/<name>.py` as a module."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"nsbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# ----------------------------------------------------------------------
# The program: set-up from the configuration and the traffic
# ----------------------------------------------------------------------
def run_config(cfg: dict):
    from navierstokes_project_nm4pde_tpu_torch import config as C

    rc = cfg["run_config"]
    parts = dict(time=C.TimeConfig, solver=C.SolverConfig, precond=C.PrecondConfig, numerics=C.NumericsConfig)
    kw = {k: cls(**rc[k]) for k, cls in parts.items()}
    rest = {k: v for k, v in rc.items() if k not in parts}
    return C.RunConfig(**kw, **rest)


def mesh_arrays(cfg: dict):
    from nsbench import meshgen

    m = dict(cfg["mesh"])
    return getattr(meshgen, m.pop("generator"))(**m)


def problem_module(cfg: dict):
    """The reference's module of the configuration's problem
    (`reference/<name>.py`: `build`, `mean_velocity`, `fixed_nodes`)."""
    return importlib.import_module(f"nsbench.reference.{cfg['problem']['reference']}")


def viscosities(cfg: dict, traffic: dict) -> np.ndarray | None:
    """The members' nu = U D / Re (U the inflow's mean velocity, D the
    problem's length scale), or None for a single run at the
    configuration's nu."""
    re = traffic.get("reynolds")
    if re is None:
        return None
    pb = cfg["problem"]
    re = np.linspace(*re["linspace"]) if isinstance(re, dict) else np.asarray(re, dtype=np.float64)
    return problem_module(cfg).mean_velocity(pb) * pb["diameter"] / re


def perturbation(coords: np.ndarray, cfg: dict, traffic: dict, seed: int, members: int) -> np.ndarray:
    """The seeded perturbation of the rest state at velocity nodes `coords`
    [n, 3]: [n, 3, members], a sum of `modes` sine modes a member with
    normal coefficients and wave numbers up to `max_wavenumber` over the
    problem's box, scaled to `amplitude` times the inflow's mean velocity
    at its largest, and nought on the problem's Dirichlet nodes."""
    pb, pt = cfg["problem"], traffic["perturbation"]
    pm = problem_module(cfg)
    rng = np.random.default_rng(seed)
    k = rng.integers(1, pt["max_wavenumber"] + 1, size=(members, pt["modes"], 3))
    phase = rng.uniform(0.0, 2.0 * np.pi, size=(members, pt["modes"]))
    coef = rng.standard_normal(size=(members, pt["modes"], 3))
    x = coords / np.asarray(pb["box"], dtype=np.float64)
    out = np.zeros((coords.shape[0], 3, members))
    for b in range(members):
        s = np.sin(np.pi * x @ k[b].T + phase[b])  # [n, modes]
        f = s @ coef[b]
        out[:, :, b] = f / np.abs(f).max()
    out[pm.fixed_nodes(coords, pb)] = 0.0
    return pt["amplitude"] * pm.mean_velocity(pb) * out


class Program:
    """The program's solver for a cell, and its one-step entry point."""

    def __init__(self, cfg: dict, traffic: dict, arrays, device):
        from navierstokes_project_nm4pde_tpu_torch import mesh, models

        pp = cfg["problem"]["program"]
        self.problem = getattr(models, pp["factory"])(**pp["args"])
        self.solver = models.NavierStokesSolver(mesh.Mesh(*arrays), self.problem, run_config(cfg), device=device)
        self.nus = viscosities(cfg, traffic)
        self.members = 1 if self.nus is None else len(self.nus)
        self.device = self.solver.device

    def initial_state(self, seed: int, cfg: dict, traffic: dict):
        s = self.solver
        single = self.nus is None
        st = s.initial_state(None if single else self.members)
        pert = perturbation(s.space.unode_coords, cfg, traffic, seed, self.members)
        du = torch.as_tensor(pert[:, :, 0] if single else pert, dtype=s.dtype, device=s.device)
        u = st.u + du
        hist = {k: u for k in ("u_prev", "u_prev2") if getattr(st, k) is not None}
        return dataclasses.replace(st, u=u, **hist)

    def labels(self) -> dict:
        """The coordinates of the program's velocity and pressure nodes:
        the labels of its state's rows."""
        return dict(u=self.solver.space.unode_coords.copy(), p=self.solver.mesh.coords.copy())

    def advance(self, state):
        """One step through the program's entry point; returns (state, a
        dict of [members] numpy diagnostics)."""
        if self.nus is None:
            state, d = self.solver.run(1, state=state)
        else:
            from navierstokes_project_nm4pde_tpu_torch.parallel.ensemble import run_ensemble

            state, d = run_ensemble(self.solver, self.nus, 1, state=state)
        return state, {f.name: np.asarray(getattr(d, f.name)).reshape(-1) for f in dataclasses.fields(d)}

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


# ----------------------------------------------------------------------
# Faults for the harness's own tests: the timed path broken underneath
# ----------------------------------------------------------------------
def _with_fault(advance, fault: str | None):
    if fault is None:
        return advance

    def broken(state):
        new, d = advance(state)
        if fault == "unchanged":  # the step returns its state unchanged
            new = dataclasses.replace(new, u=state.u, p=state.p)
        elif fault == "half":  # half the members left out
            h = state.u.shape[-1] // 2
            u, p = new.u.clone(), new.p.clone()
            u[..., h:], p[..., h:] = state.u[..., h:], state.p[..., h:]
            new = dataclasses.replace(new, u=u, p=p)
        elif fault == "node":  # one answer altered where it is produced
            u = new.u.clone()
            u[u.shape[0] // 2] += 1e-3 * float(u.abs().max())
            new = dataclasses.replace(new, u=u)
        elif fault == "pressure":  # one pressure node altered where it is produced
            p = new.p.clone()
            p[p.shape[0] // 2] += 1e-3 * float(p.abs().max())
            new = dataclasses.replace(new, p=p)
        elif fault == "drag":
            d = dict(d, c_d=d["c_d"] * (1.0 + 1e-3))
        else:
            raise ValueError(f"unknown fault {fault!r}")
        return new, d

    return broken


# ----------------------------------------------------------------------
# Spans, the profiled block and the sync count (--trace 1)
# ----------------------------------------------------------------------
class Spans:
    """Host spans around the program's module-level functions that the
    readers name (`SPAN = (module, function)`), each call's cost recorded
    by the reader's `cost(args, kwargs)`; removed on exit."""

    def __init__(self, readers: dict):
        self.readers = {n: r for n, r in readers.items() if hasattr(r, "SPAN")}
        self.calls = {n: [] for n in self.readers}
        self._saved = []

    def __enter__(self):
        for name, r in self.readers.items():
            mod = importlib.import_module(r.SPAN[0])
            fn = getattr(mod, r.SPAN[1])
            self._saved.append((mod, r.SPAN[1], fn))
            setattr(mod, r.SPAN[1], self._wrap(name, r, fn))
        return self

    def _wrap(self, name, reader, fn):
        calls, label = self.calls[name], f"nsbench.{name}"

        def wrapped(*args, **kwargs):
            calls.append(reader.cost(args, kwargs))
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)

        return wrapped

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()


def profiled_block(prog, advance, state, steps: int, spans: Spans):
    """`steps` steps under torch.profiler inside the benchmark's spans
    (the trace written under $TMPDIR and deleted once read); returns
    (state, Trace)."""
    from torch.profiler import ProfilerActivity, profile

    from nsbench.trace import RUN_SPAN, STEP_SPAN, Trace

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if prog.device.type == "cuda" else [])
    prog.sync()
    with spans, profile(activities=acts) as prof:
        with torch.profiler.record_function(RUN_SPAN):
            for _ in range(steps):
                with torch.profiler.record_function(STEP_SPAN):
                    state, _ = advance(state)
                    prog.sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        trace = Trace.from_file(path)
    finally:
        os.unlink(path)
    return state, trace


def count_syncs(prog, advance, state, steps: int):
    """Host synchronisations in `steps` steps (torch's sync debug mode
    warns at each synchronising CUDA call); returns (state, syncs)."""
    if prog.device.type != "cuda":
        return state, 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(steps):
                state, _ = advance(state)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return state, sum("called a synchronizing" in str(w.message) for w in caught)


def cpu_seconds() -> float:
    """The CPU seconds, user and system, of all this process's threads so
    far (getrusage)."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def card_info(window_cpu_s: float | None = None) -> dict:
    """The card's name and power limit (nvidia-smi), where it answers, and
    `host`: the CPUs this process may run on (`affinity`, where the host
    answers) and `window_cpu_s`, the CPU seconds the process used in the
    window (a synchronise that spins counts as busy)."""
    out, host = {}, {}
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip().splitlines()[0]
        name, limit = (x.strip() for x in line.split(","))
        out = dict(name=name, power_limit=limit)
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        pass
    try:
        host["affinity"] = sorted(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        pass
    if window_cpu_s is not None:
        host["window_cpu_s"] = window_cpu_s
    out["host"] = host
    return out


# ----------------------------------------------------------------------
# The check against the plain reference
# ----------------------------------------------------------------------
class Checker:
    """The reference on `device` for a configuration's mesh, aligned with
    the program's output nodes (`labels`: the coordinates of its velocity
    and pressure nodes, the labels of its state's rows), with the numbers
    and the control of the configuration's stepper (`check.SCHEMES`)."""

    def __init__(self, cfg: dict, arrays, labels: dict, device):
        from nsbench.reference import check

        pb = cfg["problem"]
        self.cfg, self.pb = cfg, pb
        self.scheme = check.SCHEMES[cfg["run_config"]["time"]["stepper"]]
        pm = problem_module(cfg)
        self.space, self.ref, self.prob = pm.build(arrays, pb, precision="float64", device=device)
        self.iu, self.ip = self.space.match(labels["u"]), self.space.match_vertices(labels["p"])
        self.dt = cfg["run_config"]["time"]["dt"]
        self._arrays, self._device, self._pm = arrays, device, pm

    def on_ref(self, x: np.ndarray, idx: np.ndarray) -> np.ndarray:
        out = np.zeros((len(idx),) + x.shape[1:])
        out[idx] = x
        return out

    def nu(self, nus, b: int) -> float:
        return self.pb["nu"] if nus is None else float(nus[b])

    def numbers(self, samples: list, nus) -> dict:
        """The worst of each compared number over the sampled steps
        (pre_u, pre_p, u, p, diagnostics) and their members."""
        from nsbench.reference import check

        rows = []
        for pre_u, pre_p, u, p, d in samples:
            for b in range(pre_u.shape[-1]):
                diag = {k: float(d[k][b]) for k in ("c_d", "c_l", "delta_p")}
                rows.append(self.scheme.numbers(
                    self.ref, self.prob, self.on_ref(pre_u[..., b], self.iu), self.on_ref(pre_p[..., b], self.ip),
                    self.on_ref(u[..., b], self.iu), self.on_ref(p[..., b], self.ip), diag, self.nu(nus, b), self.dt,
                ))
        return check.worst(rows)

    def control_numbers(self, samples: list, nus, precision: str = "tf32", log: list | None = None) -> dict:
        """The same numbers with the reference at `precision` put in the
        program's place: each sampled step taken again from the program's
        pre-step state by the stepper's control (`check.SCHEMES`).  With
        `log`, each control step appends its solver's information and its
        seconds."""
        from nsbench.reference import check

        _, ref_c, prob_c = self._pm.build(self._arrays, self.pb, precision=precision, device=self._device)
        solver = self.cfg["run_config"]["solver"]
        rows = []
        for pre_u, pre_p, _, _, _ in samples:
            for b in range(pre_u.shape[-1]):
                un, pn = self.on_ref(pre_u[..., b], self.iu), self.on_ref(pre_p[..., b], self.ip)
                t0 = time.perf_counter()
                u, p, diag, info = self.scheme.control(ref_c, prob_c, un, pn, self.nu(nus, b), self.dt, solver)
                if log is not None:
                    log.append(dict(info=info, seconds=time.perf_counter() - t0))
                rows.append(self.scheme.numbers(
                    self.ref, self.prob, un, pn, u.double().cpu().numpy(), p.double().cpu().numpy(),
                    diag, self.nu(nus, b), self.dt,
                ))
        return check.worst(rows)


def _host(state) -> tuple:
    """(u [n, 3, B], p [n_p, B]) of a state as float64 numpy."""
    u, p = state.u.double().cpu().numpy(), state.p.double().cpu().numpy()
    if p.ndim == 1:
        u, p = u[..., None], p[..., None]
    return u, p


# ----------------------------------------------------------------------
# One run
# ----------------------------------------------------------------------
def warm_up(prog, advance, state, traffic: dict):
    """The traffic's warm-up steps from the handed state; returns (state,
    the first step as a sample: it starts from the handed state, and is
    always checked)."""
    pre = state
    state, d = advance(state)
    first = (pre, state, d)
    for _ in range(int(traffic["warmup_steps"]) - 1):
        state, _ = advance(state)
    prog.sync()
    return state, first


# The least number of steps in a run's window, whatever its seconds: p95
# then rests on a dozen steps beyond it (240 x 5%) in a cell of long steps.
MIN_WINDOW_STEPS = 240


class Window:
    """The measured window: one step a call until `seconds` have passed
    and at least `min_steps` steps are done (the clock from the first
    step's start to the synchronise after the last), each step's wall
    time and diagnostics, and a uniform sample of `k` of its steps drawn
    from the seed (reservoir sampling; the states are held, not copied)."""

    def __init__(self, prog, advance, state, seconds: float, k: int, seed: int, min_steps: int = 1):
        rng = np.random.default_rng([seed, 1])
        self.reservoir, self.step_s, self.diags = [], [], []
        t0 = time.perf_counter()
        while True:
            t = time.perf_counter()
            pre = state
            state, d = advance(state)
            prog.sync()
            now = time.perf_counter()
            self.step_s.append(now - t)
            self.diags.append(d)
            i = len(self.step_s)
            if len(self.reservoir) < k:
                self.reservoir.append((pre, state, d))
            elif rng.random() < k / i:
                self.reservoir[int(rng.integers(k))] = (pre, state, d)
            if now - t0 >= seconds and i >= min_steps:
                break
        self.seconds = now - t0
        self.state = state


def failed_steps(diags: list, maxit: int) -> int:
    """The (member-)steps of `diags` at the Krylov cap or with a
    non-finite residual."""
    return sum(
        int(np.sum((d["iters_f"] >= maxit) | (d["iters_s"] >= maxit) | ~np.isfinite(d["residual"])))
        for d in diags
    )


def host_samples(samples: list) -> list:
    """(pre_u, pre_p, u, p, diagnostics) of sampled (pre, post, d) steps,
    the fields as float64 numpy with a trailing member axis."""
    return [(*_host(a), *_host(b), d) for a, b, d in samples]


class Context:
    """What the per-layer readers read."""

    def __init__(self, on_card: bool):
        self.on_card = on_card
        self.trace = None
        self.diags: list = []
        self.calls: dict = {}
        self.syncs = 0
        self.sync_steps = 0


def run(workload: str, seed: int, seconds: float, trace: bool, t_start: float,
        bench: dict | None = None, root: Path = ROOT, device=None, fault: str | None = None,
        log=print) -> dict:
    """One run of cell `workload`; returns the result (its keys in the
    order printed).  `device` None asks for the card (NoCard without one);
    the harness's tests pass "cpu" and a `fault`."""
    bench = load_json(Path("BENCHMARK.json")) if bench is None else bench
    cell = find_cell(bench, workload, root)
    cfg, traffic = cell["config"], cell["traffic"]
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            raise NoCard(f"the cell asks for {cell['chips']} card(s); this machine has {have}")
        device = "cuda"
    readers = {m["name"]: load_reader(m["name"], root) for m in cell["per_layer"]} if trace else {}

    # ---- set-up -------------------------------------------------------
    arrays = mesh_arrays(cfg)
    prog = Program(cfg, traffic, arrays, device)
    advance = _with_fault(prog.advance, fault)
    on_card = prog.device.type == "cuda"
    state, first = warm_up(prog, advance, prog.initial_state(seed, cfg, traffic), traffic)
    setup_s = time.perf_counter() - t_start

    # ---- the window -----------------------------------------------------
    # device_ms_per_step: the whole window under the profiler, its device
    # activity alone, and the union of that activity over the window's steps
    from nsbench.trace import device_activity, device_busy_s

    on_device = on_card and not trace and any(m["name"] == "device_ms_per_step" for m in cell["end_to_end"])
    with device_activity(on_device) as prof:
        cpu0 = cpu_seconds()
        win = Window(prog, advance, state, seconds, int(traffic["check_steps"]), seed, MIN_WINDOW_STEPS)
        window_cpu_s = cpu_seconds() - cpu0
    busy_s = device_busy_s(prof) if on_device else None
    state, step_s, diags, window_s = win.state, win.step_s, win.diags, win.seconds
    peak = torch.cuda.max_memory_allocated(prog.device) if on_card else 0

    # ---- the traced block (--trace 1) ---------------------------------
    ctx = Context(on_card)
    ctx.diags = diags
    if trace:
        spans = Spans(readers)
        state, ctx.trace = profiled_block(prog, advance, state, int(traffic["trace_steps"]), spans)
        ctx.calls = spans.calls
        ctx.sync_steps = int(traffic["sync_steps"])
        state, ctx.syncs = count_syncs(prog, advance, state, ctx.sync_steps)

    # ---- counts, then the program's state freed -----------------------
    members = prog.members
    failed = failed_steps(diags, cfg["run_config"]["solver"]["maxiter"])
    diverged = any(not np.all(np.isfinite(d["residual"])) for d in diags)
    samples = host_samples([first] + win.reservoir)
    labels, nus = prog.labels(), prog.nus
    del prog, state, first, win, advance
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # ---- metrics --------------------------------------------------------
    metrics = {}
    if trace:
        for m in cell["per_layer"]:
            v = readers[m["name"]].read(ctx)
            if v is not None:
                metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
    else:
        values = dict(
            steps_per_s=len(step_s) / window_s,
            step_ms_p95=1e3 * float(np.percentile(step_s, 95)),
            peak_mem_gib=peak / 2**30,
            setup_s=setup_s,
            device_ms_per_step=None if busy_s is None else 1e3 * busy_s / len(step_s),
        )
        for m in cell["end_to_end"]:
            if values[m["name"]] is not None:  # device_ms_per_step is read on the card only
                metrics[m["name"]] = dict(value=float(values[m["name"]]), unit=m["unit"])

    # ---- the check --------------------------------------------------------
    numbers = Checker(cfg, arrays, labels, device).numbers(samples, nus)
    limits = cell["limits"]["limits"]
    from nsbench.reference.check import verdict

    correct = verdict(numbers, limits) and not diverged
    result = dict(correct=bool(correct), attempted=len(step_s) * members, failed=failed, metrics=metrics)
    result["device"] = dict(
        platform="gpu" if on_card else "cpu",
        kind=torch.cuda.get_device_name(0) if on_card else "cpu",
        count=1 if on_card else 0,
        memory_peak_bytes=int(peak),
    )
    if trace and ctx.trace is not None:
        result["device"].update(busy_s=ctx.trace.busy_s(), window_s=ctx.trace.window_s())
        result["breakdown"] = dict(device_ops=ctx.trace.top_kernels(10), idle_gaps=ctx.trace.idle_gaps(10))
    if on_card:
        result["card"] = card_info(window_cpu_s)
    result["window"] = dict(
        steps=len(step_s), seconds=window_s, checked_steps=len(samples),
        step_ms_median=1e3 * float(np.median(step_s)),
        iters_per_step=float(np.mean([np.max(d["iters_f"]) + np.max(d["iters_s"]) for d in diags])),
    )
    result["checks"] = {k: dict(value=numbers[k], limit=limits[k]) for k in numbers}
    found = forbidden_modules()
    if found:
        raise Forbidden(f"modules {found} were imported")
    for k in numbers:
        log(f"check {k} {numbers[k]!r} limit {limits[k]!r}")
    return result
