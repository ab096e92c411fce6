"""Reynolds-sweep ensembles: B runs of one solver, one viscosity each,
advanced as one batch.

The counterpart of the reference's `parallel/ensemble.py`.  The reference
vmaps its whole step (either stepper, every scheme and convection mode)
over the viscosities and, before it does, strips the single run's fast
paths that do not survive a batch (the cached F bound, the windowed
gather, the assembled and BSR D and G, the constant-K BSR and IMEX
tables, the macro blocks, the fgmres-aux divergence), so its members run
the element branch of the step with einsum contractions.  Here that is
`NavierStokesSolver.step` with nu a [B] tensor, which never takes those paths, and
the vmap is a trailing member axis on every state array and recycle pool:
the element passes move all members as packed channels through kernels D
and C, and the Krylov solves run the members in one batch with their own
tolerances and iteration counts.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from collections.abc import Mapping

import numpy as np
import torch

from navierstokes_project_nm4pde_tpu_torch.device import torch_dtype
from navierstokes_project_nm4pde_tpu_torch.models.base import (
    State,
    StepDiagnostics,
)
from navierstokes_project_nm4pde_tpu_torch.utils.profiling import span

_ARRAYS = ("u", "p", "u_prev", "p_prev", "u_prev2", "conv_prev", "spool", "fpool", "fwpool")


def run_ensemble(solver, nus, n_steps: int, state: State | None = None):
    """Advance `n_steps` for an ensemble of viscosities `nus` [B] (the
    solver's problem supplies everything else), from rest or from an
    ensemble `state`.  Returns (ensemble State, StepDiagnostics of [B, T]
    numpy arrays).

    Steps are timed in chunks of `numerics.steps_per_chunk`; after the
    first chunk (which includes the kernels' build) the sustained
    member-steps/s go to stderr, as in the reference.  The viscosities'
    copy to the device runs in span `host_write`, the chunk's synchronise
    in `run.sync`, the diagnostics' copy to the host in `run.host_copy`
    (`utils/profiling.py`)."""
    with span("host_write"):
        nus_t = torch.as_tensor(
            np.array(nus, dtype=np.float64), dtype=solver.dtype, device=solver.device
        )
    if nus_t.dim() != 1 or nus_t.shape[0] < 1:
        raise ValueError(f"nus must be a non-empty 1-D array, got shape {tuple(nus_t.shape)}")
    B = nus_t.shape[0]
    state = solver.initial_state(B) if state is None else solver._ensure_pools(state)
    spc = max(1, int(solver.config.numerics.steps_per_chunk))
    rows, walls, done = [], [], 0
    while done < n_steps:
        length = min(spc, n_steps - done)
        t0 = time.perf_counter()
        for _ in range(length):
            state, dg = solver.step(state, nus_t)
            if not np.all(np.isfinite(dg["residual"])):
                raise FloatingPointError(
                    f"ensemble diverged: non-finite residual at step {state.step}"
                )
            rows.append(dg)
        if solver.device.type == "cuda":
            with span("run.sync"):
                torch.cuda.synchronize(solver.device)
        walls.append((length, time.perf_counter() - t0))
        done += length
    if len(walls) > 1:
        steps = sum(k for k, _ in walls[1:])
        secs = sum(s for _, s in walls[1:])
        print(
            f"[ensemble] sustained {B * steps / secs:.2f} member-steps/s "
            f"(B={B}, {steps} steps after the first chunk; first chunk "
            f"{walls[0][1]:.1f}s)",
            file=sys.stderr, flush=True,
        )
    cols = {}
    with span("run.host_copy"):
        for f in dataclasses.fields(StepDiagnostics):
            vals = [r[f.name] for r in rows]
            if vals and isinstance(vals[0], torch.Tensor):
                stacked = torch.stack(vals, dim=1)
                with span("host_read"):
                    cols[f.name] = stacked.cpu().numpy()
            else:
                cols[f.name] = (
                    np.stack(vals, axis=1) if vals else np.zeros((B, 0))
                )
    return state, StepDiagnostics(**cols)


def ensemble_state_from_numpy(arrays, device, dtype: torch.dtype | None = None) -> State:
    """An ensemble State from the reference's batched State (numpy arrays
    with a leading member axis B, its recycle pools and conv_prev
    included; t and step [B]), given as a mapping or as any object with
    those attribute names."""
    get = arrays.get if isinstance(arrays, Mapping) else (
        lambda k: getattr(arrays, k, None)
    )
    dev = torch.device(device)

    def conv(k):
        v = get(k)
        if v is None:
            return None
        v = np.moveaxis(np.array(v), 0, -1)  # members last (a writable copy)
        return torch.as_tensor(
            np.ascontiguousarray(v), dtype=dtype or torch_dtype(str(v.dtype)), device=dev
        )

    t, step = np.asarray(get("t")), np.asarray(get("step"))
    if np.ptp(t) != 0 or np.ptp(step) != 0:
        raise ValueError("ensemble members must share t and step")
    return State(
        t=float(t.reshape(-1)[0]), step=int(step.reshape(-1)[0]),
        **{k: conv(k) for k in _ARRAYS},
    )


def ensemble_state_to_numpy(state: State) -> dict:
    """An ensemble State -> dict of numpy arrays with a leading member axis
    (the reference's batched layout; None where absent), t and step [B]."""
    B = state.p.shape[-1]
    out = {
        k: (
            None if getattr(state, k) is None
            else np.moveaxis(getattr(state, k).cpu().numpy(), -1, 0)
        )
        for k in _ARRAYS
    }
    out["t"] = np.full(B, float(state.t))
    out["step"] = np.full(B, int(state.step), dtype=np.int32)
    return out
