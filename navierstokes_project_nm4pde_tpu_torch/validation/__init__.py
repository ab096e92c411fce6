"""The DFG validation runs: the published cylinder benchmarks the engine's
physics is held to (the counterparts of the reference's
`scripts/dfg_validate.py`, DFG 2D-2, and `scripts/dfg3d_validate.py`, DFG
3D-1Z), with the same flags, CSV file and JSON summary, and `--device`:

    python -m navierstokes_project_nm4pde_tpu_torch.validation.dfg_validate --re 100 \\
        --lc 0.015 --dt 1e-3 --t-end 18 --t-kick 2.5 --t-ramp 1 --t-measure 12
    python -m navierstokes_project_nm4pde_tpu_torch.validation.dfg3d_validate --lc 0.04 --nz 12

Each runs on the card unless given `--device cpu`.  This module holds what
the two share: the device, the timed run and the coefficients' CSV file.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from navierstokes_project_nm4pde_tpu_torch.device import pick_device


def open_device(name: str) -> tuple[torch.device, str]:
    """(device, its name for the header line); a CUDA device asked for on a
    machine without one stops the run with a message."""
    try:
        device = pick_device(name)
    except RuntimeError as e:
        raise SystemExit(f"navierstokes-torch: {e} (--device cpu runs on the CPU)") from None
    return device, torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)


def timed_run(solver, n_steps: int):
    """(state, diagnostics, wall seconds) of `solver.run(n_steps)`, the
    clock stopped after the device has finished."""
    t0 = time.time()
    state, diags = solver.run(n_steps)
    if solver.device.type == "cuda":
        torch.cuda.synchronize(solver.device)
    return state, diags, time.time() - t0


def write_coefficients(out_dir: str, name: str, t: np.ndarray, diags) -> None:
    """`out_dir/name`: t, c_d, c_l, delta_p and iterations a step, as the
    reference's scripts write them."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, name), "w") as f:
        f.write("t,c_d,c_l,delta_p,iters\n")
        for i in range(len(t)):
            f.write(f"{t[i]:.6f},{diags.c_d[i]:.6f},{diags.c_l[i]:.6f},{diags.delta_p[i]:.6f},"
                    f"{int(diags.iters[i])}\n")
