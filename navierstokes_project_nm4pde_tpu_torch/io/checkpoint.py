"""Checkpoint / resume of the solver state as a plain `.npz`.

The counterpart of the reference's `io/checkpoint.py` `save_checkpoint` /
`load_checkpoint`, with the same keys: u, p, t (in the state's dtype),
step (int32), and each of u_prev, p_prev, u_prev2, conv_prev, spool,
fpool, fwpool that the state carries.  A checkpoint written by either
package loads into the other.  The reference's reserved p_prev2 (which
neither package steps) is read past.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from navierstokes_project_nm4pde_tpu_torch.device import pick_device
from navierstokes_project_nm4pde_tpu_torch.models.base import State, state_from_numpy

_OPTIONAL = ("u_prev", "p_prev", "u_prev2", "conv_prev", "spool", "fpool", "fwpool")


def save_checkpoint(path: str, state: State, meta: dict | None = None) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    u = state.u.detach().cpu().numpy()
    arrays = {
        "u": u,
        "p": state.p.detach().cpu().numpy(),
        "t": np.asarray(state.t, dtype=u.dtype),
        "step": np.asarray(state.step, dtype=np.int32),
    }
    for name in _OPTIONAL:
        val = getattr(state, name)
        if val is not None:
            arrays[name] = val.detach().cpu().numpy()
    for k, v in (meta or {}).items():
        arrays[f"meta_{k}"] = np.asarray(v)
    np.savez(path, **arrays)


def load_checkpoint(path: str, dtype=torch.float32, device=None) -> State:
    """The state of a checkpoint, its arrays in `dtype` on `device` (None:
    the card)."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in ("u", "p", "t", "step", *_OPTIONAL) if k in z}
    return state_from_numpy(arrays, pick_device(device), dtype)
