"""CSV telemetry with the reference's file schemas: a copy of the reference's
`io/csvlog.py` (numpy only), held equal to it by
tests/test_torch_port_copies.py.

  gmres.csv        time, Re, iterations
  coeff_2.csv      step, c_d, c_l
  forces_results_* header + per-step drag/lift/coefficients/timings
  convergence.csv  h, eL2, eH1

`CSVLogger` appends whole chunks of per-step diagnostics between the
solver's chunks.
"""

from __future__ import annotations

import os

import numpy as np


class CSVLogger:
    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self._files = {}

    def _append(self, name: str, header: str, rows):
        path = os.path.join(self.out_dir, name)
        new = not os.path.exists(path)
        with open(path, "a") as f:
            if new and header:
                f.write(header + "\n")
            for row in rows:
                f.write(",".join(str(x) for x in row) + "\n")

    # ------------------------------------------------------------------
    def log_gmres(self, times, reynolds, iters):
        """gmres.csv: time, Re, iterations (ref: src/NavierStokes2D.cpp:626-630
        -- the reference writes no header)."""
        self._append("gmres.csv", "", zip(times, reynolds, iters))

    def log_coefficients(self, steps, c_d, c_l):
        """coeff_2.csv: step, c_d, c_l (ref: src/NavierStokes2D.cpp:682-686)."""
        self._append("coeff_2.csv", "", zip(steps, c_d, c_l))

    def log_forces(
        self, name, times, drag, lift, c_d, c_l, t_prec=None, t_solve=None
    ):
        """forces_results CSV (ref: src/main2D.cpp:50-58).  Unlike the
        reference -- whose drag column actually receives the lift coefficients
        and whose vectors are never populated, leaving a header-only file
        (SURVEY.md section 5) -- this writes the labelled quantities."""
        n = len(times)
        t_prec = t_prec if t_prec is not None else np.zeros(n)
        t_solve = t_solve if t_solve is not None else np.zeros(n)
        self._append(
            name,
            "Iteration, Drag, Lift, Coeff Drag, CoeffLift, time prec, time solve",
            zip(times, drag, lift, c_d, c_l, t_prec, t_solve),
        )

    def log_table(self, name, header, rows):
        """Generic CSV artifact (e.g. the ensemble Re-sweep summary -- a new
        capability with no reference counterpart, so no fixed schema)."""
        self._append(name, header, rows)

    def log_convergence(self, hs, e_l2, e_h1):
        """convergence.csv: h, eL2, eH1 (ref: src/main_convergence3D.cpp:43-61)."""
        self._append("convergence.csv", "h,eL2,eH1", zip(hs, e_l2, e_h1))
