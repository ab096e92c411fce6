"""Convergence-rate table (replaces dealii::ConvergenceTable): the port's
copy of the JAX package's `utils/tables.py`.


The reference uses `ConvergenceTable::evaluate_all_convergence_rates` with
log2 reduction rates (ref: src/main_convergence3D.cpp:12,70-73); this is the
same computation: observed order p = log2(e_{2h} / e_h) between successive
refinements (assuming a factor-2 mesh ladder, or generalised to the actual
h ratio)."""

from __future__ import annotations

import math


class ConvergenceTable:
    def __init__(self):
        self.rows = []  # (h, {name: value})

    def add_row(self, h: float, **errors):
        self.rows.append((h, dict(errors)))

    def rates(self) -> dict:
        """Observed orders between consecutive rows: p = log(e1/e2)/log(h1/h2)."""
        out = {}
        for i in range(1, len(self.rows)):
            h1, e1 = self.rows[i - 1]
            h2, e2 = self.rows[i]
            for name in e1:
                out.setdefault(name, []).append(
                    math.log(e1[name] / e2[name]) / math.log(h1 / h2)
                )
        return out

    def format(self) -> str:
        names = list(self.rows[0][1].keys()) if self.rows else []
        rates = self.rates()
        lines = ["h        " + "".join(f"{n:>14}{'rate':>8}" for n in names)]
        for i, (h, errs) in enumerate(self.rows):
            cells = []
            for n in names:
                cells.append(f"{errs[n]:14.4e}")
                r = rates[n][i - 1] if i > 0 else None
                cells.append(f"{r:8.2f}" if r is not None else " " * 8)
            lines.append(f"{h:<9.4g}" + "".join(cells))
        return "\n".join(lines)
