"""CSV artifacts: the part of the reference's `io/csvlog.py` that the
port's CLI writes (the ensemble's Re-sweep table).

A copy, not an import: the reference's `io/__init__.py` imports its
checkpoint module, and through it jax.
"""

from __future__ import annotations

import os


class CSVLogger:
    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)

    def _append(self, name: str, header: str, rows):
        path = os.path.join(self.out_dir, name)
        new = not os.path.exists(path)
        with open(path, "a") as f:
            if new and header:
                f.write(header + "\n")
            for row in rows:
                f.write(",".join(str(x) for x in row) + "\n")

    def log_table(self, name, header, rows):
        """Generic CSV artifact (e.g. the ensemble Re-sweep summary)."""
        self._append(name, header, rows)
