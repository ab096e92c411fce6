"""Device selection and the float32 precision policy.

The counterpart of the reference's `utils/platform.py`: the reference pins
the JAX platform; here every function takes an explicit `device` and this
module only resolves a name to a `torch.device` and sets the precision
policy once.

Precision: f32 stays exact f32.  TF32 matmuls keep ~3 decimal digits, the
same class as the bf16 operator error that cost the projection stepper's
warm start several iterations a step on the TPU (per-step operator noise
above ~1e-5 relative, PERFORMANCE.md), so TF32 is switched off for cuBLAS
and cuDNN alike.
"""

from __future__ import annotations

import torch


def set_precision_policy() -> None:
    """Full-f32 matmuls and convolutions (no TF32) for this process."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def pick_device(name: str | torch.device | None = None) -> torch.device:
    """Resolve `name` ("cpu", "cuda", "cuda:1", or None = "cuda") to a
    `torch.device` and apply the precision policy.  The port runs on the
    card unless the caller asks for the CPU: a CUDA device, named or by
    default, without a card raises instead of falling back to the CPU."""
    dev = torch.device("cuda" if name is None else name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    set_precision_policy()
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """NumericsConfig.dtype ("float32" / "float64") -> torch dtype."""
    try:
        return {"float32": torch.float32, "float64": torch.float64}[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None
