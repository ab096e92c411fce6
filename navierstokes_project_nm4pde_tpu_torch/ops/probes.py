"""Measurement probes: an f32 GEMM rate and a same-shape column gather.

The counterparts of the two TPU probes under `scripts/`: `probe_mxu_rate`
(scripts/prof_macro_build_kernel.py, one f32 [2048, 2048] product
contracted over the leading axis of both operands) and `run_case`
(scripts/prof_pallas_gather.py, out[i, j] = src[idx[i, j], j] at
[1024, 128], [8192, 128] and [8192, 8]).  No solver path calls them;
`chip_smoke.py` runs both on the card and reports their rates.

Each wrapper runs the CUDA kernel of `csrc/probe_kernels.cu` for CUDA
tensors (or raises) and its plain PyTorch version for CPU tensors;
`launch_counts` counts the kernel launches only.
"""

from __future__ import annotations

import dataclasses

import torch

from navierstokes_project_nm4pde_tpu_torch.ops import cuda_lib

launch_counts = {"sgemm_probe": 0, "column_gather": 0}

# The probe scripts' shapes.
SGEMM_N = 2048
GATHER_SHAPES = ((1024, 128), (8192, 128), (8192, 8))


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _check_f32(name: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(
                f"{name}: expected contiguous float32 matrices, got {t.dtype} "
                f"{tuple(t.shape)}"
            )


# ----------------------------------------------------------------------
# Probe E: f32 GEMM, C = A^T B
# ----------------------------------------------------------------------
def sgemm_probe_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch probe E: A^T B for A [K, M], B [K, N] (full f32 with
    the port's precision policy: TF32 off)."""
    return torch.matmul(a.T, b)


def sgemm_probe(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A^T B on the CUDA cores in f32 FMA (probe E)."""
    if a.device.type == "cpu":
        return sgemm_probe_plain(a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"sgemm_probe: unsupported devices {a.device}, {b.device}")
    _check_f32("sgemm_probe", a, b)
    K, M = a.shape
    if b.shape[0] != K:
        raise ValueError(f"sgemm_probe: contraction axes differ, {K} and {b.shape[0]}")
    N = b.shape[1]
    lib = cuda_lib.load()
    c = torch.empty((M, N), dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    cuda_lib.check(
        lib.ns_sgemm_tn_f32(a.data_ptr(), b.data_ptr(), c.data_ptr(), M, N, K, stream),
        "sgemm_probe",
    )
    launch_counts["sgemm_probe"] += 1
    return c


# ----------------------------------------------------------------------
# Probe F: same-shape column gather
# ----------------------------------------------------------------------
@dataclasses.dataclass
class ColumnIndex:
    """Row indices of a column gather, range-checked once at build."""

    idx: torch.Tensor  # [n, W] int32, each in [0, n_src)
    idx64: torch.Tensor  # the same as int64 (torch.gather's index type)
    n_src: int


def column_index(idx: torch.Tensor, n_src: int) -> ColumnIndex:
    if idx.dim() != 2 or idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"column_index: expected an integer [n, W] tensor, got {idx.dtype} {tuple(idx.shape)}")
    lo, hi = (int(v) for v in torch.aminmax(idx))
    if lo < 0 or hi >= n_src:
        raise ValueError(f"column_index: rows in [{lo}, {hi}], outside [0, {n_src})")
    return ColumnIndex(
        idx=idx.to(torch.int32).contiguous(), idx64=idx.to(torch.int64), n_src=n_src
    )


def column_gather_plain(src: torch.Tensor, ci: ColumnIndex) -> torch.Tensor:
    """Plain PyTorch probe F: out[i, j] = src[idx[i, j], j]."""
    return torch.gather(src, 0, ci.idx64)


def column_gather(src: torch.Tensor, ci: ColumnIndex) -> torch.Tensor:
    """out[i, j] = src[idx[i, j], j] (probe F)."""
    if src.device.type == "cpu":
        return column_gather_plain(src, ci)
    if src.device.type != "cuda" or ci.idx.device != src.device:
        raise ValueError(f"column_gather: unsupported devices {src.device}, {ci.idx.device}")
    _check_f32("column_gather", src)
    if src.shape[0] != ci.n_src or ci.idx.shape[1] != src.shape[1]:
        raise ValueError(
            f"column_gather: src {tuple(src.shape)} does not match an index "
            f"built for {ci.n_src} rows and width {ci.idx.shape[1]}"
        )
    lib = cuda_lib.load()
    out = torch.empty(ci.idx.shape, dtype=torch.float32, device=src.device)
    stream = torch.cuda.current_stream(src.device).cuda_stream
    cuda_lib.check(
        lib.ns_column_gather_f32(
            src.data_ptr(), ci.idx.data_ptr(), out.data_ptr(), ci.idx.shape[0],
            ci.idx.shape[1], stream,
        ),
        "column_gather",
    )
    launch_counts["column_gather"] += 1
    return out
