"""The port's measurement probes (ops/probes.py) against the TPU probes.

Probe E, `sgemm_probe` (C = A^T B), against a Pallas call, in interpret
mode, of the body of `probe_mxu_rate`'s kernel
(scripts/prof_macro_build_kernel.py:74-76: `dot_general` with the script's
DN, f32 accumulation); probe F, `column_gather`, against the Pallas
`gather_kernel` of scripts/prof_pallas_gather.py, loaded from the script.
Both get the same numpy inputs, made from a seed; on the CPU the port's
wrappers run their plain PyTorch versions.

Tolerances: E sums the same f32 products in another order than XLA's CPU
dot, so the two agree to a few f32 ulps of the largest entry; 1e-5
relative to max |ref| is stated.  F copies values: equality is exact.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from navierstokes_project_nm4pde_tpu_torch.ops import probes

REPO = Path(__file__).resolve().parents[1]
RTOL = 1e-5


def _script(name: str):
    """A TPU probe script under scripts/, loaded as a module (its main()
    does not run)."""
    spec = importlib.util.spec_from_file_location(f"_tpu_probe_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def mxu_probe():
    return _script("prof_macro_build_kernel")


@pytest.fixture(scope="module")
def gather_probe():
    return _script("prof_pallas_gather")


@pytest.mark.parametrize("K,M,N", [(32, 48, 40), (16, 8, 24), (7, 33, 5)])
def test_sgemm_probe_matches_the_pallas_dot(mxu_probe, K, M, N):
    def kern(a_ref, b_ref, o_ref):  # probe_mxu_rate's kernel body
        o_ref[:] = jax.lax.dot_general(
            a_ref[:], b_ref[:], mxu_probe.DN, preferred_element_type=jnp.float32
        )

    rng = np.random.default_rng(K * 100 + M + N)
    a = rng.standard_normal((K, M)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    ref = np.asarray(pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((M, N), jnp.float32), interpret=True,
    )(jnp.asarray(a), jnp.asarray(b)))
    before = dict(probes.launch_counts)
    out = probes.sgemm_probe(torch.from_numpy(a), torch.from_numpy(b))
    assert probes.launch_counts == before  # the CPU runs the plain version
    assert out.dtype == torch.float32 and out.shape == (M, N)
    err = np.abs(out.numpy() - ref).max()
    assert err <= RTOL * np.abs(ref).max(), err


# The TPU probe's same-shape gather; widths 6 and 1 are not multiples of 4.
@pytest.mark.parametrize("n,w", [(16, 8), (40, 12), (24, 6), (9, 1)])
def test_column_gather_matches_the_pallas_gather(gather_probe, n, w):
    rng = np.random.default_rng(n * 10 + w)
    src = rng.standard_normal((n, w)).astype(np.float32)
    idx = rng.integers(0, n, size=(n, w)).astype(np.int32)
    ref = np.asarray(pl.pallas_call(
        gather_probe.gather_kernel, out_shape=jax.ShapeDtypeStruct((n, w), jnp.float32),
        interpret=True,
    )(jnp.asarray(idx), jnp.asarray(src)))
    ci = probes.column_index(torch.from_numpy(idx), n)
    out = probes.column_gather(torch.from_numpy(src), ci)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)


def test_column_index_keeps_both_index_types():
    idx = torch.tensor([[0, 2], [1, 0], [2, 2]], dtype=torch.int64)
    ci = probes.column_index(idx, 3)
    assert ci.idx.dtype == torch.int32 and ci.idx.is_contiguous()
    assert ci.idx64.dtype == torch.int64
    assert torch.equal(ci.idx.long(), idx) and torch.equal(ci.idx64, idx)
    assert ci.n_src == 3 and ci.src_shape == (3, 2)


@pytest.mark.parametrize("idx,n_src", [
    (torch.tensor([[0, -1]], dtype=torch.int32), 4),  # a negative row
    (torch.tensor([[0, 4]], dtype=torch.int32), 4),  # a row past the source
    (torch.tensor([[0.0, 1.0]]), 4),  # not integers
    (torch.tensor([0, 1], dtype=torch.int32), 4),  # not [n, W]
])
def test_column_index_rejects_bad_rows(idx, n_src):
    with pytest.raises(ValueError):
        probes.column_index(idx, n_src)


def test_probes_reject_a_device_they_do_not_run_on():
    """Neither a CPU nor a CUDA tensor: no plain fallback, a ValueError."""
    a = torch.empty((4, 4), device="meta")
    with pytest.raises(ValueError):
        probes.sgemm_probe(a, a)
    ci = probes.column_index(torch.zeros((4, 4), dtype=torch.int32), 4)
    with pytest.raises(ValueError):
        probes.column_gather(a, ci)
