"""The hand-written CUDA kernels against their plain PyTorch versions.

These tests need an NVIDIA card (sm_90a for the build) and skip without
one.  They import nothing of JAX, so on the card they run without the
repository's JAX test configuration:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Tolerances: kernel and plain version sum the same f32 terms in another
order (kernel B with shared-memory atomics, the slot reduce and the GEMM
probe in their own fixed orders), so results agree to a few f32 ulps of
the largest entry; 1e-5 relative to max |plain| is stated.  The slot
gather and the column gather copy values: equality is exact.
"""

import numpy as np
import pytest
import torch

from navierstokes_project_nm4pde_tpu_torch.ops import macroblock as mb
from navierstokes_project_nm4pde_tpu_torch.ops import onehot as oh
from navierstokes_project_nm4pde_tpu_torch.ops import probes

RTOL = 1e-5


@pytest.fixture
def cuda():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU path runs the plain versions")
    return torch.device("cuda")


def _close(out, ref):
    err = float((out - ref).abs().max())
    assert err <= RTOL * float(ref.abs().max()), err


def _lidx(B, c_blk, nloc, U, seed):
    """A valid local slot table: each cell's nodes are distinct slots."""
    rng = np.random.default_rng(seed)
    li = np.stack([
        np.stack([rng.choice(U, nloc, replace=False) for _ in range(c_blk)])
        for _ in range(B)
    ])
    return torch.as_tensor(li.astype(np.int32))


@pytest.mark.parametrize("B,U,C", [(1, 128, 3), (7, 128, 6), (33, 128, 1), (5, 64, 8), (3, 96, 3)])
def test_macro_matvec_matches_plain(cuda, B, U, C):
    g = torch.Generator(device=cuda).manual_seed(B * 100 + C)
    FtT = torch.randn((B, U, U), generator=g, device=cuda)
    x_b = torch.randn((B, U, C), generator=g, device=cuda)
    before = mb.launch_counts["macro_matvec"]
    y = mb.macro_matvec(FtT, x_b)
    torch.cuda.synchronize()
    assert mb.launch_counts["macro_matvec"] == before + 1
    _close(y, mb.macro_matvec_plain(FtT, x_b))


# Odd block counts and a last block only partly filled with cells; more
# blocks than the persistent grid (132 CTAs at U = 128, a few per SM at
# smaller U), so each CTA walks many blocks and reuses both tiles and both
# stages; U < 128 with c_blk not dividing E, on the bulk-copy staging (even
# c_blk) and on the global-memory reads (odd c_blk: lidx rows are not
# 16-byte multiples).
BUILD_SHAPES = [
    (1, 20, 128, 0), (11, 20, 128, 7), (9, 5, 64, 4), (4, 3, 32, 0),
    (1500, 20, 128, 7), (2000, 14, 64, 5), (3000, 3, 32, 2),
]


@pytest.mark.parametrize("B,c_blk,U,E_short", BUILD_SHAPES)
def test_macro_build_matches_plain(cuda, B, c_blk, U, E_short):
    """Kernel B against its plain version (shapes: BUILD_SHAPES)."""
    nloc = 10
    E = B * c_blk - E_short
    lidx = _lidx(B, c_blk, nloc, U, seed=B + c_blk).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(E)
    F_e = torch.randn((E, nloc, nloc), generator=g, device=cuda)
    before = mb.launch_counts["macro_build"]
    out = mb.macro_build(F_e, lidx, B, U)
    torch.cuda.synchronize()
    assert mb.launch_counts["macro_build"] == before + 1
    _close(out, mb.macro_build_plain(F_e, lidx, B, U))


@pytest.mark.parametrize("B,c_blk,U,E_short", [(11, 20, 128, 7), (9, 5, 64, 4), (300, 20, 128, 3)])
def test_macro_build_v1_matches_plain_and_the_new_design(cuda, B, c_blk, U, E_short):
    """Kernel B's earlier design, kept to be timed beside the new one: it
    agrees with the plain version and with the new design, and launching
    it does not count as a launch of kernel B."""
    nloc = 10
    E = B * c_blk - E_short
    lidx = _lidx(B, c_blk, nloc, U, seed=B).to(cuda)
    F_e = torch.randn((E, nloc, nloc), generator=torch.Generator(device=cuda).manual_seed(B), device=cuda)
    before = mb.launch_counts["macro_build"]
    out = mb.macro_build_v1(F_e, lidx, B, U)
    torch.cuda.synchronize()
    assert mb.launch_counts["macro_build"] == before
    _close(out, mb.macro_build_plain(F_e, lidx, B, U))
    _close(mb.macro_build(F_e, lidx, B, U), out)
    with pytest.raises(ValueError):
        mb.macro_build_v1(F_e.cpu(), lidx.cpu(), B, U)  # no plain fallback


def test_macro_build_then_matvec_is_the_element_apply(cuda):
    """Block build and block matvec compose to sum_c F_c (x on the cell's
    slots), computed here cell by cell."""
    B, c_blk, U, nloc = 6, 4, 48, 10
    lidx = _lidx(B, c_blk, nloc, U, seed=3)
    g = torch.Generator().manual_seed(5)
    F_e = torch.randn((B * c_blk, nloc, nloc), generator=g)
    x_b = torch.randn((B, U, 3), generator=g)
    y = mb.macro_matvec(mb.macro_build(F_e.to(cuda), lidx.to(cuda), B, U), x_b.to(cuda))
    ref = torch.zeros((B, U, 3))
    li = lidx.long()
    for b in range(B):
        for c in range(c_blk):
            ref[b].index_add_(0, li[b, c], F_e[b * c_blk + c] @ x_b[b, li[b, c]])
    _close(y.cpu(), ref)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    FtT = torch.randn((2, 32, 32), device=cuda)
    x_b = torch.randn((2, 32, 3), device=cuda)
    with pytest.raises(ValueError):
        mb.macro_matvec(FtT.double(), x_b.double())
    with pytest.raises(ValueError):
        mb.macro_matvec(FtT.transpose(1, 2), x_b)
    with pytest.raises(ValueError):
        mb.macro_matvec(FtT, x_b[:, :16])
    lidx = _lidx(2, 3, 10, 32, seed=0).to(cuda)
    F_e = torch.randn((6, 10, 10), device=cuda)
    with pytest.raises(ValueError):
        mb.macro_build(F_e.double(), lidx, 2, 32)
    with pytest.raises(ValueError):
        mb.macro_build(F_e, lidx.long(), 2, 32)
    with pytest.raises(ValueError):
        mb.macro_build(F_e[:3], lidx, 2, 32)  # E does not fill the blocks
    with pytest.raises(ValueError):
        mb.macro_build(F_e, lidx, 2, 16)  # slots past U
    with pytest.raises(ValueError):
        mb.macro_build(F_e, lidx, 2, 33)  # odd U: the tile store moves 16-byte multiples


def _cells(E, nloc, n_rows, seed):
    """An element table with distinct nodes per cell; every row used."""
    rng = np.random.default_rng(seed)
    cells = np.stack([rng.choice(n_rows, nloc, replace=False) for _ in range(E)])
    cells[: n_rows // nloc, :] = np.arange(n_rows // nloc * nloc).reshape(-1, nloc)
    return cells


@pytest.mark.parametrize("E,n_rows,C", [(40, 97, 3), (300, 500, 12), (64, 150, 192), (50, 120, 384), (7, 30, 5)])
def test_slot_reduce_and_gather_match_plain(cuda, E, n_rows, C):
    """Kernels C and D on both their paths: C % 4 == 0 (16-byte vectors)
    and any other C (scalar)."""
    plans = oh.build_onehot_plans(_cells(E, 10, n_rows, seed=E), n_rows, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(C)
    y = torch.randn((plans.n_slots, C), generator=g, device=cuda)
    x = torch.randn((n_rows, C), generator=g, device=cuda)
    before = dict(oh.launch_counts)
    out = oh.onehot_reduce(plans, y)
    ye = oh.onehot_gather(plans, x)
    torch.cuda.synchronize()
    assert oh.launch_counts["slot_reduce"] == before["slot_reduce"] + 1
    assert oh.launch_counts["slot_gather"] == before["slot_gather"] + 1
    _close(out, oh.onehot_reduce_plain(plans, y))
    assert torch.equal(ye, oh.onehot_gather_plain(plans, x))
    # deterministic: a second reduce is bit-identical
    assert torch.equal(oh.onehot_reduce(plans, y), out)


def test_slot_kernels_reject_what_they_do_not_take(cuda):
    plans = oh.build_onehot_plans(_cells(20, 10, 60, seed=1), 60, device=cuda)
    with pytest.raises(ValueError):
        oh.onehot_reduce(plans, torch.randn((plans.n_slots, 4), device=cuda).double())
    with pytest.raises(ValueError):
        oh.onehot_reduce(plans, torch.randn((plans.n_slots - 1, 4), device=cuda))
    with pytest.raises(ValueError):
        oh.onehot_gather(plans, torch.randn((4, 60), device=cuda).T)


def _offset_view(shape, gen, device, offset):
    """A contiguous random tensor whose base is `offset` floats past an
    allocation's (16-byte) alignment."""
    n = int(np.prod(shape))
    return torch.randn((n + offset,), generator=gen, device=device)[offset:].view(shape)


# K, M, N: the probe's shape; an odd-sized one (4-byte copies); K shorter
# than one k-tile, and K = 0; K over many ring stages with edge tiles on
# the 16-byte path (M, N multiples of 4 but not of 128); one tile exactly;
# a tail k-tile with M not a multiple of 4.
@pytest.mark.parametrize("K,M,N", [
    (2048, 2048, 2048), (100, 130, 257), (8, 128, 128), (5, 64, 64), (0, 16, 16),
    (1000, 132, 260), (16, 128, 128), (33, 257, 130),
])
def test_sgemm_probe_matches_plain(cuda, K, M, N):
    g = torch.Generator(device=cuda).manual_seed(K + M + N)
    a = torch.randn((K, M), generator=g, device=cuda)
    b = torch.randn((K, N), generator=g, device=cuda)
    before = probes.launch_counts["sgemm_probe"]
    c = probes.sgemm_probe(a, b)
    torch.cuda.synchronize()
    assert probes.launch_counts["sgemm_probe"] == before + 1
    assert c.shape == (M, N)
    _close(c, probes.sgemm_probe_plain(a, b))


def test_sgemm_probe_takes_unaligned_bases(cuda):
    """Operands 4 bytes past 16-byte alignment take the 4-byte copies."""
    g = torch.Generator(device=cuda).manual_seed(7)
    a = _offset_view((96, 256), g, cuda, 1)
    b = _offset_view((96, 384), g, cuda, 3)
    assert a.data_ptr() % 16 and b.data_ptr() % 16
    _close(probes.sgemm_probe(a, b), probes.sgemm_probe_plain(a, b))


# The probe's shapes; widths that are not multiples of 4 (scalar kernel);
# fewer index rows than source rows.
@pytest.mark.parametrize("n_src,n,w", [
    *((n, n, w) for n, w in probes.GATHER_SHAPES), (1000, 1000, 7), (37, 37, 130),
    (3000, 500, 12), (5, 5, 1),
])
def test_column_gather_matches_plain(cuda, n_src, n, w):
    g = torch.Generator(device=cuda).manual_seed(n_src + n + w)
    src = torch.randn((n_src, w), generator=g, device=cuda)
    ci = probes.column_index(
        torch.randint(0, n_src, (n, w), generator=g, device=cuda, dtype=torch.int32), n_src
    )
    before = probes.launch_counts["column_gather"]
    out = probes.column_gather(src, ci)
    torch.cuda.synchronize()
    assert probes.launch_counts["column_gather"] == before + 1
    assert torch.equal(out, probes.column_gather_plain(src, ci))
    with pytest.raises(ValueError):
        probes.column_index(ci.idx + n_src, n_src)  # rows past the source


def test_column_gather_takes_an_unaligned_index(cuda):
    """An int32 index 4 bytes past 16-byte alignment takes the scalar kernel."""
    g = torch.Generator(device=cuda).manual_seed(11)
    n, w = 256, 64
    raw = torch.randint(0, n, (n * w + 1,), generator=g, device=cuda, dtype=torch.int32)
    ci = probes.column_index(raw[1:].view(n, w), n)
    assert ci.idx.data_ptr() % 16
    src = torch.randn((n, w), generator=g, device=cuda)
    assert torch.equal(probes.column_gather(src, ci), probes.column_gather_plain(src, ci))


def test_probes_reject_what_the_kernels_do_not_take(cuda):
    a = torch.randn((8, 16), device=cuda)
    with pytest.raises(ValueError):
        probes.sgemm_probe(a.double(), a.double())
    with pytest.raises(ValueError):
        probes.sgemm_probe(a.T, a)  # not contiguous
    with pytest.raises(ValueError):
        probes.sgemm_probe(a, torch.randn((9, 16), device=cuda))  # contraction axes differ
    with pytest.raises(ValueError):
        probes.sgemm_probe(a, a.cpu())
    src = torch.randn((32, 8), device=cuda)
    ci = probes.column_index(torch.zeros((32, 8), dtype=torch.int32, device=cuda), 32)
    with pytest.raises(ValueError):
        probes.column_gather(src.double(), ci)
    with pytest.raises(ValueError):
        probes.column_gather(src[:16], ci)  # not the index's source shape
    with pytest.raises(ValueError):
        probes.column_gather(torch.randn((8, 32), device=cuda).T, ci)  # not contiguous
    with pytest.raises(ValueError):
        probes.column_gather(src, probes.column_index(ci.idx.cpu(), 32))  # index on the CPU
