"""The hand-written CUDA kernels against their plain PyTorch versions.

These tests need an NVIDIA card (sm_90a for the build) and skip without
one.  They import nothing of JAX, so on the card they run without the
repository's JAX test configuration:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Tolerances: kernel and plain version sum the same f32 terms in another
order (kernel B with shared-memory atomics, the slot reduce, the GEMM
probe and the coarse solve in their own fixed orders), so results agree
to a few f32 ulps of the largest entry; 1e-5 relative to max |plain| is
stated.  In float64 (kernels A-D and the coarse solve) the same holds in
f64 ulps: 1e-12 is stated.  The slot
gather and the column gather copy values: equality is exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

from navierstokes_project_nm4pde_tpu_torch.ops import coarse
from navierstokes_project_nm4pde_tpu_torch.ops import macroblock as mb
from navierstokes_project_nm4pde_tpu_torch.ops import onehot as oh
from navierstokes_project_nm4pde_tpu_torch.ops import probes

RTOL = 1e-5
RTOL64 = 1e-12


@pytest.fixture
def cuda():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU path runs the plain versions")
    return torch.device("cuda")


def _close(out, ref):
    assert out.dtype == ref.dtype, (out.dtype, ref.dtype)
    err = float((out - ref).abs().max())
    tol = RTOL64 if ref.dtype == torch.float64 else RTOL
    assert err <= tol * float(ref.abs().max()), err


def _lidx(B, c_blk, nloc, U, seed):
    """A valid local slot table: each cell's nodes are distinct slots."""
    rng = np.random.default_rng(seed)
    li = np.stack([
        np.stack([rng.choice(U, nloc, replace=False) for _ in range(c_blk)])
        for _ in range(B)
    ])
    return torch.as_tensor(li.astype(np.int32))


@pytest.mark.parametrize("C", range(1, 25))
def test_macro_matvec_takes_every_width_in_one_launch(cuda, C):
    """Every channel count up to 24 (the f_recycle = 7 wide round; 3 + 3k
    for f_warmstart = k) in one launch; 25 takes two."""
    B, U = 37, 128
    g = torch.Generator(device=cuda).manual_seed(C)
    FtT = torch.randn((B, U, U), generator=g, device=cuda)
    x_b = torch.randn((B, U, C), generator=g, device=cuda)
    before = mb.launch_counts["macro_matvec"]
    y = mb.macro_matvec(FtT, x_b)
    torch.cuda.synchronize()
    assert mb.launch_counts["macro_matvec"] == before + 1
    _close(y, mb.macro_matvec_plain(FtT, x_b))
    if C == 24:
        mb.macro_matvec(FtT, torch.randn((B, U, 25), generator=g, device=cuda))
        assert mb.launch_counts["macro_matvec"] == before + 3


@pytest.mark.parametrize("C", [25, 31, 48, 49])
def test_macro_matvec_splits_wide_payloads(cuda, C):
    """Past 24 channels (f_recycle > 7, f_warmstart > 4) the wrapper splits
    the payload into ceil(C / 24) launches of near-equal channel slices,
    each writing its slice of one output (FtT is read once a launch)."""
    B, U = 23, 128
    g = torch.Generator(device=cuda).manual_seed(C)
    FtT = torch.randn((B, U, U), generator=g, device=cuda)
    x_b = torch.randn((B, U, C), generator=g, device=cuda)
    before = mb.launch_counts["macro_matvec"]
    widths = dict(mb.matvec_channels)
    y = mb.macro_matvec(FtT, x_b)
    torch.cuda.synchronize()
    n = -(-C // 24)
    assert mb.launch_counts["macro_matvec"] == before + n
    assert all(hi - lo <= 24 for lo, hi in mb.matvec_splits(C, 24))
    assert sum(mb.matvec_channels.values()) - sum(widths.values()) == n
    _close(y, mb.macro_matvec_plain(FtT, x_b))


# U not a multiple of 4 (4-byte copies of FtT); U = 250 and 256 (more than
# 48 KB of shared memory at C = 24); U of one stage or less.
@pytest.mark.parametrize("B,U,C", [
    (1, 128, 3), (7, 128, 6), (33, 128, 1), (5, 64, 8), (3, 96, 3), (4, 30, 5), (3, 250, 24),
    (2, 256, 24), (6, 12, 15), (2, 16, 2),
])
def test_macro_matvec_matches_plain(cuda, B, U, C):
    g = torch.Generator(device=cuda).manual_seed(B * 100 + C)
    FtT = torch.randn((B, U, U), generator=g, device=cuda)
    x_b = torch.randn((B, U, C), generator=g, device=cuda)
    before = mb.launch_counts["macro_matvec"]
    y = mb.macro_matvec(FtT, x_b)
    torch.cuda.synchronize()
    assert mb.launch_counts["macro_matvec"] == before + 1
    _close(y, mb.macro_matvec_plain(FtT, x_b))


# Past 256 slots a block's output columns split over CTAs (a thread a
# column, bands of at most 256): U = 300 (bands of 160 and 140), 384 (two of
# 192) and 512 (two of 256), at the single run's 3 channels and each type's
# widest launch; odd block counts.
@pytest.mark.parametrize("dtype,C", [
    (torch.float32, 3), (torch.float32, 24), (torch.float64, 3), (torch.float64, 12),
])
@pytest.mark.parametrize("B,U", [(37, 300), (23, 384), (9, 512)])
def test_macro_matvec_bands_wide_blocks(cuda, B, U, dtype, C):
    assert mb.band_cols(dtype, C, U) == {300: 160, 384: 192, 512: 256}[U]
    g = torch.Generator(device=cuda).manual_seed(U + C)
    FtT = torch.randn((B, U, U), generator=g, device=cuda, dtype=dtype)
    x_b = torch.randn((B, U, C), generator=g, device=cuda, dtype=dtype)
    key = "macro_matvec" if dtype == torch.float32 else "macro_matvec_f64"
    before = dict(mb.launch_counts)
    y = mb.macro_matvec(FtT, x_b)
    torch.cuda.synchronize()
    assert mb.launch_counts == {**before, key: before[key] + 1}
    _close(y, mb.macro_matvec_plain(FtT, x_b))


# Odd block counts and a last block only partly filled with cells; more
# blocks than the persistent grid (132 CTAs at U = 128, a few per SM at
# smaller U), so each CTA walks many blocks and reuses both tiles and both
# stages; U < 128 with c_blk not dividing E, on the bulk-copy staging (even
# c_blk) and on the global-memory reads (odd c_blk: lidx rows are not
# 16-byte multiples).  Wide blocks, whose two tiles do not fit one CTA's
# shared memory, in bands of rows: U = 164 (two bands of 82), 192 at c_blk
# 34 (two of 96), 194 (U not a multiple of 4: even bands), 256 at c_blk 48
# (86, 86 and 84: U not a multiple of the band), 384 (seven, the last 54),
# more (block, band) items than the persistent grid, and odd c_blk.
BUILD_SHAPES = [
    (1, 20, 128, 0), (11, 20, 128, 7), (9, 5, 64, 4), (4, 3, 32, 0),
    (1500, 20, 128, 7), (2000, 14, 64, 5), (3000, 3, 32, 2),
    (301, 20, 164, 7), (133, 34, 192, 5), (41, 34, 194, 1), (301, 48, 256, 11),
    (45, 33, 256, 2), (67, 48, 384, 3), (3, 48, 384, 47),
]
# kernel B's rows a band at those widths (float32, nloc 10)
BUILD_BANDS = {(20, 164): 82, (34, 192): 96, (34, 194): 98, (48, 256): 86, (33, 256): 86, (48, 384): 55}


@pytest.mark.parametrize("B,c_blk,U,E_short", BUILD_SHAPES)
def test_macro_build_matches_plain(cuda, B, c_blk, U, E_short):
    """Kernel B against its plain version (shapes: BUILD_SHAPES)."""
    nloc = 10
    assert mb.band_rows(torch.float32, c_blk, nloc, U) == BUILD_BANDS.get((c_blk, U), U)
    E = B * c_blk - E_short
    lidx = _lidx(B, c_blk, nloc, U, seed=B + c_blk).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(E)
    F_e = torch.randn((E, nloc, nloc), generator=g, device=cuda)
    before = mb.launch_counts["macro_build"]
    out = mb.macro_build(F_e, lidx, B, U)
    torch.cuda.synchronize()
    assert mb.launch_counts["macro_build"] == before + 1
    _close(out, mb.macro_build_plain(F_e, lidx, B, U))


@pytest.mark.parametrize("B,c_blk,U,E_short", [
    (1295, 20, 128, 2), (40, 7, 64, 3), (33, 9, 128, 0), (301, 48, 256, 5), (133, 34, 192, 0),
    (67, 48, 384, 1), (41, 33, 256, 7),
])
def test_macro_build_on_triangles(cuda, B, c_blk, U, E_short):
    """Kernel B on 2D cells (nloc 6): the 118,071-DoF channel's plan shape
    (c_blk 20: bulk-copy staging) and odd c_blk, whose c_blk * nloc is not
    a multiple of 4 (the global-memory reads); wide blocks in bands."""
    nloc = 6
    E = B * c_blk - E_short
    lidx = _lidx(B, c_blk, nloc, U, seed=B + c_blk).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(E)
    F_e = torch.randn((E, nloc, nloc), generator=g, device=cuda)
    out = mb.macro_build(F_e, lidx, B, U)
    torch.cuda.synchronize()
    _close(out, mb.macro_build_plain(F_e, lidx, B, U))


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
    for half in (torch.bfloat16, torch.float16):
        with pytest.raises(ValueError):
            mb.macro_matvec(FtT.to(half), x_b.to(half))
    with pytest.raises(ValueError):
        mb.macro_matvec(FtT.double(), x_b)  # the types differ
    with pytest.raises(ValueError):
        mb.macro_matvec(FtT.transpose(1, 2), x_b)
    with pytest.raises(ValueError):
        mb.macro_matvec(FtT, x_b[:, :16])
    lidx = _lidx(2, 3, 10, 32, seed=0).to(cuda)
    F_e = torch.randn((6, 10, 10), device=cuda)
    for half in (torch.bfloat16, torch.float16):
        with pytest.raises(ValueError):
            mb.macro_build(F_e.to(half), lidx, 2, 32)
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


@pytest.mark.parametrize("E,n_rows,C", [
    (40, 97, 3), (300, 500, 12), (64, 150, 192), (50, 120, 384), (7, 30, 5), (60, 140, 1),
    (45, 110, 16), (45, 110, 17), (33, 90, 20),
])
def test_slot_reduce_and_gather_match_plain(cuda, E, n_rows, C):
    """Kernels C and D on all their paths: C <= 16 (a thread a channel),
    and wider C % 4 == 0 (16-byte vectors) and any other C (scalar)."""
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


@pytest.mark.parametrize("C", [1, 3, 6, 9, 16])
def test_slot_kernels_narrow_and_wide_designs_agree_bit_for_bit(cuda, C):
    """At C <= 16 the narrow kernels sum (and copy) in the wide designs'
    order: C channels alone give, bit for bit, what the same channels give
    as the first of a wide payload's (16-byte vectors at 32, scalar at
    33), in float32 and float64."""
    plans = oh.build_onehot_plans(_cells(200, 10, 350, seed=C), 350, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(C)
    for dtype in (torch.float32, torch.float64):
        for width in (32, 33):
            y = torch.randn((plans.n_slots, width), generator=g, device=cuda, dtype=dtype)
            x = torch.randn((350, width), generator=g, device=cuda, dtype=dtype)
            assert torch.equal(oh.onehot_reduce(plans, y[:, :C].contiguous()),
                               oh.onehot_reduce(plans, y)[:, :C])
            assert torch.equal(oh.onehot_gather(plans, x[:, :C].contiguous()),
                               oh.onehot_gather(plans, x)[:, :C])


@pytest.mark.parametrize("C", [3, 12])
def test_slot_kernels_on_a_fine_subset_plan(cuda, C):
    """Kernels C and D on an IMEX fine-subset plan: a strict subset of the
    cells against all the rows (rows outside the subset reduce to 0),
    valence below the full table's."""
    from navierstokes_project_nm4pde_tpu_torch.ops import operators as ops

    n_rows, E = 400, 300
    cells = _cells(E, 10, n_rows, seed=9)
    sub = np.random.default_rng(9).choice(E, 60, replace=False)
    full = oh.build_onehot_plans(cells, n_rows, device=cuda)
    plans = oh.build_onehot_plans(cells[sub], n_rows, device=cuda)
    assert int(plans.reduce.lengths.max()) < int(full.reduce.lengths.max())
    assert int((plans.reduce.lengths == 0).sum()) > 0
    g = torch.Generator(device=cuda).manual_seed(C)
    x = torch.randn((n_rows, C), generator=g, device=cuda)
    y = torch.randn((plans.n_slots, C), generator=g, device=cuda)
    assert torch.equal(oh.onehot_gather(plans, x), oh.onehot_gather_plain(plans, x))
    _close(oh.onehot_reduce(plans, y), oh.onehot_reduce_plain(plans, y))
    # the fine pass built on it, against the same pass on the CPU
    im = ops.ImexTables(
        f_idx=torch.as_tensor(sub, device=cuda), Jinv_f=None, detJ_f=None, plans=plans
    )
    C_ef = torch.randn((sub.size, 10, 10), generator=g, device=cuda)
    im_cpu = dataclasses.replace(
        im, plans=oh.build_onehot_plans(cells[sub], n_rows, device="cpu")
    )
    _close(ops.apply_convection_fine(im, C_ef, x).cpu(),
           ops.apply_convection_fine(im_cpu, C_ef.cpu(), x.cpu()))


def test_slot_kernels_reject_what_they_do_not_take(cuda):
    plans = oh.build_onehot_plans(_cells(20, 10, 60, seed=1), 60, device=cuda)
    for half in (torch.bfloat16, torch.float16):
        with pytest.raises(ValueError):
            oh.onehot_reduce(plans, torch.randn((plans.n_slots, 4), device=cuda).to(half))
        with pytest.raises(ValueError):
            oh.onehot_gather(plans, torch.randn((60, 4), device=cuda).to(half))
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


@pytest.mark.parametrize("C", [1, 3])
def test_slot_kernels_on_the_monolithic_paths_plan(cuda, C):
    """Kernels C and D on the element plan the monolithic stepper builds
    (a DFG duct in its Morton order) at the widths its element passes
    move: 3 channels (every F apply, D u, G p, M hist) and 1."""
    from navierstokes_project_nm4pde_tpu_torch.fem.space import build_taylor_hood
    from navierstokes_project_nm4pde_tpu_torch.mesh import cylinder_duct_3d

    space = build_taylor_hood(cylinder_duct_3d(lc=0.12, nz=4).reorder_spatial("morton"))
    plans = oh.build_onehot_plans(space.cells_u, space.n_unodes, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(C)
    y = torch.randn((plans.n_slots, C), generator=g, device=cuda)
    x = torch.randn((space.n_unodes, C), generator=g, device=cuda)
    before = dict(oh.launch_counts)
    out, ye = oh.onehot_reduce(plans, y), oh.onehot_gather(plans, x)
    torch.cuda.synchronize()
    assert oh.launch_counts["slot_reduce"] == before["slot_reduce"] + 1
    assert oh.launch_counts["slot_gather"] == before["slot_gather"] + 1
    _close(out, oh.onehot_reduce_plain(plans, y))
    assert torch.equal(ye, oh.onehot_gather_plain(plans, x))


# ---- float64 (the float64 runs): each kernel's _f64 entry point ----------
@pytest.mark.parametrize("B,U,C", [
    (37, 128, 1), (37, 128, 3), (11, 128, 12), (5, 30, 5), (3, 250, 12), (2, 256, 7), (4, 12, 2),
    (3, 31, 5), (6, 127, 12),
])
def test_macro_matvec_float64_matches_plain(cuda, B, U, C):
    """Kernel A in float64 up to its widest payload a launch (12), on the
    16-byte copies (U even) and one element a copy (odd U), counted under
    its float64 entry point."""
    assert mb.max_channels(torch.float64) == 12
    g = torch.Generator(device=cuda).manual_seed(B * 100 + C)
    FtT = torch.randn((B, U, U), generator=g, device=cuda, dtype=torch.float64)
    x_b = torch.randn((B, U, C), generator=g, device=cuda, dtype=torch.float64)
    before = dict(mb.launch_counts)
    y = mb.macro_matvec(FtT, x_b)
    torch.cuda.synchronize()
    assert mb.launch_counts == {**before, "macro_matvec_f64": before["macro_matvec_f64"] + 1}
    _close(y, mb.macro_matvec_plain(FtT, x_b))


@pytest.mark.parametrize("C", [13, 24, 25])
def test_macro_matvec_float64_splits_past_its_widest_payload(cuda, C):
    """Past 12 channels a float64 payload splits as a float32 one does past
    24: ceil(C / 12) launches, each writing its slice of one output."""
    B, U = 23, 128
    g = torch.Generator(device=cuda).manual_seed(C)
    FtT = torch.randn((B, U, U), generator=g, device=cuda, dtype=torch.float64)
    x_b = torch.randn((B, U, C), generator=g, device=cuda, dtype=torch.float64)
    before = mb.launch_counts["macro_matvec_f64"]
    y = mb.macro_matvec(FtT, x_b)
    torch.cuda.synchronize()
    assert mb.launch_counts["macro_matvec_f64"] == before + -(-C // 12)
    _close(y, mb.macro_matvec_plain(FtT, x_b))


@pytest.mark.parametrize("B,c_blk,U,E_short,nloc", [
    (11, 20, 128, 7, 10), (9, 5, 64, 4, 10), (1500, 20, 128, 7, 10), (33, 9, 128, 0, 10),
    (1295, 20, 128, 2, 6), (40, 7, 64, 3, 6), (6, 4, 168, 1, 10),
    (33, 20, 164, 1, 10), (133, 34, 192, 5, 10), (301, 48, 256, 11, 10), (41, 48, 384, 0, 10),
    (101, 48, 256, 7, 6), (67, 34, 192, 3, 6), (11, 48, 384, 29, 6),
])
def test_macro_build_float64_matches_plain(cuda, B, c_blk, U, E_short, nloc):
    """Kernel B in float64 (one tile a CTA) on tetrahedra and triangles, a
    last block partly filled, U = 168 (one tile, 225,792 bytes of shared
    memory), U = 164 (215,168), and U = 192-384 in bands of rows (113 f64
    rows of 256 fit: bands of 86, 86 and 84); counted under its float64
    entry point."""
    assert mb.band_rows(torch.float64, c_blk, nloc, U) == {192: 96, 256: 86, 384: 64}.get(U, U)
    E = B * c_blk - E_short
    lidx = _lidx(B, c_blk, nloc, U, seed=B + c_blk).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(E)
    F_e = torch.randn((E, nloc, nloc), generator=g, device=cuda, dtype=torch.float64)
    before = dict(mb.launch_counts)
    out = mb.macro_build(F_e, lidx, B, U)
    torch.cuda.synchronize()
    assert mb.launch_counts == {**before, "macro_build_f64": before["macro_build_f64"] + 1}
    _close(out, mb.macro_build_plain(F_e, lidx, B, U))


@pytest.mark.parametrize("U,R", [(170, 170), (172, 86), (256, 86)])
def test_macro_build_float64_bands_a_tile_past_shared_memory(cuda, U, R):
    """U = 170 needs 231,200 bytes, one tile a CTA; U = 172 (236,672) and
    256 do not fit and run in bands of R rows, one launch each."""
    assert mb.band_rows(torch.float64, 3, 10, U) == R
    lidx = _lidx(5, 3, 10, U, seed=U).to(cuda)
    F_e = torch.randn((14, 10, 10), device=cuda, dtype=torch.float64)
    before = mb.launch_counts["macro_build_f64"]
    out = mb.macro_build(F_e, lidx, 5, U)
    torch.cuda.synchronize()
    assert mb.launch_counts["macro_build_f64"] == before + 1
    _close(out, mb.macro_build_plain(F_e, lidx, 5, U))


# Very wide blocks: kernel A stages the [U, C] input panel in chunks of P
# rows where the whole panel no longer fits beside its column bands (up to
# U = 2,336 the bands narrow to make room, to 32 columns at 24 float32
# channels; at 12 float64 channels past 2,250; past U = 2,336 they stay at
# 256: at 3 float32 channels past 10,432), the accumulators kept across
# chunks; two blocks each.
@pytest.mark.parametrize("dtype,C,U,W,P", [
    (torch.float32, 24, 2336, 32, 2336), (torch.float32, 24, 2560, 256, 528),
    (torch.float64, 12, 2560, 256, 1056), (torch.float32, 3, 14464, 256, 3168),
    (torch.float64, 3, 14464, 256, 3168), (torch.float32, 3, 11904, 256, 3168),
])
def test_macro_matvec_stages_a_very_wide_panel_in_chunks(cuda, dtype, C, U, W, P):
    assert (mb.band_cols(dtype, C, U), mb.panel_rows(dtype, C, U)) == (W, P)
    g = torch.Generator(device=cuda).manual_seed(U + C)
    FtT = torch.randn((2, U, U), generator=g, device=cuda, dtype=dtype)
    x_b = torch.randn((2, U, C), generator=g, device=cuda, dtype=dtype)
    key = "macro_matvec" if dtype == torch.float32 else "macro_matvec_f64"
    before = dict(mb.launch_counts)
    y = mb.macro_matvec(FtT, x_b)
    torch.cuda.synchronize()
    assert mb.launch_counts == {**before, key: before[key] + 1}
    _close(y, mb.macro_matvec_plain(FtT, x_b))


# Very wide blocks in kernel B: past one band of two float32 tiles' rows
# (U not a multiple of 4: 13,442 at c_blk 20, 11,906 at 48) float32 takes
# the one-tile design in bands of R rows; past one band of its whole rows
# (float32 at U = 29,058, float64 at 29,184) the tiles are R x W.  U =
# 13,440 and 11,904 still run in one-row bands of two tiles.  One or two
# blocks, the last one cell short.
@pytest.mark.parametrize("dtype,c_blk,U,B,R,W", [
    (torch.float32, 20, 13440, 2, 1, 13440), (torch.float32, 20, 13442, 2, 4, 13442),
    (torch.float32, 48, 11904, 2, 1, 11904), (torch.float32, 48, 11906, 2, 4, 11906),
    (torch.float32, 20, 29058, 1, 15, 3648), (torch.float64, 20, 29184, 1, 14, 1952),
])
def test_macro_build_bands_very_wide_blocks(cuda, dtype, c_blk, U, B, R, W):
    nloc = 10
    assert (mb.band_rows(dtype, c_blk, nloc, U), mb.build_band_cols(dtype, c_blk, nloc, U)) == (R, W)
    E = B * c_blk - 1
    lidx = _lidx(B, c_blk, nloc, U, seed=U).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(U)
    F_e = torch.randn((E, nloc, nloc), generator=g, device=cuda, dtype=dtype)
    key = "macro_build" if dtype == torch.float32 else "macro_build_f64"
    before = dict(mb.launch_counts)
    out = mb.macro_build(F_e, lidx, B, U)
    torch.cuda.synchronize()
    assert mb.launch_counts == {**before, key: before[key] + 1}
    _close(out, mb.macro_build_plain(F_e, lidx, B, U))


@pytest.mark.parametrize("E,n_rows,C", [
    (40, 97, 1), (300, 500, 3), (60, 140, 9), (64, 150, 64), (64, 150, 192), (45, 110, 17),
    (33, 90, 20),
])
def test_slot_kernels_float64_match_plain(cuda, E, n_rows, C):
    """Kernels C and D in float64: narrow (C <= 16), wide on double2 vectors
    (C even) and scalar (C odd); C deterministic, D exact."""
    plans = oh.build_onehot_plans(_cells(E, 10, n_rows, seed=E), n_rows, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(C)
    y = torch.randn((plans.n_slots, C), generator=g, device=cuda, dtype=torch.float64)
    x = torch.randn((n_rows, C), generator=g, device=cuda, dtype=torch.float64)
    before = dict(oh.launch_counts)
    out = oh.onehot_reduce(plans, y)
    ye = oh.onehot_gather(plans, x)
    torch.cuda.synchronize()
    assert oh.launch_counts == {**before, "slot_reduce_f64": before["slot_reduce_f64"] + 1,
                                "slot_gather_f64": before["slot_gather_f64"] + 1}
    _close(out, oh.onehot_reduce_plain(plans, y))
    assert torch.equal(ye, oh.onehot_gather_plain(plans, x))
    assert torch.equal(oh.onehot_reduce(plans, y), out)


def _coarse_w(nc, dtype, device):
    """`frozen_cho_w` of an SPD matrix like the coarse Schur matrix: the
    leading [nc, nc] block of a 3D grid's Laplacian, shifted by 1e-6 of
    its mean diagonal as `host_coarse_dense` shifts."""
    n = int(np.ceil(nc ** (1 / 3)))
    idx = np.arange(n**3).reshape(n, n, n)
    A = np.zeros((n**3, n**3))
    for ax in range(3):
        a, b = (np.moveaxis(idx, ax, 0)[s].ravel() for s in (slice(None, -1), slice(1, None)))
        np.add.at(A, (a, b), -1.0)
        np.add.at(A, (b, a), -1.0)
        np.add.at(A, (a, a), 1.0)
        np.add.at(A, (b, b), 1.0)
    A = A[:nc, :nc]
    return coarse.frozen_cho_w(A + 1e-6 * np.trace(A) / nc * np.eye(nc), dtype, device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nc,cols", [(1708, 1), (88, 64), (301, 3), (45, 9)])
def test_coarse_solve_matches_plain(cuda, nc, cols, dtype):
    """The frozen coarse solve at the duct's (nc, 1 column: one warp a row,
    rows in bands of 8) and the sweep's (nc 88, 64 columns in groups of 8)
    shapes, an odd nc with 3 columns (a partial last band, a group of 4
    with one column masked) and 9 columns (a partial last group): two
    launches, and the plain version's result (1e-5 / 1e-12 of max |plain|:
    the same products summed in another order).  A 1-D rc takes the one
    column's path."""
    w = _coarse_w(nc, dtype, cuda)
    g = torch.Generator(device=cuda).manual_seed(nc + cols)
    rc = torch.randn((nc, cols), generator=g, device=cuda, dtype=dtype)
    key = "coarse_solve" if dtype == torch.float32 else "coarse_solve_f64"
    before = dict(coarse.launch_counts)
    z = coarse.coarse_solve(w, rc)
    torch.cuda.synchronize()
    assert coarse.launch_counts == {**before, key: before[key] + 2}
    assert z.shape == rc.shape and z.dtype == dtype
    _close(z, coarse.coarse_solve_plain(w, rc))
    if cols == 1:
        assert torch.equal(coarse.coarse_solve(w, rc[:, 0]), z[:, 0])


@pytest.mark.parametrize("nc,cols", [(1708, 1), (88, 64)])
def test_coarse_solve_replays_repeat_bit_for_bit(cuda, nc, cols):
    """Captured in a CUDA graph, two replays and an eager call give the same
    bits: no atomics, every sum in a fixed order."""
    w = _coarse_w(nc, torch.float32, cuda)
    rc = torch.randn((nc, cols), generator=torch.Generator(device=cuda).manual_seed(1), device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        coarse.coarse_solve(w, rc)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        z = coarse.coarse_solve(w, rc)
    graph.replay()
    first = z.clone()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(z, first)
    assert torch.equal(coarse.coarse_solve(w, rc), first)


def test_coarse_solve_rejects_what_the_kernel_does_not_take(cuda):
    w = _coarse_w(30, torch.float32, cuda)  # [30, 32]
    rc = torch.randn((30, 4), device=cuda)
    for half in (torch.bfloat16, torch.float16):
        with pytest.raises(ValueError):
            coarse.coarse_solve(w.to(half), rc.to(half))
    with pytest.raises(ValueError):
        coarse.coarse_solve(w, rc.double())  # the types differ
    with pytest.raises(ValueError):
        coarse.coarse_solve(w.cpu(), rc)  # the devices differ
    with pytest.raises(ValueError):
        coarse.coarse_solve(w, rc.T.contiguous().T)  # not contiguous
    with pytest.raises(ValueError):
        coarse.coarse_solve(w[:, :30].contiguous(), rc)  # ld not a multiple of 4
    with pytest.raises(ValueError):
        coarse.coarse_solve(w, rc[:29].contiguous())  # rows other than nc
    with pytest.raises(ValueError):
        coarse.coarse_solve(w, rc[None])  # three dimensions
