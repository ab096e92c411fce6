"""Krylov solvers in PyTorch: flexible GMRES, CG, recycled-projection CG,
the least-squares warm start, recycled-block GCR, and the fixed-iteration
inner solves of the block preconditioners.

The counterparts of the reference's `solvers/krylov.py` `_norm`, `fgmres`
(with `aux`), `cg`, `cg_recycled`, `ls_warmstart`, `gcr_recycled`,
`cg_fixed` and `gmres_fixed`, with the same algorithms and stopping rules,
so that a float64 run takes the same iteration counts as the reference.
The fixed-iteration solves never read a value back to the host.

The reference runs its loops under `lax.while_loop` on the device.  Here
the loops run in Python and read the residual norm back to the host once
per iteration (one device synchronisation each), which also keeps the
small Hessenberg/Givens algebra of FGMRES on the host in float64.

The CG loops (`cg`, `cg_recycled`) keep their state in tensors that one
function per loop updates in place, an iteration a call: the batched loop
also keeps its per-member stop mask, its counts and its tolerances on the
device, so the host only reads the residuals.  Given a `CGGraphs` cache
(the projection step's pressure solve on the frozen S1 and its two-level
preconditioner, on the card, with no process group), that function is
captured once per loop and shape as CUDA graphs cut at the layers' spans,
and each iteration is one replay of them; every other caller runs it
eagerly.  The FGMRES and GCR loops read operators that change every step
and stay eager.

Every solver also solves [n, B] batches, one column per ensemble member
(`gcr_recycled` and `cg_recycled` with pools [k, n, B]), with the
semantics of `jax.vmap` over the reference's loops: each member iterates
exactly as its own solve would, with its own tolerance and iteration
count, and a member that has stopped is frozen while the others run on.
In FGMRES the members still iterating share the inner index j, so their
restart cycles run in lockstep.  One host sync per iteration reads all B
residuals; a single system is the batch B = 1.  A zero norm in one
column is guarded in that column alone.

`fgmres` takes a process `group` (the owned+halo step of
`parallel/halo_step.py`): each rank then holds its block of every vector,
and every dot product is all-reduced over the group (the reference's
`axis_name` psum), so that every rank reads the same norms and takes the
same branch.

Each iteration runs inside a span (`utils/profiling.py`:
`krylov.fgmres.iter`, `krylov.fgmres.cycle` for a cycle's back
substitution and update, `krylov.cg.iter`, `krylov.cg_recycled.iter`,
`krylov.gcr.iter`), each read of a value to the host inside a `host_read`
span and each synchronising copy of a host array to the device inside a
`host_write` span; with no profiler running a span costs one flag check.
A replayed CG iteration runs inside its iteration span as consecutive
graph launches, each layer it calls (`precond.coarse_solve`,
`schur.banded_matvec`) inside that layer's span with the sizes of an eager
call.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import warnings
from typing import Callable, NamedTuple

import numpy as np
import torch

from navierstokes_project_nm4pde_tpu_torch.utils.profiling import cutting, setup_phase, span


class SolveInfo(NamedTuple):
    iters: int  # total iterations performed
    residual: float  # final residual norm


def _dot(x, y, precise: bool):
    if precise and x.dtype != torch.float64:
        return torch.dot(x.double(), y.double()).to(x.dtype)
    return torch.dot(x, y)


def _norm(x, precise: bool):
    return torch.sqrt(_dot(x, x, precise))


def _matvec_dots(V, w, precise: bool):
    """Row-wise dot products V @ w as one matmul (optionally f64)."""
    if precise and V.dtype != torch.float64:
        return (V.double() @ w.double()).to(w.dtype)
    return V @ w


def _dot2(x, y, precise: bool):
    """(x.y, y.y) in one reduction."""
    xs = _matvec_dots(torch.stack([x, y]), y, precise)
    return xs[0], xs[1]


def _allsum(t: torch.Tensor, group) -> torch.Tensor:
    """t summed over the ranks of `group` (None: t)."""
    if group is not None:
        import torch.distributed as dist

        dist.all_reduce(t, group=group)
    return t


# Column-wise forms for [n, B] batches (one column per member).
def _cdot(x, y, precise: bool, group=None):
    """[B] column dot products."""
    if precise and x.dtype != torch.float64:
        return _allsum((x.double() * y.double()).sum(0), group).to(x.dtype)
    return _allsum((x * y).sum(0), group)


def _cnorm(x, precise: bool, group=None):
    return torch.sqrt(_cdot(x, x, precise, group))


def _bdots(V, w, precise: bool, group=None):
    """[B, k] dot products of each member's basis rows V [B, k, n] with its
    vector w [B, n] (one batched matmul)."""
    if precise and V.dtype != torch.float64:
        return _allsum(torch.bmm(V.double(), w.double()[:, :, None])[:, :, 0], group).to(w.dtype)
    return _allsum(torch.bmm(V, w[:, :, None])[:, :, 0], group)


def _gram(S, precise: bool):
    """[B, k, k] Gram matrices S S^T of member-major rows S [B, k, n]."""
    if precise and S.dtype != torch.float64:
        return torch.bmm(S.double(), S.double().transpose(1, 2)).to(S.dtype)
    return torch.bmm(S, S.transpose(1, 2))


def _rows(x: torch.Tensor) -> torch.Tensor:
    """[n, B] columns (or pool rows [k, n, B]) -> member-major [B, n]
    ([B, k, n])."""
    return x.movedim(-1, 0).contiguous()


def _bcomb(c, V):
    """[B, n] combinations sum_k c[b, k] V[b, k, :] of basis rows."""
    return torch.bmm(c[:, None, :], V)[:, 0]


def _host(t: torch.Tensor) -> np.ndarray:
    """A small tensor as float64 numpy (the host sync)."""
    with span("host_read"):
        return t.detach().to("cpu", torch.float64).numpy()


def _host_float(t: torch.Tensor) -> float:
    """A 0-d tensor as a float (the host sync)."""
    with span("host_read"):
        return float(t)


def _to_device(a, like: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """A host array on `like`'s device (from pageable memory the copy
    waits for the device's queue)."""
    with span("host_write"):
        return torch.as_tensor(a, dtype=dtype, device=like.device)


# ----------------------------------------------------------------------
# Flexible GMRES
# ----------------------------------------------------------------------
def fgmres(
    A: Callable,
    b: torch.Tensor,
    M: Callable | None = None,
    x0: torch.Tensor | None = None,
    *,
    rtol: float = 1e-6,
    atol=0.0,
    restart: int = 50,
    maxiter: int = 200,
    precise: bool = True,
    tol_mode: str = "r0",
    aux: bool = False,
    group=None,
):
    """Solve A x = b by right-preconditioned flexible GMRES (CGS2
    orthogonalisation, Givens rotations, restarts).  Returns (x, SolveInfo).

    b is one system [n] or B systems [n, B] (A and M then map [n, B] ->
    [n, B] column by column, `atol` is a float or a [B] array, and
    SolveInfo holds [B] numpy iterations and residuals).
    tol_mode: "r0" (rtol relative to ||b - A x0||), "b" (to ||b||) or
    "abs" (absolute).  A zero guess (x0=None) skips the A(x0) apply.

    aux=True: A returns (A z, f(z)) with f linear (for [n, B] columns, f's
    output carries the members on its trailing axis), and the return is
    (x, SolveInfo, f(x)) with f(x) combined from the iterations' values
    (None when x0 is None and no iteration ran: then x = 0)."""
    if M is None:
        M = lambda v: v  # noqa: E731
    if b.dim() == 1:
        if aux:
            def A1(v):
                y, a = A(v[:, 0])
                return y[:, None], a[..., None]
        else:
            A1 = lambda v: A(v[:, 0])[:, None]  # noqa: E731
        out = fgmres(
            A1, b[:, None], lambda v: M(v[:, 0])[:, None],
            None if x0 is None else x0[:, None], rtol=rtol, atol=atol,
            restart=restart, maxiter=maxiter, precise=precise, tol_mode=tol_mode,
            aux=aux, group=group,
        )
        x, info = out[0][:, 0], SolveInfo(iters=int(out[1].iters[0]), residual=float(out[1].residual[0]))
        if aux:
            return x, info, None if out[2] is None else out[2][..., 0]
        return x, info
    A_full = A if aux else (lambda z: (A(z), None))
    n, B = b.shape
    m = restart
    aux_x = None
    if x0 is None:
        r = b
    else:
        w0, aux_x = A_full(x0)
        r = b - w0
    res = _host(_cnorm(r, precise, group))
    if tol_mode == "r0":
        ref = res
    elif tol_mode == "b":
        ref = _host(_cnorm(b, precise, group))
    elif tol_mode == "abs":
        ref = np.ones(B)
    else:
        raise ValueError(f"unknown tol_mode: {tol_mode}")
    tol = np.maximum(rtol * ref, np.broadcast_to(np.asarray(atol, np.float64), (B,)))

    # Inside, vectors are member-major rows [B, n], so that each member's
    # basis is one contiguous [k, n] block and the Gram-Schmidt products
    # are batched matmuls (A and M still see [n, B] columns).
    r = r.T.contiguous()
    x = torch.zeros_like(r) if x0 is None else x0.T.contiguous()
    iters = np.zeros(B, np.int64)
    active = (res > tol) & (iters < maxiter)
    while active.any():
        beta_t = _cnorm(r.T, precise, group)
        beta = _host(beta_t)
        V = r.new_zeros((B, m + 1, n))
        Z = r.new_zeros((B, m, n))
        H = np.zeros((B, m + 1, m))
        cs = np.zeros((B, m))
        sn = np.zeros((B, m))
        g = np.zeros((B, m + 1))
        g[:, 0] = beta
        V[:, 0] = torch.where(beta_t[:, None] > 0, r / beta_t[:, None], r)
        Zaux = []
        jm = np.zeros(B, np.int64)  # each member's inner iterations this cycle
        res_c = beta.copy()
        j = 0
        while j < m:
            live = active & (res_c > tol)
            if not live.any():
                break
            with span("krylov.fgmres.iter"):
                z = M(V[:, j].T)
                w, a = A_full(z)
                w = w.T.contiguous()
                Zaux.append(a)
                Vj = V[:, : j + 1]
                h1 = _bdots(Vj, w, precise, group)
                w = w - _bcomb(h1, Vj)
                h2 = _bdots(Vj, w, precise, group)
                w = w - _bcomb(h2, Vj)
                hlast_t = _cnorm(w.T, precise, group)
                hcol = _host(torch.cat([h1 + h2, hlast_t[:, None]], dim=1)).T  # the sync, [j+2, B]
                V[:, j + 1] = torch.where(hlast_t[:, None] > 0, w / hlast_t[:, None], w)
                Z[:, j] = z.T

                for i in range(j):  # accumulated Givens rotations, all members
                    t1 = cs[:, i] * hcol[i] + sn[:, i] * hcol[i + 1]
                    t2 = -sn[:, i] * hcol[i] + cs[:, i] * hcol[i + 1]
                    hcol[i], hcol[i + 1] = t1, t2
                denom = np.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
                safe = np.where(denom > 0, denom, 1.0)
                c = np.where(denom > 0, hcol[j] / safe, 1.0)
                s_ = np.where(denom > 0, hcol[j + 1] / safe, 0.0)
                hcol[j], hcol[j + 1] = denom, 0.0
                # only the members still iterating take this column
                cs[live, j], sn[live, j] = c[live], s_[live]
                H[live, : j + 2, j] = hcol.T[live]
                gj = g[:, j].copy()
                g[live, j + 1] = -s_[live] * gj[live]
                g[live, j] = c[live] * gj[live]
                res_c = np.where(live, np.abs(g[:, j + 1]), res_c)
                jm += live
                j += 1

        with span("krylov.fgmres.cycle"):
            # per member, as the reference masks it: y = H[:jm, :jm]^-1 g[:jm]
            # by back substitution (an identity block past jm), x += Z^T y, and
            # the next residual from the recurrence, r = g[jm] V^T Q^T e_jm
            act = np.arange(m)[None, :] < jm[:, None]  # [B, m]
            Hm = np.where(act[:, :, None] & act[:, None, :], H[:, :m, :m], 0.0)
            Hm[:, np.arange(m), np.arange(m)] += np.where(act, 0.0, 1.0)
            gm = np.where(act, g[:, :m], 0.0)
            Y = np.zeros((B, m))
            for i in range(m - 1, -1, -1):
                Y[:, i] = (gm[:, i] - (Hm[:, i, i + 1:] * Y[:, i + 1:]).sum(1)) / Hm[:, i, i]
            rows = np.arange(B)
            wv = np.zeros((B, m + 1))
            wv[rows, jm] = 1.0
            for i in range(m - 1, -1, -1):  # Q^T e_jm: apply G_i^T in reverse, i < jm
                wi = cs[:, i] * wv[:, i] - sn[:, i] * wv[:, i + 1]
                wi1 = sn[:, i] * wv[:, i] + cs[:, i] * wv[:, i + 1]
                sel = i < jm
                wv[:, i] = np.where(sel, wi, wv[:, i])
                wv[:, i + 1] = np.where(sel, wi1, wv[:, i + 1])
            Cr = g[rows, jm][:, None] * wv
            on = _to_device(active, b)[:, None]
            Yt = _to_device(Y, b, b.dtype)
            Crt = _to_device(Cr, b, b.dtype)
            x = torch.where(on, x + _bcomb(Yt, Z), x)
            r = torch.where(on, _bcomb(Crt, V), r)
            if aux and Zaux:
                # f(Z^T y) = sum_j y_j f(z_j); y is 0 for members not iterating
                inc = sum(a * Yt[:, i] for i, a in enumerate(Zaux))
                aux_x = inc if aux_x is None else aux_x + inc
            res = np.where(active, res_c, res)
            iters = iters + np.where(active, jm, 0)
            active = (res > tol) & (iters < maxiter)
    x = x.T.contiguous()
    if aux:
        return x, SolveInfo(iters=iters, residual=res), aux_x
    return x, SolveInfo(iters=iters, residual=res)


# ----------------------------------------------------------------------
# CG
# ----------------------------------------------------------------------
class CGGraphs:
    """CUDA graphs of CG iterations whose operators never change.

    One iteration's graphs per key (the loop, its shapes, dtype and
    settings), captured at the key's first solve and replayed by every
    later one: A and M must read only tensors that outlive the cache (one
    solver's frozen operators).  The capture is cut at each span given
    sizes (`schur.banded_matvec`, `precond.coarse_solve`) into consecutive
    graphs (`_Cuts`), so that a replay runs each layer's kernels inside
    its span with the sizes of an eager call, as an eager iteration does.
    The capture is timed as set-up phase `setup.krylov_graphs`.  All
    graphs share one memory pool; `replays` counts the iterations
    replayed."""

    WARMUP = 3  # eager iterations on the scratch state before a capture

    def __init__(self):
        self._graphs: dict = {}
        self._pool = None
        self.replays = 0

    def load(self, key, body, state: list):
        """(key's static tensors, loaded with `state`; a function that
        replays one iteration on them), capturing `body(static)` first if
        the key is new."""
        if key not in self._graphs:
            with setup_phase("setup.krylov_graphs"):
                self._graphs[key] = self._capture(body, state)
        cuts, static = self._graphs[key]
        for s, t in zip(static, state):
            s.copy_(t)
        dev = static[0].device

        def replay():
            with torch.cuda.device(dev):
                cuts.replay()
            self.replays += 1

        return static, replay

    def _capture(self, body, state: list):
        # PyTorch keeps a cuBLAS workspace (32 MiB on sm90) for each stream
        # that calls cuBLAS.  Dropping them before the warm-up, before the
        # capture and after it (torch._inductor's cudagraph trees do the
        # same) keeps one allocated at a time: the graph's own, allocated
        # while it is captured, goes back to the graph pool, which only
        # these graphs' captures draw on, and its replays keep using it.
        dev = state[0].device
        with torch.cuda.device(dev):
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            static = [t.clone() for t in state]  # the warm-up's scratch, then the graph's
            torch._C._cuda_clearCublasWorkspaces()
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(self.WARMUP):
                    body(static)
            torch.cuda.current_stream(dev).wait_stream(side)
            torch._C._cuda_clearCublasWorkspaces()
            # as torch.cuda.graph does before a capture
            torch.cuda.synchronize(dev)
            gc.collect()
            torch.cuda.empty_cache()
            cuts = _Cuts(self._pool)
            with torch.cuda.stream(side), cutting(cuts.span):
                cuts.begin()
                body(static)
                cuts.end()
            torch.cuda.current_stream(dev).wait_stream(side)
            torch._C._cuda_clearCublasWorkspaces()
        return cuts, static


class _Cuts:
    """One capture on the current (side) stream, cut into consecutive
    graphs at each span given sizes: `parts` [(span name, its sizes,
    graph)] in the order they run, name None for the work between spans
    (left out where there is none).  Graphs of one pool captured one after
    another may pass tensors on, since they are replayed in the same
    order.  Spans given sizes do not nest.  `graph` is the graph class
    (`torch.cuda.CUDAGraph`)."""

    def __init__(self, pool, graph=None):
        self.pool, self.parts, self._empty = pool, [], []
        self._graph = graph or torch.cuda.CUDAGraph

    def begin(self, name=None, sizes=None):
        graph = self._graph()
        graph.capture_begin(self.pool)
        self.parts.append((name, sizes, graph))

    def end(self):
        name, _, graph = self.parts[-1]
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            graph.capture_end()
        for w in caught:
            if name is None and "CUDA Graph is empty" in str(w.message):
                # no work between two spans: nothing to replay, but the graph
                # is kept, since freeing a graph of the pool while later
                # captures still draw on it breaks the pool
                self._empty.append(self.parts.pop()[2])
            else:
                warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)

    @contextlib.contextmanager
    def span(self, name: str, sizes: dict):
        self.end()
        self.begin(name, sizes)
        yield
        self.end()
        self.begin()

    def replay(self):
        for name, sizes, graph in self.parts:
            if name is None:
                graph.replay()
            else:
                with span(name, **sizes):
                    graph.replay()


def _iterations(body, state: list, graphs: CGGraphs | None, key):
    """(the loop's tensors, a function running one iteration on them):
    `body` eagerly, or with `graphs` the replay of key's graph on its
    static tensors.  The eager loop works on copies of the vectors x, r
    and p: x and r may be the caller's (x0, b) or a projection's that the
    harvest reads again, and p is r itself where M is the identity; the
    per-member scalars are the loop's own."""
    if graphs is None:
        st = [t.clone() for t in state[:3]] + state[3:]
        return st, functools.partial(body, st)
    return graphs.load(key, body, state)


def cg(
    A: Callable,
    b: torch.Tensor,
    M: Callable | None = None,
    x0: torch.Tensor | None = None,
    *,
    rtol: float = 1e-6,
    atol=0.0,
    maxiter: int = 1000,
    precise: bool = True,
    graphs: CGGraphs | None = None,
):
    """Preconditioned CG for B systems at once: b [n, B], A and M map
    [n, B] -> [n, B] column by column; `atol` is a float or a [B] array.
    The residual norm rides the loop (fused with r.z), as in the
    reference.  Returns (x [n, B], SolveInfo with [B] numpy iters and
    residuals).  A single system is the case B = 1.  With `graphs`, each
    iteration is a replay of CUDA graphs (`CGGraphs`)."""
    if x0 is None:
        x, r = torch.zeros_like(b), b
    else:
        x, r = x0, b - A(x0)
    x, r, info = _cg_columns(A, M, b, x, r, rtol, atol, maxiter, precise, "krylov.cg.iter", graphs)
    return x, info


def _cg_columns_iter(A, M, st: list, maxiter: int, precise: bool):
    """One iteration of the batched CG loop, in place on its state st = [x,
    r, p, rz, res, k, tol]: the members with res > tol and k < maxiter take
    it, the others stay frozen; res (float64) and the counts k follow."""
    x, r, p, rz, res, k, tol = st
    on = (res > tol) & (k < maxiter)
    Ap = A(p)
    alpha = rz / _cdot(p, Ap, precise)
    torch.where(on, x + alpha * p, x, out=x)
    r_new = r - alpha * Ap
    z = M(r_new)
    rz_new, rr = _cdot(z, r_new, precise), _cdot(r_new, r_new, precise)
    torch.where(on, z + (rz_new / rz) * p, p, out=p)
    torch.where(on, r_new, r, out=r)
    torch.where(on, rz_new, rz, out=rz)
    torch.where(on, torch.sqrt(rr).double(), res, out=res)
    k.add_(on)


def _cg_columns(A, M, b, x, r, rtol, atol, maxiter, precise, name, graphs=None):
    """The CG loop on [n, B] columns from the iterate x and its residual r
    (the tolerance against ||b||), each iteration in span `name`; returns
    (x, r, SolveInfo).  The device decides which members iterate, from the
    same float64 residuals and tolerances as the host's `active`, so the
    two agree bit for bit and the host reads the residuals alone."""
    if M is None:
        M = lambda v: v  # noqa: E731
    B = b.shape[1]
    z = M(r)
    rz, rr = _cdot(z, r, precise), _cdot(r, r, precise)
    res_t = torch.sqrt(rr).double()
    res = _host(res_t)
    bnorm = _host(_cnorm(b, precise))
    tol = np.maximum(rtol * bnorm, np.broadcast_to(np.asarray(atol, np.float64), (B,)))
    k = np.zeros(B, np.int64)
    active = (res > tol) & (k < maxiter)
    if not active.any():
        return x, r, SolveInfo(iters=k, residual=res)
    state = [x, r, z, rz, res_t, torch.zeros(B, dtype=torch.int64, device=b.device),
             _to_device(tol, b, torch.float64)]
    body = functools.partial(_cg_columns_iter, A, M, maxiter=maxiter, precise=precise)
    st, step = _iterations(body, state, graphs, ("columns", tuple(b.shape), b.dtype, maxiter, precise))
    while active.any():
        with span(name):
            step()
            res = _host(st[4])  # the sync
            k = k + active
            active = (res > tol) & (k < maxiter)
    x, r = st[0], st[1]
    if graphs is not None:  # out of the static tensors
        x, r = x.clone(), r.clone()
    return x, r, SolveInfo(iters=k, residual=res)


# ----------------------------------------------------------------------
# CG with a recycled projection space (frozen operators only)
# ----------------------------------------------------------------------
def cg_recycled(
    A: Callable,
    b: torch.Tensor,
    M: Callable | None,
    x0: torch.Tensor | None,
    poolD: torch.Tensor,
    poolW: torch.Tensor,
    *,
    rtol: float = 1e-6,
    atol: float = 0.0,
    maxiter: int = 1000,
    precise: bool = True,
    graphs: CGGraphs | None = None,
):
    """Preconditioned CG warm-started by a least-squares projection onto
    recycled directions `poolD` [k, n] whose exact images `poolW = A poolD`
    are carried along (valid only for an operator frozen across calls).
    Zero pool rows are ignored.  Returns (x, SolveInfo, harvest) with
    harvest = [x - x_proj, r_proj - r_final] ([2, n]): the next pool row
    (direction, image) of this call's CG increment.  For B columns b
    [n, B] the pools are [k, n, B] and the harvest [2, n, B], each member
    projected on its own pool.  `graphs`: as in `cg`."""
    if b.dim() == 2:
        return _cg_recycled_columns(A, b, M, x0, poolD, poolW, rtol, atol, maxiter, precise, graphs)
    if M is None:
        M = lambda v: v  # noqa: E731
    if x0 is None:
        x0 = torch.zeros_like(b)
        r = b
    else:
        r = b - A(x0)
    k = poolD.shape[0]
    dtype = b.dtype

    S = torch.cat([poolW, r[None, :]], dim=0)
    G = _matvec_dots(S, S.T, precise)  # [k+1, k+1]
    wn = torch.sqrt(torch.clamp(torch.diagonal(G)[:k], min=0.0))
    sc = torch.where(wn > 0, 1.0 / wn, torch.zeros_like(wn))
    eye = torch.eye(k, dtype=dtype, device=b.device)
    Gn = G[:k, :k] * sc[:, None] * sc[None, :] + 1e-5 * eye
    Gn = torch.where((eye > 0) & (wn == 0)[:, None], torch.ones_like(Gn), Gn)
    h = G[:k, k] * sc
    c = torch.linalg.solve_ex(Gn, h).result
    Dn = poolD * sc[:, None]
    Wn = poolW * sc[:, None]
    x = x0 + c @ Dn
    r = r - c @ Wn
    c2 = torch.linalg.solve_ex(Gn, _matvec_dots(Wn, r, precise)).result
    x = x + c2 @ Dn
    r = r - c2 @ Wn
    x_proj, r_proj = x, r

    z = M(r)
    rz, rr = _dot2(z, r, precise)
    res_t = torch.sqrt(rr)
    res = _host_float(res_t)
    tol = max(rtol * _host_float(_norm(b, precise)), float(atol))
    j = 0
    if res > tol and j < maxiter:
        body = functools.partial(_cg_vector_iter, A, M, precise=precise)
        st, step = _iterations(body, [x, r, z, rz, res_t], graphs,
                               ("vector", tuple(b.shape), dtype, precise))
        while res > tol and j < maxiter:
            with span("krylov.cg_recycled.iter"):
                step()
                res = _host_float(st[4])  # the sync
                j += 1
        x, r = st[0], st[1]
        if graphs is not None:  # out of the static tensors
            x, r = x.clone(), r.clone()
    harvest = torch.stack([x - x_proj, r_proj - r])
    return x, SolveInfo(iters=j, residual=res), harvest


def _cg_vector_iter(A, M, st: list, precise: bool):
    """One iteration of the single-vector CG loop, in place on its state
    st = [x, r, p, rz, res] (rz and res 0-d)."""
    x, r, p, rz, res = st
    Ap = A(p)
    alpha = rz / _dot(p, Ap, precise)
    x.add_(alpha * p)
    r.sub_(alpha * Ap)
    z = M(r)
    rz_new, rr = _dot2(z, r, precise)
    torch.add(z, (rz_new / rz) * p, out=p)
    rz.copy_(rz_new)
    torch.sqrt(rr, out=res)


def _cg_recycled_columns(A, b, M, x0, poolD, poolW, rtol, atol, maxiter, precise, graphs=None):
    """`cg_recycled` for B members at once (b [n, B], pools [k, n, B]):
    each member's projection on its own pool, then the batched CG."""
    if x0 is None:
        x0, r = torch.zeros_like(b), b
    else:
        r = b - A(x0)
    k = poolD.shape[0]
    Wm, Dm = _rows(poolW), _rows(poolD)  # [B, k, n]
    G = _gram(torch.cat([Wm, _rows(r)[:, None]], dim=1), precise)  # [B, k+1, k+1]
    wn = torch.sqrt(torch.clamp(torch.diagonal(G, dim1=1, dim2=2)[:, :k], min=0.0))
    sc = torch.where(wn > 0, 1.0 / wn, torch.zeros_like(wn))
    eye = torch.eye(k, dtype=b.dtype, device=b.device)
    Gn = G[:, :k, :k] * sc[:, :, None] * sc[:, None, :] + 1e-5 * eye
    Gn = torch.where((eye > 0) & (wn == 0)[:, :, None], torch.ones_like(Gn), Gn)
    c = torch.linalg.solve_ex(Gn, G[:, :k, k] * sc).result
    Dn, Wn = Dm * sc[:, :, None], Wm * sc[:, :, None]
    x = x0 + _bcomb(c, Dn).T
    r = r - _bcomb(c, Wn).T
    c2 = torch.linalg.solve_ex(Gn, _bdots(Wn, _rows(r), precise)).result
    x = x + _bcomb(c2, Dn).T
    r = r - _bcomb(c2, Wn).T
    x_proj, r_proj = x, r
    x, r, info = _cg_columns(A, M, b, x, r, rtol, atol, maxiter, precise, "krylov.cg_recycled.iter",
                             graphs)
    return x, info, torch.stack([x - x_proj, r_proj - r])


# ----------------------------------------------------------------------
# Least-squares warm start from (direction, image) pairs
# ----------------------------------------------------------------------
def ls_warmstart(D: torch.Tensor, Y: torch.Tensor, r0: torch.Tensor, precise: bool = True):
    """The combination c minimising ||r0 - Y^T c|| over directions D [k, n]
    with images Y = A D [k, n] (ridge-regularised normal equations); returns
    (D^T c, r0 - Y^T c), or (0, r0) when the projection does not shrink the
    residual (a zero or degenerate pool).  No operator apply and no host
    sync: the guard is a device-side select."""
    k = D.shape[0]
    G = _matvec_dots(Y, Y.T, precise)  # [k, k]
    rhs = _matvec_dots(Y, r0, precise)
    ridge = 1e-8 * torch.clamp(torch.diagonal(G).max(), min=1e-30)
    eye = torch.eye(k, dtype=G.dtype, device=G.device)
    c = torch.linalg.solve_ex(G + ridge * eye, rhs).result
    x0 = c @ D
    r_new = r0 - c @ Y
    ok = _norm(r_new, precise) < _norm(r0, precise)
    return torch.where(ok, x0, torch.zeros_like(x0)), torch.where(ok, r_new, r0)


# ----------------------------------------------------------------------
# Recycled-block GCR
# ----------------------------------------------------------------------
def _solve_small(G: torch.Tensor, h: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Solve the normalised Gram system on the `active` rows (ridge 1e-5 on
    the diagonal); inactive rows are identity rows with zero rhs, so their
    coefficients are exactly 0."""
    K = G.shape[0]
    eye = torch.eye(K, dtype=torch.bool, device=G.device)
    Gm = torch.where(
        eye,
        torch.where(active, torch.diagonal(G) + 1e-5, torch.ones_like(h)),
        torch.where(active[:, None] & active[None, :], G, torch.zeros_like(G)),
    )
    return torch.linalg.solve_ex(Gm, torch.where(active, h, torch.zeros_like(h))).result


def gcr_recycled(
    A_block: Callable,
    b: torch.Tensor,
    M: Callable,
    pool: torch.Tensor,
    *,
    rtol: float = 1e-6,
    atol=0.0,
    tol_mode: str = "r0",
    max_narrow: int = 8,
    precise: bool = True,
):
    """Solve A x = b by least squares over recycled and fresh directions.

    Round 1 applies A once to the block [M b, pool rows] ([n, 1 + k]
    columns: one wide apply, whose cost is close to one narrow apply) and
    takes the least-squares combination, refined once against the exact
    residual; each narrow round then adds one direction M r and solves the
    small normalised Gram system again against the exact residual.  Every
    direction is applied with the current operator, so the converged x
    meets ||b - A x|| <= tol.  `A_block` and `M` map [n, K] -> [n, K]
    column by column; zero pool rows are ignored.  One host sync a round.

    Returns (x, SolveInfo, D) with D [1 + k + max_narrow, n] the normalised
    directions (row 0 = M b, rows 1..k = the pool, then the narrow
    rounds'); SolveInfo.iters = 1 + the narrow rounds.  For B columns b
    [n, B] (pool [k, n, B], D [K, n, B]) `A_block` and `M` map [n, K, B]
    -> [n, K, B], each member with its own operator."""
    if b.dim() == 2:
        return _gcr_recycled_columns(A_block, b, M, pool, rtol, atol, tol_mode, max_narrow, precise)
    n, dtype, dev = b.shape[0], b.dtype, b.device
    k = pool.shape[0]
    K = 1 + k + max_narrow
    ref = 1.0 if tol_mode == "abs" else _host_float(_norm(b, precise))
    tol = max(rtol * ref, float(atol))

    with span("krylov.gcr.iter"):  # round 1: the wide apply
        D = b.new_zeros((K, n))
        W = b.new_zeros((K, n))
        D0 = torch.cat([M(b[:, None]).T, pool], dim=0)
        W0 = A_block(D0.T.contiguous()).T
        S0 = torch.cat([W0, b[None, :]], dim=0)
        G0 = _matvec_dots(S0, S0.T, precise)  # [k + 2, k + 2]
        wnorm = torch.sqrt(torch.clamp(torch.diagonal(G0)[: 1 + k], min=0.0))
        scale0 = torch.where(wnorm > 0, 1.0 / wnorm, torch.zeros_like(wnorm))
        D[: 1 + k] = D0 * scale0[:, None]
        W[: 1 + k] = W0 * scale0[:, None]
        act = torch.arange(K, device=dev) < 1 + k
        G = b.new_zeros((K, K))
        G[: 1 + k, : 1 + k] = G0[: 1 + k, : 1 + k] * scale0[:, None] * scale0[None, :]
        h0 = b.new_zeros(K)
        h0[: 1 + k] = G0[: 1 + k, 1 + k] * scale0
        c = _solve_small(G, h0, act)
        r = b - c @ W
        d1 = _solve_small(G, _matvec_dots(W, r, precise), act)
        c = c + d1
        r = r - d1 @ W
        res = _host_float(_norm(r, precise))  # the sync
    j = 0
    while res > tol and j < max_narrow:
        with span("krylov.gcr.iter"):
            i = 1 + k + j
            d = M(r[:, None])[:, 0]
            w = A_block(d[:, None])[:, 0]
            T = _matvec_dots(torch.cat([W, w[None, :]], dim=0), torch.stack([w, r], dim=1), precise)
            wn = torch.sqrt(torch.clamp(T[K, 0], min=0.0))
            s = torch.where(wn > 0, 1.0 / wn, torch.zeros_like(wn))
            D[i] = d * s
            W[i] = w * s
            gcol = T[:K, 0] * s
            gcol[i] = (wn > 0).to(dtype)
            G[:, i] = gcol
            G[i, :] = gcol
            hr = T[:K, 1].clone()
            hr[i] = T[K, 1] * s
            delta = _solve_small(G, hr, torch.arange(K, device=dev) <= i)
            c = c + delta
            r = r - delta @ W
            res = _host_float(_norm(r, precise))  # the sync
            j += 1
    return c @ D, SolveInfo(iters=1 + j, residual=res), D


def _gcr_recycled_columns(A_block, b, M, pool, rtol, atol, tol_mode, max_narrow, precise):
    """`gcr_recycled` for B members at once, member-major inside ([B, K, n]
    bases); a member whose residual meets its tolerance is frozen while the
    others take narrow rounds."""
    n, B = b.shape
    dtype, dev = b.dtype, b.device
    k = pool.shape[0]
    K = 1 + k + max_narrow
    ref = np.ones(B) if tol_mode == "abs" else _host(_cnorm(b, precise))
    tol = np.maximum(rtol * ref, np.broadcast_to(np.asarray(atol, np.float64), (B,)))
    bm = _rows(b)  # [B, n]

    with span("krylov.gcr.iter"):  # round 1: the wide apply
        D = b.new_zeros((B, K, n))
        W = b.new_zeros((B, K, n))
        D0 = torch.cat([M(b[:, None, :]), pool.movedim(0, 1)], dim=1)  # [n, 1 + k, B]
        W0 = _rows(A_block(D0.contiguous())).transpose(1, 2)  # [B, 1 + k, n]
        D0 = _rows(D0).transpose(1, 2)
        G0 = _gram(torch.cat([W0, bm[:, None]], dim=1), precise)  # [B, k + 2, k + 2]
        wnorm = torch.sqrt(torch.clamp(torch.diagonal(G0, dim1=1, dim2=2)[:, : 1 + k], min=0.0))
        scale0 = torch.where(wnorm > 0, 1.0 / wnorm, torch.zeros_like(wnorm))
        D[:, : 1 + k] = D0 * scale0[:, :, None]
        W[:, : 1 + k] = W0 * scale0[:, :, None]
        G = b.new_zeros((B, K, K))
        G[:, : 1 + k, : 1 + k] = G0[:, : 1 + k, : 1 + k] * scale0[:, :, None] * scale0[:, None, :]
        h0 = b.new_zeros((B, K))
        h0[:, : 1 + k] = G0[:, : 1 + k, 1 + k] * scale0
        act = torch.arange(K, device=dev) < 1 + k
        c = _solve_small_rows(G, h0, act)
        r = bm - _bcomb(c, W)
        d1 = _solve_small_rows(G, _bdots(W, r, precise), act)
        c = c + d1
        r = r - _bcomb(d1, W)
        res = _host(_cnorm(r.T, precise))  # the sync
    j = np.zeros(B, np.int64)
    active = (res > tol) & (j < max_narrow)
    rnd = 0  # every member still iterating has taken `rnd` narrow rounds
    while active.any():
        with span("krylov.gcr.iter"):
            on = _to_device(active, b)
            i = 1 + k + rnd
            d = _rows(M(r.T[:, None, :].contiguous())[:, 0])  # [B, n]
            w = _rows(A_block(d.T[:, None, :].contiguous())[:, 0])
            lhs, rhs = torch.cat([W, w[:, None]], dim=1), torch.stack([w, r], dim=2)
            if precise and dtype != torch.float64:
                T = torch.bmm(lhs.double(), rhs.double()).to(dtype)
            else:
                T = torch.bmm(lhs, rhs)  # [B, K + 1, 2]
            wn = torch.sqrt(torch.clamp(T[:, K, 0], min=0.0))
            s = torch.where(wn > 0, 1.0 / wn, torch.zeros_like(wn))
            Dn, Wn, Gn = D.clone(), W.clone(), G.clone()
            Dn[:, i] = d * s[:, None]
            Wn[:, i] = w * s[:, None]
            gcol = T[:, :K, 0] * s[:, None]
            gcol[:, i] = (wn > 0).to(dtype)
            Gn[:, :, i] = gcol
            Gn[:, i, :] = gcol
            hr = T[:, :K, 1].clone()
            hr[:, i] = T[:, K, 1] * s
            delta = _solve_small_rows(Gn, hr, torch.arange(K, device=dev) <= i)
            D = torch.where(on[:, None, None], Dn, D)
            W = torch.where(on[:, None, None], Wn, W)
            G = torch.where(on[:, None, None], Gn, G)
            c = torch.where(on[:, None], c + delta, c)
            r = torch.where(on[:, None], r - _bcomb(delta, Wn), r)
            res = np.where(active, _host(_cnorm(r.T, precise)), res)  # the sync
            j = j + active
            rnd += 1
            active = (res > tol) & (j < max_narrow)
    return _bcomb(c, D).T.contiguous(), SolveInfo(iters=1 + j, residual=res), D.permute(1, 2, 0)


def _solve_small_rows(G: torch.Tensor, h: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """`_solve_small` for B members at once: G [B, K, K], h [B, K], the
    `active` rows [K] shared."""
    K = G.shape[-1]
    eye = torch.eye(K, dtype=torch.bool, device=G.device)
    diag = torch.diagonal(G, dim1=1, dim2=2)
    Gm = torch.where(
        eye,
        torch.where(active, diag + 1e-5, torch.ones_like(diag))[:, :, None],
        torch.where(active[:, None] & active[None, :], G, torch.zeros_like(G)),
    )
    return torch.linalg.solve_ex(Gm, torch.where(active, h, torch.zeros_like(h))).result


# ----------------------------------------------------------------------
# Fixed-iteration inner solvers (for the block preconditioners)
# ----------------------------------------------------------------------
def cg_fixed(A: Callable, b: torch.Tensor, M: Callable, iters: int, precise: bool = False):
    """`iters` steps of preconditioned CG, no convergence checks (the
    reference's `cg_fixed`), on one vector b [n] or on B columns [n, B]
    (dots per column).  The guards on p.Ap and r.z are device-side
    selects: no host sync."""
    dot = _dot if b.dim() == 1 else _cdot
    x = torch.zeros_like(b)
    r = b
    z = M(r)
    p = z
    rz = dot(r, z, precise)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    for _ in range(iters):
        Ap = A(p)
        pAp = dot(p, Ap, precise)
        alpha = torch.where(pAp > 0, rz / pAp, zero)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = dot(r, z, precise)
        beta = torch.where(rz > 0, rz_new / rz, zero)
        p = z + beta * p
        rz = rz_new
    return x


def gmres_fixed(A: Callable, b: torch.Tensor, M: Callable, iters: int, precise: bool = False):
    """One `iters`-step right-preconditioned GMRES cycle, no checks (the
    reference's `gmres_fixed`): single-pass batched classical Gram-Schmidt,
    then the least squares on the Hessenberg by its normal equations (with
    the reference's 1e-30 ridge), solved on the device by `solve_ex`
    (`torch.linalg.solve` would read its error flag back): no host sync.
    b is one vector [n] or B columns [n, B], each its own cycle."""
    if b.dim() == 2:
        return _gmres_fixed_columns(A, b, M, iters, precise)
    n = b.shape[0]
    m = iters
    beta = _norm(b, precise)
    V = b.new_zeros((m + 1, n))
    Z = b.new_zeros((m, n))
    H = b.new_zeros((m + 1, m + 1))
    V[0] = torch.where(beta > 0, b / beta, b)
    for j in range(m):
        z = M(V[j])
        w = A(z)
        # rows > j of V are zero, so the full product is the partial one
        hcol = _matvec_dots(V, w, precise)
        w = w - V.T @ hcol
        hlast = _norm(w, precise)
        V[j + 1] = torch.where(hlast > 0, w / hlast, w)
        Z[j] = z
        hcol[j + 1] = hlast
        H[:, j] = hcol
    Hm = H[:, :m]
    e1 = b.new_zeros(m + 1)
    e1[0] = beta
    HtH = Hm.T @ Hm + 1e-30 * torch.eye(m, dtype=b.dtype, device=b.device)
    y = torch.linalg.solve_ex(HtH, Hm.T @ e1).result
    return Z.T @ y


def _gmres_fixed_columns(A, b, M, m: int, precise: bool):
    """`gmres_fixed` on B columns b [n, B]: A and M map [n, B] -> [n, B];
    the bases are member-major ([B, m + 1, n]) for batched products."""
    n, B = b.shape
    beta = _cnorm(b, precise)  # [B]
    V = b.new_zeros((B, m + 1, n))
    Z = b.new_zeros((B, m, n))
    H = b.new_zeros((B, m + 1, m + 1))
    V[:, 0] = _rows(torch.where(beta > 0, b / beta, b))
    for j in range(m):
        z = M(V[:, j].T)
        w = _rows(A(z))
        hcol = _bdots(V, w, precise)  # [B, m + 1]
        w = w - _bcomb(hcol, V)
        hlast = _cnorm(w.T, precise)
        V[:, j + 1] = torch.where(hlast[:, None] > 0, w / hlast[:, None], w)
        Z[:, j] = z.T
        hcol[:, j + 1] = hlast
        H[:, :, j] = hcol
    Hm = H[:, :, :m]
    e1 = b.new_zeros((B, m + 1))
    e1[:, 0] = beta
    Ht = Hm.transpose(1, 2)
    HtH = Ht @ Hm + 1e-30 * torch.eye(m, dtype=b.dtype, device=b.device)
    y = torch.linalg.solve_ex(HtH, (Ht @ e1[:, :, None])[:, :, 0]).result
    return _bcomb(y, Z).T.contiguous()
