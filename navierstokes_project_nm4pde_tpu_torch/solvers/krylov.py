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

Every solver solves [n, B] batches, one column per ensemble member
(`gcr_recycled` and `cg_recycled` with pools [k, n, B]), with the
semantics of `jax.vmap` over the reference's loops: each member iterates
exactly as its own solve would, with its own tolerance and iteration
count, and a member that has stopped is frozen while the others run on.
In FGMRES the members still iterating share the inner index j, so their
restart cycles run in lockstep.  One host sync per iteration reads all B
residuals.  A zero norm in one column is guarded in that column alone.
Each method has one loop for a single system b [n] (pools [k, n],
SolveInfo as (int, float)) and for columns: `fgmres` runs one system as
the batch of one; the others pick their products and layouts by rank
(matrix-vector products on one system, batched products on member-major
rows for columns), since the batched forms would cost one system a fifth
more host time a call, and a B = 1 column runs as its [n] view.

The CG loop (`cg`, `cg_recycled`) keeps its state in tensors that one
function updates in place, an iteration a call.  For B > 1 columns that
function also keeps the per-member stop mask, the counts and the
tolerances on the device, so the host only reads the residuals.  One
system takes a body with no mask, since the host alone decides when to
stop: the mask's selects and column reductions would add 10 kernels to an
iteration of 28, and 2% to the device time of a step of the 965k-DoF duct
on an H100.  Given a `CGGraphs` cache (the projection step's pressure
solve on the frozen S1 and its two-level preconditioner, on the card,
with no process group), that function is captured once per body and
shape as CUDA graphs cut at the layers' spans, and each iteration is one
replay of them; every other caller runs it eagerly.  The FGMRES and GCR
loops read operators that change every step and stay eager; GCR's narrow
rounds keep the members' stop mask on the device.

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
    """[*batch, k, k] Gram matrices S S^T of (member-major) rows S [*batch,
    k, n]."""
    if precise and S.dtype != torch.float64:
        return (S.double() @ S.double().mT).to(S.dtype)
    return S @ S.mT


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


def _vector_op(f: Callable) -> Callable:
    """An operator on B = 1 columns [n, 1] (blocks [n, K, 1]) as the
    operator on their [n] ([n, K]) views."""
    return lambda v: f(v[..., None])[..., 0]


def _first(atol) -> float:
    """A tolerance given as a float or a [1] array, as the float."""
    return float(np.broadcast_to(np.asarray(atol, np.float64), (1,))[0])


def _batch_info(info: SolveInfo) -> SolveInfo:
    """One system's SolveInfo (int, float) as a B = 1 batch's ([1] arrays)."""
    return SolveInfo(iters=np.array([info.iters]), residual=np.array([info.residual]))


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

    One iteration's graphs per key (the iteration body, its shapes, dtype and
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
    """Preconditioned CG.  The residual norm rides the loop (fused with
    r.z), as in the reference.  b is one system [n] (returns x [n] and
    SolveInfo(int, float)) or B systems [n, B] (A and M map [n, B] -> [n,
    B] column by column, `atol` is a float or a [B] array; returns x [n, B]
    and SolveInfo with [B] numpy iters and residuals; a B = 1 column runs
    as its [n] view).  With `graphs`, each iteration is a replay of CUDA
    graphs (`CGGraphs`)."""
    if M is None:
        M = lambda v: v  # noqa: E731
    if b.dim() == 2 and b.shape[1] == 1:  # a B = 1 column runs as its [n] view
        x, info = cg(_vector_op(A), b[:, 0], _vector_op(M), None if x0 is None else x0[:, 0], rtol=rtol,
                     atol=_first(atol), maxiter=maxiter, precise=precise, graphs=graphs)
        return x[:, None], _batch_info(info)
    if x0 is None:
        x, r = torch.zeros_like(b), b
    else:
        x, r = x0, b - A(x0)
    x, r, info = _cg_loop(A, M, b, x, r, rtol, atol, maxiter, precise, "krylov.cg.iter", graphs)
    return x, info


def _cg_single_iter(A, M, st: list, precise: bool):
    """One iteration of the CG loop on one system, in place on its state st
    = [x, r, p, rz, res] ([n] vectors, rz and res 0-d): no stop mask, since
    the host alone decides when to stop."""
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


def _cg_masked_iter(A, M, st: list, maxiter: int, precise: bool):
    """One iteration of the CG loop on B > 1 columns, in place on its state
    st = [x, r, p, rz, res, k, tol]: the members with res > tol and k <
    maxiter take it, the others stay frozen; res (float64) and the counts k
    follow."""
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


def _cg_loop(A, M, b, x, r, rtol, atol, maxiter, precise, name, graphs=None):
    """The CG loop from the iterate x and its residual r (the tolerance
    against ||b||), each iteration in span `name`; returns (x, r,
    SolveInfo), the info as `cg`'s.  One system b [n] takes the mask-free
    body, its count and residual kept on the host as Python numbers.  B > 1
    columns [n, B] take the masked one: the device decides which members
    iterate, from the same float64 residuals and tolerances as the host's
    `active`, so the two agree bit for bit and the host reads the residuals
    alone."""
    single = b.dim() == 1
    z = M(r)
    if single:
        rz, rr = _dot2(z, r, precise)
        res_t = torch.sqrt(rr)
        read, more, k = _host_float, bool, 0
        tol = max(rtol * _host_float(_norm(b, precise)), float(atol))
        state = [x, r, z, rz, res_t]
        body = functools.partial(_cg_single_iter, A, M, precise=precise)
        key = ("single", tuple(b.shape), b.dtype, precise)
    else:
        B = b.shape[1]
        rz, rr = _cdot(z, r, precise), _cdot(r, r, precise)
        res_t = torch.sqrt(rr).double()
        read, more, k = _host, np.any, np.zeros(B, np.int64)
        tol = np.maximum(rtol * _host(_cnorm(b, precise)), np.broadcast_to(np.asarray(atol, np.float64), (B,)))
        state = [x, r, z, rz, res_t, torch.zeros(B, dtype=torch.int64, device=b.device)]
        body = functools.partial(_cg_masked_iter, A, M, maxiter=maxiter, precise=precise)
        key = ("masked", tuple(b.shape), b.dtype, maxiter, precise)
    res = read(res_t)
    active = (res > tol) & (k < maxiter)
    if more(active):
        if not single:
            state.append(_to_device(tol, b, torch.float64))
        st, step = _iterations(body, state, graphs, key)
        while more(active):
            with span(name):
                step()
                res = read(st[4])  # the sync
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
    atol=0.0,
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
    if M is None:
        M = lambda v: v  # noqa: E731
    if b.dim() == 2 and b.shape[1] == 1:  # a B = 1 column runs as its [n] view
        x, info, harvest = cg_recycled(
            _vector_op(A), b[:, 0], _vector_op(M), None if x0 is None else x0[:, 0], poolD[..., 0],
            poolW[..., 0], rtol=rtol, atol=_first(atol), maxiter=maxiter, precise=precise, graphs=graphs,
        )
        return x[:, None], _batch_info(info), harvest[..., None]
    if x0 is None:
        x0, r = torch.zeros_like(b), b
    else:
        r = b - A(x0)
    x, r = _pool_projection(x0, r, poolD, poolW, precise)
    x_proj, r_proj = x, r
    x, r, info = _cg_loop(A, M, b, x, r, rtol, atol, maxiter, precise, "krylov.cg_recycled.iter", graphs)
    return x, info, torch.stack([x - x_proj, r_proj - r])


def _pool_projection(x0, r, poolD, poolW, precise):
    """(x, r) after the least-squares projection of the residual on the
    pool, refined once against the projected residual: one system's r [n]
    on its pool ([k, n] directions and images), or each member's column of
    r [n, B] on its own pool ([k, n, B]; member-major rows inside, batched
    products)."""
    if r.dim() == 1:
        rows = cols = lambda x: x  # noqa: E731
        dots, comb = _matvec_dots, (lambda c, V: c @ V)
    else:
        rows, cols, dots, comb = _rows, (lambda x: x.T), _bdots, _bcomb
    k = poolD.shape[0]
    Wm, Dm = rows(poolW), rows(poolD)  # [*batch, k, n]
    G = _gram(torch.cat([Wm, rows(r)[..., None, :]], dim=-2), precise)  # [*batch, k+1, k+1]
    wn = torch.sqrt(torch.clamp(torch.diagonal(G, dim1=-2, dim2=-1)[..., :k], min=0.0))
    sc = torch.where(wn > 0, 1.0 / wn, torch.zeros_like(wn))
    eye = torch.eye(k, dtype=r.dtype, device=r.device)
    Gn = G[..., :k, :k] * sc[..., :, None] * sc[..., None, :] + 1e-5 * eye
    Gn = torch.where((eye > 0) & (wn == 0)[..., :, None], torch.ones_like(Gn), Gn)
    c = torch.linalg.solve_ex(Gn, G[..., :k, k] * sc).result
    Dn, Wn = Dm * sc[..., None], Wm * sc[..., None]
    x = x0 + cols(comb(c, Dn))
    r = r - cols(comb(c, Wn))
    c2 = torch.linalg.solve_ex(Gn, dots(Wn, rows(r), precise)).result
    return x + cols(comb(c2, Dn)), r - cols(comb(c2, Wn))


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
    -> [n, K, B], each member with its own operator; a member whose
    residual meets its tolerance is frozen while the others take narrow
    rounds; a B = 1 column runs as its [n] view.  One loop, its layouts
    and products picked by rank (member-major bases [B, K, n] and batched
    products for columns), since the batched ones and the members' selects
    would cost one system a fifth more host time a call."""
    if b.dim() == 2 and b.shape[1] == 1:
        x, info, D = gcr_recycled(
            _vector_op(A_block), b[:, 0], _vector_op(M), pool[..., 0], rtol=rtol, atol=_first(atol),
            tol_mode=tol_mode, max_narrow=max_narrow, precise=precise,
        )
        return x[:, None], _batch_info(info), D[..., None]
    n, dtype, dev = b.shape[0], b.dtype, b.device
    k = pool.shape[0]
    K = 1 + k + max_narrow
    if b.dim() == 1:
        batch, bm = (), b
        ref = 1.0 if tol_mode == "abs" else _host_float(_norm(b, precise))
        tol = max(rtol * ref, float(atol))
        read, more, j = _host_float, bool, 0
        dots, comb = _matvec_dots, (lambda c, V: c @ V)
        rnorm = lambda x: _norm(x, precise)  # noqa: E731
        narrow = lambda op, x: op(x[:, None])[:, 0]  # noqa: E731

        def wide():  # round 1's block [M b, pool rows] and its image, as rows
            D0 = torch.cat([M(b[:, None]).T, pool], dim=0)  # [1 + k, n]
            return D0, A_block(D0.T.contiguous()).T
    else:
        B = b.shape[1]
        batch, bm = (B,), _rows(b)  # [B, n]; the bases are member-major [B, K, n]
        ref_t = b.new_ones(B, dtype=torch.float64) if tol_mode == "abs" else _cnorm(b, precise).double()
        ref = np.ones(B) if tol_mode == "abs" else _host(ref_t)
        tol = np.maximum(rtol * ref, np.broadcast_to(np.asarray(atol, np.float64), (B,)))
        read, more, j = _host, np.any, np.zeros(B, np.int64)
        dots, comb = _bdots, _bcomb
        rnorm = lambda x: _cnorm(x.T, precise).double()  # noqa: E731
        narrow = lambda op, x: _rows(op(x.T[:, None, :].contiguous())[:, 0])  # noqa: E731

        def wide():
            D0 = torch.cat([M(b[:, None, :]), pool.movedim(0, 1)], dim=1)  # [n, 1 + k, B]
            W0 = _rows(A_block(D0.contiguous())).transpose(1, 2)  # [B, 1 + k, n]
            return _rows(D0).transpose(1, 2), W0

    with span("krylov.gcr.iter"):  # round 1: the wide apply
        D0, W0 = wide()
        D = b.new_zeros((*batch, K, n))
        W = b.new_zeros((*batch, K, n))
        G0 = _gram(torch.cat([W0, bm[..., None, :]], dim=-2), precise)  # [*batch, k + 2, k + 2]
        wnorm = torch.sqrt(torch.clamp(torch.diagonal(G0, dim1=-2, dim2=-1)[..., : 1 + k], min=0.0))
        scale0 = torch.where(wnorm > 0, 1.0 / wnorm, torch.zeros_like(wnorm))
        D[..., : 1 + k, :] = D0 * scale0[..., None]
        W[..., : 1 + k, :] = W0 * scale0[..., None]
        G = b.new_zeros((*batch, K, K))
        G[..., : 1 + k, : 1 + k] = G0[..., : 1 + k, : 1 + k] * scale0[..., :, None] * scale0[..., None, :]
        h0 = b.new_zeros((*batch, K))
        h0[..., : 1 + k] = G0[..., : 1 + k, 1 + k] * scale0
        act = torch.arange(K, device=dev) < 1 + k
        c = _solve_small_rows(G, h0, act)
        r = bm - comb(c, W)
        d1 = _solve_small_rows(G, dots(W, r, precise), act)
        c = c + d1
        r = r - comb(d1, W)
        res_t = rnorm(r)
        res = read(res_t)  # the sync
    active = (res > tol) & (j < max_narrow)
    if batch and active.any():  # the tolerances on the device, bit for bit; a scalar atol needs no copy
        atol_t = float(atol) if np.ndim(atol) == 0 else _to_device(atol, b, torch.float64)
        tol_t = torch.clamp(rtol * ref_t, min=atol_t)
    rnd = 0  # every member still iterating has taken `rnd` narrow rounds
    while more(active):
        with span("krylov.gcr.iter"):
            # the members still iterating are those above their tolerance,
            # since each of them has taken rnd < max_narrow rounds; one
            # system takes every round the loop runs
            on = res_t > tol_t if batch else None
            i = 1 + k + rnd
            d = narrow(M, r)  # [*batch, n]
            w = narrow(A_block, d)
            T = _matvec_dots(torch.cat([W, w[..., None, :]], dim=-2), torch.stack([w, r], dim=-1), precise)
            wn = torch.sqrt(torch.clamp(T[..., K, 0], min=0.0))  # T [*batch, K + 1, 2]
            s = torch.where(wn > 0, 1.0 / wn, torch.zeros_like(wn))
            # row i of D and W and row and column i of G, written for the
            # members that take the round (the others' stay zero)
            D[..., i, :] = _keep(on, d * s[..., None], D[..., i, :])
            W[..., i, :] = _keep(on, w * s[..., None], W[..., i, :])
            gcol = T[..., :K, 0] * s[..., None]
            gcol[..., i] = (wn > 0).to(dtype)
            gcol = _keep(on, gcol, G[..., i, :])
            G[..., :, i] = gcol
            G[..., i, :] = gcol
            hr = T[..., :K, 1].clone()
            hr[..., i] = T[..., K, 1] * s
            delta = _solve_small_rows(G, hr, torch.arange(K, device=dev) <= i)
            c = _keep(on, c + delta, c)
            r = _keep(on, r - comb(delta, W), r)
            res_t = _keep(on, rnorm(r), res_t)
            res = read(res_t)  # the sync
            j = j + active
            rnd += 1
            active = (res > tol) & (j < max_narrow)
    if batch:
        return _bcomb(c, D).T.contiguous(), SolveInfo(iters=1 + j, residual=res), D.permute(1, 2, 0)
    return c @ D, SolveInfo(iters=1 + j, residual=res), D


def _keep(on, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """`new` in the rows of the members in `on` [B], `old` in the others';
    `on` None: `new`."""
    return new if on is None else torch.where(on.view(-1, *(1,) * (new.dim() - 1)), new, old)


def _solve_small_rows(G: torch.Tensor, h: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Solve the normalised Gram system (G [*batch, K, K], h [*batch, K],
    each member's its own) on the `active` rows [K] (ridge 1e-5 on the
    diagonal); inactive rows are identity rows with zero rhs, so their
    coefficients are exactly 0."""
    K = G.shape[-1]
    eye = torch.eye(K, dtype=torch.bool, device=G.device)
    diag = torch.diagonal(G, dim1=-2, dim2=-1)
    Gm = torch.where(
        eye,
        torch.where(active, diag + 1e-5, torch.ones_like(diag))[..., :, None],
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
    b is one vector [n] (bases [m + 1, n], matrix-vector products) or B
    columns [n, B] (A and M then map [n, B] -> [n, B]; bases member-major
    [B, m + 1, n], batched products), each its own cycle; a B = 1 column
    runs as its [n] view.  One loop, its products picked by rank, since the
    batched ones would cost one system a quarter more host time a call."""
    if b.dim() == 2 and b.shape[1] == 1:
        return gmres_fixed(_vector_op(A), b[:, 0], _vector_op(M), iters, precise)[:, None]
    if b.dim() == 1:
        rows = cols = lambda x: x  # noqa: E731
        dots, comb, norm, rnorm = _matvec_dots, (lambda c, V: V.T @ c), _norm, _norm
    else:
        rows, cols, dots, comb, norm = _rows, (lambda x: x.T), _bdots, _bcomb, _cnorm
        rnorm = lambda x, p: _cnorm(x.T, p)  # noqa: E731
    m = iters
    beta = norm(b, precise)  # [*batch]
    bm = rows(torch.where(beta > 0, b / beta, b))
    V = b.new_zeros((*bm.shape[:-1], m + 1, bm.shape[-1]))
    Z = b.new_zeros((*bm.shape[:-1], m, bm.shape[-1]))
    H = b.new_zeros((*bm.shape[:-1], m + 1, m + 1))
    V[..., 0, :] = bm
    for j in range(m):
        z = M(cols(V[..., j, :]))
        w = rows(A(z))
        # rows > j of V are zero, so the full product is the partial one
        hcol = dots(V, w, precise)  # [*batch, m + 1]
        w = w - comb(hcol, V)
        hlast = rnorm(w, precise)[..., None]
        V[..., j + 1, :] = torch.where(hlast > 0, w / hlast, w)
        Z[..., j, :] = cols(z)
        hcol[..., j + 1] = hlast[..., 0]
        H[..., :, j] = hcol
    Hm = H[..., :m]
    e1 = b.new_zeros((*bm.shape[:-1], m + 1))
    e1[..., 0] = beta
    Ht = Hm.mT
    HtH = Ht @ Hm + 1e-30 * torch.eye(m, dtype=b.dtype, device=b.device)
    y = torch.linalg.solve_ex(HtH, dots(Ht, e1, False)).result
    return cols(comb(y, Z)).contiguous()
