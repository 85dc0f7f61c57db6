"""Linear-algebra decompositions and statistics (port of
``paddle_tpu/ops/linalg_ext.py``).

The factorizations are ``torch.linalg``'s (LAPACK on the CPU, cuSOLVER
on the card). A factor is unique only up to the sign or phase of its
columns, so their agreement with the reference is held through
reconstructions, singular values and eigenvalues. ``lu``'s pivots are
1-based int32, as the reference's; ``eig`` / ``eigvals`` give complex
results. ``lstsq`` is the reference's SVD solve (``jnp.linalg.lstsq``:
rank by ``rcond``, residuals always), so it runs alike on the CPU and
the card. The histograms bucket on the tensor's own device (torch's
``histogram`` runs on the CPU only). ``svd_lowrank`` / ``pca_lowrank``
start from the port's seeded generator: their draws are the port's own.
"""
from __future__ import annotations

import torch

from ._op import op_fn, wrap
from ..framework.random import default_generator as _default_generator

__all__ = [
    "svd", "svd_lowrank", "pca_lowrank", "qr", "eig", "eigvals", "eigh",
    "eigvalsh", "lu", "lu_unpack", "householder_product", "ormqr", "cond",
    "cov", "corrcoef", "cdist", "dist", "mv", "inverse", "lstsq", "vander",
    "histogram", "histogramdd", "vector_norm", "matrix_transpose", "addmm",
]


@op_fn(name="svd")
def _svd(x, *, full_matrices=False):
    return tuple(torch.linalg.svd(x, full_matrices=full_matrices))


def svd(x, full_matrices=False, name=None):
    return _svd(x, full_matrices=full_matrices)


@op_fn(name="qr_op")
def _qr(x, *, mode="reduced"):
    q, r = torch.linalg.qr(x, mode=mode)
    return (r,) if mode == "r" else (q, r)


def qr(x, mode="reduced", name=None):
    out = _qr(x, mode=mode)
    return out[0] if mode == "r" else out


@op_fn(differentiable=False)
def eig(x):
    w, v = torch.linalg.eig(x)
    return w, v


@op_fn(differentiable=False, name="eigvals")
def _eigvals(x):
    return torch.linalg.eigvals(x)


def eigvals(x, name=None):
    return _eigvals(x)


@op_fn(name="eigh_op")
def _eigh(x, *, UPLO="L"):
    w, v = torch.linalg.eigh(x, UPLO=UPLO)
    return w, v


def eigh(x, UPLO="L", name=None):
    return _eigh(x, UPLO=UPLO)


@op_fn(name="eigvalsh_op")
def _eigvalsh(x, *, UPLO="L"):
    return torch.linalg.eigvalsh(x, UPLO=UPLO)


def eigvalsh(x, UPLO="L", name=None):
    return _eigvalsh(x, UPLO=UPLO)


@op_fn(name="lu_op")
def _lu(x):
    lu_mat, piv = torch.linalg.lu_factor(x)
    return lu_mat, piv.to(torch.int32)       # 1-based, as Paddle's


def lu(x, pivot=True, get_infos=False, name=None):
    lu_mat, piv = _lu(x)
    if get_infos:
        info = wrap(torch.zeros(x.shape[:-2], dtype=torch.int32,
                                device=x.device))
        return lu_mat, piv, info
    return lu_mat, piv


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    """``(P, L, U)`` of an LU factorization, ``x = P L U``; a part not
    asked for is None."""
    P, L, U = torch.lu_unpack(x, y.to(torch.int32),
                              unpack_data=unpack_ludata,
                              unpack_pivots=unpack_pivots)
    return (wrap(P) if unpack_pivots else None,
            wrap(L) if unpack_ludata else None,
            wrap(U) if unpack_ludata else None)


@op_fn(name="householder_product_op")
def _householder_product(x, tau):
    return torch.linalg.householder_product(x, tau)


def householder_product(x, tau, name=None):
    return _householder_product(x, tau)


@op_fn(name="ormqr_op")
def _ormqr(x, tau, other, *, left=True, transpose=False):
    return torch.ormqr(x, tau, other, left=left, transpose=transpose)


def ormqr(x, tau, other, left=True, transpose=False, name=None):
    """``other`` multiplied by the Q of a QR in Householder form (from
    the left or the right, transposed or not), without forming Q."""
    return _ormqr(x, tau, other, left=left, transpose=transpose)


@op_fn(name="cond_op", differentiable=False)
def _cond(x, *, p=None):
    p = 2 if p is None else p
    if p in (2, -2):
        s = torch.linalg.svdvals(x)
        return s[..., 0] / s[..., -1] if p == 2 else s[..., -1] / s[..., 0]
    return torch.linalg.cond(x, p=p)


def cond(x, p=None, name=None):
    return _cond(x, p=p)


@op_fn(name="cov_op")
def _cov(x, *, rowvar=True, ddof=True, fweights=None, aweights=None):
    x = x if rowvar or x.ndim < 2 else x.T
    return torch.cov(x, correction=1 if ddof else 0, fweights=fweights,
                     aweights=aweights)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    return _cov(x, rowvar=rowvar, ddof=ddof, fweights=fweights,
                aweights=aweights)


@op_fn(name="corrcoef_op")
def _corrcoef(x, *, rowvar=True):
    return torch.corrcoef(x if rowvar or x.ndim < 2 else x.T)


def corrcoef(x, rowvar=True, name=None):
    return _corrcoef(x, rowvar=rowvar)


@op_fn(name="cdist_op")
def _cdist(x, y, *, p=2.0):
    diff = x[..., :, None, :] - y[..., None, :, :]
    if p == 2.0:
        return torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-30)
    if p == float("inf"):
        return torch.amax(diff.abs(), dim=-1)
    if p == 0:
        return torch.sum((diff != 0).to(x.dtype), dim=-1)
    return torch.sum(diff.abs() ** p, dim=-1) ** (1.0 / p)


def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary",
          name=None):
    return _cdist(x, y, p=float(p))


@op_fn(name="dist_op")
def _dist(x, y, *, p=2.0):
    d = (x - y).abs()
    if p == float("inf"):
        return torch.amax(d)
    if p == float("-inf"):
        return torch.amin(d)
    if p == 0:
        return torch.sum((d != 0).to(x.dtype))
    return torch.sum(d ** p) ** (1.0 / p)


def dist(x, y, p=2.0, name=None):
    return _dist(x, y, p=float(p))


@op_fn
def mv(x, vec):
    return torch.matmul(x, vec)


def inverse(x, name=None):
    from .linalg import inv
    return inv(x)


@op_fn(name="lstsq_op")
def _lstsq_full(x, y, *, rcond=None):
    """``jnp.linalg.lstsq``'s solve: the SVD of ``x``, singular values
    below ``rcond`` times the largest dropped (default: eps times the
    larger dim), the residuals' squared column norms always."""
    m, n = x.shape[-2], x.shape[-1]
    one = y.ndim == 1
    b = y[:, None] if one else y
    eps = torch.finfo(x.dtype).eps
    rc = eps * max(m, n) if rcond is None else (eps if rcond < 0
                                                else rcond)
    u, s, vt = torch.linalg.svd(x, full_matrices=False)
    mask = (s > 0) & (s >= rc * s[0])
    rank = mask.sum()
    safe = torch.where(mask, s, torch.ones_like(s))
    s_inv = torch.where(mask, 1 / safe, torch.zeros_like(s))[:, None]
    sol = vt.mT @ (s_inv * (u.mT @ b))
    resid = torch.linalg.vector_norm(b - x @ sol, dim=0) ** 2
    if one:
        sol = sol.reshape(-1)
    return sol, resid, rank.to(torch.int32), s


def lstsq(x, y, rcond=None, driver=None, name=None):
    return _lstsq_full(x, y, rcond=rcond)


@op_fn(name="vander_op")
def _vander(x, *, n=None, increasing=False):
    n = x.shape[-1] if n is None else n
    pw = torch.arange(n, device=x.device)
    return x[..., None] ** (pw if increasing else pw.flip(0))


def vander(x, n=None, increasing=False, name=None):
    return _vander(x, n=n, increasing=increasing)


def _edges(lo, hi, bins, dtype, device):
    """numpy's ``bins + 1`` equal edges over ``[lo, hi]``."""
    return torch.linspace(float(lo), float(hi), bins + 1, dtype=dtype,
                          device=device)


def _bin_index(x, edges):
    """numpy's bin of each value of ``x`` over ``edges``: ``[e_i,
    e_{i+1})``, the last bin closed; -1 outside ``[e_0, e_n]``."""
    nb = edges.numel() - 1
    i = torch.searchsorted(edges, x, right=True) - 1
    i = torch.where(x == edges[-1], nb - 1, i)
    return torch.where((x < edges[0]) | (x > edges[-1]) | (i < 0)
                       | (i >= nb), -1, i)


@op_fn(name="histogram_op", differentiable=False)
def _histogram(x, *, bins=100, min=0, max=0, weight=None, density=False):
    flat = x.reshape(-1)
    lo, hi = float(min), float(max)
    if lo == 0.0 and hi == 0.0:
        lo, hi = float(flat.min()), float(flat.max())
        if hi == lo:
            hi = lo + 1.0
    edges = _edges(lo, hi, bins, flat.dtype if flat.is_floating_point()
                   else torch.float32, x.device)
    idx = _bin_index(flat.to(edges.dtype), edges)
    w = (torch.ones_like(edges[:1]).expand_as(flat) if weight is None
         else weight.reshape(-1).to(edges.dtype))
    hist = torch.zeros(bins, dtype=edges.dtype, device=x.device)
    hist = hist.index_add(0, idx.clamp(min=0), torch.where(idx >= 0, w, 0))
    if density:
        return hist / (hist.sum() * (edges[1:] - edges[:-1]))
    if weight is not None:
        return hist
    return hist.to(torch.int64)


def histogram(input, bins=100, min=0, max=0, weight=None, density=False,
              name=None):
    return _histogram(input, bins=bins, min=min, max=max, weight=weight,
                      density=density)


def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    """``(hist, edges)`` of ``[N, D]`` samples over a grid of ``bins``
    (an int or one per dim) within ``ranges`` (``(lo, hi)`` pairs, or
    Paddle's flat ``[lo0, hi0, lo1, ...]``; default the data's extent),
    numpy's rules at each dim."""
    n, d = x.shape
    if ranges is not None and not isinstance(ranges[0], (list, tuple)):
        ranges = list(zip(ranges[::2], ranges[1::2]))
    nb = [int(bins)] * d if isinstance(bins, int) else [int(b) for b in bins]
    edges, flat_idx, ok = [], torch.zeros(n, dtype=torch.long,
                                          device=x.device), None
    for k in range(d):
        col = x[:, k]
        if ranges is None:
            lo, hi = float(col.min()), float(col.max())
        else:
            lo, hi = float(ranges[k][0]), float(ranges[k][1])
        if lo == hi:
            lo, hi = lo - 0.5, hi + 0.5
        e = _edges(lo, hi, nb[k], x.dtype, x.device)
        i = _bin_index(col, e)
        ok = i >= 0 if ok is None else ok & (i >= 0)
        flat_idx = flat_idx * nb[k] + i.clamp(min=0)
        edges.append(e)
    w = (torch.ones(n, dtype=x.dtype, device=x.device) if weights is None
         else weights.to(x.dtype))
    total = 1
    for b in nb:
        total *= b
    hist = torch.zeros(total, dtype=x.dtype, device=x.device).index_add(
        0, flat_idx, torch.where(ok, w, 0)).reshape(nb)
    if density:
        vol = torch.ones((), dtype=x.dtype, device=x.device)
        for k, e in enumerate(edges):
            shape = [1] * d
            shape[k] = nb[k]
            vol = vol * (e[1:] - e[:-1]).reshape(shape)
        hist = hist / hist.sum() / vol
    elif weights is None:
        hist = hist.to(torch.int64)     # counts, as the reference's
    return wrap(hist), [wrap(e) for e in edges]


def svd_lowrank(x, q=6, niter=2, M=None, name=None):
    """A rank-``q`` SVD ``(U, S, V)`` by randomized subspace iteration
    (Halko et al.), the basis re-orthonormalized at each of ``niter``
    power iterations; the start vectors come from the port's generator
    of ``x``'s device."""
    if M is not None:
        x = x - M
    m, n = x.shape[-2], x.shape[-1]
    q = min(q, m, n)
    omega = torch.randn(x.shape[:-2] + (n, q), dtype=x.dtype,
                        device=x.device,
                        generator=_default_generator(x.device))
    Q, _ = torch.linalg.qr(x @ omega)
    for _ in range(niter):
        Z, _ = torch.linalg.qr(x.mT @ Q)
        Q, _ = torch.linalg.qr(x @ Z)
    u, s, vh = torch.linalg.svd(Q.mT @ x, full_matrices=False)
    return wrap(Q @ u), wrap(s), wrap(vh.mT)


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    m, n = x.shape[-2], x.shape[-1]
    if q is None:
        q = min(6, m, n)
    if center:
        x = x - x.mean(dim=-2, keepdim=True)
    return svd_lowrank(x, q=q, niter=niter)


@op_fn(name="vector_norm_op")
def _vector_norm(x, *, p=2.0, axis=None, keepdim=False):
    if axis is None:
        axis = tuple(range(x.ndim))
    if p == float("inf"):
        return torch.amax(x.abs(), dim=axis, keepdim=keepdim)
    if p == float("-inf"):
        return torch.amin(x.abs(), dim=axis, keepdim=keepdim)
    if p == 0:
        return torch.sum((x != 0).to(x.dtype), dim=axis, keepdim=keepdim)
    return torch.sum(x.abs() ** p, dim=axis, keepdim=keepdim) ** (1.0 / p)


def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    if isinstance(axis, (list, tuple)):
        axis = tuple(axis)
    return _vector_norm(x, p=float(p), axis=axis, keepdim=keepdim)


@op_fn
def matrix_transpose(x):
    return x.transpose(-1, -2)


@op_fn(name="addmm_op")
def _addmm(input, x, y, *, beta=1.0, alpha=1.0):
    return beta * input + alpha * (x @ y)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return _addmm(input, x, y, beta=beta, alpha=alpha)
