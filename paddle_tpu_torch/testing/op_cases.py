"""Seeded inputs for every registered op of the op library.

One table, ``CASES``, keyed by the registered op name (``registered_ops()``):
each entry makes the positional and keyword arguments of one call from a
seeded ``numpy`` generator and a ``Shapes`` record, so the same inputs can
go through two implementations (the CPU against the JAX reference in the
tests, the card against the CPU in ``chip_smoke.py``'s ``[ops]`` phase).
Arrays are ``numpy``; the caller turns them into its tensors
(``to_tensors``). An in-place name (``add_``) without its own entry takes
its base's. Nothing here imports torch or JAX.

``Case`` options:

- ``tol``: ``(rtol, atol)`` for float32 where the default (1e-5, 1e-6)
  is too tight, with the reason in ``why``;
- ``grad``: False where no gradient is compared (with ``why``);
- ``random``: the name of a statistical check in place of a value
  comparison (the draws differ between implementations);
- ``half``: False where the op takes no bfloat16 / float16 input;
- ``compare``: the name of a comparison in place of the outputs'
  values, for factorizations unique only up to the sign or phase of
  their columns (``"svd"``, ``"qr"``, ``"eigh"``, ``"eig"``,
  ``"eigvals"``: reconstructions, singular values and eigenvalues).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np

__all__ = ["Shapes", "SMALL", "CARD", "Pool", "Inputs", "Case", "CASES",
           "case_for", "to_tensors", "KEYED"]


@dataclasses.dataclass(frozen=True)
class Shapes:
    ew: Tuple[int, ...]      # elementwise, reduction, manipulation, logic
    mm: Tuple[int, int, int]  # matmul-class [m, k] x [k, n]
    rows: Tuple[int, int]    # sort / topk / argsort rows
    la: Tuple[int, int]      # decompositions and solves: [batch, n, n]


SMALL = Shapes(ew=(3, 4, 5), mm=(6, 5, 7), rows=(3, 9), la=(2, 4))
# the eager path's widths: [TRAIN_BATCH, TRAIN_SEQ, hidden] activations,
# Llama-3-8B's gate product, its vocabulary rows, 256-wide solves
CARD = Shapes(ew=(4, 2048, 4096), mm=(8192, 4096, 14336), rows=(8, 128256),
              la=(8, 256))


class Pool:
    """Seeded standard normals and uniforms drawn once, handed out in
    consecutive slices: inputs of tens of millions of elements for a few
    hundred ops without drawing each anew (``Inputs(..., pool=)``)."""

    def __init__(self, seed, size):
        rng = np.random.default_rng(seed)
        self.normal = rng.standard_normal(size, dtype=np.float32)
        self.uniform = rng.random(size, dtype=np.float32)

    def take(self, kind, shape, at):
        """``shape`` elements of ``kind`` from offset ``at`` (wrapping to
        0 where they would run past the end) and the next offset."""
        buf = getattr(self, kind)
        n = int(np.prod(shape, dtype=np.int64))
        assert n <= buf.size, (shape, buf.size)
        at = at if at + n <= buf.size else 0
        return buf[at:at + n].reshape(shape), at + n


class Inputs:
    """Seeded numpy inputs (float32 unless said); from ``pool`` where one
    is given, at offsets that follow from the seed, so one seed gives the
    same arrays again (views into the pool: copy before writing)."""

    def __init__(self, seed=0, pool=None):
        self.rng = np.random.default_rng(seed)
        self.pool = pool
        if pool is not None:
            self.at = {k: seed % getattr(pool, k).size
                       for k in ("normal", "uniform")}

    def _take(self, kind, shape):
        a, self.at[kind] = self.pool.take(kind, shape, self.at[kind])
        return a

    def f(self, *shape, lo=None, hi=None):
        if self.pool is not None:
            if lo is None:
                return self._take("normal", shape)
            u = self._take("uniform", shape)
            return (u * np.float32(hi - lo) + np.float32(lo)).astype(
                np.float32)
        if lo is None:
            return self.rng.standard_normal(shape, dtype=np.float32)
        return self.rng.uniform(lo, hi, shape).astype(np.float32)

    def pos(self, *shape):
        return self.f(*shape, lo=0.5, hi=2.0)

    def unit(self, *shape):
        return self.f(*shape, lo=-0.9, hi=0.9)

    def prob(self, *shape):
        return self.f(*shape, lo=0.05, hi=0.95)

    def i(self, *shape, lo=-5, hi=6):
        if self.pool is not None:
            u = self._take("uniform", shape)
            return (np.floor(u * (hi - lo)).astype(np.int64) + lo).clip(
                lo, hi - 1)
        return self.rng.integers(lo, hi, shape).astype(np.int64)

    def b(self, *shape):
        if self.pool is not None:
            return self._take("uniform", shape) < 0.5
        return self.rng.random(shape) < 0.5

    def perm(self, n):
        return self.rng.permutation(n).astype(np.int64)

    def spd(self, b, n):
        a = self.f(b, n, n)
        return (a @ a.transpose(0, 2, 1) / n + np.eye(n, dtype=np.float32)
                ).astype(np.float32)

    def wellcond(self, b, n):
        return (self.f(b, n, n) / np.sqrt(n)
                + 2 * np.eye(n, dtype=np.float32)).astype(np.float32)

    def upper(self, b, n):
        return np.triu(self.wellcond(b, n)).astype(np.float32)

    def c(self, *shape):
        """complex64 with standard normal real and imaginary parts."""
        return (self.f(*shape) + 1j * self.f(*shape)).astype(np.complex64)

    def reflectors(self, b, m, k):
        """``(x [b, m, k], tau [b, k])``: k Householder reflectors
        ``I - tau v v^T`` in LAPACK's compact form (v's unit head
        implicit, its tail below x's diagonal), each orthogonal: tau =
        2 / |v|^2. Random taus would make reflectors of norm ~m, whose
        product overflows float32."""
        x = self.f(b, m, k)
        below = np.tril(x, -1)[..., :k]
        tau = (2.0 / (1.0 + (below ** 2).sum(-2))).astype(np.float32)
        return x, tau

    def ties(self, *shape):
        """float32 small integers: many equal values."""
        return self.i(*shape, lo=-3, hi=4).astype(np.float32)


@dataclasses.dataclass
class Case:
    make: Callable
    tol: Optional[Tuple[float, float]] = None
    grad: bool = True
    random: Optional[str] = None
    half: bool = True
    why: str = ""
    compare: Optional[str] = None


def C(make, **kw):
    return Case(make, **kw)


def _u(fn):
    """A unary op on ``S.ew`` normals."""
    return C(lambda r, S: ((r.f(*S.ew),), {}))


def _dom(gen, **kw):
    return C(lambda r, S: ((getattr(r, gen)(*S.ew),), {}), **kw)


def _bin(gen="f", **kw):
    return C(lambda r, S: ((getattr(r, gen)(*S.ew),
                            getattr(r, gen)(*S.ew)), {}), **kw)


def _ints2(**kw):
    return C(lambda r, S: ((r.i(*S.ew), r.i(*S.ew, lo=1, hi=7)), {}),
             grad=False, half=False, **kw)


def _bools2():
    return C(lambda r, S: ((r.b(*S.ew), r.b(*S.ew)), {}), grad=False,
             half=False)


CASES = {}

# -- ops.math -----------------------------------------------------------------
for n in ("abs", "exp", "expm1", "sin", "cos", "tan", "atan", "sinh", "cosh",
          "tanh", "asinh", "sigmoid", "erf", "square", "softsign",
          "floor", "ceil", "round", "trunc", "frac", "sign", "isnan",
          "isinf", "isfinite", "deg2rad", "rad2deg", "real", "imag",
          "conj"):
    CASES[n] = _u(n)
for n in ("log", "log2", "log10", "sqrt", "rsqrt", "lgamma", "digamma"):
    CASES[n] = _dom("pos")
CASES["log1p"] = _dom("pos")
CASES["reciprocal"] = _dom("pos")
CASES["acosh"] = C(lambda r, S: ((1.0 + r.pos(*S.ew),), {}))
for n in ("asin", "acos", "atanh", "erfinv"):
    CASES[n] = _dom("unit")
CASES["erfinv"] = _dom("unit", tol=(1e-4, 1e-5),
                      why="erfinv: XLA's and torch's polynomial "
                          "approximations differ by a few float32 ulps")
CASES["lgamma"] = _dom("pos", tol=(1e-4, 1e-5),
                       why="lgamma: XLA's Lanczos series and torch's differ "
                           "by a few float32 ulps")
CASES["digamma"] = _dom("pos", tol=(1e-4, 1e-5),
                        why="digamma: series approximations differ by a few "
                            "float32 ulps")
CASES["polygamma"] = C(lambda r, S: ((r.pos(*S.ew),), {"n": 1}),
                       tol=(1e-4, 1e-5), half=False,
                       why="polygamma: series approximations differ by a "
                           "few float32 ulps")
CASES["logit"] = C(lambda r, S: ((r.prob(*S.ew),), {"eps": 1e-3}))
CASES["angle"] = _u("angle")
for n in ("add", "subtract", "multiply", "maximum", "minimum", "fmax",
          "fmin", "atan2", "hypot", "logaddexp"):
    CASES[n] = _bin()
CASES["divide"] = C(lambda r, S: ((r.f(*S.ew), r.pos(*S.ew)), {}))
CASES["pow"] = C(lambda r, S: ((r.pos(*S.ew), r.f(*S.ew)), {}))
CASES["mod"] = C(lambda r, S: ((r.f(*S.ew) * 3, r.pos(*S.ew)), {}),
                 grad=False, why="mod: the gradient jumps at each multiple "
                                  "of y; values are compared")
CASES["floor_divide"] = _ints2()
CASES["gcd"] = _ints2()
CASES["lcm"] = _ints2()
CASES["heaviside"] = C(lambda r, S: ((r.f(*S.ew), r.f(*S.ew)), {}),
                       grad=False, why="heaviside: a step, zero gradient "
                                       "almost everywhere")
CASES["ldexp"] = C(lambda r, S: ((r.f(*S.ew), r.i(*S.ew, lo=-3, hi=4)), {}),
                   half=False)
CASES["lerp"] = C(lambda r, S: ((r.f(*S.ew), r.f(*S.ew), r.prob(*S.ew)),
                                {}))
CASES["scale"] = C(lambda r, S: ((r.f(*S.ew),), {"scale": 2.5, "bias": 0.5,
                                                 "bias_after_scale": False}))
CASES["clip"] = C(lambda r, S: ((r.f(*S.ew),), {"min": -0.5, "max": 0.7}))
CASES["stanh"] = _u("stanh")
CASES["softplus"] = C(lambda r, S: ((r.f(*S.ew) * 10,),
                                    {"beta": 2.0, "threshold": 5.0}))
CASES["cumsum"] = C(lambda r, S: ((r.f(*S.ew),), {"axis": 1}))
CASES["cumprod"] = C(lambda r, S: ((r.f(*S.ew, lo=0.99, hi=1.01),),
                                   {"dim": -1}), tol=(1e-4, 1e-5),
                     why="cumprod: a running product of up to 4096 factors "
                         "near 1 rounds once a factor")
CASES["cummax_values"] = C(lambda r, S: ((r.f(*S.ew),), {"axis": 2}))
CASES["logsumexp"] = C(lambda r, S: ((r.f(*S.ew),),
                                     {"axis": [0, 2], "keepdim": True}))
CASES["nan_to_num"] = C(
    lambda r, S: ((np.where(r.b(*S.ew), np.float32(np.inf),
                            r.f(*S.ew)).astype(np.float32),),
                  {"nan": 1.0, "posinf": 9.0}))
CASES["trapezoid"] = C(lambda r, S: ((r.f(*S.ew),), {"dx": 0.5, "axis": 1}))

# -- ops.reduction ------------------------------------------------------------
for n in ("sum", "mean", "max", "min", "amax", "amin", "nansum", "nanmean"):
    CASES[n] = C(lambda r, S: ((r.f(*S.ew),), {"axis": [0, 2]}))
CASES["sum"] = C(lambda r, S: ((r.f(*S.ew),), {"axis": -1, "keepdim": True}))
CASES["prod"] = C(lambda r, S: ((r.pos(*S.ew[:-1], 8),), {"axis": -1}))
CASES["all"] = C(lambda r, S: ((r.b(*S.ew),), {"axis": 1}), half=False)
CASES["any"] = C(lambda r, S: ((r.b(*S.ew),), {"axis": [0, 1]}),
                 half=False)
CASES["argmax"] = C(lambda r, S: ((r.f(*S.ew),), {"axis": -1}))
CASES["argmin"] = C(lambda r, S: ((r.f(*S.ew),), {"axis": 0,
                                                  "keepdim": True}))
CASES["std"] = C(lambda r, S: ((r.f(*S.ew),), {"axis": -1}))
CASES["var"] = C(lambda r, S: ((r.f(*S.ew),), {"axis": [1, 2],
                                               "unbiased": False}))
CASES["median"] = C(lambda r, S: ((r.f(*S.rows),), {"axis": -1}))
CASES["quantile"] = C(lambda r, S: ((r.f(*S.rows),
                                     np.array([0.1, 0.5, 0.9], np.float32)),
                                    {"axis": -1, "keepdim": True}))
CASES["count_nonzero"] = C(lambda r, S: ((r.i(*S.ew, lo=0, hi=3),),
                                         {"axis": 1}), half=False)
CASES["kthvalue_values"] = C(lambda r, S: ((r.f(*S.rows),),
                                           {"k": 3, "axis": -1}))

# -- ops.creation -------------------------------------------------------------
CASES["arange"] = C(lambda r, S: ((0, S.ew[-1] * 3, 2), {}))
CASES["empty"] = C(lambda r, S: ((list(S.ew),), {"dtype": "float32"}))
CASES["full"] = C(lambda r, S: ((list(S.ew), 2.5), {}))
CASES["eye"] = C(lambda r, S: ((S.mm[0], S.mm[1]), {}))
CASES["logspace"] = C(lambda r, S: ((0.0, 2.0, S.ew[-1]), {}))
CASES["tril_indices"] = C(lambda r, S: ((S.la[1], S.la[1] + 1, 1), {}))
CASES["triu_indices"] = C(lambda r, S: ((S.la[1], S.la[1] + 1, -1), {}))
for n in ("zeros_like", "ones_like", "empty_like", "clone", "assign"):
    CASES[n] = _u(n)
CASES["zeros_like"] = C(lambda r, S: ((r.f(*S.ew),), {"dtype": "int32"}),
                        half=False)
CASES["full_like"] = C(lambda r, S: ((r.f(*S.ew), 3.0), {}))
CASES["complex"] = C(lambda r, S: ((r.f(*S.ew), r.f(*S.ew)), {}),
                     grad=False, half=False,
                     why="complex outputs: JAX and torch conjugate complex "
                         "gradients differently")
CASES["diag"] = C(lambda r, S: ((r.f(S.mm[0], S.mm[1]),), {"offset": 1}))
CASES["diagflat"] = C(lambda r, S: ((r.f(S.la[1]),), {"offset": -1}))
CASES["tril"] = C(lambda r, S: ((r.f(*S.ew),), {"diagonal": 1}))
CASES["triu"] = C(lambda r, S: ((r.f(*S.ew),), {"diagonal": -1}))
CASES["meshgrid"] = C(lambda r, S: ((r.f(S.ew[1]), r.f(S.ew[2])), {}))

# -- ops.manipulation -----------------------------------------------------
CASES["reshape"] = C(lambda r, S: ((r.f(*S.ew),),
                                   {"shape": [S.ew[0], -1]}))
CASES["transpose"] = C(lambda r, S: ((r.f(*S.ew),), {"perm": [2, 0, 1]}))
CASES["moveaxis"] = C(lambda r, S: ((r.f(*S.ew),),
                                    {"source": 0, "destination": -1}))
CASES["swapaxes"] = C(lambda r, S: ((r.f(*S.ew),), {"axis1": 0,
                                                    "axis2": 2}))
CASES["flatten"] = C(lambda r, S: ((r.f(*S.ew),), {"start_axis": 1}))
CASES["squeeze"] = C(lambda r, S: ((r.f(S.ew[0], 1, S.ew[2], 1),),
                                   {"axis": [1, 2]}))
CASES["unsqueeze"] = C(lambda r, S: ((r.f(*S.ew),), {"axis": [0, -1]}))
CASES["concat"] = C(lambda r, S: ((r.f(*S.ew), r.f(*S.ew), r.f(*S.ew)),
                                  {"axis": 1}))
CASES["stack"] = C(lambda r, S: ((r.f(*S.ew), r.f(*S.ew)), {"axis": -1}))
CASES["split_op"] = C(lambda r, S: ((r.f(*S.ew),), {
    "num_or_sections": [1, -1, S.ew[-1] // 2], "axis": -1}))
CASES["chunk"] = C(lambda r, S: ((r.f(S.ew[0], 4, *S.ew[2:]), 2), {
    "axis": 1}))
CASES["tile"] = C(lambda r, S: ((r.f(*S.ew[1:]),), {"repeat_times":
                                                    [2, 1, 1]}))
CASES["expand"] = C(lambda r, S: ((r.f(1, *S.ew[1:]),),
                                  {"shape": [S.ew[0], -1, -1]}))
CASES["broadcast_to"] = C(lambda r, S: ((r.f(S.ew[2]),),
                                        {"shape": list(S.ew)}))
CASES["flip"] = C(lambda r, S: ((r.f(*S.ew),), {"axis": [0, 2]}))
CASES["roll"] = C(lambda r, S: ((r.f(*S.ew),), {"shifts": 2, "axis": 1}))
CASES["rot90"] = C(lambda r, S: ((r.f(*S.ew),), {"k": 3, "axes": (1, 2)}))
CASES["pad"] = C(lambda r, S: ((r.f(*S.ew),), {"pad": [1, 2, 0, 3],
                                               "mode": "reflect"}))
CASES["cast_f"] = C(lambda r, S: ((r.f(*S.ew),), {"dtype": "float16"}),
                    tol=(1e-3, 1e-3), why="a float16 result")
CASES["getitem"] = C(lambda r, S: ((r.f(*S.ew),), {
    "idx": (slice(None), np.array([2, 0, 1]), slice(1, None, 2))}))
CASES["gather"] = C(lambda r, S: ((r.f(*S.ew), r.i(2, 3, lo=0, hi=S.ew[1])),
                                  {"axis": 1}))
CASES["gather_nd"] = C(lambda r, S: ((r.f(*S.ew), np.stack([
    r.i(5, lo=0, hi=S.ew[0]), r.i(5, lo=0, hi=S.ew[1])], -1)), {}))
CASES["index_select"] = C(lambda r, S: ((r.f(*S.ew),
                                         r.i(6, lo=0, hi=S.ew[2])),
                                        {"axis": -1}))
CASES["take_along_axis"] = C(lambda r, S: ((r.f(*S.ew), r.i(
    S.ew[0], 3, S.ew[2], lo=0, hi=S.ew[1])), {"axis": 1}))
CASES["put_along_axis"] = C(lambda r, S: ((r.f(*S.ew), np.stack([
    r.perm(S.ew[1])[:2] for _ in range(S.ew[0] * S.ew[2])]).reshape(
    S.ew[0], S.ew[2], 2).transpose(0, 2, 1), r.f(S.ew[0], 2, S.ew[2])),
    {"axis": 1, "reduce": "add"}))
CASES["scatter"] = C(lambda r, S: ((r.f(*S.ew), r.perm(S.ew[0])[:2],
                                    r.f(2, *S.ew[1:])), {}))
CASES["scatter_nd_add"] = C(lambda r, S: ((r.f(*S.ew), np.stack([
    r.i(6, lo=0, hi=S.ew[0]), r.i(6, lo=0, hi=S.ew[1])], -1),
    r.f(6, S.ew[2])), {}), tol=(1e-5, 1e-5),
    why="duplicate (i, j) pairs sum in another order")
CASES["index_add"] = C(lambda r, S: ((r.f(*S.ew), r.i(4, lo=0, hi=S.ew[1]),
                                      ), {"axis": 1, "value": r.f(
                                          S.ew[0], 4, S.ew[2])}),
                       tol=(1e-5, 1e-5),
                       why="duplicate indices sum in another order")
CASES["index_put"] = C(lambda r, S: ((r.f(*S.ew), (r.perm(S.ew[0])[:2],
                                                   r.perm(S.ew[1])[:2]),
                                      r.f(2, S.ew[2])), {}))
CASES["where"] = C(lambda r, S: ((r.b(*S.ew), r.f(*S.ew), r.f(*S.ew)), {}))
CASES["nonzero"] = C(lambda r, S: ((r.i(*S.ew, lo=0, hi=2),), {}),
                     half=False)
CASES["masked_select_nondiff"] = C(lambda r, S: ((r.f(*S.ew), r.b(*S.ew)),
                                                 {}))
CASES["masked_select"] = CASES["masked_select_nondiff"]
CASES["masked_fill"] = C(lambda r, S: ((r.f(*S.ew), r.b(*S.ew)),
                                       {"value": -2.0}))
CASES["sort"] = C(lambda r, S: ((r.f(*S.rows),), {"descending": True}))
CASES["argsort"] = C(lambda r, S: ((r.f(*S.rows),), {"axis": -1}))
CASES["unique_op"] = C(lambda r, S: ((r.i(*S.ew, lo=0, hi=40),), {}),
                       half=False)
CASES["searchsorted"] = C(lambda r, S: ((np.sort(r.f(S.rows[1])),
                                         r.f(*S.ew)), {"right": True}))
CASES["bincount"] = C(lambda r, S: ((r.i(S.ew[-1] * 4, lo=0, hi=9),),
                                    {"minlength": 12}), half=False)
CASES["repeat_interleave"] = C(lambda r, S: ((r.f(*S.ew),),
                                             {"repeats": 2, "axis": 1}))
CASES["as_real"] = C(lambda r, S: (((r.f(*S.ew) + 1j * r.f(*S.ew)).astype(
    np.complex64),), {}), grad=False, half=False, why="a complex input")
CASES["as_complex"] = C(lambda r, S: ((r.f(*S.ew, 2),), {}), grad=False,
                        half=False, why="complex outputs: JAX and torch "
                                        "conjugate complex gradients "
                                        "differently")
CASES["diagonal"] = C(lambda r, S: ((r.f(*S.ew),), {"offset": 1,
                                                    "axis1": 1,
                                                    "axis2": 2}))
CASES["trace"] = C(lambda r, S: ((r.f(*S.ew),), {"axis1": 1, "axis2": 2}))
CASES["kron"] = C(lambda r, S: ((r.f(3, 4), r.f(2, 5)), {}))
CASES["one_hot_nd"] = C(lambda r, S: ((r.i(*S.ew[:2], lo=-1, hi=7),),
                                      {"num_classes": 7}), half=False)
CASES["tensordot"] = C(lambda r, S: ((r.f(S.mm[0], S.mm[1] // 4, 4),
                                      r.f(4, S.mm[1] // 4, S.mm[2])),
                                     {"axes": ([1, 2], [1, 0])}),
                       tol=(1e-4, 1e-5), why="a float32 product over k "
                                             "terms sums in another order")

# -- ops.logic ----------------------------------------------------------------
for n in ("equal", "not_equal", "less_than", "less_equal", "greater_than",
          "greater_equal"):
    CASES[n] = C(lambda r, S: ((r.i(*S.ew, lo=0, hi=3).astype(np.float32),
                                r.i(*S.ew, lo=0, hi=3).astype(np.float32)),
                               {}))
for n in ("logical_and", "logical_or", "logical_xor"):
    CASES[n] = _bools2()
CASES["logical_not"] = C(lambda r, S: ((r.b(*S.ew),), {}), half=False)
for n in ("bitwise_and", "bitwise_or", "bitwise_xor"):
    CASES[n] = C(lambda r, S: ((r.i(*S.ew, lo=-9, hi=9),
                                r.i(*S.ew, lo=-9, hi=9)), {}), half=False)
CASES["bitwise_not"] = C(lambda r, S: ((r.i(*S.ew, lo=-9, hi=9),), {}),
                         half=False)
CASES["isclose"] = C(lambda r, S: ((r.f(*S.ew), r.f(*S.ew) * 1e-3),
                                   {"atol": 0.5}), half=False,
                     why="a tolerance test flips where bf16 rounding moves "
                         "a difference across atol")
CASES["allclose"] = C(lambda r, S: ((r.f(*S.ew), r.f(*S.ew)),
                                    {"atol": 10.0}))
CASES["equal_all"] = C(lambda r, S: ((r.i(*S.ew, lo=0, hi=1),
                                      r.i(*S.ew, lo=0, hi=1)), {}),
                       half=False)
CASES["isin"] = C(lambda r, S: ((r.i(*S.ew, lo=0, hi=20),
                                 r.i(7, lo=0, hi=20)), {}), half=False)

# -- ops.linalg ---------------------------------------------------------------
_MM = dict(tol=(1e-4, 1e-5), why="a float32 product over k terms sums in "
                                 "another order (XLA's dot, cuBLAS / MKL)")
CASES["matmul"] = C(lambda r, S: ((r.f(S.mm[1], S.mm[0]), r.f(S.mm[1],
                                                             S.mm[2])),
                                  {"transpose_x": True}), **_MM)
CASES["bmm"] = C(lambda r, S: ((r.f(2, S.mm[0] // 2, S.mm[1]),
                                r.f(2, S.mm[1], S.mm[2])), {}), **_MM)
CASES["dot"] = C(lambda r, S: ((r.f(*S.ew), r.f(*S.ew)), {}), **_MM)
CASES["inner"] = C(lambda r, S: ((r.f(S.mm[0], S.mm[1]),
                                  r.f(S.mm[2], S.mm[1])), {}), **_MM)
CASES["outer"] = C(lambda r, S: ((r.f(S.mm[0]), r.f(S.mm[2])), {}))
CASES["cross"] = C(lambda r, S: ((r.f(S.ew[0], 3), r.f(S.ew[0], 3)),
                                 {"axis": -1}))
CASES["einsum"] = C(lambda r, S: ((r.f(2, S.mm[0] // 2, S.mm[1]),
                                   r.f(2, S.mm[1], S.mm[2])),
                                  {"equation": "bij,bjk->bik"}), **_MM)
CASES["multi_dot"] = C(lambda r, S: (([r.f(S.mm[0], S.mm[1]),
                                       r.f(S.mm[1], S.mm[2]),
                                       r.f(S.mm[2], 3)],), {}), **_MM)
CASES["multi_dot_op"] = C(lambda r, S: ((r.f(S.mm[0], S.mm[1]),
                                         r.f(S.mm[1], S.mm[2])), {}), **_MM)
CASES["norm"] = C(lambda r, S: ((r.f(*S.ew),), {"p": 3, "axis": -1}))
CASES["matrix_norm"] = C(lambda r, S: ((r.f(S.la[0], S.la[1], S.la[1]),),
                                       {"p": 1}), half=False)
_LA = dict(tol=(1e-4, 1e-5), half=False,
           why="LAPACK / cuSOLVER and XLA factor in another order: float32 "
               "roundoff grows with the condition number")
CASES["cholesky"] = C(lambda r, S: ((r.spd(*S.la),), {"upper": True}), **_LA)
CASES["cholesky_solve"] = C(lambda r, S: ((
    r.f(S.la[0], S.la[1], 3), np.linalg.cholesky(r.spd(*S.la)).astype(
        np.float32)), {}), **_LA)
CASES["inv"] = C(lambda r, S: ((r.wellcond(*S.la),), {}), **_LA)
CASES["pinv"] = C(lambda r, S: ((np.concatenate(
    [r.wellcond(*S.la), r.f(S.la[0], S.la[1], 2) / np.sqrt(S.la[1])],
    -1).astype(np.float32),), {}), **_LA)
CASES["solve"] = C(lambda r, S: ((r.wellcond(*S.la),
                                  r.f(S.la[0], S.la[1], 2)), {}), **_LA)
CASES["triangular_solve"] = C(lambda r, S: ((r.upper(*S.la),
                                             r.f(S.la[0], S.la[1], 2)),
                                            {"transpose": True}), **_LA)
CASES["matrix_rank"] = C(lambda r, S: ((r.f(S.la[0], S.la[1], 3) @ r.f(
    S.la[0], 3, S.la[1]),), {}), **_LA)
CASES["det"] = C(lambda r, S: ((r.wellcond(*S.la) / 2,), {}),
                 **dict(_LA, tol=(1e-3, 1e-5),
                        why="a determinant's roundoff grows with n (256 on "
                            "the card)"))
CASES["slogdet"] = C(lambda r, S: ((r.wellcond(*S.la),), {}), **_LA)
CASES["matrix_power"] = C(lambda r, S: ((r.wellcond(*S.la) / 2,),
                                        {"n": 3}), **_LA)
CASES["matrix_exp"] = C(lambda r, S: ((r.f(S.la[0], S.la[1], S.la[1])
                                       / (2 * S.la[1]),), {}), **_LA)

# -- ops.random and the fills (statistics, not values) -----------------------
CASES["bernoulli"] = C(lambda r, S: ((r.prob(*S.ew),), {}),
                       random="bernoulli")
CASES["gumbel"] = C(lambda r, S: ((list(S.ew),), {}), random="gumbel")
CASES["exponential_"] = C(lambda r, S: ((r.f(*S.ew),), {"lam": 2.0}),
                          random="exponential")
CASES["uniform_"] = C(lambda r, S: ((r.f(*S.ew),), {"min": -2.0,
                                                    "max": 3.0}),
                      random="uniform")
CASES["normal_"] = C(lambda r, S: ((r.f(*S.ew),), {"mean": 1.0, "std": 2.0}),
                     random="normal")
CASES["cauchy_"] = C(lambda r, S: ((r.f(*S.ew),), {"loc": 1.0,
                                                   "scale": 2.0}),
                     random="cauchy")
CASES["geometric_"] = C(lambda r, S: ((r.f(*S.ew), 0.3), {}),
                        random="geometric")

# -- ops: the surface's own -------------------------------------------------
CASES["create_tensor"] = C(lambda r, S: (("float32",), {}))
CASES["t_"] = C(lambda r, S: ((r.f(S.mm[0], S.mm[1]),), {}))
CASES["transpose_"] = C(lambda r, S: ((r.f(*S.ew), [1, 0, 2]), {}))
CASES["cast_"] = C(lambda r, S: ((r.f(*S.ew), "int32"), {}), grad=False,
                   why="an integer result")
CASES["where_"] = CASES["where"]

# -- nn.functional ------------------------------------------------------------
for n in ("relu", "relu6", "f_sigmoid", "log_sigmoid", "f_tanh", "tanhshrink",
          "hardswish", "mish", "f_softsign", "silu", "swish"):
    CASES[n] = C(lambda r, S: ((r.f(*S.ew) * 4,), {}))
CASES["elu"] = C(lambda r, S: ((r.f(*S.ew),), {"alpha": 0.7}))
CASES["celu"] = C(lambda r, S: ((r.f(*S.ew),), {"alpha": 1.3}))
CASES["selu"] = _u("selu")
CASES["gelu"] = C(lambda r, S: ((r.f(*S.ew),), {"approximate": True}))
CASES["leaky_relu"] = C(lambda r, S: ((r.f(*S.ew),),
                                      {"negative_slope": 0.2}))
CASES["prelu"] = C(lambda r, S: ((r.f(*S.ew), r.prob(S.ew[1])), {}))
CASES["rrelu"] = C(lambda r, S: ((r.f(*S.ew),), {"training": False}))
_STEP = dict(half=False, why="a step at the threshold: bf16 rounds the "
                             "threshold and the inputs near it to either side")
CASES["hardshrink"] = C(lambda r, S: ((r.f(*S.ew),), {"threshold": 0.3}),
                        **_STEP)
CASES["softshrink"] = C(lambda r, S: ((r.f(*S.ew),), {"threshold": 0.3}))
CASES["hardsigmoid"] = C(lambda r, S: ((r.f(*S.ew) * 4,), {}))
CASES["hardtanh"] = C(lambda r, S: ((r.f(*S.ew),), {"min": -0.5,
                                                    "max": 0.8}))
CASES["f_softplus"] = C(lambda r, S: ((r.f(*S.ew) * 10,), {"beta": 2.0,
                                                           "threshold": 5.0}))
CASES["thresholded_relu"] = C(lambda r, S: ((r.f(*S.ew),),
                                            {"threshold": 0.2, "value": -1.0}),
                              **_STEP)
CASES["softmax"] = C(lambda r, S: ((r.f(*S.ew),), {"axis": 1}))
CASES["log_softmax"] = C(lambda r, S: ((r.f(*S.ew),), {"axis": -1}))
CASES["glu"] = C(lambda r, S: ((r.f(*S.ew[:-1], 2 * S.ew[-1]),), {}))
CASES["maxout"] = C(lambda r, S: ((r.f(S.ew[0], 4, *S.ew[2:]),),
                                  {"groups": 2, "axis": 1}))
CASES["gumbel_softmax_p"] = C(lambda r, S: ((r.f(*S.ew),),
                                            {"temperature": 0.5,
                                             "hard": True}), half=False,
                              why="the hard one-hot flips at near-ties of a "
                                  "bf16 softmax")
CASES["linear"] = C(lambda r, S: ((r.f(S.mm[0], S.mm[1]),
                                   r.f(S.mm[1], S.mm[2]), r.f(S.mm[2])),
                                  {}), **_MM)
CASES["embedding"] = C(lambda r, S: ((r.i(*S.ew[:2], lo=0, hi=S.mm[0]),
                                      r.f(S.mm[0], S.mm[1])),
                                     {"padding_idx": 0}))
CASES["one_hot"] = C(lambda r, S: ((r.i(*S.ew[:2], lo=0, hi=6),),
                                   {"num_classes": 6}), half=False)
CASES["dropout_p"] = C(lambda r, S: ((r.f(*S.ew),), {
    "p": 0.25, "training": True, "mode": "upscale_in_train"}),
    random="dropout")
CASES["alpha_dropout_p"] = C(lambda r, S: ((r.f(*S.ew),), {"p": 0.2}),
                             random="alpha_dropout")
CASES["f_pad"] = C(lambda r, S: ((r.f(*S.ew),), {
    "pad_cfg": ((0, 0), (2, 1), (1, 3)), "mode": "circular", "value": 0.0}))
CASES["cosine_similarity"] = C(lambda r, S: ((r.f(*S.ew), r.f(*S.ew)),
                                             {"axis": -1}))
CASES["bilinear"] = C(lambda r, S: ((r.f(S.ew[0], 5), r.f(S.ew[0], 6),
                                     r.f(4, 5, 6), r.f(4)), {}))
CASES["label_smooth"] = C(lambda r, S: ((r.prob(*S.ew),),
                                        {"epsilon": 0.2}))
CASES["pixel_shuffle"] = C(lambda r, S: ((r.f(2, 8, 3, 5),),
                                         {"upscale_factor": 2}))
CASES["pixel_unshuffle"] = C(lambda r, S: ((r.f(2, 3, 4, 6),),
                                           {"downscale_factor": 2}))
CASES["channel_shuffle"] = C(lambda r, S: ((r.f(2, 6, 3, 4),),
                                           {"groups": 3}))
CASES["interpolate"] = C(lambda r, S: ((r.f(2, 3, 6, 8),),
                                       {"size": [9, 5], "mode": "bicubic"}))
CASES["unfold"] = C(lambda r, S: ((r.f(2, 3, 7, 6),), {
    "kernel_sizes": [3, 2], "strides": [2, 1], "paddings": 1}))
CASES["fold"] = C(lambda r, S: ((r.f(2, 3 * 3 * 2, 4 * 7),), {
    "output_sizes": [7, 6], "kernel_sizes": [3, 2], "strides": [2, 1],
    "paddings": 1}))
CASES["normalize"] = C(lambda r, S: ((r.f(*S.ew),), {"p": 3, "axis": -1}))
CASES["layer_norm"] = C(lambda r, S: ((r.f(*S.ew), r.f(*S.ew[1:]),
                                       r.f(*S.ew[1:])),
                                      {"normalized_ndim": 2}))
CASES["rms_norm"] = C(lambda r, S: ((r.f(*S.ew), r.f(S.ew[-1])),
                                    {"epsilon": 1e-5}))
CASES["_batch_norm_train"] = C(lambda r, S: ((r.f(2, 3, 4, 5), r.f(3),
                                              r.f(3)), {
    "epsilon": 1e-5, "data_format": "NCHW", "ch_axis": 1}),
    tol=(1e-5, 1e-5), why="E[x^2] - E[x]^2 cancels in float32")
CASES["_batch_norm_eval"] = C(lambda r, S: ((r.f(2, 3, 4, 5), r.f(3),
                                             r.pos(3), r.f(3), r.f(3)),
                                            {"epsilon": 1e-5,
                                             "ch_axis": 1}))
CASES["instance_norm"] = C(lambda r, S: ((r.f(2, 3, 4, 5), r.f(3), r.f(3)),
                                         {}), tol=(1e-5, 1e-5),
                           why="variance over 20 values in another order")
CASES["group_norm"] = C(lambda r, S: ((r.f(2, 6, 4, 5), r.f(6), r.f(6)),
                                      {"num_groups": 3}), tol=(1e-5, 1e-5),
                        why="variance over 40 values in another order")
CASES["local_response_norm"] = C(lambda r, S: ((r.f(2, 7, 4, 5),),
                                               {"size": 3, "alpha": 0.1}))
CASES["_sdpa_op"] = C(lambda r, S: ((r.f(2, 6, 4, 8), r.f(2, 6, 2, 8),
                                     r.f(2, 6, 2, 8)),
                                    {"is_causal": True}), tol=(1e-5, 1e-5),
                      why="a float32 softmax over keys summed in another "
                          "order")
CASES["apply_rotary_emb"] = C(lambda r, S: ((r.f(2, 6, 3, 8), r.f(6, 4),
                                             r.f(6, 4)), {}))
CASES["fused_rope"] = C(lambda r, S: ((r.f(2, 6, 3, 8), r.f(2, 6, 4),
                                       r.f(2, 6, 4)), {"neox": False}))
CASES["flash_attn_varlen"] = C(lambda r, S: ((
    r.f(10, 2, 8), r.f(10, 2, 8), r.f(10, 2, 8),
    np.array([0, 0, 0, 1, 1, 1, 1, 2, 2, -1]),
    np.array([0, 0, 0, 1, 1, 1, 1, 2, 2, -1]),
    np.array([0, 1, 2, 0, 1, 2, 3, 0, 1, 9]),
    np.array([0, 1, 2, 0, 1, 2, 3, 0, 1, 9])),
    {"causal": True, "scale": None}), tol=(1e-5, 1e-5),
    why="a float32 softmax over keys summed in another order")

# losses: logits / probabilities and labels at small widths
_B, _K = 6, 5
CASES["cross_entropy"] = C(lambda r, S: ((r.f(_B, _K), r.i(_B, lo=0, hi=_K)),
                                         {"label_smoothing": 0.1}))
CASES["softmax_with_cross_entropy"] = C(
    lambda r, S: ((r.f(_B, _K), r.i(_B, 1, lo=0, hi=_K)), {}))
CASES["binary_cross_entropy"] = C(lambda r, S: ((r.prob(_B, _K),
                                                 r.b(_B, _K).astype(
                                                     np.float32)), {}))
CASES["binary_cross_entropy_with_logits"] = C(
    lambda r, S: ((r.f(_B, _K), r.b(_B, _K).astype(np.float32)),
                  {"pos_weight": None}))
CASES["mse_loss"] = C(lambda r, S: ((r.f(_B, _K), r.f(_B, _K)), {}))
CASES["l1_loss"] = C(lambda r, S: ((r.f(_B, _K), r.f(_B, _K)),
                                   {"reduction": "sum"}))
CASES["square_error_cost"] = C(lambda r, S: ((r.f(_B, _K), r.f(_B, _K)), {}))
CASES["log_loss"] = C(lambda r, S: ((r.prob(_B, 1), r.b(_B, 1).astype(
    np.float32)), {}))
CASES["nll_loss"] = C(lambda r, S: ((np.log(r.prob(_B, _K)),
                                     r.i(_B, lo=0, hi=_K)), {}))
CASES["kl_div"] = C(lambda r, S: ((np.log(r.prob(_B, _K)), r.prob(_B, _K)),
                                  {"reduction": "batchmean"}))
CASES["smooth_l1_loss"] = C(lambda r, S: ((r.f(_B, _K), r.f(_B, _K)),
                                          {"delta": 0.5}))
CASES["margin_ranking_loss"] = C(lambda r, S: ((r.f(_B), r.f(_B), np.sign(
    r.f(_B)).astype(np.float32)), {"margin": 0.1}))
CASES["hinge_embedding_loss"] = C(lambda r, S: ((r.f(_B, _K), np.sign(
    r.f(_B, _K)).astype(np.float32)), {"margin": 0.5}))
CASES["cosine_embedding_loss"] = C(lambda r, S: ((r.f(_B, _K), r.f(_B, _K),
                                                  np.sign(r.f(_B)).astype(
                                                      np.float32)),
                                                 {"margin": 0.1}))
CASES["triplet_margin_loss"] = C(lambda r, S: ((r.f(_B, _K), r.f(_B, _K),
                                                r.f(_B, _K)), {"swap": True}))
CASES["sigmoid_focal_loss"] = C(lambda r, S: ((r.f(_B, _K), r.b(
    _B, _K).astype(np.float32)), {"gamma": 2.0}))
CASES["dice_loss"] = C(lambda r, S: ((r.prob(_B, _K), r.i(_B, 1, lo=0,
                                                           hi=_K)), {}))
CASES["npair_loss"] = C(lambda r, S: ((r.f(_B, _K), r.f(_B, _K),
                                       r.i(_B, lo=0, hi=3).astype(
                                           np.float32)), {}))
CASES["poisson_nll_loss"] = C(lambda r, S: ((r.f(_B, _K), r.pos(_B, _K)),
                                            {"full": True}))
CASES["multi_label_soft_margin_loss"] = C(lambda r, S: ((r.f(_B, _K), r.b(
    _B, _K).astype(np.float32)), {}))
CASES["soft_margin_loss"] = C(lambda r, S: ((r.f(_B, _K), np.sign(r.f(
    _B, _K)).astype(np.float32)), {}))
CASES["gaussian_nll_loss"] = C(lambda r, S: ((r.f(_B, _K), r.pos(_B, _K),
                                              r.f(_B, _K)), {"full": True}))

# -- ops.math_ext -------------------------------------------------------------
CASES["add_n_op"] = C(lambda r, S: ((r.f(*S.ew), r.f(*S.ew), r.f(*S.ew)),
                                    {}))
for n in ("bitwise_left_shift", "bitwise_right_shift"):
    CASES[n] = C(lambda r, S: ((r.i(*S.ew, lo=-9, hi=9),
                                r.i(*S.ew, lo=0, hi=4)), {}), half=False)
CASES["bucketize_op"] = C(lambda r, S: ((r.f(*S.ew), np.sort(
    r.f(S.rows[1]))), {"right": True}), half=False,
    why="a bucket flips where bf16 rounds a value across a boundary")
for n in ("copysign", "nextafter"):
    CASES[n] = _bin()
CASES["nextafter"] = _bin(half=False, why="the neighbouring float is a "
                                          "float32 notion")
_TIES = dict(why="small integers as floats: runs of equal values, so the "
                 "index is the last equal position and a tie splits the "
                 "gradient as the reference's parallel scan does")
for n in ("cummax", "cummin"):
    CASES[n] = C(lambda r, S: ((r.ties(*S.ew),), {"axis": 1}), **_TIES)
    CASES[n + "_op"] = C(lambda r, S: ((r.ties(*S.ew),), {"axis": 2}),
                         **_TIES)
CASES["cumulative_trapezoid"] = C(lambda r, S: ((r.f(*S.ew),),
                                                {"dx": 0.5, "axis": 1}))
CASES["cumulative_trapezoid_op"] = C(lambda r, S: ((r.f(*S.ew),), {
    "x": np.cumsum(r.pos(*S.ew), -1).astype(np.float32)}), tol=(1e-4, 1e-5),
    why="a running sum of up to 4096 terms in another order")
CASES["diff"] = C(lambda r, S: ((r.f(*S.ew),), {
    "axis": 1, "prepend": r.f(S.ew[0], 1, S.ew[2])}))
CASES["diff_op"] = C(lambda r, S: ((r.f(*S.ew),), {"n": 2, "axis": -1}))
CASES["floor_mod"] = C(lambda r, S: ((r.f(*S.ew) * 3, r.pos(*S.ew)), {}),
                       grad=False, why="mod: the gradient jumps at each "
                                       "multiple of y; values are compared")
CASES["remainder_"] = CASES["floor_mod"]
# composites whose reference result leaves its tape (``stop_gradient``):
# the port's differentiate (torch views and ops), so no gradient is
# compared against the reference's (none)
_OFF_TAPE = dict(grad=False, why="the reference's composite rebuilds its "
                                 "outputs outside its tape (stop_gradient); "
                                 "the port's differentiate")
CASES["frexp"] = C(lambda r, S: ((r.f(*S.ew) * 10,), {}), half=False,
                   **_OFF_TAPE)
for n in ("gammainc", "gammaincc"):
    CASES[n] = C(lambda r, S: ((2 * r.pos(*S.ew), 2 * r.pos(*S.ew)), {}),
                 tol=(1e-4, 1e-5), half=False,
                 why="series approximations differ by a few float32 ulps; "
                     "d/da is a float64 central difference against XLA's "
                     "series")
CASES["gammaln"] = _dom("pos", tol=(1e-4, 1e-5),
                        why="Lanczos series differ by a few float32 ulps")
for n in ("i0", "i0e", "i1", "i1e"):
    CASES[n] = C(lambda r, S: ((r.f(*S.ew) * 3,), {}), tol=(1e-4, 1e-5),
                 why="Bessel series (Cephes in both, evaluated in another "
                     "order) differ by a few float32 ulps")
CASES["sinc"] = _u("sinc")
CASES["neg"] = _u("neg")
CASES["sgn"] = _u("sgn")
CASES["signbit"] = _u("signbit")
CASES["increment"] = C(lambda r, S: ((r.f(*S.ew),), {"value": 2.5}),
                       grad=False, why="an in-place counter outside "
                                       "autograd in both packages")
for n in ("isneginf", "isposinf"):
    CASES[n] = C(lambda r, S: ((np.where(r.b(*S.ew), np.float32(np.inf),
                                         np.where(r.b(*S.ew),
                                                  -np.float32(np.inf),
                                                  r.f(*S.ew))).astype(
        np.float32),), {}))
CASES["isreal"] = C(lambda r, S: ((np.where(r.b(*S.ew), r.c(*S.ew),
                                            r.f(*S.ew)).astype(
    np.complex64),), {}), half=False, why="a complex input")
CASES["logcumsumexp"] = C(lambda r, S: ((r.f(*S.ew),), {"axis": 1}),
                          tol=(1e-5, 1e-5),
                          why="a running log-sum-exp in another order")
CASES["multigammaln_op"] = C(lambda r, S: ((2 + r.pos(*S.ew),), {"p": 3}),
                             tol=(1e-4, 1e-5), half=False,
                             why="sums of lgamma series, a few ulps each")
CASES["multigammaln_"] = CASES["multigammaln_op"]
CASES["multiplex_op"] = C(lambda r, S: ((r.f(S.ew[1], S.ew[2]),
                                         r.f(S.ew[1], S.ew[2]),
                                         r.f(S.ew[1], S.ew[2])),
                                        {"index": r.i(S.ew[1], 1, lo=0,
                                                      hi=3)}))
_NANS = dict(tol=(1e-5, 1e-5), why="an interpolation between two sorted "
                                   "values, rounded in another order")
CASES["nanmedian"] = C(lambda r, S: ((np.where(
    r.prob(*S.ew) < 0.15, np.float32(np.nan), r.f(*S.ew)).astype(
    np.float32),), {"axis": [0, 2]}), **_NANS)
CASES["nanmedian_op"] = C(lambda r, S: ((np.where(
    r.prob(*S.ew) < 0.15, np.float32(np.nan), r.f(*S.ew)).astype(
    np.float32),), {"axis": 1, "keepdim": True}), **_NANS)
CASES["nanquantile"] = C(lambda r, S: ((np.where(
    r.prob(*S.ew) < 0.15, np.float32(np.nan), r.f(*S.ew)).astype(
    np.float32),), {"q": [0.25, 0.75], "axis": -1}), **_NANS)
CASES["nanquantile_op"] = C(lambda r, S: ((np.where(
    r.prob(*S.ew) < 0.15, np.float32(np.nan), r.f(*S.ew)).astype(
    np.float32),), {"q": 0.3, "axis": (1, 2), "keepdim": True}), **_NANS)
CASES["polar"] = C(lambda r, S: ((r.pos(*S.ew), r.f(*S.ew)), {}),
                   half=False, why="a complex output")
CASES["reduce_as_op"] = C(lambda r, S: ((r.f(*S.ew),), {
    "target_shape": (1, S.ew[1], 1)}), tol=(1e-5, 1e-5),
    why="a sum in another order")
CASES["renorm_op"] = C(lambda r, S: ((r.f(*S.ew),), {
    "p": 2.0, "axis": 1, "max_norm": 3.0}), tol=(1e-5, 1e-5),
    why="a norm summed in another order")
CASES["renorm_"] = CASES["renorm_op"]
CASES["take_op"] = C(lambda r, S: ((r.f(*S.ew), r.i(
    9, lo=-2 * int(np.prod(S.ew)), hi=2 * int(np.prod(S.ew)))),
    {"mode": "wrap"}))

# -- ops.manipulation_ext -----------------------------------------------------
CASES["as_strided"] = C(lambda r, S: ((r.f(*S.ew), (S.ew[0], 3),
                                       (S.ew[1] * S.ew[2], 2), 1), {}))
CASES["as_strided_op"] = C(lambda r, S: ((r.f(*S.ew),), {
    "shape": (2, S.ew[2], 2), "stride": (S.ew[2], 1, 3), "offset": 2}))
for n in ("atleast_1d", "atleast_2d", "atleast_3d"):
    CASES[n] = C(lambda r, S: ((r.f(S.ew[2]), r.f(S.ew[1], S.ew[2])), {}),
                 **_OFF_TAPE)
CASES["broadcast_tensors"] = C(lambda r, S: (([r.f(S.ew[0], 1, S.ew[2]),
                                               r.f(1, S.ew[1], 1)],), {}))
CASES["crop"] = C(lambda r, S: ((r.f(*S.ew),), {
    "shape": [2, -1, 3], "offsets": [1, 0, 1]}))
CASES["crop_op"] = C(lambda r, S: ((r.f(*S.ew),), {
    "shape": (1, 2, S.ew[2] - 1), "offsets": (1, 1, 0)}))
CASES["diag_embed"] = C(lambda r, S: ((r.f(S.ew[0], 5),), {
    "offset": 1, "dim1": 0, "dim2": 2}))
CASES["diag_embed_op"] = C(lambda r, S: ((r.f(S.ew[0], 4),), {
    "offset": -2}))
CASES["diagonal_scatter"] = C(lambda r, S: ((r.f(S.ew[0], 5, 6),
                                             r.f(S.ew[0], 5)),
                                            {"offset": 1, "axis1": 1,
                                             "axis2": 2}))
CASES["diagonal_scatter_op"] = C(lambda r, S: ((r.f(6, S.ew[0], 5),
                                                r.f(S.ew[0], 4)),
                                               {"offset": -2, "axis1": 0,
                                                "axis2": 2}))
CASES["dsplit"] = C(lambda r, S: ((r.f(S.ew[0], 3, 6), 3), {}), **_OFF_TAPE)
CASES["hsplit"] = C(lambda r, S: ((r.f(S.ew[0], 6, 3), [1, 4]), {}),
                    **_OFF_TAPE)
CASES["vsplit"] = C(lambda r, S: ((r.f(6, *S.ew[1:]), 2), {}), **_OFF_TAPE)
CASES["expand_as"] = C(lambda r, S: ((r.f(1, S.ew[1], 1), r.f(*S.ew)), {}))
CASES["index_fill"] = C(lambda r, S: ((r.f(*S.ew), r.perm(S.ew[1])[:2],
                                       1, -1.5), {}))
CASES["index_fill_op"] = C(lambda r, S: ((r.f(*S.ew), r.perm(S.ew[2])[:3]),
                                         {"axis": 2, "value": 0.25}))
CASES["index_sample"] = C(lambda r, S: ((r.f(S.ew[1], S.ew[2]), r.i(
    S.ew[1], 4, lo=0, hi=S.ew[2])), {}))
CASES["index_sample_op"] = CASES["index_sample"]
CASES["kthvalue_op"] = C(lambda r, S: ((r.f(*S.rows),), {
    "k": 3, "axis": -1, "keepdim": True}))
CASES["masked_scatter_op"] = C(lambda r, S: ((r.f(*S.ew), r.b(*S.ew),
                                              r.f(int(np.prod(S.ew)))), {}))
CASES["masked_scatter_"] = CASES["masked_scatter_op"]
_MODE = dict(why="counts of equal values compare every pair of a row: a "
                 "short row of small integers, at both sizes")
CASES["mode"] = C(lambda r, S: ((r.ties(S.ew[0], 9),), {}), **_MODE)
CASES["mode_op"] = C(lambda r, S: ((r.ties(9, S.ew[0]),),
                                   {"axis": 0, "keepdim": True}), **_MODE)
CASES["select_scatter"] = C(lambda r, S: ((r.f(*S.ew), r.f(S.ew[0],
                                                           S.ew[2]), 1, 2),
                                          {}))
CASES["select_scatter_op"] = C(lambda r, S: ((r.f(*S.ew), r.f(*S.ew[:2])),
                                             {"axis": 2, "index": -1}))
CASES["shard_index_op"] = C(lambda r, S: ((r.i(S.ew[0], 1, lo=0, hi=20),), {
    "index_num": 20, "nshards": 3, "shard_id": 1, "ignore_value": -1}),
    half=False)
CASES["slice_op"] = C(lambda r, S: ((r.f(*S.ew),), {
    "axes": (0, 2), "starts": (1, -3), "ends": (S.ew[0], 1 << 20)}))
CASES["slice_scatter"] = C(lambda r, S: ((r.f(*S.ew), r.f(
    S.ew[0], (S.ew[1] + 1) // 2, S.ew[2])), {
    "axes": [1], "starts": [0], "ends": [S.ew[1]], "strides": [2]}))
CASES["slice_scatter_op"] = C(lambda r, S: ((r.f(*S.ew), r.f(
    S.ew[0], S.ew[1], 2)), {"axes": (2,), "starts": (1,), "ends": (4,),
                            "strides": (2,)}))
CASES["strided_slice_op"] = C(lambda r, S: ((r.f(*S.ew),), {
    "axes": (0, 1, 2), "starts": (0, 3, 1), "ends": (S.ew[0], 0, S.ew[2]),
    "strides": (2, -1, 2)}))
CASES["tensor_unfold_op"] = C(lambda r, S: ((r.f(*S.ew),), {
    "axis": 1, "size": 3, "step": 2}))
CASES["top_p_sampling"] = C(lambda r, S: ((r.f(S.ew[0], S.rows[1]),
                                           np.full(S.ew[0], 0.8,
                                                   np.float32)), {}),
                            random="top_p")
CASES["unflatten"] = C(lambda r, S: ((r.f(S.ew[0], S.ew[1] * S.ew[2]), 1,
                                      [S.ew[1], -1]), {}))
CASES["unflatten_op"] = C(lambda r, S: ((r.f(*S.ew),), {
    "axis": -1, "shape": (1, S.ew[2])}))
CASES["unique_consecutive"] = C(lambda r, S: ((r.i(*S.ew, lo=0, hi=2),), {
    "return_inverse": True, "return_counts": True}), half=False)
CASES["view"] = C(lambda r, S: ((r.f(*S.ew), [S.ew[0], -1]), {}))
CASES["view_as"] = C(lambda r, S: ((r.f(*S.ew), r.f(S.ew[0],
                                                    S.ew[1] * S.ew[2])), {}))

# -- ops.misc_ext ---------------------------------------------------------------
CASES["_combinations"] = C(lambda r, S: ((r.f(6),), {"r": 3}))
CASES["combinations"] = C(lambda r, S: ((r.f(5),), {
    "r": 2, "with_replacement": True}))
for n in ("column_stack", "dstack", "hstack", "vstack", "row_stack"):
    CASES[n] = C(lambda r, S: (([r.f(S.ew[1], S.ew[2]),
                                 r.f(S.ew[1], S.ew[2])],), {}))
CASES["pdist"] = C(lambda r, S: ((r.f(7, S.ew[2]),), {}), tol=(1e-5, 1e-5),
                   why="a sum of squares over the row in another order")
CASES["randint_like"] = C(lambda r, S: ((r.f(*S.ew),), {"low": 2,
                                                        "high": 9}),
                          random="randint_like")
CASES["binomial"] = C(lambda r, S: ((r.i(*S.ew, lo=0, hi=20), r.prob(
    *S.ew)), {}), random="binomial")
CASES["standard_gamma"] = C(lambda r, S: ((2 * r.pos(*S.ew),), {}),
                            random="standard_gamma")

# -- ops.linalg_ext -------------------------------------------------------------
for n in ("addmm", "addmm_op"):
    CASES[n] = C(lambda r, S: ((r.f(S.mm[0], S.mm[2]), r.f(S.mm[0], S.mm[1]),
                                r.f(S.mm[1], S.mm[2])),
                               {"beta": 0.5, "alpha": 2.0}), **_MM)
CASES["cdist"] = C(lambda r, S: ((r.f(2, 5, S.ew[2]), r.f(2, 4, S.ew[2])),
                                 {}), tol=(1e-5, 1e-5),
                   why="a sum of squares over the row in another order")
CASES["cdist_op"] = C(lambda r, S: ((r.f(5, S.ew[2]), r.f(3, S.ew[2])),
                                    {"p": 3.0}), tol=(1e-5, 1e-5),
                      why="a sum of cubes over the row in another order")
CASES["cond_op"] = C(lambda r, S: ((r.wellcond(*S.la),), {"p": "fro"}),
                     **_LA)
for n in ("corrcoef", "corrcoef_op", "cov"):
    CASES[n] = C(lambda r, S: ((r.f(4, S.ew[2]),), {}), tol=(1e-4, 1e-5),
                 why="means and products over the row in another order")
CASES["cov_op"] = C(lambda r, S: ((r.f(S.ew[2], 3),), {
    "rowvar": False, "aweights": r.pos(S.ew[2])}), tol=(1e-4, 1e-5),
    why="weighted means over the rows in another order")
CASES["dist"] = C(lambda r, S: ((r.f(*S.ew), r.f(*S.ew)), {"p": 3.0}),
                  tol=(1e-4, 1e-5), why="a sum over every element in another "
                                        "order")
CASES["dist_op"] = C(lambda r, S: ((r.f(*S.ew), r.f(*S.ew)),
                                   {"p": float("inf")}))
_FACT = dict(half=False, grad=False,
             why="factors are unique only up to the sign or phase of their "
                 "columns: held by reconstructions and spectra, gradients "
                 "by sign-free compositions (test_torch_linalg_ext.py)")
CASES["svd"] = C(lambda r, S: ((r.f(S.la[0], S.la[1], S.la[1] - 1),), {}),
                 compare="svd", tol=(1e-4, 1e-5), **_FACT)
CASES["qr_op"] = C(lambda r, S: ((r.f(S.la[0], S.la[1] + 2, S.la[1]),), {}),
                   compare="qr", tol=(1e-4, 1e-5), **_FACT)
CASES["eig"] = C(lambda r, S: ((r.wellcond(*S.la),), {}), compare="eig",
                 tol=(1e-4, 1e-5), **_FACT)
CASES["eigvals"] = C(lambda r, S: ((r.wellcond(*S.la),), {}),
                     compare="eigvals", tol=(1e-4, 1e-5), **_FACT)
_EIGH = dict(_FACT, why=_FACT["why"] + "; cuSOLVER's float32 syevd at n "
             "256 reconstructs 2e-4 of max |A| away from LAPACK's")
for n in ("eigh", "eigh_op"):
    CASES[n] = C(lambda r, S: ((r.spd(*S.la),), {"UPLO": "U"}),
                 compare="eigh", tol=(1e-3, 1e-5), **_EIGH)
for n in ("eigvalsh", "eigvalsh_op"):
    CASES[n] = C(lambda r, S: ((r.spd(*S.la),), {}), **_LA)
for n in ("histogram", "histogram_op"):
    CASES[n] = C(lambda r, S: ((r.f(*S.ew),), {"bins": 7, "min": -2.0,
                                               "max": 2.0}), half=False)
CASES["histogram_op"] = C(lambda r, S: ((r.f(*S.ew),), {
    "bins": 5, "weight": r.pos(*S.ew), "density": True}), half=False,
    tol=(1e-4, 1e-6), why="weighted counts summed in another order")
CASES["histogramdd"] = C(lambda r, S: ((r.f(S.rows[1], 2),), {
    "bins": [4, 3], "ranges": [[-2.0, 2.0], [-1.5, 1.5]]}), half=False)
for n in ("householder_product", "householder_product_op"):
    CASES[n] = C(lambda r, S: (r.reflectors(S.la[0], S.la[1] + 1,
                                            S.la[1] - 1), {}), **_LA)
for n in ("lstsq", "lstsq_op"):
    CASES[n] = C(lambda r, S: ((r.f(S.la[1] + 3, S.la[1]),
                                r.f(S.la[1] + 3, 2)), {}), **_LA)
for n in ("lu", "lu_op"):
    CASES[n] = C(lambda r, S: ((r.wellcond(*S.la),), {}), **_LA)
CASES["lu_unpack"] = C(lambda r, S: ((r.f(S.la[0], S.la[1], S.la[1]),
                                      np.tile(np.minimum(
                                          np.arange(S.la[1]) + 2, S.la[1]),
                                          (S.la[0], 1)).astype(np.int32)),
                                     {}), **_OFF_TAPE)
CASES["matrix_transpose"] = _u("matrix_transpose")
CASES["mv"] = C(lambda r, S: ((r.f(S.mm[0], S.mm[1]), r.f(S.mm[1])), {}),
                **_MM)
for n in ("ormqr", "ormqr_op"):
    CASES[n] = C(lambda r, S: (r.reflectors(S.la[0], S.la[1], S.la[1] - 1)
                               + (r.f(S.la[0], S.la[1], 3),),
                               {"left": True, "transpose": True}), **_LA)
for n in ("vander", "vander_op"):
    CASES[n] = C(lambda r, S: ((r.unit(S.ew[2]),), {"n": 5,
                                                    "increasing": True}))
CASES["vector_norm_op"] = C(lambda r, S: ((r.f(*S.ew),), {
    "p": 3.0, "axis": (0, 2)}), tol=(1e-5, 1e-5),
    why="a sum of cubes in another order")

# -- ops.fft_ops ----------------------------------------------------------------
_FFT = dict(tol=(1e-4, 1e-4), half=False,
            why="pocketfft / cuFFT and XLA's FFT butterfly in other orders: "
                "float32 roundoff grows with log n of the size of the values")
CASES["fft"] = C(lambda r, S: ((r.f(*S.ew),), {"axis": 1, "norm": "ortho"}),
                 **_FFT)
CASES["ifft"] = C(lambda r, S: ((r.c(*S.ew),), {"n": S.ew[-1] + 2}), **_FFT)
CASES["rfft"] = C(lambda r, S: ((r.f(*S.ew),), {"norm": "forward"}), **_FFT)
CASES["irfft"] = C(lambda r, S: ((r.c(*S.ew),), {"n": 2 * S.ew[-1] - 2}),
                   **_FFT)
CASES["hfft"] = C(lambda r, S: ((r.c(*S.ew),), {"axis": 1}), **_FFT)
CASES["ihfft"] = C(lambda r, S: ((r.f(*S.ew),), {"norm": "ortho"}), **_FFT)
for n in ("fft2", "ifft2", "fftn", "ifftn"):
    CASES[n] = C(lambda r, S: ((r.c(*S.ew),), {"axes": (-2, -1)}), **_FFT)
CASES["fftn"] = C(lambda r, S: ((r.f(*S.ew),), {"axes": (0, 2),
                                                "norm": "ortho"}), **_FFT)
CASES["rfft2"] = C(lambda r, S: ((r.f(*S.ew),), {"axes": (-2, -1)}), **_FFT)
CASES["rfftn"] = C(lambda r, S: ((r.f(*S.ew),), {"s": (S.ew[1], 4),
                                                 "axes": (1, 2)}), **_FFT)
for n in ("irfft2", "irfftn", "hfft2", "hfftn"):
    CASES[n] = C(lambda r, S: ((r.c(*S.ew),), {
        "s": (S.ew[1], 2 * S.ew[2] - 2), "axes": (-2, -1)}), **_FFT)
for n in ("ihfft2", "ihfftn"):
    CASES[n] = C(lambda r, S: ((r.f(*S.ew),), {"axes": (-2, -1),
                                               "norm": "forward"}), **_FFT)
CASES["fftshift"] = C(lambda r, S: ((r.f(*S.ew),), {"axes": (1,)}))
CASES["ifftshift"] = C(lambda r, S: ((r.c(*S.ew),), {"axes": None}),
                       half=False, why="a complex input")
_NFFT = 16
CASES["stft_op"] = C(lambda r, S: ((r.f(S.ew[0], S.ew[1] * 8),
                                    r.pos(_NFFT)), {
    "n_fft": _NFFT, "hop_length": 4, "center": True, "pad_mode": "reflect",
    "normalized": True, "onesided": True}), **_FFT)
CASES["istft_op"] = C(lambda r, S: ((r.c(S.ew[0], _NFFT // 2 + 1,
                                         S.ew[1] * 2 + 1),
                                     r.pos(_NFFT)), {
    "n_fft": _NFFT, "hop_length": 4, "center": True, "normalized": False,
    "onesided": True, "length": None, "return_complex": False}), **_FFT)
# the signal namespace's framing ops (registered by the port at import,
# by the reference at their first call)
CASES["signal_frame"] = C(lambda r, S: ((r.f(S.ew[0], 8 * S.ew[1]),), {
    "frame_length": 16, "hop_length": 8, "axis": -1}))
CASES["signal_overlap_add"] = C(lambda r, S: ((r.f(S.ew[0], 16, S.ew[1]),),
                                              {"hop_length": 8, "axis": -1}))

# the registered ops whose reference call takes a JAX key: the port's
# takes a generator (``generator=``), made by the caller
KEYED = ("dropout_p", "alpha_dropout_p", "gumbel_softmax_p", "rrelu",
         "_sdpa_op")


def case_for(name):
    """The case of a registered op (an in-place ``x_`` takes its base's)."""
    if name in CASES:
        return CASES[name]
    if name.endswith("_") and name[:-1] in CASES:
        return CASES[name[:-1]]
    raise KeyError(name)


def to_tensors(obj, convert):
    """``obj`` with every numpy array (in lists / tuples too) passed
    through ``convert``."""
    if isinstance(obj, np.ndarray):
        return convert(obj)
    if isinstance(obj, tuple):
        return tuple(to_tensors(o, convert) for o in obj)
    if isinstance(obj, list):
        return [to_tensors(o, convert) for o in obj]
    if isinstance(obj, dict):
        return {k: to_tensors(v, convert) for k, v in obj.items()}
    return obj
