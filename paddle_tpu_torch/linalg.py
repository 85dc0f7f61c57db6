"""The ``paddle.linalg`` namespace (port of ``paddle_tpu/linalg.py``: the
reference's 31 names)."""
from .ops.linalg import (cholesky, cholesky_solve, det, inv,  # noqa
                         matrix_exp, matrix_norm, matrix_power, matrix_rank,
                         multi_dot, norm, pinv, slogdet, solve,
                         triangular_solve)
from .ops.linalg_ext import (cond, corrcoef, cov, eig, eigh, eigvals,  # noqa
                             eigvalsh, householder_product, lstsq, lu,
                             lu_unpack, ormqr, pca_lowrank, qr, svd,
                             svd_lowrank, vector_norm)

__all__ = [
    'cholesky', 'norm', 'matrix_norm', 'vector_norm', 'cond', 'cov',
    'corrcoef', 'inv', 'eig', 'eigvals', 'multi_dot', 'matrix_rank', 'svd',
    'qr', 'householder_product', 'pca_lowrank', 'svd_lowrank', 'lu',
    'lu_unpack', 'matrix_exp', 'matrix_power', 'det', 'slogdet', 'eigh',
    'eigvalsh', 'pinv', 'solve', 'cholesky_solve', 'triangular_solve',
    'lstsq', 'ormqr',
]
