"""``paddle.linalg`` (counterpart: paddle_tpu/linalg.py): the linear
algebra subset of the tensor API, with ``inv`` for `inverse`."""
from .ops.linalg import (cholesky, cholesky_solve, cond, det, dist, eig,
                         eigh, eigvalsh, inverse, lstsq, matrix_power,
                         matrix_rank, multi_dot, norm, p_norm, pinv, qr,
                         slogdet, solve, svd, triangular_solve)

inv = inverse

__all__ = [
    "cholesky", "cholesky_solve", "cond", "det", "dist", "eig", "eigh",
    "eigvalsh", "inv", "inverse", "lstsq", "matrix_power", "matrix_rank",
    "multi_dot", "norm", "p_norm", "pinv", "qr", "slogdet", "solve", "svd",
    "triangular_solve",
]
