"""Linear algebra (counterpart: paddle_tpu/ops/linalg.py).

Kept from the JAX package: ``norm`` is the elementwise p-norm over
``axis`` whatever the rank; ``slogdet`` returns ``stack([sign,
logdet])``; ``svd`` returns ``(u, s, v)`` with ``v`` the transpose of
``vh``; ``lstsq`` returns solution, residuals, rank and singular values
computed through an SVD as ``jnp.linalg.lstsq`` does (on CUDA
``torch.linalg.lstsq`` has only the ``gels`` routine, which gives neither
rank nor singular values); ``triangular_solve`` transposes ``x`` first
and then reads the triangle ``upper`` names; ``histogramdd`` raises.
``eig`` runs ``torch.linalg.eig`` on the tensor's device (the JAX package
goes through numpy on the host) and returns complex tensors.
"""
from __future__ import annotations

import torch

__all__ = ["norm", "p_norm", "dist", "cholesky", "inverse", "pinv",
           "matrix_power", "matrix_rank", "det", "slogdet", "svd", "qr",
           "eigh", "eigvalsh", "eig", "lstsq", "solve", "triangular_solve",
           "cholesky_solve", "cross", "bilinear_tensor_product",
           "histogramdd", "cond", "multi_dot"]


def norm(x, p="fro", axis=None, keepdim=False, name=None):
    if p == "fro" and axis is None:
        return torch.sqrt(torch.sum(x * x))
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis
    if ax is None:
        ax = tuple(range(x.dim()))
    if p == "fro":
        return torch.sqrt(torch.sum(x * x, dim=ax, keepdim=keepdim))
    if p == float("inf"):
        return torch.amax(torch.abs(x), dim=ax, keepdim=keepdim)
    if p == float("-inf"):
        return torch.amin(torch.abs(x), dim=ax, keepdim=keepdim)
    if p == 0:
        return torch.sum((x != 0).to(x.dtype), dim=ax, keepdim=keepdim)
    return torch.sum(torch.abs(x) ** p, dim=ax, keepdim=keepdim) ** (1.0 / p)


def p_norm(x, p=2, axis=-1, keepdim=False, name=None):
    return norm(x, p, axis, keepdim)


def dist(x, y, p=2, name=None):
    return norm(x - y, p)


def cholesky(x, upper=False, name=None):
    low = torch.linalg.cholesky(x)
    return low.transpose(-1, -2) if upper else low


def inverse(x, name=None):
    return torch.linalg.inv(x)


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return torch.linalg.pinv(x, rtol=rcond, hermitian=hermitian)


def matrix_power(x, n, name=None):
    return torch.linalg.matrix_power(x, n)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    """The count of singular values above ``tol`` (default: the largest
    times max(M, N) times the dtype's eps), as ``jnp.linalg.matrix_rank``."""
    if x.dim() < 2:
        return (x != 0).any().long()
    s = torch.linalg.svdvals(x)
    if tol is None:
        tol = s.amax(-1) * max(x.shape[-2:]) * torch.finfo(s.dtype).eps
    tol = torch.as_tensor(tol, dtype=s.dtype, device=s.device)
    return (s > tol.unsqueeze(-1)).sum(-1)


def det(x, name=None):
    return torch.linalg.det(x)


def slogdet(x, name=None):
    sign, logdet = torch.linalg.slogdet(x)
    return torch.stack([sign, logdet])


def svd(x, full_matrices=False, name=None):
    u, s, vh = torch.linalg.svd(x, full_matrices=full_matrices)
    return u, s, vh.transpose(-1, -2)


def qr(x, mode="reduced", name=None):
    return tuple(torch.linalg.qr(x, mode=mode))


def eigh(x, UPLO="L", name=None):
    return tuple(torch.linalg.eigh(x, UPLO=UPLO))


def eigvalsh(x, UPLO="L", name=None):
    return torch.linalg.eigvalsh(x, UPLO=UPLO)


def eig(x, name=None):
    return tuple(torch.linalg.eig(x))


def lstsq(x, y, rcond=None, driver=None, name=None):
    """``jnp.linalg.lstsq``: the minimum-norm solution through an SVD,
    the residuals ``|y - x @ sol|^2`` a column, the rank (singular
    values above ``rcond`` times the largest; default eps times max(M,
    N)) and the singular values.  ``driver`` is taken and not read."""
    b = y.unsqueeze(-1) if y.dim() == 1 else y
    m, n = x.shape
    if rcond is None:
        rcond = torch.finfo(x.dtype).eps * max(n, m)
    elif rcond < 0:
        rcond = torch.finfo(x.dtype).eps
    u, s, vh = torch.linalg.svd(x, full_matrices=False)
    mask = (s > 0) & (s >= rcond * s[0])
    rank = mask.sum()
    s_inv = torch.where(mask, 1 / torch.where(mask, s, 1), 0).unsqueeze(-1)
    sol = vh.mH @ (s_inv * (u.mH @ b))
    resid = torch.linalg.vector_norm(b - x @ sol, dim=0) ** 2
    if y.dim() == 1:
        sol = sol.reshape(-1)
    return sol, resid, rank, s


def solve(x, y, name=None):
    return torch.linalg.solve(x, y)


def _as_matrix(b, fn):
    """``fn`` of ``b`` as a column when ``b`` is a vector."""
    if b.dim() == 1:
        return fn(b.unsqueeze(-1)).squeeze(-1)
    return fn(b)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    a = x.transpose(-1, -2) if transpose else x
    return _as_matrix(y, lambda b: torch.linalg.solve_triangular(
        a, b, upper=upper, unitriangular=unitriangular))


def cholesky_solve(x, y, upper=False, name=None):
    """The solution of ``A z = x`` for ``A`` given by its Cholesky factor
    ``y``, of which only the named triangle is read (and differentiated,
    as JAX's ``cho_solve``)."""
    factor = y.triu() if upper else y.tril()
    return _as_matrix(x, lambda b: torch.cholesky_solve(b, factor,
                                                        upper=upper))


def cross(x, y, axis=9, name=None):
    ax = axis
    if ax == 9:
        ax = next((i for i, s in enumerate(x.shape) if s == 3), -1)
    return torch.linalg.cross(x, y, dim=ax)


def bilinear_tensor_product(x, y, weight, bias=None, name=None):
    out = torch.einsum("bi,oij,bj->bo", x, weight, y)
    return out if bias is None else out + bias


def histogramdd(*args, **kwargs):
    raise NotImplementedError


def cond(x, p=None, name=None):
    """The condition number: by singular values for ``p`` None, 2, -2 or
    "fro", else ``norm(x) * norm(inv(x))`` in the matrix norm ``p``."""
    if p is None or p == 2 or p == "fro":
        s = torch.linalg.svdvals(x)
        if p == "fro":
            return torch.sqrt(torch.sum(s * s, -1)) * torch.sqrt(
                torch.sum((1.0 / s) ** 2, -1))
        return s[..., 0] / s[..., -1]
    if p == -2:
        s = torch.linalg.svdvals(x)
        return s[..., -1] / s[..., 0]
    return torch.linalg.matrix_norm(x, ord=p) * torch.linalg.matrix_norm(
        torch.linalg.inv(x), ord=p)


def multi_dot(x, name=None):
    out = x[0]
    for a in x[1:]:
        out = torch.matmul(out, a)
    return out
