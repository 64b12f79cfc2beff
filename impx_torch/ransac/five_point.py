"""Batched Nistér five-point minimal solver for the essential matrix
(impx/ransac/five_point.py).

The steps, on any leading batch shape [..., 5, 2]:

  1. the 4-dim null space {X, Y, Z, W} of the 5x9 epipolar system, by five
     Householder reflections (`_null_basis`), parameterises
     E = x·X + y·Y + z·Z + W;
  2. det(E) = 0 and the trace constraint 2·E·Eᵀ·E − tr(E·Eᵀ)·E = 0 give 10
     cubics in (x, y, z): their 10x20 coefficient matrix is one
     gather-product-matmul over a symbolic table built once on the host
     (`_equation_table`, plain Python and numpy);
  3. a 10x10 elimination by Householder reflections (`_qr_solve_10`) keeps
     the 10 monomials free of x², y², xy; pairing z-shifted rows gives three
     equations x·px(z) + y·py(z) + p1(z) = 0, whose determinant is the
     degree-10 n(z);
  4. real roots of n on the tangent grid z = tan θ (g(θ) = n(tan θ)·cos¹⁰θ,
     512 points), each sign change bisected 28 times: impx's root finder,
     so that the candidate sets and their order match impx's;
  5. (x, y) per root from the 3x2 system by Cramer's rule on its normal
     equations, E from the basis, projected onto the essential manifold
     (`eight_point.project_essential`), and every candidate that misses its
     own five constraints by 1e-2 or more is marked invalid.

Returns up to MAX_ROOTS candidates per problem with a validity mask;
degenerate samples give invalid slots. No step synchronises with the host.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from impx_torch.ransac.eight_point import project_essential

# monomial order: all 20 monomials of total degree <= 3 in (x, y, z).
# LEFT: the 10 containing x², y² or xy (eliminated); RIGHT: the rest.
_LEFT = [(3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1),
         (2, 0, 0), (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0)]
_RIGHT = [(1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
          (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0)]

MAX_ROOTS = 10
GRID = 512
BISECTIONS = 28          # halvings of a pi/(GRID-1) interval: ~2e-11, past fp32
RESIDUAL_MAX = 1e-2      # a candidate's largest epipolar residual on its own sample


# ----------------------------------------------------------------- symbolic table
def _sym_cmul(c1: dict, c2: dict) -> dict:
    """Product of two symbolic coefficients (sorted basis-index tuple -> float)."""
    out: dict = {}
    for t1, v1 in c1.items():
        for t2, v2 in c2.items():
            t = tuple(sorted(t1 + t2))
            out[t] = out.get(t, 0.0) + v1 * v2
    return out


def _sym_cadd(a: dict, b: dict, s: float = 1.0) -> dict:
    out = dict(a)
    for t, v in b.items():
        out[t] = out.get(t, 0.0) + s * v
    return out


def _sym_pmul(p: dict, q: dict) -> dict:
    out: dict = {}
    for m1, c1 in p.items():
        for m2, c2 in q.items():
            m = (m1[0] + m2[0], m1[1] + m2[1], m1[2] + m2[2])
            c = _sym_cmul(c1, c2)
            out[m] = _sym_cadd(out[m], c) if m in out else c
    return out


def _sym_padd(p: dict, q: dict, s: float = 1.0) -> dict:
    out = dict(p)
    for m, c in q.items():
        out[m] = _sym_cadd(out[m], c, s) if m in out else {t: s * v for t, v in c.items()}
    return out


@functools.lru_cache(maxsize=None)
def _equation_table():
    """The symbolic expansion of the 10 cubics, once, as a sparse table over
    the 36 null-basis entries (impx/ransac/five_point.py:168).

    Every coefficient of the 10x20 system is a cubic form in the basis
    entries, so the assembly is terms = B[I1]·B[I2]·B[I3] over the unique
    cubic monomials of the 37-vector [basis(36), 1], then terms @ S.

    Returns (I1, I2, I3 [T] int arrays, S [T, 200] float32: slot = equation
    * 20 + column over _LEFT + _RIGHT)."""
    def lin(i, j):  # E[i][j]: degree 1 in (x, y, z), linear in the basis entries
        return {(1, 0, 0): {(0 + i * 3 + j,): 1.0}, (0, 1, 0): {(9 + i * 3 + j,): 1.0},
                (0, 0, 1): {(18 + i * 3 + j,): 1.0}, (0, 0, 0): {(27 + i * 3 + j,): 1.0}}

    E = [[lin(i, j) for j in range(3)] for i in range(3)]

    def det3(M):
        t0 = _sym_pmul(M[0][0], _sym_padd(_sym_pmul(M[1][1], M[2][2]), _sym_pmul(M[1][2], M[2][1]), -1.0))
        t1 = _sym_pmul(M[0][1], _sym_padd(_sym_pmul(M[1][0], M[2][2]), _sym_pmul(M[1][2], M[2][0]), -1.0))
        t2 = _sym_pmul(M[0][2], _sym_padd(_sym_pmul(M[1][0], M[2][1]), _sym_pmul(M[1][1], M[2][0]), -1.0))
        return _sym_padd(_sym_padd(t0, t1, -1.0), t2)

    EEt = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(3):
            acc: dict = {}
            for k in range(3):
                acc = _sym_padd(acc, _sym_pmul(E[i][k], E[j][k]))
            EEt[i][j] = acc
    trace = _sym_padd(_sym_padd(EEt[0][0], EEt[1][1]), EEt[2][2])

    eqs = [det3(E)]
    for i in range(3):
        for j in range(3):
            acc = {}
            for k in range(3):
                acc = _sym_padd(acc, _sym_pmul(EEt[i][k], E[k][j]))
            eqs.append(_sym_padd({m: {t: 2.0 * v for t, v in c.items()} for m, c in acc.items()},
                                 _sym_pmul(trace, E[i][j]), -1.0))

    cols = _LEFT + _RIGHT
    term_index: dict = {}
    rows = []  # (term id, slot, value)
    for eq_i, eq in enumerate(eqs):
        for ci, m in enumerate(cols):
            for t, v in eq.get(m, {}).items():
                tt = tuple(t) + (36,) * (3 - len(t))  # pad with the 1-symbol
                if tt not in term_index:
                    term_index[tt] = len(term_index)
                rows.append((term_index[tt], eq_i * 20 + ci, v))
    index = np.zeros((3, len(term_index)), np.int64)
    for tt, ti in term_index.items():
        index[:, ti] = tt
    S = np.zeros((len(term_index), 200), np.float32)
    for ti, slot, v in rows:
        S[ti, slot] += v
    return index[0], index[1], index[2], S


@functools.lru_cache(maxsize=None)
def _conv_table(da: int, db: int) -> np.ndarray:
    """[da, db, da + db - 1] 0/1 table: the product of two ascending
    polynomials is einsum('...i,...j,ijk->...k', a, b, table)."""
    t = np.zeros((da, db, da + db - 1), np.float32)
    for i in range(da):
        for j in range(db):
            t[i, j, i + j] = 1.0
    return t


@functools.lru_cache(maxsize=None)
def _constants(device: torch.device, dtype: torch.dtype):
    """The tables as tensors on `device` in `dtype`, once per (device, dtype)."""
    i1, i2, i3, S = _equation_table()
    eps = 1e-3
    thetas = torch.linspace(-math.pi / 2 + eps, math.pi / 2 - eps, GRID, dtype=dtype)
    k = torch.arange(11, dtype=dtype)
    # T[k, i] = sin^k(θᵢ) cos^(10−k)(θᵢ): g(θ) = Σ n_k T[k]
    T = torch.sin(thetas)[None] ** k[:, None] * torch.cos(thetas)[None] ** (10 - k[:, None])
    index = {name: torch.as_tensor(i, device=device) for name, i in (("i1", i1), ("i2", i2), ("i3", i3))}
    tables = {"S": S, "thetas": thetas, "T": T, "k": k, "conv45": _conv_table(4, 5),
              "conv44": _conv_table(4, 4), "conv48": _conv_table(4, 8), "conv57": _conv_table(5, 7)}
    return {**index, **{name: torch.as_tensor(t).to(device, dtype) for name, t in tables.items()}}


# ----------------------------------------------------------------- the solver
def _homogeneous(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def _epipolar_system(x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """[..., 5, 9] rows kron(x1h, x0h) of x1ᵀ E x0 = 0, E flattened row-major."""
    p0, p1 = _homogeneous(x0), _homogeneous(x1)
    return (p1[..., :, :, None] * p0[..., :, None, :]).reshape(*x0.shape[:-2], 5, 9)


def _householder(v: torch.Tensor, rows: torch.Tensor, k: int, floor: float) -> torch.Tensor:
    """The unit Householder vector that zeroes x = v's entries below row k
    (entries above k already masked to 0); a zero column gives 0 (no
    reflection)."""
    nrm = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    sign = torch.where(v[..., k:k + 1] >= 0, 1.0, -1.0)
    u = v + sign * nrm * (rows == k).to(v.dtype)
    un = torch.sqrt(torch.sum(u * u, dim=-1, keepdim=True))
    return torch.where(un > floor, u / torch.clamp(un, min=floor), 0.0)


def _null_basis(x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """Null-space basis [..., 4, 3, 3] (X, Y, Z, W) of the 5x9 epipolar
    system by five Householder reflections of Aᵀ (impx/ransac/five_point.py:92):
    columns 5..8 of Q are an orthonormal basis of null(A). A degenerate
    sample (rank < 5) skips its reflection and scores low later."""
    M = _epipolar_system(x0, x1).mT                          # [..., 9, 5]
    batch = M.shape[:-2]
    Q = torch.eye(9, dtype=M.dtype, device=M.device).expand(*batch, 9, 9)
    rows = torch.arange(9, device=M.device)
    for k in range(5):
        v = _householder(torch.where(rows >= k, M[..., :, k], 0.0), rows, k, 1e-20)
        M = M - 2.0 * v[..., :, None] * (v[..., None, :] @ M)
        Q = Q - 2.0 * (Q @ v[..., :, None]) * v[..., None, :]
    return Q[..., :, 5:9].mT.reshape(*batch, 4, 3, 3)


def _qr_solve_10(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve A X = B for [..., 10, 10] A and B by 10 Householder reflections
    and a triangular solve (impx/ransac/five_point.py:283). No pivoting: a
    singular system gives inf/nan, which the caller masks as a degenerate
    sample."""
    n = 10
    G = torch.cat([A, B], dim=-1)                            # [..., 10, 20]
    rows = torch.arange(n, device=A.device)
    for k in range(n):
        v = _householder(torch.where(rows >= k, G[..., :, k], 0.0), rows, k, 1e-30)
        G = G - 2.0 * v[..., :, None] * (v[..., None, :] @ G)
    return torch.linalg.solve_triangular(G[..., :, :n], G[..., :, n:], upper=True)


def _pconv(a: torch.Tensor, b: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Product of ascending polynomials on trailing coefficient axes."""
    return torch.einsum("...i,...j,ijk->...k", a, b, table)


def _polyval(c: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Horner on ascending coefficients; c [..., D], z [...]."""
    out = c[..., -1]
    for k in range(c.shape[-1] - 2, -1, -1):
        out = out * z + c[..., k]
    return out


def solve_essential_5pt(x0: torch.Tensor, x1: torch.Tensor, dtype: torch.dtype = torch.float32):
    """x0, x1: [..., 5, 2] normalized image points. Returns
    (E [..., MAX_ROOTS, 3, 3], valid [..., MAX_ROOTS] bool); invalid slots
    hold a projection of the identity. dtype: impx's float32; float64 serves
    as a reference for the conditioning of a sample."""
    x0, x1 = x0.to(dtype), x1.to(dtype)
    c = _constants(x0.device, dtype)
    basis = _null_basis(x0, x1)                              # [..., 4, 3, 3]
    batch = basis.shape[:-3]

    # the 10x20 cubic system from the symbolic table
    flat = torch.cat([basis.reshape(*batch, 36), torch.ones(*batch, 1, dtype=dtype, device=x0.device)], dim=-1)
    terms = flat[..., c["i1"]] * flat[..., c["i2"]] * flat[..., c["i3"]]     # [..., T]
    M20 = (terms @ c["S"]).reshape(*batch, 10, 20)
    C = _qr_solve_10(M20[..., :10], M20[..., 10:])
    finite = torch.isfinite(C).all(dim=-1).all(dim=-1)

    def zrow(u, v):
        """row u − z·row v over RIGHT monomials -> (px[4], py[4], p1[5]),
        ascending z-power coefficients of x·px(z) + y·py(z) + p1(z)."""
        px = torch.stack([u[..., 2], u[..., 1] - v[..., 2], u[..., 0] - v[..., 1], -v[..., 0]], dim=-1)
        py = torch.stack([u[..., 5], u[..., 4] - v[..., 5], u[..., 3] - v[..., 4], -v[..., 3]], dim=-1)
        p1 = torch.stack([u[..., 9], u[..., 8] - v[..., 9], u[..., 7] - v[..., 8],
                          u[..., 6] - v[..., 7], -v[..., 6]], dim=-1)
        return px, py, p1

    # z·(x²) − (x²z), z·(y²) − (y²z), z·(xy) − (xyz)
    (px1, py1, p11), (px2, py2, p12), (px3, py3, p13) = (
        zrow(C[..., 4, :], C[..., 5, :]), zrow(C[..., 6, :], C[..., 7, :]), zrow(C[..., 8, :], C[..., 9, :]))
    # det of the 3x3 polynomial matrix: the degree-10 n(z), [..., 11] ascending
    c45, c44 = c["conv45"], c["conv44"]
    n = _pconv(px1, _pconv(py2, p13, c45) - _pconv(py3, p12, c45), c["conv48"])
    n = n - _pconv(py1, _pconv(px2, p13, c45) - _pconv(px3, p12, c45), c["conv48"])
    n = n + _pconv(p11, _pconv(px2, py3, c44) - _pconv(py2, px3, c44), c["conv57"])

    # real roots on the tangent grid: the first MAX_ROOTS sign changes
    thetas = c["thetas"]
    g = n @ c["T"]                                           # [..., GRID]
    crossing = g[..., :-1] * g[..., 1:] < 0
    order = torch.where(crossing, 1.0, -1.0) * 1e6 - torch.arange(GRID - 1, dtype=dtype, device=x0.device)
    slots = torch.topk(order, MAX_ROOTS, dim=-1).indices     # [..., R] interval ids
    has_root = torch.gather(crossing, -1, slots) & finite[..., None]
    lo, hi = thetas[slots], thetas[slots + 1]
    g_lo = torch.gather(g, -1, slots)
    k = c["k"]

    def geval(theta):  # g(θ) = Σ n_k sin^k θ cos^(10−k) θ
        s, co = torch.sin(theta)[..., None], torch.cos(theta)[..., None]
        return torch.sum(n[..., None, :] * s ** k * co ** (10 - k), dim=-1)

    for _ in range(BISECTIONS):
        mid = 0.5 * (lo + hi)
        g_mid = geval(mid)
        left = g_lo * g_mid > 0
        lo, hi, g_lo = torch.where(left, mid, lo), torch.where(left, hi, mid), torch.where(left, g_mid, g_lo)
    z = torch.tan(0.5 * (lo + hi))                           # [..., R]

    # (x, y) per root: Cramer's rule on the regularised 2x2 normal equations
    pv = lambda p: _polyval(p[..., None, :], z)  # noqa: E731
    M = torch.stack([torch.stack([pv(px1), pv(py1)], dim=-1), torch.stack([pv(px2), pv(py2)], dim=-1),
                     torch.stack([pv(px3), pv(py3)], dim=-1)], dim=-2)          # [..., R, 3, 2]
    rhs = -torch.stack([pv(p11), pv(p12), pv(p13)], dim=-1)                    # [..., R, 3]
    MtM = M.mT @ M
    Mtb = (M.mT @ rhs[..., None])[..., 0]
    a, bb = MtM[..., 0, 0] + 1e-12, MtM[..., 0, 1]
    cc, d = MtM[..., 1, 0], MtM[..., 1, 1] + 1e-12
    det = a * d - bb * cc
    e, f = Mtb[..., 0], Mtb[..., 1]
    coef = torch.stack([(d * e - bb * f) / det, (a * f - cc * e) / det, z, torch.ones_like(z)], dim=-1)
    E = torch.einsum("...rk,...kij->...rij", coef, basis)
    E = E / (torch.linalg.matrix_norm(E)[..., None, None] + 1e-12)
    valid = has_root & torch.isfinite(E).all(dim=-1).all(dim=-1)
    E = torch.where(valid[..., None, None], E, torch.eye(3, dtype=dtype, device=x0.device))
    # the essential manifold absorbs the fp32 residue of the root chain
    E = project_essential(E)
    E = E / (torch.linalg.matrix_norm(E)[..., None, None] + 1e-12)
    # every candidate must satisfy the five constraints it was solved from:
    # an ill-conditioned back-substitution can leave a root off by ~1e-1
    resid = torch.einsum("...ni,...rij,...nj->...rn", _homogeneous(x1), E, _homogeneous(x0))
    valid = valid & (resid.abs().amax(dim=-1) < RESIDUAL_MAX)
    return E, valid
