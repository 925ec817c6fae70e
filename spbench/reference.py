"""The plain reference that decides ``correct``, and its lower-precision controls.

Plain numpy and PyTorch only: nothing here imports the program. The
reference takes the run's matrix and right-hand sides from the benchmark and
judges the program's answers by what they say:

* ``residual``: ||b - A x||_2 / ||b||_2 of a refined solution, an fp64
  product of its own (the study's 1e-10 gate, test_pardiso.c:258-275);
* ``backward_errors``: the componentwise backward error of one solve y of
  A y = r with the program's factor (Oettli and Prager), row by row
  |r - A y|_i / (|A| |y| + |r|)_i, its largest and its median row. It holds
  the factorization and its correction solves to the precision they were
  computed in, whatever the matrix's condition (~u times the growth for an
  fp32 factor), and unlike a normwise error it does not change with the
  row and column scalings the program applies, nor fall to nothing where
  y is dominated by a near-null direction (dc1's stand-in, rcond ~1e-16).

Neither needs the program's orderings, matching or scaling, so the reference
derives none of them. The controls are the reference put in the program's
place one precision lower (TF32 products for an fp32 factor with TF32 off):
a blocked band LU without pivoting in the natural order
(:class:`BandLuControl`), and static pivoting done plainly: a maximum-product
matching, Ruiz scaling and a blocked dense LU without pivoting
(:class:`GespDenseControl`), the same class of algorithm as the program's
multifrontal path. They run only in ``spbench.control`` and the tests, never
in a benchmark run.
"""
from __future__ import annotations

import contextlib
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

__all__ = ["PlainCsr", "residual", "backward_errors", "BandLuControl", "GespDenseControl",
           "ControlFactor", "control_factor", "tf32_round"]


class PlainCsr:
    """A CSR matrix for fp64 products on the host."""

    def __init__(self, shape, indptr, indices, data):
        self.n = int(shape[0])
        self.indptr = np.asarray(indptr, np.int64)
        self.indices = np.asarray(indices, np.int64)
        self.data = np.asarray(data, np.float64)
        self.rows = np.repeat(np.arange(self.n, dtype=np.int64), np.diff(self.indptr))

    def matvec(self, x: np.ndarray) -> np.ndarray:
        return np.bincount(self.rows, weights=self.data * x[self.indices], minlength=self.n)


def residual(a: PlainCsr, x: np.ndarray, b: np.ndarray) -> float:
    """||b - A x||_2 / ||b||_2 in fp64; inf for an answer that is not finite."""
    x = np.asarray(x, np.float64)
    if not np.isfinite(x).all():
        return float("inf")
    nb = float(np.linalg.norm(b))
    return float(np.linalg.norm(b - a.matvec(x)) / (nb if nb > 0 else 1.0))


def backward_errors(a: PlainCsr, y: np.ndarray, r: np.ndarray):
    """(largest, median) componentwise backward error of y as a solution of
    A y = r, in fp64; (inf, inf) for an answer that is not finite."""
    y = np.asarray(y, np.float64)
    if not np.isfinite(y).all():
        return float("inf"), float("inf")
    num = np.abs(r - a.matvec(y))
    den = np.bincount(a.rows, weights=np.abs(a.data) * np.abs(y)[a.indices],
                      minlength=a.n) + np.abs(r)
    w = np.divide(num, den, out=np.zeros_like(num), where=den > 0)
    return float(w.max()), float(np.median(w))


# ---------------------------------------------------------------------------
# Controls: the reference one precision below the configuration's
# ---------------------------------------------------------------------------


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to TF32's 10-bit mantissa (nearest, ties away)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def _tf32(device: torch.device):
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = device.type == "cuda"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _mm(x: torch.Tensor, y: torch.Tensor, tf32: bool) -> torch.Tensor:
    """x @ y in TF32 (the card's tensor cores, or the rounding emulated on
    the CPU: inputs to 10 mantissa bits, fp32 sums), or in full fp32."""
    if not tf32:
        return x @ y
    if x.device.type == "cuda":
        with _tf32(x.device):
            return x @ y
    return tf32_round(x) @ tf32_round(y)


def _panel_lu(panel: torch.Tensor, eps: float, tf32: bool, ib: int = 64) -> torch.Tensor:
    """LU without pivoting of an m x b panel (m >= b) with static pivot
    perturbation (PARDISO's rule: a pivot of magnitude <= eps becomes -eps
    if negative, else +eps): rank-1 steps inside blocks of ``ib`` columns,
    a TRSM and a product (TF32 if asked) between them."""
    d = panel.clone()
    b = d.shape[1]
    for j0 in range(0, b, ib):
        j1 = min(b, j0 + ib)
        for k in range(j0, j1):
            piv = d[k, k]
            d[k, k] = torch.where(piv.abs() <= eps, torch.where(piv < 0, -eps, eps), piv)
            d[k + 1:, k] /= d[k, k]
            d[k + 1:, k + 1:j1] -= torch.outer(d[k + 1:, k], d[k, k + 1:j1])
        if j1 < b:
            d[j0:j1, j1:] = torch.linalg.solve_triangular(d[j0:j1, j0:j1], d[j0:j1, j1:],
                                                          upper=False, unitriangular=True)
            d[j1:, j1:] -= _mm(d[j1:, j0:j1], d[j0:j1, j1:], tf32)
    return d


class BandLuControl:
    """Blocked band LU without pivoting, in the natural order, P x P blocks,
    block row r holding A[rP:(r+1)P, (r-ml)P:(r+mu+1)P]; the Schur products
    in TF32, the rest in fp32. Solves in fp32."""

    def __init__(self, a: PlainCsr, device, tf32: bool = True, p: int = 128):
        device = torch.device(device)
        n = a.n
        d = a.indices - a.rows
        self.p, self.n, self.device = p, n, device
        self.ml = ml = max(1, -(-int(max(0, -d.min())) // p))
        self.mu = mu = max(1, -(-int(max(0, d.max())) // p))
        self.nb = nb = -(-n // p)
        w = (ml + mu + 1) * p
        band = torch.zeros(nb * p * w, dtype=torch.float32, device=device)
        pos = (a.rows // p) * p * w + (a.rows % p) * w + (a.indices - (a.rows // p - ml) * p)
        band[torch.from_numpy(pos).to(device)] = torch.from_numpy(a.data).to(device, torch.float32)
        pad = torch.arange(n, nb * p, device=device)
        band[pad * w + ml * p + pad % p] = 1.0
        band = band.view(nb, p, w)
        for r in range(nb):
            row = band[r]
            row[:, ml * p:(ml + 1) * p] = _panel_lu(row[:, ml * p:(ml + 1) * p], 0.0, False, p)
            lu = row[:, ml * p:(ml + 1) * p]
            kmu = min(mu, nb - 1 - r)
            if kmu:
                u = row[:, (ml + 1) * p:(ml + 1 + kmu) * p]
                u.copy_(torch.linalg.solve_triangular(lu, u, upper=False, unitriangular=True))
            for dd in range(1, min(ml, nb - 1 - r) + 1):
                below = band[r + dd]
                c0 = (ml - dd) * p
                x = torch.linalg.solve_triangular(lu, below[:, c0:c0 + p], upper=True,
                                                  left=False)
                below[:, c0:c0 + p] = x
                if kmu:
                    below[:, c0 + p:c0 + p + kmu * p] -= _mm(
                        x, row[:, (ml + 1) * p:(ml + 1 + kmu) * p], tf32)
        self.band = band

    def solve(self, r: torch.Tensor) -> torch.Tensor:
        p, ml, mu, nb, band = self.p, self.ml, self.mu, self.nb, self.band
        y = torch.zeros(nb * p, dtype=torch.float32, device=self.device)
        y[:self.n] = r.to(torch.float32)
        y = y.view(nb, p)
        for r_ in range(nb):                      # L: unit lower, forward
            k = min(ml, r_)
            if k:
                left = band[r_][:, (ml - k) * p:ml * p]
                y[r_] -= left @ y[r_ - k:r_].reshape(-1)
            y[r_] = torch.linalg.solve_triangular(
                band[r_][:, ml * p:(ml + 1) * p], y[r_][:, None], upper=False,
                unitriangular=True)[:, 0]
        for r_ in range(nb - 1, -1, -1):          # U: backward
            k = min(mu, nb - 1 - r_)
            if k:
                right = band[r_][:, (ml + 1) * p:(ml + 1 + k) * p]
                y[r_] -= right @ y[r_ + 1:r_ + 1 + k].reshape(-1)
            y[r_] = torch.linalg.solve_triangular(
                band[r_][:, ml * p:(ml + 1) * p], y[r_][:, None], upper=True)[:, 0]
        return y.reshape(-1)[:self.n]


def max_product_matching(a: PlainCsr) -> np.ndarray:
    """Column matched to each row by a maximum-product perfect matching (the
    criterion of MC64's option 5): minimum total cost log(max_i |a_ij|) -
    log |a_ij| + 1 over the entries, by scipy's LAPJVsp."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import min_weight_full_bipartite_matching
    mag = np.abs(a.data)
    ok = mag > 0
    cmax = np.zeros(a.n)
    np.maximum.at(cmax, a.indices[ok], mag[ok])
    cost = np.log(cmax[a.indices[ok]]) - np.log(mag[ok]) + 1.0
    g = csr_matrix((cost, (a.rows[ok], a.indices[ok])), shape=(a.n, a.n))
    rows, cols = min_weight_full_bipartite_matching(g)
    match = np.empty(a.n, dtype=np.int64)
    match[rows] = cols
    return match


def ruiz_scaling(a: PlainCsr, cperm: np.ndarray, iters: int = 20):
    """Row and column scalings that bring every row's and column's largest
    magnitude of A[:, cperm] near 1 (Ruiz's infinity-norm iteration)."""
    inv = np.empty(a.n, dtype=np.int64)
    inv[cperm] = np.arange(a.n)
    cols = inv[a.indices]                       # column of each entry in A[:, cperm]
    mag = np.abs(a.data)
    dr, dc = np.ones(a.n), np.ones(a.n)
    for _ in range(iters):
        s = mag * dr[a.rows] * dc[cols]
        rmax = np.zeros(a.n)
        np.maximum.at(rmax, a.rows, s)
        dr /= np.sqrt(np.where(rmax > 0, rmax, 1.0))
        s = mag * dr[a.rows] * dc[cols]
        cmax = np.zeros(a.n)
        np.maximum.at(cmax, cols, s)
        dc /= np.sqrt(np.where(cmax > 0, cmax, 1.0))
    return dr, dc, cols


class GespDenseControl:
    """Static pivoting in the plain: a maximum-product matching, Ruiz
    scaling, then a blocked right-looking dense LU without pivoting of
    S = Dr A Q Dc with PARDISO's pivot perturbation (1e-4 max |S|), column-major
    in one buffer: each panel's LU, one TRSM, the trailing update in column
    chunks (no copy of the matrix is made), the products in TF32 (or fp32).
    Solves in fp32 by blocks; A x = b is S w = Dr b, x[Q] = Dc w."""

    def __init__(self, a: PlainCsr, device, tf32: bool = True, nb: int = 512,
                 chunk: int = 8192):
        device = torch.device(device)
        n = a.n
        self.n, self.device, self.block = n, device, 4096
        cperm = max_product_matching(a)
        dr, dc, cols = ruiz_scaling(a, cperm)
        vals = a.data * dr[a.rows] * dc[cols]
        buf = torch.zeros((n, n), dtype=torch.float32, device=device)
        buf[torch.from_numpy(cols).to(device), torch.from_numpy(a.rows).to(device)] = \
            torch.from_numpy(vals).to(device, torch.float32)
        m = buf.t()                                   # m[i, j] = S[i, j], column-major
        del buf
        eps = 1e-4 * max(float(np.abs(vals).max()), 1.0)   # PARDISO's fp32 threshold
        for k in range(0, n, nb):
            b = min(nb, n - k)
            m[k:, k:k + b] = _panel_lu(m[k:, k:k + b], eps, tf32)
            if k + b == n:
                continue
            u12 = torch.linalg.solve_triangular(m[k:k + b, k:k + b], m[k:k + b, k + b:],
                                                upper=False, unitriangular=True)
            m[k:k + b, k + b:] = u12
            l21 = m[k + b:, k:k + b].contiguous()
            for c0 in range(0, n - k - b, chunk):
                c1 = min(n - k - b, c0 + chunk)
                m[k + b:, k + b + c0:k + b + c1] -= _mm(l21, u12[:, c0:c1], tf32)
            del u12, l21
        self.lu = m
        self.cperm = torch.from_numpy(cperm).to(device)
        self.dr = torch.from_numpy(dr).to(device, torch.float32)
        self.dc = torch.from_numpy(dc).to(device, torch.float32)

    def solve(self, r: torch.Tensor) -> torch.Tensor:
        y = _dense_solve(self.lu, r.to(torch.float32) * self.dr, self.block)
        x = torch.empty_like(y)
        x[self.cperm] = self.dc * y
        return x


def _dense_solve(lu: torch.Tensor, y: torch.Tensor, bs: int) -> torch.Tensor:
    """(L U)^-1 y in place by blocks: unit lower L forward, then U backward."""
    n = y.shape[0]
    for i in range(0, n, bs):
        j = min(n, i + bs)
        if i:
            y[i:j] -= lu[i:j, :i] @ y[:i]
        y[i:j] = torch.linalg.solve_triangular(lu[i:j, i:j], y[i:j, None], upper=False,
                                               unitriangular=True)[:, 0]
    for i in range(((n - 1) // bs) * bs, -1, -bs):
        j = min(n, i + bs)
        if j < n:
            y[i:j] -= lu[i:j, j:] @ y[j:]
        y[i:j] = torch.linalg.solve_triangular(lu[i:j, i:j], y[i:j, None], upper=True)[:, 0]
    return y


_CONTROLS = {"band_lu_tf32": BandLuControl, "gesp_dense_tf32": GespDenseControl}


class ControlFactor:
    """A control factorization in the program's place: the attributes and
    the correction solve (``solve_original_device``: fp64 in the original
    coordinates, in and out) that the program's refinement reads."""

    def __init__(self, kind: str, a: PlainCsr, device, tf32: bool = True):
        self.device = torch.device(device)
        self.inner = _CONTROLS[kind](a, self.device, tf32)
        self.policy = SimpleNamespace(name=f"control_{kind}" + ("" if tf32 else "_as_fp32"))
        self.report = SimpleNamespace(t_analyze=0.0, t_factorize=0.0, n_pivot_perturbed=0,
                                      notes=f"control={kind}")

    def solve_original_device(self, r: torch.Tensor) -> torch.Tensor:
        return self.inner.solve(r).to(torch.float64)

    def refactorize_timed(self) -> float:
        return 0.0


def control_factor(kind: Optional[str], a: PlainCsr, device, tf32: bool = True) -> ControlFactor:
    """The configuration's control in the program's place; ``tf32=False``
    gives the same reference at the configuration's own precision, the
    witness that a control's failure is its precision's."""
    if kind not in _CONTROLS:
        raise ValueError(f"unknown control {kind!r}; known: {sorted(_CONTROLS)}")
    return ControlFactor(kind, a, device, tf32)
