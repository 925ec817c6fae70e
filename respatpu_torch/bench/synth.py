"""Deterministic synthetic sparse matrix generators (a copy of
``respatpu.bench.synth``, numpy only: the same seed gives the same matrix).

The reference's corpus is 36 SuiteSparse matrices fetched over the network
(matrices/moderate/getModerateSizeMatrices.sh, README.md:110-155). In
network-less environments the bench registry substitutes structurally similar
synthetic matrices (FEM-like Laplacians, banded, and power-law/circuit-like
patterns) matched to each corpus entry's n/nnz scale; real ``.mtx`` files are
used whenever present on disk.

``from_row_lengths`` and ``row_block_edges`` are the port's own: shapes at
the edges of the CSR kernel's row blocks, for its checks on the card.
"""
from __future__ import annotations

import numpy as np

from ..formats import COOMatrix, CSRMatrix, coo_to_csr

__all__ = ["laplacian_3d", "laplacian_2d", "random_banded", "powerlaw",
           "mesh_fem_3d", "circuit_like", "make_spd_like", "synth_like",
           "from_row_lengths", "row_block_edges"]


def laplacian_2d(nx: int, ny: int, dtype=np.float64) -> CSRMatrix:
    """5-point 2D Laplacian, SPD, n = nx*ny, nnz ~ 5n."""
    n = nx * ny
    idx = np.arange(n)
    ix, iy = idx % nx, idx // nx
    rows, cols, vals = [idx], [idx], [np.full(n, 4.0)]
    for di, dj, cond in ((1, 0, ix < nx - 1), (-1, 0, ix > 0),
                         (0, 1, iy < ny - 1), (0, -1, iy > 0)):
        m = cond
        rows.append(idx[m])
        cols.append(idx[m] + di + dj * nx)
        vals.append(np.full(m.sum(), -1.0))
    coo = COOMatrix((n, n), np.concatenate(rows).astype(np.int32),
                    np.concatenate(cols).astype(np.int32),
                    np.concatenate(vals).astype(dtype))
    return coo_to_csr(coo)


def laplacian_3d(nx: int, ny: int, nz: int, dtype=np.float64) -> CSRMatrix:
    """7-point 3D Laplacian, SPD, n = nx*ny*nz, nnz ~ 7n (FEM-matrix stand-in)."""
    n = nx * ny * nz
    idx = np.arange(n)
    ix = idx % nx
    iy = (idx // nx) % ny
    iz = idx // (nx * ny)
    rows, cols, vals = [idx], [idx], [np.full(n, 6.0)]
    for step, coord, lim in ((1, ix, nx), (nx, iy, ny), (nx * ny, iz, nz)):
        up = coord < lim - 1
        dn = coord > 0
        rows += [idx[up], idx[dn]]
        cols += [idx[up] + step, idx[dn] - step]
        vals += [np.full(up.sum(), -1.0), np.full(dn.sum(), -1.0)]
    coo = COOMatrix((n, n), np.concatenate(rows).astype(np.int32),
                    np.concatenate(cols).astype(np.int32),
                    np.concatenate(vals).astype(dtype))
    return coo_to_csr(coo)


def random_banded(n: int, bandwidth: int, nnz_per_row: int, seed: int = 0,
                  diag_dominant: bool = True) -> CSRMatrix:
    """Unsymmetric banded random matrix with ~nnz_per_row entries per row."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), nnz_per_row)
    offs = rng.integers(-bandwidth, bandwidth + 1, size=rows.shape[0])
    cols = np.clip(rows + offs, 0, n - 1)
    vals = rng.standard_normal(rows.shape[0])
    coo = COOMatrix((n, n), rows.astype(np.int32), cols.astype(np.int32), vals)
    a = coo_to_csr(coo)  # dedups; nnz/row slightly below target
    if diag_dominant:
        a = _add_dominant_diag(a)
    return a


def powerlaw(n: int, avg_nnz_per_row: int, alpha: float = 1.8, seed: int = 0,
             diag_dominant: bool = True) -> CSRMatrix:
    """Circuit-like pattern: power-law row lengths, scattered columns."""
    rng = np.random.default_rng(seed)
    raw = rng.pareto(alpha, size=n) + 1.0
    lens = np.maximum(1, (raw / raw.mean() * avg_nnz_per_row)).astype(np.int64)
    lens = np.minimum(lens, n)
    rows = np.repeat(np.arange(n), lens)
    cols = rng.integers(0, n, size=rows.shape[0])
    vals = rng.standard_normal(rows.shape[0])
    coo = COOMatrix((n, n), rows.astype(np.int32), cols.astype(np.int32), vals)
    a = coo_to_csr(coo)
    if diag_dominant:
        a = _add_dominant_diag(a)
    return a


def mesh_fem_3d(n: int, avg_degree: float = 16.0, seed: int = 0,
                jitter: int = 16, spd: bool = True) -> CSRMatrix:
    """Irregular 3-D mesh matrix: the honest FEM stand-in.

    The corpus "fem" entries (2cubes_sphere, cfd2, offshore, ...) are
    assembled on unstructured tetrahedral meshes: locally clustered columns,
    NO constant diagonals (a pure stencil stand-in is unrealistically easy —
    the DIA fast path handles it — while uniform-random-in-band is
    unrealistically hard). This generator reproduces the real structure:
    nodes on a 3-D grid, 26-neighbour candidate edges kept with probability
    q = (avg_degree-1)/26 (degree variance like a tet mesh), and a
    locality-preserving *jittered relabelling* (sort by index + U(0,jitter))
    that breaks the constant grid offsets exactly the way irregular node
    numbering does, while keeping RCM-like bandwidth ~ nx*ny.
    """
    rng = np.random.default_rng(seed)
    nx = max(2, round(n ** (1.0 / 3.0)))
    ny = nx
    nz = max(2, -(-n // (nx * ny)))
    n = nx * ny * nz
    idx = np.arange(n, dtype=np.int64)
    ix, iy, iz = idx % nx, (idx // nx) % ny, idx // (nx * ny)
    q = min(1.0, max(0.05, (avg_degree - 1.0) / 26.0))
    # 13 canonical half-space directions (symmetrized below)
    dirs = [(dx, dy, dz)
            for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
            if (dz, dy, dx) > (0, 0, 0)]
    # locality-preserving relabel: new label = rank of (idx + jitter)
    relabel = np.argsort(np.argsort(idx + rng.uniform(0, max(jitter, 1), n)))
    rows, cols, vals = [idx], [idx], [np.zeros(n)]  # diagonal placeholder
    for dx, dy, dz in dirs:
        ok = ((ix + dx >= 0) & (ix + dx < nx) & (iy + dy >= 0) &
              (iy + dy < ny) & (iz + dz >= 0) & (iz + dz < nz))
        ok &= rng.random(n) < q
        src = idx[ok]
        dst = src + dx + dy * nx + dz * nx * ny
        v = -np.abs(rng.standard_normal(src.size)) - 0.05
        rows += [src, dst]
        cols += [dst, src]
        if spd:
            vals += [v, v]
        else:
            vals += [v, v * (1.0 + 0.3 * rng.standard_normal(src.size))]
    r = relabel[np.concatenate(rows)]
    c = relabel[np.concatenate(cols)]
    coo = COOMatrix((n, n), r.astype(np.int32), c.astype(np.int32),
                    np.concatenate(vals))
    return _add_dominant_diag(coo_to_csr(coo))


def circuit_like(n: int, avg_nnz_per_row: int, seed: int = 0,
                 locality: float = 64.0, hub_fraction: float = 5e-4,
                 hub_degree: int = 512,
                 diag: str = "weak") -> CSRMatrix:
    """Circuit-matrix stand-in with realistic locality.

    Real circuit matrices (dc1, ASIC_320ks) are netlists: power-law degree,
    columns mostly *near* the row (components connect locally) plus a few
    hub nets (power/ground/clock) touching everything. Uniform-random
    columns (the old powerlaw generator) misrepresent them as having zero
    locality. Column distance from the diagonal ~ geometric(1/locality);
    ``hub_fraction`` of rows become dense hubs.

    ``diag``: "weak" (default, round-5) stores a diagonal that is NOT
    dominant — magnitudes 5–50 % of the row max, with ~1 % of rows given a
    near-zero diagonal — so GESP weighted matching and static pivot
    perturbation are actually load-bearing, like on the real matrices the
    reference factors (test_pardiso.c:141,144-148).  "dominant" keeps the
    old easy-mode diagonal for well-posedness-only tests.
    """
    rng = np.random.default_rng(seed)
    raw = rng.pareto(1.8, size=n) + 1.0
    # >= 2 off-diagonal entries per row: a row holding ONLY its (weak)
    # diagonal is numerically singular — downscaled stand-ins (nnz budget
    # below 1/row) hit exactly that degenerate case
    lens = np.maximum(2, (raw / raw.mean() * avg_nnz_per_row)).astype(np.int64)
    lens = np.minimum(lens, n)
    rows = np.repeat(np.arange(n), lens)
    dist = rng.geometric(1.0 / max(locality, 1.0), size=rows.size)
    sign = rng.choice((-1, 1), size=rows.size)
    cols = np.clip(rows + sign * dist, 0, n - 1)
    vals = rng.standard_normal(rows.size)
    nhub = max(1, int(n * hub_fraction))
    hubs = rng.choice(n, size=nhub, replace=False)
    hub_degree = min(hub_degree, max(8, n // 16))  # tiny stand-ins
    hrows = np.repeat(hubs, hub_degree)
    hcols = rng.integers(0, n, size=hrows.size)
    coo = COOMatrix((n, n),
                    np.concatenate([rows, hrows, hcols]).astype(np.int32),
                    np.concatenate([cols, hcols, hrows]).astype(np.int32),
                    np.concatenate([vals, np.ones(2 * hrows.size) * 0.01]))
    a = coo_to_csr(coo)
    if diag == "dominant":
        return _add_dominant_diag(a)
    # weak diagonal: magnitude 5-50 % of the row max, random sign, ~1 % of
    # rows near-zero (forces perturbation / off-diagonal matching)
    coo = a.tocoo()
    rmax = np.zeros(a.nrows)
    np.maximum.at(rmax, coo.row, np.abs(coo.val))
    rmax = np.where(rmax > 0, rmax, 1.0)
    mag = (0.05 + 0.45 * rng.random(a.nrows)) * rmax
    # near-zero diagonals (forces off-diagonal matching) only on rows with
    # enough off-diagonal support to stay nonsingular
    deg = a.row_lengths()
    tiny = (rng.random(a.nrows) < 0.01) & (deg >= 3)
    mag = np.where(tiny, 1e-10 * rmax, mag)
    d = np.arange(a.nrows, dtype=np.int32)
    coo2 = COOMatrix(a.shape,
                     np.concatenate([coo.row, d]),
                     np.concatenate([coo.col, d]),
                     np.concatenate([coo.val,
                                     mag * rng.choice((-1.0, 1.0), a.nrows)]))
    return coo_to_csr(coo2)


def _add_dominant_diag(a: CSRMatrix) -> CSRMatrix:
    """Ensure a nonzero, dominant diagonal (keeps LU/ILU well-posed)."""
    coo = a.tocoo()
    rowsum = np.zeros(a.nrows)
    np.add.at(rowsum, coo.row, np.abs(coo.val))
    d = np.arange(a.nrows, dtype=np.int32)
    coo2 = COOMatrix(a.shape,
                     np.concatenate([coo.row, d]),
                     np.concatenate([coo.col, d]),
                     np.concatenate([coo.val, rowsum + 1.0]))
    return coo_to_csr(coo2)


def make_spd_like(a: CSRMatrix) -> CSRMatrix:
    """Symmetrize A into (A + A^T)/2 plus dominant diagonal."""
    at = a.transpose()
    coo, coot = a.tocoo(), at.tocoo()
    coo2 = COOMatrix(a.shape,
                     np.concatenate([coo.row, coot.row]),
                     np.concatenate([coo.col, coot.col]),
                     np.concatenate([coo.val, coot.val]) * 0.5)
    return _add_dominant_diag(coo_to_csr(coo2))


def synth_like(name: str, n: int, nnz: int, kind: str, seed: int = 0) -> CSRMatrix:
    """Create a synthetic stand-in for a named corpus matrix.

    The *nnz* budget is authoritative (it drives memory/time); stencil
    generators are sized from it (7 nnz/row for the 3-D, 5 for the 2-D
    stencil), so ``max_synth_nnz`` caps are actually honored.
    """
    per_row = max(1, round(nnz / max(n, 1)))
    if kind == "fem":
        # irregular-mesh stand-in sized by the nnz budget (deg*n = nnz)
        nn = max(64, round(nnz / max(per_row, 2)))
        return mesh_fem_3d(nn, avg_degree=float(per_row), seed=seed)
    if kind == "grid2d":
        side = max(2, round((nnz / 5.0) ** 0.5))
        return laplacian_2d(side, side)
    if kind == "circuit":
        return circuit_like(n, per_row, seed=seed)
    return random_banded(n, max(per_row * 8, 16), per_row, seed=seed)


def from_row_lengths(lens, n: int, seed: int = 0) -> CSRMatrix:
    """A matrix with the given row lengths, distinct sorted random columns
    in each row and values in [0.5, 1.5). The values are positive so that,
    with an x of positive mean, |y| of a long row grows with its length and
    the rounding of two summation orders stays small beside it."""
    rng = np.random.default_rng(seed)
    lens = np.asarray(lens, np.int64)
    indptr = np.concatenate([[0], np.cumsum(lens)])
    cols = np.concatenate([np.zeros(0, np.int64)]
                          + [np.sort(rng.choice(n, k, replace=False)) for k in lens])
    return CSRMatrix((lens.size, n), indptr, cols.astype(np.int32),
                     rng.uniform(0.5, 1.5, int(indptr[-1])))


def row_block_edges(cap: int, max_rows: int, n: int = 6000, seed: int = 77) -> dict:
    """Named matrices at the edges of a partition of the rows into blocks of
    at most ``cap`` entries and ``max_rows`` rows
    (``respatpu_torch.kernels.spmv.row_blocks``)."""
    rng = np.random.default_rng(seed)

    def short(k):
        return rng.integers(1, 12, k)

    lens = {
        # streamed alone at the capacity; one entry more takes the long-row path
        "row_cap_and_cap+1": np.concatenate([short(40), [cap], short(300), [cap + 1], short(25)]),
        "empty_run": np.concatenate([short(90), np.zeros(3 * max_rows + 7, np.int64), short(90)]),
        "one_row": [37],
        "one_row_wide": [700],
        "rows_no_entries": np.zeros(1000, np.int64),
        "short_last_block": np.full(3 * max_rows + 1, 8),
        # rows of 40-600 among short ones: too long for the one lane a short row gets
        "wide_among_short": np.where(np.arange(5000) % 61 == 0, rng.integers(40, 600, 5000),
                                     rng.integers(0, 9, 5000)),
    }
    return {name: from_row_lengths(v, n, seed=i) for i, (name, v) in enumerate(lens.items())}
