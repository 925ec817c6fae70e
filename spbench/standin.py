"""Frozen copy of the corpus stand-ins the benchmark runs on.

A copy of ``respatpu_torch.bench.synth`` (the generators the corpus uses),
``respatpu_torch.bench.corpus._seed`` and ``respatpu_torch.formats.coo_to_csr``,
numpy only. The program's copies may change; this one does not, so a
configuration names the same pattern in every later check. A stand-in is a
synthetic matrix of its class, sized after the corpus entry whose name it
takes: not that SuiteSparse matrix, whose pattern and conditioning differ. The pattern is
fixed by the corpus name; :func:`seeded_values` then scales the values from the
run's seed (D A D for a symmetric class, D1 A D2 otherwise, factors in
[0.5, 2]), which keeps the pattern, and so the work, the same from seed to seed.
"""
from __future__ import annotations

import hashlib
from typing import NamedTuple, Tuple

import numpy as np

__all__ = ["Csr", "standin", "seeded_values", "build_matrix", "name_seed", "rhs",
           "Images", "stream_seed"]


class Csr(NamedTuple):
    """Host CSR: int64 row pointer, int32 sorted columns, float64 values."""

    shape: Tuple[int, int]
    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray

    @property
    def n(self) -> int:
        return self.shape[0]

    @property
    def nnz(self) -> int:
        return int(self.data.size)

    def rows(self) -> np.ndarray:
        return np.repeat(np.arange(self.shape[0], dtype=np.int64), np.diff(self.indptr))


def name_seed(name: str) -> int:
    """The pattern's seed: the first 4 bytes of the name's SHA-256."""
    return int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "little") % (2 ** 31)


def _coo_to_csr(shape, row, col, val, sum_duplicates: bool = True) -> Csr:
    m, n = shape
    key = row.astype(np.int64) * n + col.astype(np.int64)
    order = np.argsort(key, kind="stable")
    row, col, val = row[order], col[order], val[order]
    if sum_duplicates and len(key) > 0:
        k = key[order]
        uniq = np.empty(len(k), dtype=bool)
        uniq[0] = True
        np.not_equal(k[1:], k[:-1], out=uniq[1:])
        seg = np.cumsum(uniq) - 1
        val = np.bincount(seg, weights=val, minlength=seg[-1] + 1)
        row, col = row[uniq], col[uniq]
    indptr = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(np.bincount(row, minlength=m), out=indptr[1:])
    return Csr((m, n), indptr, np.ascontiguousarray(col, dtype=np.int32),
               np.ascontiguousarray(val, dtype=np.float64))


def _add_dominant_diag(a: Csr) -> Csr:
    row = a.rows().astype(np.int32)
    rowsum = np.zeros(a.n)
    np.add.at(rowsum, row, np.abs(a.data))
    d = np.arange(a.n, dtype=np.int32)
    return _coo_to_csr(a.shape, np.concatenate([row, d]), np.concatenate([a.indices, d]),
                       np.concatenate([a.data, rowsum + 1.0]))


def laplacian_2d(nx: int, ny: int) -> Csr:
    n = nx * ny
    idx = np.arange(n)
    ix, iy = idx % nx, idx // nx
    rows, cols, vals = [idx], [idx], [np.full(n, 4.0)]
    for di, dj, cond in ((1, 0, ix < nx - 1), (-1, 0, ix > 0),
                         (0, 1, iy < ny - 1), (0, -1, iy > 0)):
        rows.append(idx[cond])
        cols.append(idx[cond] + di + dj * nx)
        vals.append(np.full(cond.sum(), -1.0))
    return _coo_to_csr((n, n), np.concatenate(rows).astype(np.int32),
                       np.concatenate(cols).astype(np.int32), np.concatenate(vals))


def random_banded(n: int, bandwidth: int, nnz_per_row: int, seed: int = 0) -> Csr:
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), nnz_per_row)
    offs = rng.integers(-bandwidth, bandwidth + 1, size=rows.shape[0])
    cols = np.clip(rows + offs, 0, n - 1)
    vals = rng.standard_normal(rows.shape[0])
    return _add_dominant_diag(_coo_to_csr((n, n), rows.astype(np.int32),
                                          cols.astype(np.int32), vals))


def mesh_fem_3d(n: int, avg_degree: float = 16.0, seed: int = 0, jitter: int = 16) -> Csr:
    """Irregular 3-D mesh matrix (SPD): 26-neighbour candidate edges kept with
    probability (avg_degree - 1) / 26, a locality-preserving jittered
    relabelling, a dominant diagonal."""
    rng = np.random.default_rng(seed)
    nx = max(2, round(n ** (1.0 / 3.0)))
    ny = nx
    nz = max(2, -(-n // (nx * ny)))
    n = nx * ny * nz
    idx = np.arange(n, dtype=np.int64)
    ix, iy, iz = idx % nx, (idx // nx) % ny, idx // (nx * ny)
    q = min(1.0, max(0.05, (avg_degree - 1.0) / 26.0))
    dirs = [(dx, dy, dz)
            for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
            if (dz, dy, dx) > (0, 0, 0)]
    relabel = np.argsort(np.argsort(idx + rng.uniform(0, max(jitter, 1), n)))
    rows, cols, vals = [idx], [idx], [np.zeros(n)]
    for dx, dy, dz in dirs:
        ok = ((ix + dx >= 0) & (ix + dx < nx) & (iy + dy >= 0) &
              (iy + dy < ny) & (iz + dz >= 0) & (iz + dz < nz))
        ok &= rng.random(n) < q
        src = idx[ok]
        dst = src + dx + dy * nx + dz * nx * ny
        v = -np.abs(rng.standard_normal(src.size)) - 0.05
        rows += [src, dst]
        cols += [dst, src]
        vals += [v, v]
    r = relabel[np.concatenate(rows)]
    c = relabel[np.concatenate(cols)]
    return _add_dominant_diag(_coo_to_csr((n, n), r.astype(np.int32), c.astype(np.int32),
                                          np.concatenate(vals)))


def circuit_like(n: int, avg_nnz_per_row: int, seed: int = 0, locality: float = 64.0,
                 hub_fraction: float = 5e-4, hub_degree: int = 512) -> Csr:
    """Circuit-matrix stand-in: power-law row lengths, columns near the
    diagonal (geometric distance), a few dense hub nets, and a weak diagonal
    (5-50 % of the row maximum, ~1 % of rows near zero), so that weighted
    matching and static pivot perturbation carry load."""
    rng = np.random.default_rng(seed)
    raw = rng.pareto(1.8, size=n) + 1.0
    lens = np.maximum(2, (raw / raw.mean() * avg_nnz_per_row)).astype(np.int64)
    lens = np.minimum(lens, n)
    rows = np.repeat(np.arange(n), lens)
    dist = rng.geometric(1.0 / max(locality, 1.0), size=rows.size)
    sign = rng.choice((-1, 1), size=rows.size)
    cols = np.clip(rows + sign * dist, 0, n - 1)
    vals = rng.standard_normal(rows.size)
    nhub = max(1, int(n * hub_fraction))
    hubs = rng.choice(n, size=nhub, replace=False)
    hub_degree = min(hub_degree, max(8, n // 16))
    hrows = np.repeat(hubs, hub_degree)
    hcols = rng.integers(0, n, size=hrows.size)
    a = _coo_to_csr((n, n), np.concatenate([rows, hrows, hcols]).astype(np.int32),
                    np.concatenate([cols, hcols, hrows]).astype(np.int32),
                    np.concatenate([vals, np.ones(2 * hrows.size) * 0.01]))
    row = a.rows().astype(np.int32)
    rmax = np.zeros(a.n)
    np.maximum.at(rmax, row, np.abs(a.data))
    rmax = np.where(rmax > 0, rmax, 1.0)
    mag = (0.05 + 0.45 * rng.random(a.n)) * rmax
    deg = np.diff(a.indptr)
    tiny = (rng.random(a.n) < 0.01) & (deg >= 3)
    mag = np.where(tiny, 1e-10 * rmax, mag)
    d = np.arange(a.n, dtype=np.int32)
    return _coo_to_csr(a.shape, np.concatenate([row, d]), np.concatenate([a.indices, d]),
                       np.concatenate([a.data, mag * rng.choice((-1.0, 1.0), a.n)]))


def standin(name: str, n: int, nnz: int, kind: str) -> Csr:
    """The corpus stand-in of ``name`` (``corpus.load_matrix`` without a
    file on disk and without an nnz cap): pattern and base values from the
    name alone."""
    seed = name_seed(name)
    per_row = max(1, round(nnz / max(n, 1)))
    if kind == "fem":
        return mesh_fem_3d(max(64, round(nnz / max(per_row, 2))), avg_degree=float(per_row),
                           seed=seed)
    if kind == "grid2d":
        side = max(2, round((nnz / 5.0) ** 0.5))
        return laplacian_2d(side, side)
    if kind == "circuit":
        return circuit_like(n, per_row, seed=seed)
    return random_banded(n, max(per_row * 8, 16), per_row, seed=seed)


def seed_words(seed: int) -> int:
    return int(seed) % (2 ** 64)


def seeded_values(a: Csr, seed: int, symmetric: bool) -> Csr:
    """``a`` with its values scaled from ``seed``: D A D when ``symmetric``
    (keeps symmetry and definiteness), else D1 A D2; every factor drawn
    log-uniform in [0.5, 2]."""
    rng = np.random.default_rng([seed_words(seed), 0])
    d1 = np.exp2(rng.uniform(-1.0, 1.0, a.n))
    d2 = d1 if symmetric else np.exp2(rng.uniform(-1.0, 1.0, a.n))
    data = a.data * (d1[a.rows()] * d2[a.indices])
    return Csr(a.shape, a.indptr, a.indices, data)


def build_matrix(spec: dict, seed: int) -> Csr:
    """The run's matrix from a configuration's ``matrix`` section: the
    stand-in that the generator makes for ``target_n`` rows and
    ``target_nnz`` nonzeros, its values scaled from ``seed`` unless
    ``scale_values`` is false (then every seed runs the same matrix). Where the
    section states the built ``n`` and ``nnz``, the stand-in has to have them."""
    base = standin(spec["name"], int(spec["target_n"]), int(spec["target_nnz"]), spec["kind"])
    if "n" in spec and (base.n, base.nnz) != (int(spec["n"]), int(spec["nnz"])):
        raise ValueError(f"{spec['name']}: the stand-in has {base.n} rows and {base.nnz} "
                         f"nonzeros; the configuration states {spec['n']} and {spec['nnz']}")
    if not spec.get("scale_values", True):
        return base
    return seeded_values(base, seed, bool(spec["symmetric"]))


def stream_seed(seed: int, *words: int) -> int:
    """A 63-bit seed for one stream of the run's seed (for ``torch.Generator``)."""
    state = np.random.SeedSequence([seed_words(seed), *words]).generate_state(1, np.uint64)
    return int(state[0]) >> 1


def rhs(n: int, seed: int, stream: int, index: int) -> np.ndarray:
    """A standard normal vector from the run's seed: ``stream`` 3 for the
    factor probes."""
    return np.random.default_rng([seed_words(seed), stream, index]).standard_normal(n)


class Images:
    """Right-hand sides b = A x, x standard normal, made on ``device`` from
    the run's seed: chunk ``c`` of ``stream`` holds ``k`` of them, drawn by a
    generator of its own, so that any chunk can be made again alone."""

    def __init__(self, m: Csr, device="cpu"):
        import torch
        self.n = m.n
        self.dev = torch.device(device)
        self.lengths = torch.from_numpy(np.diff(m.indptr)).to(self.dev)
        self.cols = torch.from_numpy(m.indices.astype(np.int64)).to(self.dev)
        self.vals = torch.from_numpy(m.data).to(self.dev)

    def chunk(self, seed: int, stream: int, c: int, k: int) -> np.ndarray:
        """Host fp64, one row a right-hand side."""
        import torch
        gen = torch.Generator(device=self.dev).manual_seed(stream_seed(seed, stream, c))
        x = torch.randn((self.n, k), generator=gen, dtype=torch.float64, device=self.dev)
        out = np.empty((k, self.n))
        for j in range(0, k, 4):    # 4 columns at a time: a gather of nnz x 4 entries
            # each row summed in its own order (no atomics): the same seed, the same bits
            b = torch.segment_reduce(self.vals[:, None] * x[self.cols, j:j + 4], "sum",
                                     lengths=self.lengths, axis=0)
            out[j:j + 4] = b.t().cpu().numpy()
        return out
