"""Count a configuration's work once and freeze it into its file.

    python -m spbench.count_work <config name> [...]   # writes "work" into each file

The counts come from the frozen stand-in (base values, seed 0) and the
port's own analysis of it at this benchmark's first version (its band
ordering, or its multifrontal partition); the harness reads the file and
never the live plan, so a kernel's roofline reads the same work whatever
later implements it. What is counted is what the factorization needs under
that ordering:

* band (no pivoting, fill inside the envelope): L(i, k) can be nonzero for
  first(i) <= k < i and U(k, j) for first(j) <= k < j, where first(i) is the
  first column of row i and first(j) the first row of column j. Step k does
  cL_k divisions and 2 cL_k cU_k flops of update, with cL_k, cU_k the counts
  of such i > k and j > k. The block algorithm's count (P = 128 blocks, LU,
  TRSMs and products of full blocks) is recorded beside it.
* snlu: the filled pattern of the port's analysis (matching, then its
  fill-reducing order): step k does cL_k divisions and 2 cL_k cU_k flops,
  cL_k and cU_k the entries of column k below and of row k right of the
  diagonal; the factor's entries are the pattern's. The program computes
  dense fronts, whose partial LUs (a front of k pivots and m update rows,
  w = k + m: the sum over t = m .. w-1 of t + 2 t^2 flops, k^2 + 2 k m
  entries) count explicit zeros; that count is recorded beside the need as
  ``front_flops`` and ``front_entries``.

``apply_bytes`` is the factor's entries once in fp32: the least one
correction solve reads. ``csr64_bytes`` is one fp64 CSR product's least
bytes (int64 row pointer, int32 columns, fp64 values, x read, y written).
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
if __package__ in (None, ""):
    sys.path.insert(0, str(HERE.parent))

from spbench import standin  # noqa: E402


def csr64_bytes(n: int, nnz: int) -> int:
    """Least bytes of one fp64 CSR SpMV (``timing.spmv_csr_sol_bytes``'s model)."""
    return (n + 1) * 8 + nnz * 4 + nnz * 8 + n * 8 + n * 8


def envelope_work(indptr: np.ndarray, indices: np.ndarray, n: int) -> dict:
    """Flops and factor entries of an unpivoted LU confined to the envelope."""
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    cols = indices.astype(np.int64)
    first_col = np.arange(n, dtype=np.int64)          # of each row (diagonal included)
    np.minimum.at(first_col, rows, cols)
    first_row = np.arange(n, dtype=np.int64)          # of each column
    np.minimum.at(first_row, cols, rows)
    # c_L[k] = #{i > k : first_col[i] <= k}: rows i whose envelope spans k
    def spans(first):
        d = np.zeros(n + 1, dtype=np.int64)
        np.add.at(d, first, 1)
        np.add.at(d, np.arange(n), -1)   # row i leaves at k = i (counted for k < i only)
        return np.cumsum(d)[:n]
    cl, cu = spans(first_col), spans(first_row)
    flops = int((cl + 2 * cl * cu).sum())
    entries = int((np.arange(n) - first_col).sum() + (np.arange(n) - first_row + 1).sum())
    return {"factor_flops": flops, "factor_entries": entries,
            "lower_bandwidth": int((np.arange(n) - first_col).max()),
            "upper_bandwidth": int((np.arange(n) - first_row).max())}


def block_band_flops(n: int, bl: int, bu: int, p: int = 128) -> dict:
    ml, mu, nb = max(1, -(-bl // p)), max(1, -(-bu // p)), -(-n // p)
    flops = 0
    for r in range(nb):
        kl, ku = min(ml, nb - 1 - r), min(mu, nb - 1 - r)
        flops += (2 * p ** 3) // 3 + (kl + ku) * p ** 3 + 2 * kl * ku * p ** 3
    return {"block_p": p, "block_rows": nb, "ml": ml, "mu": mu, "block_flops": flops,
            "block_band_bytes_fp32": nb * p * (ml + mu + 1) * p * 4}


def front_work(snode_ptr: np.ndarray, rowstruct) -> dict:
    k = np.diff(np.asarray(snode_ptr, np.int64))
    m = np.array([r.size for r in rowstruct], dtype=np.int64)
    w = k + m

    def s1(x):                  # sum_{t < x} t
        return x * (x - 1) // 2

    def s2(x):                  # sum_{t < x} t^2
        return (x - 1) * x * (2 * x - 1) // 6

    flops = int(((s1(w) - s1(m)) + 2 * (s2(w) - s2(m))).sum())
    return {"front_flops": flops, "front_entries": int((k * k + 2 * k * m).sum()),
            "fronts": int(k.size), "widest_front": int(w.max())}


def pattern_work(indptr: np.ndarray, indices: np.ndarray, n: int) -> dict:
    """Flops and entries of an unpivoted LU whose fill is the given pattern
    (closed under elimination)."""
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    cols = indices.astype(np.int64)
    cl = np.bincount(cols[rows > cols], minlength=n)
    cu = np.bincount(rows[cols > rows], minlength=n)
    return {"factor_flops": int((cl + 2 * cl * cu).sum()), "factor_entries": int(rows.size)}


def count(cfg: dict) -> dict:
    import torch

    from respatpu_torch import CSRMatrix
    from respatpu_torch import solve as S
    from respatpu_torch.analysis import permute_csr
    mat = standin.build_matrix(cfg["matrix"], 0)
    a = CSRMatrix(mat.shape, mat.indptr, mat.indices, mat.data)
    n = a.nrows
    work = {"rows": n, "nnz": a.nnz, "csr64_bytes": csr64_bytes(n, a.nnz)}
    if cfg["method"] == "band":
        perm, bl, bu = S.band_ordering(a)
        ap = a if bool((perm == np.arange(n)).all()) else permute_csr(a, perm)
        work["order"] = "natural" if ap is a else "rcm"
        work.update(envelope_work(ap.indptr, ap.indices, n))
        work.update(block_band_flops(n, bl, bu))
    elif cfg["method"] == "snlu":
        fac = S.SupernodalLuFactorization(a, policy=cfg["policy"], matching=cfg["matching"],
                                          device="cuda" if torch.cuda.is_available() else "cpu")
        part = fac.part
        work.update(pattern_work(part.filled.indptr, part.filled.indices, n))
        work.update(front_work(part.snode_ptr, part.rowstruct))
        work["fill_nnz"] = int(part.fill_nnz)
        work["pool_bytes"] = int(fac.report.factor_bytes)
    else:
        raise ValueError(f"no work count for method {cfg['method']!r}")
    work["apply_bytes"] = 4 * work["factor_entries"]
    return work


def main(argv=None) -> int:
    names = sys.argv[1:] if argv is None else argv
    for name in names:
        path = HERE / "configs" / f"{name}.json"
        with open(path) as f:
            cfg = json.load(f)
        cfg["work"] = count(cfg)
        with open(path, "w") as f:
            json.dump(cfg, f, indent=1)
            f.write("\n")
        print(name, json.dumps(cfg["work"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
