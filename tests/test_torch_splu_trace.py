"""Where the scheduled sparse LU (``solve.SparseLuFactorization``) records
its spans and counter: the set-up's ``schedule``, ``factor`` and
``triangles``, and in every correction apply ``tri_solve`` with ``lower`` and
``upper`` around K7's two launches and ``tri_levels``. One test, a group of
checks, so that the suite's collected count stays in its safe range
(ROADMAP, "The test-count trap")."""
import numpy as np
import torch

from respatpu_torch import solve, timing
from respatpu_torch.bench.synth import laplacian_2d
from respatpu_torch.formats import CSRMatrix


def _children(rec, i):
    return [rec.names[k] for k, p in enumerate(rec.parents) if p == i]


def test_sparse_lu_records_its_set_up_and_its_triangular_solves():
    lap = laplacian_2d(16, 16)
    n = lap.nrows
    rng = np.random.default_rng(21)
    d = np.exp2(rng.uniform(-1.0, 1.0, n))            # D A D: SPD, values of their own
    rows = np.repeat(np.arange(n), np.diff(lap.indptr))
    a = CSRMatrix(lap.shape, lap.indptr, lap.indices, lap.data * d[rows] * d[lap.indices])
    b = rng.standard_normal(n)

    with timing.recording() as setup:
        fac = solve.factorize(a, policy="fp32", method="sparse", matching=False, device="cpu")
    assert setup.names == ["schedule", "factor", "triangles"]
    assert setup.parents == [-1, -1, -1] and "tri_levels" not in setup.counts

    x_off, rep_off = solve.solve_refined(a, b, fac=fac)
    with timing.recording() as rec:
        x_on, rep_on = solve.solve_refined(a, b, fac=fac)
    assert timing._recording is None
    # the recording changes nothing of the answer
    assert np.array_equal(x_on, x_off) and rep_on.iterations == rep_off.iterations

    corrections = rep_on.iterations - 1
    assert rep_on.converged and corrections >= 1
    tri = [i for i, name in enumerate(rec.names) if name == "tri_solve"]
    assert len(tri) == corrections
    for i in tri:
        assert rec.names[rec.parents[i]] == "apply"
        assert _children(rec, i) == ["lower", "upper"]
    levels = fac._l.levels + fac._u.levels
    assert levels > 2
    assert rec.counts["tri_levels"] == corrections * levels

    # the refined answer against a plain fp64 solve of the dense matrix
    dense = torch.zeros(n, n, dtype=torch.float64)
    dense[torch.from_numpy(rows), torch.from_numpy(a.indices.astype(np.int64))] = \
        torch.from_numpy(a.data)
    ref = torch.linalg.solve(dense, torch.from_numpy(b)).numpy()
    assert np.linalg.norm(x_on - ref) <= 1e-12 * np.linalg.norm(ref)
