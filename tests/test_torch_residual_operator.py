"""A's fp64 residual operator, held by the factorization for its life
(``solve._residual_operator``), and the host gate ``relative_residual`` as
one compiled CSR product. On ``device="cpu"``; the answers and iteration
counts of ``solve_refined`` against respatpu's are held by
tests/test_torch_direct.py and tests/test_torch_snlu.py."""
import dataclasses

import numpy as np
import pytest
import torch

from respatpu_torch import solve, timing
from respatpu_torch.analysis import permute_csr
from respatpu_torch.bench.synth import circuit_like, laplacian_2d, random_banded
from respatpu_torch.formats import COOMatrix, coo_to_csr


def _scatter_residual(a, x, b):
    """The gate as it was written before the compiled product: the rows'
    products scattered by ``np.add.at``."""
    rows = np.repeat(np.arange(a.nrows), a.row_lengths())
    ax = np.zeros(a.nrows)
    np.add.at(ax, rows, a.data * x[a.indices])
    nb = np.linalg.norm(b)
    return float(np.linalg.norm(ax - b) / (nb if nb > 0 else 1.0))


def _layouts(rec):
    return rec.names.count("layout")


_METHODS = {
    # RCM moves laplacian_2d's rows: the band refines against its own permuted
    # copy (fac._ap) and gates on fac.a, two held operators
    "band": lambda: laplacian_2d(12, 9),
    "snlu": lambda: circuit_like(150, 5, seed=21, diag="dominant"),
}


@pytest.mark.parametrize("method", list(_METHODS))
def test_residual_operator_is_held_by_the_factorization(method):
    a = _METHODS[method]()
    fac = solve.factorize(a, "fp32", method=method, device="cpu")
    b = np.random.default_rng(3).standard_normal(a.nrows)
    permuted = method == "band"
    if permuted:
        assert fac._ap is not a

    # the first refined solve builds the operator, the second reuses it
    reads = []
    for _ in range(2):
        with timing.recording() as rec:
            x, rep = solve.solve_refined(a, b, fac=fac)
        assert rep.converged and "gmres_ir" not in rep.notes, method
        reads.append((rec.counts.get("a_upload", 0), rec.counts.get("a_reuse", 0),
                      _layouts(rec)))
        assert rep.residual == solve.relative_residual(a, x, b)
    assert reads == [(1, 0, 1), (0, 1, 0)], method
    held = solve._residual_operator(fac, fac.a)
    assert held is solve._residual_operator(fac, fac.a) and held.a is a
    assert held.on_host() is held.on_host()
    assert set(fac._residual_ops) == ({"a", "_ap"} if permuted else {"a"})

    # a matrix that is not the factorization's own: its own operator, made for
    # the call and not kept; the held one is left as it was
    rng = np.random.default_rng(5)
    a2 = dataclasses.replace(a, data=a.data * (1 + 1e-3 * rng.uniform(size=a.nnz)))
    b2 = rng.standard_normal(a.nrows)
    with timing.recording() as rec:
        x2, rep2 = solve.solve_refined(a2, b2, fac=fac)
    assert rep2.converged, method
    assert rep2.residual == solve.relative_residual(a2, x2, b2) < 1e-10
    assert solve.relative_residual(a, x2, b2) > 1e-6          # not a's residual
    if permuted:
        # the band refines in its own permuted system (reused) and, gated on
        # a2, finishes by GMRES-IR on a2's operator, made for the call
        assert "gmres_ir" in rep2.notes
        assert rec.counts.get("a_upload") == 1 and rec.counts.get("a_reuse") == 1
    else:
        assert "gmres_ir" not in rep2.notes
        assert rec.counts.get("a_upload") == 1 and "a_reuse" not in rec.counts
    op2 = solve._residual_operator(fac, a2)
    assert op2 is not solve._residual_operator(fac, a2) and op2.a is a2
    assert solve._residual_operator(fac, a) is held
    with timing.recording() as rec:
        solve.solve_refined(a, b, fac=fac)
    assert rec.counts.get("a_upload", 0) == 0 and _layouts(rec) == 0

    # fac.a rebound to another object, as persist's loaders bind a matrix:
    # the held operator is made anew from it, once
    a3 = dataclasses.replace(a, data=a.data.copy())
    fac.a = a3
    rebuilt = solve._residual_operator(fac, a3)
    assert rebuilt is not held and rebuilt.a is a3
    assert solve._residual_operator(fac, a3) is rebuilt
    assert solve._residual_operator(fac, a) is not held       # no longer fac's
    with timing.recording() as rec:
        x3, rep3 = solve.solve_refined(a3, b, fac=fac)
        solve.solve_refined(a3, b, fac=fac)
    # the band's residuals run on its permuted copy, still its own
    assert rec.counts.get("a_upload", 0) == (0 if permuted else 1), method
    assert rep3.converged and np.array_equal(x3, x)


def _random_unsymmetric():
    rng = np.random.default_rng(11)
    n, k = 400, 3000
    rows, cols = rng.integers(0, n, k), rng.integers(0, n, k)
    return coo_to_csr(COOMatrix((n, n), rows.astype(np.int32), cols.astype(np.int32),
                                rng.standard_normal(k)))


def _empty_rows():
    a = _random_unsymmetric()
    keep = np.repeat(np.arange(a.nrows) % 4 != 0, a.row_lengths())
    lens = np.where(np.arange(a.nrows) % 4 != 0, a.row_lengths(), 0)
    return dataclasses.replace(a, indptr=np.concatenate([[0], np.cumsum(lens)]).astype(np.int64),
                               indices=a.indices[keep], data=a.data[keep])


def _permuted_band():
    a = random_banded(500, bandwidth=12, nnz_per_row=6, seed=4)
    return permute_csr(a, np.random.default_rng(6).permutation(a.nrows))


_GATE_CASES = {
    "random_unsymmetric": _random_unsymmetric,
    "empty_rows": _empty_rows,
    "band_natural": lambda: random_banded(500, bandwidth=12, nnz_per_row=6, seed=4),
    "band_permuted": _permuted_band,
}


@pytest.mark.parametrize("case", list(_GATE_CASES))
def test_relative_residual_is_the_scatter_it_replaced(case):
    a = _GATE_CASES[case]()
    if case == "empty_rows":
        assert (a.row_lengths() == 0).sum() >= a.nrows // 4
    rng = np.random.default_rng(7)
    x = rng.standard_normal(a.ncols)
    b_near = solve.make_rhs_for_known_x(a, x)[0] + 1e-6 * rng.standard_normal(a.nrows)
    for b in (rng.standard_normal(a.nrows), b_near, np.zeros(a.nrows)):
        want = _scatter_residual(a, x, b)
        got = solve.relative_residual(a, x, b)
        assert got == pytest.approx(want, rel=1e-13, abs=0), case
        # a torch vector in, as the refined solves pass theirs
        assert solve.relative_residual(a, torch.from_numpy(x), b) == got
