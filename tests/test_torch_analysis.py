"""The port's host analysis (ordering, permutation, structural symmetry)
against respatpu's on the same matrices."""
import numpy as np
import pytest

import respatpu.analysis as janalysis
import respatpu.bench.synth as jsynth

from respatpu_torch import analysis
from respatpu_torch.interop import csr_from_respatpu
from respatpu_torch.io import native

MATRICES = {
    "random_banded": lambda: jsynth.random_banded(300, 9, 5, seed=1),
    "mesh_fem_3d": lambda: jsynth.mesh_fem_3d(2000, seed=3),
    "circuit_like": lambda: jsynth.circuit_like(1500, 5, seed=2),
    "laplacian_2d": lambda: jsynth.laplacian_2d(13, 9),
    "powerlaw": lambda: jsynth.powerlaw(800, 6, seed=5),
    "laplacian_3d": lambda: jsynth.laplacian_3d(7, 6, 5),
    "weak_diagonal": lambda: jsynth.random_banded(200, 30, 3, seed=8, diag_dominant=False),
}


@pytest.fixture
def python_bfs(monkeypatch):
    """Both packages on their Python breadth-first search. respatpu's native
    routine counts a stored diagonal into a vertex's degree, so on a matrix
    whose diagonal is stored only in part it can order ties differently from
    respatpu's own Python search; the port's two routines both follow the
    Python search's rules."""
    monkeypatch.setattr(janalysis, "_USE_NATIVE", False)
    monkeypatch.setattr(analysis, "_USE_NATIVE", False)


@pytest.mark.parametrize("name", list(MATRICES))
def test_rcm_ordering_matches_respatpu(name, python_bfs):
    a = MATRICES[name]()
    perm = analysis.rcm_ordering(csr_from_respatpu(a))
    assert perm.dtype == np.int32
    np.testing.assert_array_equal(perm, janalysis.rcm_ordering(a))
    assert sorted(perm.tolist()) == list(range(a.nrows))


@pytest.mark.parametrize("name", list(MATRICES))
def test_native_rcm_equals_python_bfs(name, monkeypatch):
    if not native.available():
        pytest.skip("no host C++ compiler to build io/csrc/rcm_order.cpp")
    a = csr_from_respatpu(MATRICES[name]())
    fast = analysis.rcm_ordering(a)
    monkeypatch.setattr(analysis, "_USE_NATIVE", False)
    np.testing.assert_array_equal(fast, analysis.rcm_ordering(a))


def test_rcm_handles_missing_diagonal_and_components():
    """Two components, no stored diagonal, an isolated vertex."""
    from respatpu_torch.formats import COOMatrix, coo_to_csr
    rows = np.array([0, 1, 2, 4, 5, 5], np.int32)
    cols = np.array([1, 2, 0, 5, 6, 4], np.int32)
    a = coo_to_csr(COOMatrix((7, 7), rows, cols, np.ones(6)))
    indptr, indices = analysis.symmetrized_adjacency(a)
    assert indptr.tolist() == [0, 2, 4, 6, 6, 7, 9, 10]
    assert indices.tolist() == [1, 2, 0, 2, 0, 1, 5, 4, 6, 5]
    perm = analysis.rcm_ordering(a)
    assert sorted(perm.tolist()) == list(range(7))
    assert perm[-1] == 3  # the isolated vertex has the least degree: first seed, last reversed


@pytest.mark.parametrize("name", list(MATRICES))
def test_permute_csr_and_symmetry_match_respatpu(name, python_bfs):
    a = MATRICES[name]()
    t = csr_from_respatpu(a)
    perm = janalysis.rcm_ordering(a)
    pj, pt = janalysis.permute_csr(a, perm), analysis.permute_csr(t, perm)
    np.testing.assert_array_equal(pj.indptr, pt.indptr)
    assert pj.indices.tobytes() == pt.indices.tobytes()
    assert pj.data.tobytes() == pt.data.tobytes()
    assert analysis.structural_symmetry(t) == janalysis.structural_symmetry(a)


def test_ordering_dispatch():
    a = csr_from_respatpu(MATRICES["laplacian_2d"]())
    np.testing.assert_array_equal(analysis.ordering(a, "natural"), np.arange(a.nrows))
    np.testing.assert_array_equal(analysis.ordering(a, "rcm"), analysis.rcm_ordering(a))
    for method in ("amd", "mindeg", "nd", "fillauto"):  # the fill-reducing orderings
        assert sorted(analysis.ordering(a, method).tolist()) == list(range(a.nrows))
    np.testing.assert_array_equal(analysis.ordering(a, "amd"), analysis.ordering(a, "mindeg"))
    with pytest.raises(ValueError):
        analysis.ordering(a, "nope")
