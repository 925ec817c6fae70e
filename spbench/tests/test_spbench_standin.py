"""The frozen stand-ins give the port's corpus matrices, and the seed moves
only the values."""
import numpy as np
import pytest

from spbench import standin

CATALOGUE = [("2cubes_sphere", 101492, 1647264, "fem", 103823, 1596035),
             ("dc1", 116835, 766396, "circuit", 116835, 872297)]


@pytest.mark.parametrize("name,n,nnz,kind,rows,stored", CATALOGUE)
def test_catalogue_size_counts(name, n, nnz, kind, rows, stored):
    a = standin.standin(name, n, nnz, kind)
    assert a.shape == (rows, rows)
    assert a.nnz == stored


@pytest.mark.parametrize("kind", ["fem", "circuit", "grid2d", "banded"])
def test_equal_to_the_port_at_a_small_size(kind):
    from respatpu_torch.bench import corpus, synth
    name = f"spbench_{kind}"
    ours = standin.standin(name, 2500, 30000, kind)
    port = synth.synth_like(name, 2500, 30000, kind, seed=corpus._seed(name))
    assert ours.shape == port.shape
    for mine, theirs in ((ours.indptr, port.indptr), (ours.indices, port.indices),
                         (ours.data, port.data)):
        assert mine.dtype == theirs.dtype
        assert np.array_equal(mine, theirs)


def test_name_seed_is_the_corpus_seed():
    from respatpu_torch.bench import corpus
    for name in ("2cubes_sphere", "dc1", "offshore"):
        assert standin.name_seed(name) == corpus._seed(name)


@pytest.mark.parametrize("symmetric", [True, False])
def test_seed_scales_values_and_keeps_the_pattern(symmetric):
    spec = {"name": "dc1", "kind": "circuit", "target_n": 3000, "target_nnz": 20000,
            "symmetric": symmetric}
    base = standin.standin("dc1", 3000, 20000, "circuit")
    a, b, c = (standin.build_matrix(spec, s) for s in (2 ** 31 + 7, 2 ** 31 + 7, 5))
    assert np.array_equal(a.data, b.data)
    assert not np.array_equal(a.data, c.data)
    for m in (a, c):
        assert np.array_equal(m.indptr, base.indptr) and np.array_equal(m.indices, base.indices)
        ratio = np.abs(m.data / base.data)
        assert ratio.min() >= 0.25 - 1e-12 and ratio.max() <= 4.0 + 1e-12


def test_symmetric_scaling_keeps_symmetry():
    spec = {"name": "2cubes_sphere", "kind": "fem", "target_n": 2000, "target_nnz": 30000,
            "symmetric": True}
    a = standin.build_matrix(spec, 123)
    dense = np.zeros(a.shape)
    dense[a.rows(), a.indices] = a.data
    assert np.array_equal(dense, dense.T)


def test_rhs_streams_differ_and_repeat():
    r1 = standin.rhs(100, 9, 1, 0)
    assert np.array_equal(r1, standin.rhs(100, 9, 1, 0))
    assert not np.array_equal(r1, standin.rhs(100, 9, 2, 0))
    assert not np.array_equal(r1, standin.rhs(100, 9, 1, 1))
    assert standin.rhs(5, -3, 1, 0).shape == (5,)


@pytest.mark.parametrize("config", ["2cubes_sphere.band_fp32", "dc1.snlu_fp32"])
def test_a_configuration_states_the_sizes_it_builds(config):
    import json
    from pathlib import Path
    path = Path(standin.__file__).resolve().parent / "configs" / f"{config}.json"
    spec = dict(json.loads(path.read_text())["matrix"])
    a = standin.build_matrix(spec, 2 ** 31 + 1)
    assert (a.n, a.nnz) == (spec["n"], spec["nnz"])
    spec["nnz"] += 1
    with pytest.raises(ValueError):
        standin.build_matrix(spec, 1)
