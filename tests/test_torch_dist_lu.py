"""The port's SPIKE band LU (``dist_lu``) against respatpu's on its 8-device
CPU mesh and against scipy, with the same numpy inputs. The port's shards are
on the CPU, where the band kernels' plain versions run."""
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import respatpu.bench.synth as jsynth
import respatpu.dist as jdist
import respatpu.dist_lu as jdl

from respatpu_torch import dist, dist_lu
from respatpu_torch.interop import csr_from_respatpu
from respatpu_torch.solve import BandLuFactorization, relative_residual


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread: the vectors here are small, and the intra-op
    threads of every xdist worker would only contend with each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_spike_matches_respatpu_and_scipy():
    """At P = 1, 3 and 8 (n not divisible by P, padded partitions, bandwidth
    past one block): respatpu's band (RCM by default, ml, mu, block rows a
    partition, the reduced system's order); the solve within 2e-4 of
    respatpu's and of scipy's, one and several right-hand sides; the
    factor's pivots and report; refined solves of both packages at 1e-10 or
    below; the single-device band LU agrees."""
    cases = [(lambda m: m.laplacian_2d(40, 30), 8, 32),
             (lambda m: m.random_banded(997, bandwidth=25, nnz_per_row=5, seed=7), 3, 32),
             (lambda m: m.random_banded(900, bandwidth=40, nnz_per_row=7, seed=3), 1, 16)]
    for gen, p, blk in cases:
        ja = gen(jsynth)
        a = csr_from_respatpu(ja)
        A = sp.csr_matrix((a.data, a.indices, a.indptr), shape=a.shape).tocsc()
        rng = np.random.default_rng(p)
        b = rng.standard_normal(a.nrows)
        bm = rng.standard_normal((a.nrows, 3))
        jfac = jdl.DistBandLu(ja, mesh=jdist.make_mesh(p), p=blk)
        fac = dist_lu.DistBandLu(a, mesh=dist.make_mesh(p, "cpu"), p=blk)
        assert fac.report.policy == jfac.report.policy == f"fp32+spike{p}"
        np.testing.assert_array_equal(fac.perm, jfac.perm)
        assert (fac.ml, fac.mu, fac.nb_loc) == (jfac.ml, jfac.mu, jfac.nb_loc)
        assert fac.reduced_order == p * (fac.ml + fac.mu) * blk == jfac._rlu.shape[0]
        assert fac.report.n_pivot_perturbed == jfac.report.n_pivot_perturbed == 0
        x, xj, ref = fac.solve(b), jfac.solve(b), spla.spsolve(A, b)
        scale = np.abs(ref).max()
        assert np.abs(x - xj).max() <= 2e-4 * scale and np.abs(x - ref).max() <= 2e-4 * scale
        assert fac.report.residual < 1e-5 and fac.report.t_factorize > 0
        xm, refm = fac.solve(bm), spla.spsolve(A, bm)
        assert xm.shape == (a.nrows, 3)
        assert np.abs(xm - jfac.solve(bm)).max() <= 2e-4 * np.abs(refm).max()
        assert np.abs(xm - refm).max() <= 2e-4 * np.abs(refm).max()
        single = BandLuFactorization(a, p=blk, device="cpu").solve(b)
        assert np.abs(x - single).max() <= 2e-4 * scale
        xr, rep = dist_lu.dist_solve_refined(a, b, fac=fac)
        _, jrep = jdl.dist_solve_refined(ja, b, fac=jfac)
        assert rep.residual <= 1e-10 and jrep.residual <= 1e-10, (rep.residual, jrep.residual)
        assert relative_residual(a, xr, b) <= 1e-10 and rep.policy == f"fp32+spike{p}+ir_fp64"


def test_spike_on_two_processes_matches_one_process(tmp_path):
    """SPIKE on two ranks of a CPU process group (gloo), 2 shards each: the
    band, the pivots, one and three right-hand sides and the refined solve
    equal the one-process mesh's of 4 shards bit for bit on both ranks."""
    from torch_ranks import matrix_data, run_ranks, spike
    a = csr_from_respatpu(jsynth.random_banded(997, bandwidth=25, nnz_per_row=5, seed=7))
    data = matrix_data(a, b=np.random.default_rng(3).standard_normal(a.nrows), p=32)
    one = spike(dist.make_mesh(4, "cpu"), data)
    assert one["iterations"] >= 1
    for r in run_ranks("spike", data, tmp_path, 2):
        assert not r["jax_loaded"]
        for key in one:
            np.testing.assert_array_equal(r[key], one[key], err_msg=key)
