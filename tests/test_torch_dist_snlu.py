"""The port's subtree-sharded multifrontal LU (``dist_snlu_sub``) against
respatpu's on its 8-device CPU mesh, with the same numpy inputs: the subtree
owners, the distributed solves on respatpu's own factor, refined solves of
both, the port's factor against its single-device one, and persistence. The
port's shards are on the CPU, where the frontal kernels' plain versions run."""
import numpy as np
import pytest
import torch

import respatpu.bench.synth as jsynth
import respatpu.dist as jdist
import respatpu.dist_snlu_sub as jds

from respatpu_torch import dist, dist_snlu_sub as ds, persist
from respatpu_torch.interop import csr_from_respatpu, sharded_pool_from_respatpu
from respatpu_torch.kernels import snlu_device as F
from respatpu_torch.solve import relative_residual


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread: the vectors here are small, and the intra-op
    threads of every xdist worker would only contend with each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_subtree_lu_matches_respatpu(tmp_path):
    """FEM on 8 shards, a circuit on 4, a grid on 1: respatpu's owners and
    shard pool sizes; the port's solves on respatpu's factor within 1e-6 of
    respatpu's (inf-norm); refined solves of both at 1e-10 or below; the
    port's own factor within 1e-5 of its single-device pool (bit for bit
    where no parent has children on two shards), two factorizations equal
    bit for bit; a saved factor loads and solves as the live one."""
    cases = [(lambda m: m.mesh_fem_3d(800, seed=4), 8),
             (lambda m: m.circuit_like(600, 6, seed=1, diag="dominant"), 4),
             (lambda m: m.laplacian_2d(12, 11), 1)]
    for gen, p in cases:
        ja = gen(jsynth)
        a = csr_from_respatpu(ja)
        b = np.random.default_rng(p).standard_normal(a.nrows)
        jfac = jds.DistSubtreeLu(ja, mesh=jdist.make_mesh(p))
        mesh = dist.make_mesh(p, "cpu")
        on_theirs = sharded_pool_from_respatpu(jfac, mesh)
        np.testing.assert_array_equal(on_theirs.plan.owner, jfac.plan.owner)
        jpart = jfac.part
        vol = (F._pad_dims(np.diff(jpart.snode_ptr))
               + F._pad_dims([rs.size for rs in jpart.rowstruct])) ** 2
        np.testing.assert_array_equal(
            ds.assign_subtrees(np.asarray(jpart.sn_parent), vol, p),
            jds.assign_subtrees(np.asarray(jpart.sn_parent), vol, p))
        assert on_theirs.local_pool_bytes == jfac.local_pool_bytes
        assert on_theirs.replicated_pool_bytes == jfac.replicated_pool_bytes
        xj, xt = jfac.solve(b), on_theirs.solve(b)
        assert np.abs(xt - xj).max() <= 1e-6 * np.abs(xj).max(), p
        xr = jfac.solve_refined(b)
        assert relative_residual(a, xr, b) <= 1e-10

        fac = ds.DistSubtreeLu(a, mesh=mesh)
        np.testing.assert_array_equal(fac.plan.owner, jfac.plan.owner)
        vals = fac.factor_values()
        pool, _ = F.frontal_factor_pool(F.build_frontal_plan(fac.part), device="cpu")
        single = F.values_from_pool(F.build_frontal_plan(fac.part), pool)
        assert np.abs(vals - single).max() <= 1e-5 * np.abs(single).max()
        if p == 1:
            np.testing.assert_array_equal(vals, single)
        fac.refactorize_timed()
        np.testing.assert_array_equal(fac.factor_values(), vals)
        x = fac.solve_refined(b)
        assert fac.report.residual <= 1e-10 and relative_residual(a, x, b) <= 1e-10
        assert (fac.local_pool_bytes < fac.replicated_pool_bytes) == (p > 1)
        path = str(tmp_path / f"sub{p}.npz")
        persist.save_sparse_factorization(path, fac)
        loaded = persist.load_sparse_factorization(path, a, device="cpu")
        xs = fac.solve(b)
        assert np.abs(loaded.solve(b) - xs).max() <= 1e-5 * np.abs(xs).max()


def test_subtree_lu_on_two_processes_matches_one_process(tmp_path):
    """The subtree LU on two ranks of a CPU process group (gloo), 2 shards
    each, on the FEM matrix above: every shard's pool, the pivots, a solve
    and a refined solve equal the one-process mesh's of 4 shards bit for bit
    on both ranks; corners cross between the ranks; the pools stay on their
    ranks: ``factor_values`` and a save refuse."""
    from torch_ranks import matrix_data, run_ranks, subtree
    a = csr_from_respatpu(jsynth.mesh_fem_3d(800, seed=4))
    data = matrix_data(a, b=np.random.default_rng(4).standard_normal(a.nrows))
    one = subtree(dist.make_mesh(4, "cpu"), data)
    ranks = run_ranks("subtree", data, tmp_path, 2)
    for rank, r in enumerate(ranks):
        assert not r["jax_loaded"] and int(r["sent"]) > 0
        assert "factor_values" in r["refused"][0] and "save" in r["refused"][1]
        for key in ("pivots", "x", "refined", "iterations"):
            np.testing.assert_array_equal(r[key], one[key], err_msg=key)
        for d in (2 * rank, 2 * rank + 1):
            np.testing.assert_array_equal(r[f"pool_{d}"], one[f"pool_{d}"], err_msg=f"pool {d}")
