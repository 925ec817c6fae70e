"""The port's distributed SpMV, block-Jacobi ILU(0), CG and BiCGSTAB against
respatpu's on its 8-device CPU mesh, with the same numpy inputs; and the
distributed commands of the port's CLI. The port's shards are on the CPU,
where the kernels' plain versions run."""
import csv
import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import respatpu.bench.synth as jsynth
import respatpu.dist as jdist

from respatpu_torch import cli, dist
from respatpu_torch.bench import corpus, runner
from respatpu_torch.config import ExperimentConfig
from respatpu_torch.interop import csr_from_respatpu, row_partition_from_respatpu
from respatpu_torch.io import write_mtx


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread: the vectors here are small, and the intra-op
    threads of every xdist worker would only contend with each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CASES = {
    "laplacian_2d": lambda m: m.laplacian_2d(20, 13),
    "random_banded": lambda m: m.random_banded(300, 25, 7, seed=3),
    "powerlaw": lambda m: m.powerlaw(200, 5, seed=8),
}


def _inf(y, ref):
    return float(np.abs(y - ref).max() / np.abs(ref).max())


def test_row_partition_and_spmv_match_respatpu(monkeypatch):
    """Partition arrays equal respatpu's, array by array; the fp32 product
    within 1e-5 of respatpu's in the inf-norm (a shard's rows are summed in
    another order), the fp64 one within 1e-12 of its df64; the single-word
    policies against the port's single-device product; two calls equal bit
    for bit; the exchange moves exactly the requested entries."""
    for name, gen in CASES.items():
        ja = gen(jsynth)
        a = csr_from_respatpu(ja)
        A = sp.csr_matrix((a.data, a.indices, a.indptr), shape=a.shape)
        x = np.random.default_rng(1).standard_normal(a.nrows)
        for p in (1, 3, 8):
            mesh = dist.make_mesh(p, "cpu")
            assert mesh.describe() == f"{p} shard{'s' * (p > 1)} on the CPU"
            op = dist.DistSpmv(a, mesh)
            jp, tp = jdist.build_row_partition(ja, p), op.plan
            assert (tp.n_loc, tp.halo) == (jp.n_loc, jp.halo), (name, p)
            np.testing.assert_array_equal(tp.send_idx, jp.send_idx)
            np.testing.assert_array_equal(tp.send_mask, jp.send_mask)
            back = row_partition_from_respatpu(jp)
            for got, want in zip(back.local, tp.local):
                np.testing.assert_array_equal(got.indptr, want.indptr)
                np.testing.assert_array_equal(got.indices, want.indices)
                np.testing.assert_array_equal(got.data, want.data)
            xs = op.shard_vector(x)
            before = mesh.bytes_moved
            y1 = op(xs)
            assert mesh.bytes_moved - before == op.exchange_bytes == tp.exchange_entries * 4
            y = op.unshard(y1)
            assert all(torch.equal(u, v) for u, v in zip(y1, op(xs))), (name, p)
            if p in (3, 8):
                jm = jdist.make_mesh(p)
                jop = jdist.DistSpmv(ja, jm)
                yj = jop.unshard(jop(jop.shard_vector(x)))
                assert _inf(y, yj) <= 1e-5, (name, p)
                jop64 = jdist.DistSpmv(ja, jm, policy="df64")
                yj64 = jop64.unshard(jop64(jop64.shard_vector(x)))
                op64 = dist.DistSpmv(a, mesh, policy="fp64")
                assert _inf(op64.unshard(op64(op64.shard_vector(x))), yj64) <= 1e-12, (name, p)
            assert _inf(y, A @ x) <= 1e-5
            for policy in ("bf16", "fp32_ftz"):
                ops = [dist.DistSpmv(a, m, policy=policy) for m in (dist.make_mesh(1, "cpu"), mesh)]
                one, got = (o.unshard(o(o.shard_vector(x))) for o in ops)
                assert _inf(got, one) <= 1e-5, policy
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            dist.make_mesh(4)


def test_krylov_and_block_jacobi_match_respatpu():
    """dist_cg and dist_bicgstab (with block-Jacobi ILU(0)) take respatpu's
    iteration counts within 2 and reach its solutions within 1e-4; the
    preconditioner's apply within 1e-5 of respatpu's. D9: a BiCGSTAB stopped
    at max_iters returns its best iterate, where respatpu returns its last."""
    jm8, m8 = jdist.make_mesh(8), dist.make_mesh(8, "cpu")
    ja = jsynth.laplacian_2d(18, 18)
    a = csr_from_respatpu(ja)
    A = sp.csr_matrix((a.data, a.indices, a.indptr), shape=a.shape)
    b = A @ np.random.default_rng(1).standard_normal(a.nrows)
    xj, itj = jdist.dist_cg(ja, b, mesh=jm8, tol=1e-7, max_iters=2000)
    xt, itt = dist.dist_cg(a, b, mesh=m8, tol=1e-7, max_iters=2000)
    assert abs(itj - itt) <= 2 and _inf(xt, xj) <= 1e-4, (itj, itt)
    for name in ("laplacian_2d", "random_banded"):
        ja = CASES[name](jsynth)
        a = csr_from_respatpu(ja)
        A = sp.csr_matrix((a.data, a.indices, a.indptr), shape=a.shape)
        b = A @ np.ones(a.nrows)
        for p in (3, 8):
            jm, m = jdist.make_mesh(p), dist.make_mesh(p, "cpu")
            jop, op = jdist.DistSpmv(ja, jm), dist.DistSpmv(a, m)
            jpre = jdist.BlockJacobiIlu(ja, jop.plan, jm)
            pre = dist.BlockJacobiIlu(a, op.plan, m)
            r = np.random.default_rng(2).standard_normal(a.nrows)
            rp = np.zeros(p * op.plan.n_loc)  # respatpu's apply_host takes x padded
            rp[:r.size] = r
            assert _inf(pre.apply_host(r), jpre.apply_host(rp)[:r.size]) <= 1e-5, (name, p)
            xj, itj = jdist.dist_bicgstab(ja, b, mesh=jm, op=jop, pre=jpre)
            xt, itt = dist.dist_bicgstab(a, b, mesh=m, op=op, pre=pre)
            assert abs(itj - itt) <= 2 and _inf(xt, xj) <= 1e-4, (name, p, itj, itt)
            assert np.linalg.norm(A @ xt - b) <= 1e-5 * np.linalg.norm(b)
    ja = jsynth.circuit_like(400, 5, seed=1, diag="dominant")
    a = csr_from_respatpu(ja)
    A = sp.csr_matrix((a.data, a.indices, a.indptr), shape=a.shape)
    b = A @ np.ones(a.nrows)
    jm, m = jdist.make_mesh(3), dist.make_mesh(3, "cpu")

    def res(x):
        return np.linalg.norm(A @ x - b) / np.linalg.norm(b)

    got = [res(dist.dist_bicgstab(a, b, mesh=m, precondition=False, max_iters=k,
                                  tol=1e-12)[0]) for k in (12, 13)]
    last = res(jdist.dist_bicgstab(ja, b, mesh=jm, precondition=False, max_iters=13,
                                   tol=1e-12)[0])
    assert got[1] == got[0] and last > 10 * got[1], (got, last)


def test_distributed_cli_commands(tmp_path, capsys, monkeypatch):
    """``scaling``, ``sweep ilu0dist`` and ``lu --method subtree`` on the CPU,
    with respatpu's row keys and CSV header; a config that asks for several
    devices is refused (D8)."""
    cli.main(["scaling", "2cubes_sphere", "--shards", "1", "2", "--max-synth-nnz", "20000",
              "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("[scaling]") == 2 and "not a scaling" in out
    rows = json.loads(out[out.index("[\n"):])
    assert [r["devices"] for r in rows] == [1, 2]
    for r in rows:
        assert {"matrix", "synthetic", "n", "nnz", "devices", "halo", "t_spmv_s",
                "gnnz_per_s"} <= set(r) and r["card"] == "cpu" and r["cards"] == 1
        assert r["scaling_result"] == (r["devices"] == 1) and r["t_spmv_s"] > 0
    assert rows[1]["mesh"] == "2 shards on the CPU" and rows[1]["exchange_bytes"] > 0

    path = str(tmp_path / "dist.csv")
    monkeypatch.setattr(corpus, "MODERATE", [corpus._BY_NAME[n] for n in
                                             ("ecology2", "2cubes_sphere")])
    cli.main(["sweep", "ilu0dist", "--max-synth-nnz", "5000", "--shards", "3",
              "--device", "cpu", "--csv", path])
    with open(path) as f:
        table = list(csv.reader(f))
    assert table[0] == runner.ILU0DIST_HEADER == [
        "policy", "matrix", "n", "nnz", "synthetic", "ndev", "t_setup_s", "t_krylov_s",
        "krylov_iters", "krylov_residual", "status", "timestamp"]
    assert [r[1] for r in table[1:]] == ["ecology2", "2cubes_sphere"]
    for r in table[1:]:
        assert r[5] == "3" and r[10] in ("ok", "stagnated")
    assert table[1][10] == "ok" and float(table[1][9]) <= 1e-10
    assert capsys.readouterr().out.count("[ilu0dist]") == 2

    mtx = str(tmp_path / "fem.mtx")
    write_mtx(mtx, csr_from_respatpu(jsynth.mesh_fem_3d(600, seed=4)).tocoo())
    cli.main(["lu", mtx, "--method", "subtree", "--shards", "4", "--device", "cpu", "--refine"])
    out = capsys.readouterr().out
    assert "method=subtree 4 shards on the CPU" in out and "policy=fp32" in out
    assert float(out.split("rel_residual=")[1].split()[0]) <= 1e-10
    with pytest.raises(NotImplementedError, match="n_devices=4"):
        ExperimentConfig(n_devices=4).run()


def test_two_processes_match_one_process(tmp_path):
    """Two ranks of a CPU process group (gloo), 1 and 2 shards each:
    respatpu's psum check (1 + 2 = 3 on both ranks); a take from another
    rank's shard; DistSpmv in fp32 and fp64, dist_cg, the block-Jacobi apply
    and dist_bicgstab equal the
    one-process mesh of as many shards bit for bit on both ranks, and are
    within the tolerances above of respatpu's results on its CPU mesh; a
    product moves the same bytes in all, between the ranks' shards and
    across them."""
    from torch_ranks import krylov, matrix_data, run_ranks
    ja = CASES["laplacian_2d"](jsynth)
    a = csr_from_respatpu(ja)
    A = sp.csr_matrix((a.data, a.indices, a.indptr), shape=a.shape)
    x = np.random.default_rng(1).standard_normal(a.nrows)
    data = matrix_data(a, x=x, b=A @ np.ones(a.nrows))
    for k in (1, 2):
        ranks = run_ranks("krylov", data, tmp_path, k)
        one = krylov(dist.make_mesh(2 * k, "cpu"), data)
        assert float(ranks[0]["psum"]) == float(ranks[1]["psum"]) == 3.0 * k
        assert one["take"] and all(bool(r["take"]) for r in ranks)
        for r in ranks:
            assert not r["jax_loaded"]
            assert str(r["describe"]) == f"{2 * k} shards over 2 ranks on the CPU (gloo)"
            for key in ("y_fp32", "y_fp64", "cg", "cg_iterations", "apply", "bicgstab",
                        "bicgstab_iterations"):
                np.testing.assert_array_equal(r[key], one[key], err_msg=f"{key}, {k} a rank")
        for policy in ("fp32", "fp64"):
            assert sum(int(r[f"bytes_{policy}"]) for r in ranks) == one[f"bytes_{policy}"] > 0
    jm = jdist.make_mesh(4)
    jop = jdist.DistSpmv(ja, jm)
    assert _inf(one["y_fp32"], jop.unshard(jop(jop.shard_vector(x)))) <= 1e-5
    jop64 = jdist.DistSpmv(ja, jm, policy="df64")
    assert _inf(one["y_fp64"], jop64.unshard(jop64(jop64.shard_vector(x)))) <= 1e-12
    xj, itj = jdist.dist_cg(ja, data["b"], mesh=jm, tol=1e-7, max_iters=2000)
    assert abs(itj - int(one["cg_iterations"])) <= 2 and _inf(one["cg"], xj) <= 1e-4
    jpre = jdist.BlockJacobiIlu(ja, jop.plan, jm)
    rp = np.zeros(4 * jop.plan.n_loc)
    rp[:x.size] = x
    assert _inf(one["apply"], jpre.apply_host(rp)[:x.size]) <= 1e-5
    xj, itj = jdist.dist_bicgstab(ja, data["b"], mesh=jm, op=jop, pre=jpre)
    assert abs(itj - int(one["bicgstab_iterations"])) <= 2 and _inf(one["bicgstab"], xj) <= 1e-4
