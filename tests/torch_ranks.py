"""What the port's two-process tests run on every rank, and their launcher.

``run_ranks(job, data, tmp_path, k)`` starts two processes of this file as
the ranks of a CPU process group (gloo, its store a file in ``tmp_path``),
``k`` shards a rank. Each rank runs ``JOBS[job](mesh, data)`` and saves what
it returns; the caller runs the same function on a one-process mesh of as
many shards and compares. This file imports only numpy, torch and
respatpu_torch, so no rank loads JAX (each says whether it did).

    python tests/torch_ranks.py JOB RANK WORLD STORE K INPUT.npz OUTPUT.npz
"""
import os
import subprocess
import sys
import time

import numpy as np
import torch

from respatpu_torch import dist, dist_lu, dist_snlu_sub, persist
from respatpu_torch.formats import CSRMatrix

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120  # a rank's wall time before the test fails


def matrix_data(a: CSRMatrix, **more) -> dict:
    return dict(shape=np.array(a.shape), indptr=a.indptr, indices=a.indices, data=a.data, **more)


def _matrix(data) -> CSRMatrix:
    return CSRMatrix(tuple(int(v) for v in data["shape"]), data["indptr"], data["indices"],
                     data["data"])


def krylov(mesh, data) -> dict:
    """respatpu's psum check, both DistSpmv products with the bytes a call
    moves, a ``take`` from the last shard to the first, CG, the block-Jacobi
    apply and BiCGSTAB."""
    a, x, b = _matrix(data), data["x"], data["b"]
    one = mesh.map(lambda d: torch.tensor(float(mesh.shards[d].rank + 1)))
    out = {"psum": float(mesh.psum(one).first), "describe": mesh.describe()}
    for policy in ("fp32", "fp64"):
        op = dist.DistSpmv(a, mesh, policy=policy)
        xs = op.shard_vector(x)
        before = mesh.bytes_moved + mesh.bytes_sent
        y = op(xs)
        out[f"bytes_{policy}"] = mesh.bytes_moved + mesh.bytes_sent - before
        out[f"y_{policy}"] = op.unshard(y)
    # take: the last shard's piece of x handed to shard 0 (across ranks: one transfer)
    last, n_loc = mesh.size - 1, op.plan.n_loc
    got = mesh.take(xs[last], last, 0, like=((n_loc,), torch.float64))
    if mesh.is_local(0):
        want = np.zeros(n_loc)
        want[:x.size - last * n_loc] = x[last * n_loc:]
        out["take"] = bool(np.array_equal(got.numpy(), want))
    else:
        out["take"] = got is None
    out["cg"], out["cg_iterations"] = dist.dist_cg(a, b, mesh=mesh, tol=1e-7, max_iters=2000)
    op = dist.DistSpmv(a, mesh)
    pre = dist.BlockJacobiIlu(a, op.plan, mesh)
    out["apply"] = pre.apply_host(x)
    out["bicgstab"], out["bicgstab_iterations"] = dist.dist_bicgstab(a, b, mesh=mesh, op=op,
                                                                     pre=pre)
    return out


def spike(mesh, data) -> dict:
    """SPIKE's band, its solve of one right-hand side and of three, and the
    refined solve."""
    a, b = _matrix(data), data["b"]
    fac = dist_lu.DistBandLu(a, mesh=mesh, p=int(data["p"]))
    x, rep = dist_lu.dist_solve_refined(a, b, fac=fac)
    return {"band": [fac.ml, fac.mu, fac.nb_loc, fac.reduced_order],
            "pivots": fac.report.n_pivot_perturbed, "x": fac.solve(b),
            "xm": fac.solve(np.stack([b, -b, 2 * b], axis=1)), "refined": x,
            "iterations": rep.iterations}


def subtree(mesh, data) -> dict:
    """The subtree LU's pools (this rank's shards'), the bytes its factor
    sent to other ranks, a solve and a refined solve; over ranks, whether
    ``factor_values`` and a save refuse."""
    a, b = _matrix(data), data["b"]
    fac = dist_snlu_sub.DistSubtreeLu(a, mesh=mesh)
    out = {f"pool_{d}": fac.pools[d].numpy() for d in mesh.local_shards}
    out.update(sent=mesh.bytes_sent, pivots=fac.report.n_pivot_perturbed, x=fac.solve(b),
               refined=fac.solve_refined(b), iterations=fac.report.iterations)
    if mesh.ranks > 1:
        refused = []
        for fn in (fac.factor_values, lambda: persist.save_sparse_factorization(
                os.devnull, fac)):
            try:
                fn()
                refused.append("")
            except ValueError as e:
                refused.append(str(e))
        out["refused"] = refused
    return out


JOBS = {"krylov": krylov, "spike": spike, "subtree": subtree}


def run_ranks(job: str, data: dict, tmp_path, k: int, world: int = 2) -> list:
    """``JOBS[job]`` on ``world`` ranks of ``k`` shards each; every rank's
    results, in rank order. Fails on a rank's error or after ``TIMEOUT_S``."""
    inp = str(tmp_path / f"{job}{k}_in.npz")
    np.savez(inp, **data)
    outs = [str(tmp_path / f"{job}{k}_rank{r}.npz") for r in range(world)]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")  # the ranks share this host
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), job, str(r), str(world),
                               str(tmp_path / f"{job}{k}_store"), str(k), inp, outs[r]],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    deadline = time.monotonic() + TIMEOUT_S
    try:
        logs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {job} exited {p.returncode}:\n{log[-3000:]}"
    return [dict(np.load(o, allow_pickle=False)) for o in outs]


def _main(argv):
    job, rank, world, store, k, inp, out = argv
    torch.set_num_threads(1)
    dist.init_distributed(num_processes=int(world), process_id=int(rank), device="cpu",
                          init_method=f"file://{store}", timeout_s=TIMEOUT_S / 2)
    try:
        res = JOBS[job](dist.make_mesh(int(world) * int(k)), dict(np.load(inp)))
    finally:
        dist.shutdown_distributed()
    res["jax_loaded"] = "jax" in sys.modules
    np.savez(out, **res)


if __name__ == "__main__":
    _main(sys.argv[1:])
