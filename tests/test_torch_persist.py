"""Factor persistence on the CPU against respatpu on the same inputs: the band,
multifrontal (plain and matched) and scheduled factors saved by both
packages, array for array; the loaded solves against respatpu's loaded
solves and against the live ones; refinement and the condition estimate of a
loaded factor; R3 repaired (the port binds a file to A's values too and
refuses a file bound to no matrix, where respatpu accepts both); a corrupted
pattern; the frontal branch taken when the triangles do not fit, in the
factor's own type. respatpu runs on its CPU JAX path, at most 200 rows. The
loaded factors' kernels are held to their plain versions on a card in
tests/test_torch_cuda.py and chip_smoke.py.

Tolerances: stored values within 1e-6 of the largest (fp32: both packages
factor in fp32, in other orders) or 1e-12 (fp64 against respatpu's
double-float); loaded solves within 1e-5 (fp32) or 1e-12 (fp64) of the
largest entry. The matched case is a circuit with a dominant diagonal, as in
tests/test_torch_snlu.py: on the weak-diagonal one the pivot growth lifts
the two packages' fp32 rounding differences to 3e-6."""
import json

import numpy as np
import pytest
import torch

from respatpu import persist as jpersist
from respatpu import solve as jsolve
from respatpu.bench.synth import circuit_like, laplacian_2d, random_banded

from respatpu_torch import persist, solve
from respatpu_torch.interop import csr_from_respatpu

TOL = {"fp32": 1e-5, "fp64": 1e-12}
VALS_TOL = {"fp32": 1e-6, "fp64": 1e-12}

# case: (matrix, policy, respatpu's factorization, the port's)
CASES = {
    "snlu": (lambda: laplacian_2d(13, 14), "fp32",
             lambda a: jsolve.SupernodalLuFactorization(a, policy="fp32"),
             lambda t: solve.SupernodalLuFactorization(t, policy="fp32", device="cpu")),
    "snlu_matched": (lambda: circuit_like(180, 5, seed=9, diag="dominant"), "fp32",
                     lambda a: jsolve.SupernodalLuFactorization(a, policy="fp32", matching=True),
                     lambda t: solve.SupernodalLuFactorization(t, policy="fp32", matching=True,
                                                               device="cpu")),
    "scheduled": (lambda: random_banded(150, 12, 5, seed=31), "fp32",
                  lambda a: jsolve.SparseLuFactorization(a, policy="fp32"),
                  lambda t: solve.SparseLuFactorization(t, policy="fp32", device="cpu")),
    "band_fp32": (lambda: random_banded(160, 6, 4, seed=21), "fp32",
                  lambda a: jsolve.factorize_band(a, policy="fp32"),
                  lambda t: solve.factorize_band(t, policy="fp32", device="cpu")),
    "band_fp64": (lambda: random_banded(160, 6, 4, seed=21), "fp64",
                  lambda a: jsolve.factorize_band(a, policy="df64"),
                  lambda t: solve.factorize_band(t, policy="fp64", device="cpu")),
}


def _rel(got, want):
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """Each case factored and saved by both packages, once, on first use."""
    root, done = tmp_path_factory.mktemp("persist"), {}

    def get(case):
        if case not in done:
            make, policy, jmake, tmake = CASES[case]
            a = make()
            t = csr_from_respatpu(a)
            jfac, tfac = jmake(a), tmake(t)
            jpath, tpath = str(root / f"j_{case}.npz"), str(root / f"t_{case}.npz")
            band = case.startswith("band")
            (jpersist.save_band_factorization if band else
             jpersist.save_sparse_factorization)(jpath, jfac)
            (persist.save_band_factorization if band else
             persist.save_sparse_factorization)(tpath, tfac)
            done[case] = (a, t, policy, jfac, tfac, jpath, tpath)
        return done[case]
    return get


def _load(case, path, a, **kw):
    if case.startswith("band"):
        return persist.load_band_factorization(path, a, device="cpu")
    return persist.load_sparse_factorization(path, a, device="cpu", **kw)


@pytest.mark.parametrize("case", list(CASES))
def test_file_and_solves_match_respatpus(saved, case):
    """The port's file holds respatpu's arrays under respatpu's names: the
    permutations, the filled pattern and the matrix hash bit for bit, the
    values within the policy's tolerance; the loaded factor solves like
    respatpu's loaded one and like the live one, refines to 1e-12 and
    estimates the condition number within a factor of 2 of the live one."""
    a, t, policy, jfac, tfac, jpath, tpath = saved(case)
    zj, zt = np.load(jpath), np.load(tpath)
    mj, mt = json.loads(str(zj["meta"])), json.loads(str(zt["meta"]))
    assert mt["version"] == 2 and mt["matrix_hash"] == mj["matrix_hash"]
    assert mt["values_hash"] == persist._values_hash(a.data)
    assert set(mj) - set(mt) <= {"c"}
    assert set(mt) - set(mj) == {"values_hash"} | ({"values_type"} if "findptr" in zt else set())
    keys = ("perm", "findptr", "findices", "cperm", "dr", "dc")
    assert {k for k in zj.files if k in keys} == {k for k in zt.files if k in keys}
    for k in keys:
        if k in zj.files:
            assert np.array_equal(zj[k], zt[k]), k
    if case.startswith("band"):
        assert all(mt[k] == mj[k] for k in ("n", "p", "ml", "mu"))
        jband = zj["band0"].astype(np.float64)
        if policy == "fp64":
            jband = jband + zj["band1"]  # respatpu's double-float pair
        assert _rel(zt["band0"], jband) <= VALS_TOL[policy]
        assert zt["band0"].dtype == (np.float64 if policy == "fp64" else np.float32)
    else:
        assert mt["pattern_hash"] == mj["pattern_hash"]
        assert _rel(zt["fvals"], zj["fvals"]) <= VALS_TOL[policy]

    b, _ = solve.make_rhs_for_known_x(t)
    loaded = _load(case, tpath, t)
    assert loaded.policy.name == policy and loaded.report.notes == "loaded from " + f"t_{case}.npz"
    x = loaded.solve(b)
    jload = (jpersist.load_band_factorization if case.startswith("band")
             else jpersist.load_sparse_factorization)(jpath, a)
    assert _rel(x, jload.solve(b)) <= TOL[policy]
    assert _rel(x, tfac.solve(b)) <= TOL[policy]
    xr, rep = solve.solve_refined(t, b, fac=loaded)
    assert rep.converged and rep.residual <= 1e-12, rep
    ratio = loaded.condest() / tfac.condest()
    assert 0.5 <= ratio <= 2.0
    with pytest.raises(RuntimeError, match="cannot be factored again"):
        loaded.refactorize_timed()


def _rewrite(path, out, meta_fn=None, **arrays):
    z = np.load(path)
    meta = json.loads(str(z["meta"]))
    if meta_fn is not None:
        meta_fn(meta)
    np.savez_compressed(out, meta=json.dumps(meta),
                        **{**{k: z[k] for k in z.files if k != "meta"}, **arrays})


@pytest.mark.parametrize("kind", ["other_values", "no_hash", "corrupted_pattern",
                                  "other_pattern"])
def test_loading_refuses_what_is_not_bound_to_the_matrix(saved, tmp_path, kind):
    """R3 repaired: respatpu binds a factor to the pattern alone and accepts
    a same-pattern matrix with other values (then solving it with the wrong
    factor) and a file without a hash; the port refuses both, as it refuses
    another pattern and a filled pattern whose hash no longer matches."""
    a, t, _, _, _, jpath, tpath = saved("snlu_matched")
    if kind == "other_values":
        data = np.array(a.data, np.float64)
        data[::7] *= 1.5
        other = solve.CSRMatrix(t.shape, t.indptr, t.indices, data)
        jother = type(a)(a.shape, a.indptr, a.indices, data.copy())
        jload = jpersist.load_sparse_factorization(jpath, jother)  # accepted
        b, _ = solve.make_rhs_for_known_x(other)
        assert jload.report.notes.startswith("loaded") and \
            solve.relative_residual(other, jload.solve(b), b) > 1e-3
        with pytest.raises(ValueError, match=r"t_snlu_matched\.npz.*values_hash"):
            persist.load_sparse_factorization(tpath, other, device="cpu")
    elif kind == "no_hash":
        for key in ("matrix_hash", "values_hash"):
            out = str(tmp_path / f"no_{key}.npz")
            _rewrite(tpath, out, lambda m: m.pop(key))
            with pytest.raises(ValueError, match=f"no_{key}.npz.*has no {key}"):
                persist.load_sparse_factorization(out, t, device="cpu")
        # respatpu's own file carries no values hash: refused by the port
        with pytest.raises(ValueError, match="has no values_hash"):
            persist.load_sparse_factorization(jpath, t, device="cpu")
    elif kind == "corrupted_pattern":
        out = str(tmp_path / "corrupted.npz")
        findices = np.load(tpath)["findices"].copy()
        findices[[3, 4]] = findices[[4, 3]]
        _rewrite(tpath, out, findices=findices)
        with pytest.raises(ValueError, match=r"corrupted\.npz.*file corrupted"):
            persist.load_sparse_factorization(out, t, device="cpu")
    else:
        other = csr_from_respatpu(circuit_like(180, 5, seed=10, diag="dominant"))
        with pytest.raises(ValueError, match="matrix_hash"):
            persist.load_sparse_factorization(tpath, other, device="cpu")
        with pytest.raises(ValueError, match="'sparse_lu', not a 'band_lu'"):
            persist.load_band_factorization(tpath, t, device="cpu")


def _no_room(monkeypatch):
    monkeypatch.setattr(persist, "_tri_budget", lambda device: 0)


def test_frontal_branch_keeps_the_factors_type(tmp_path, monkeypatch):
    """Where the triangles do not fit, the factor is solved from a frontal
    pool rebuilt from the stored values, with no factorization: an fp64
    factor in an fp64 pool (respatpu rebuilds fp32, R3), an fp32 one in
    fp32; each solve equals the live factor's bit for bit, and the fp64 one
    refines to 1e-12. A loaded factor saved again keeps the ordering and
    amalgamation that the branch re-runs; a scheduled factor, which has no
    supernodal analysis, keeps its memory error."""
    t = csr_from_respatpu(circuit_like(300, 5, seed=4))
    b, _ = solve.make_rhs_for_known_x(t)
    for policy, dtype in (("fp64", torch.float64), ("fp32", torch.float32)):
        live = solve.SupernodalLuFactorization(t, policy=policy, matching=True, device="cpu")
        path = str(tmp_path / f"{policy}.npz")
        persist.save_sparse_factorization(path, live)
        with monkeypatch.context() as mp:
            _no_room(mp)
            fac = persist.load_sparse_factorization(path, t, device="cpu")
        assert isinstance(fac, persist.LoadedFrontalLu) and fac.matched
        assert fac._frontal.pool.dtype == dtype and fac.policy.name == policy
        assert fac.report.notes.endswith("apply=frontal_" + policy)
        assert np.array_equal(fac.solve(b), live.solve(b))
        assert np.array_equal(fac.factor_values(), live.factor_values())
        if policy == "fp64":
            assert fac.report.residual <= 1e-12
            _, rep = solve.solve_refined(t, b, fac=fac)
            assert rep.residual <= 1e-12
    fits = persist.load_sparse_factorization(path, t, device="cpu")
    assert isinstance(fits, persist.LoadedSparseLu)

    live = solve.SupernodalLuFactorization(t, policy="fp64", order="rcm", amalg=8,
                                           matching=True, device="cpu")
    persist.save_sparse_factorization(path, live)
    again = str(tmp_path / "again.npz")
    persist.save_sparse_factorization(again, persist.load_sparse_factorization(path, t,
                                                                               device="cpu"))
    meta = json.loads(str(np.load(again)["meta"]))
    assert (meta["order"], meta["amalg"], meta["values_type"]) == ("rcm", 8, "float64")
    sched = solve.SparseLuFactorization(t, policy="fp64", device="cpu")
    persist.save_sparse_factorization(path, sched)
    _no_room(monkeypatch)
    fac = persist.load_sparse_factorization(again, t, device="cpu")
    assert isinstance(fac, persist.LoadedFrontalLu)
    assert np.array_equal(fac.solve(b), live.solve(b))
    with pytest.raises(MemoryError, match="triangles would need"):
        persist.load_sparse_factorization(path, t, device="cpu")


def test_a_loaded_factor_keeps_its_policy(tmp_path):
    """Every policy of the scheduled LU saved and loaded: the same policy and
    flush, the same triangles, so the loaded solve equals the live one bit
    for bit. Every policy of the multifrontal LU loaded onto triangles in
    the type its pool holds (fp32 for bf16, whose values the pool factors
    and solves in fp32), so the loaded solve lies as close to the live one
    as the policy's solve type allows. And the CSR file round trip."""
    t = csr_from_respatpu(laplacian_2d(12, 11))
    b, _ = solve.make_rhs_for_known_x(t)
    for policy in ("fp32", "fp32_ftz", "bf16", "fp64"):
        live = solve.factorize(t, policy, method="sparse", device="cpu")
        path = str(tmp_path / f"{policy}.npz")
        persist.save_sparse_factorization(path, live)
        fac = persist.load_sparse_factorization(path, t, device="cpu")
        assert fac.policy == live.policy and fac._l.vals.dtype == live._l.vals.dtype
        assert np.array_equal(fac.solve(b), live.solve(b)), policy
        assert fac.report.n_pivot_perturbed == live.report.n_pivot_perturbed
    for policy in ("fp32", "fp32_ftz", "bf16", "fp64"):
        live = solve.SupernodalLuFactorization(t, policy=policy, device="cpu")
        path = str(tmp_path / f"snlu_{policy}.npz")
        persist.save_sparse_factorization(path, live)
        fac = persist.load_sparse_factorization(path, t, device="cpu")
        assert fac.policy == live.policy and fac._l.vals.dtype == live._dtype, policy
        want = live.solve(b)
        assert _rel(fac.solve(b), want) <= TOL["fp64" if policy == "fp64" else "fp32"], policy
        assert _rel(fac.solve_transpose(b), live.solve_transpose(b)) <= TOL["fp32"], policy
    path = str(tmp_path / "a.npz")
    persist.save_csr(path, t)
    back = persist.load_csr_npz(path)
    assert back.shape == t.shape and back.data.tobytes() == t.data.tobytes()
    assert np.array_equal(back.indptr, t.indptr) and np.array_equal(back.indices, t.indices)
