"""The port's band LU (``respatpu_torch.kernels.bandlu``) against respatpu's
on the same inputs, on the CPU: the wrappers run their kernels' plain
versions here, respatpu runs under CPU JAX as ``tests/test_bandlu.py`` does."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from respatpu import solve as jsolve
from respatpu.bench.synth import circuit_like, laplacian_2d, mesh_fem_3d, random_banded
from respatpu.kernels import bandlu as jband
from respatpu.kernels import dflinalg
from respatpu.precision import df_from_f64, df_to_f64

from respatpu_torch.interop import (band_from_respatpu, band_to_numpy, csr_from_respatpu,
                                    df_to_numpy)
from respatpu_torch import solve as tsolve
from respatpu_torch.bench import synth
from respatpu_torch.kernels import bandlu
from respatpu_torch.precision import FP32_MIN_NORMAL, get_policy

PACK = {"random_banded": lambda: random_banded(100, 6, 4, seed=1),
        "laplacian_2d": lambda: laplacian_2d(16, 12),
        "mesh_fem_3d": lambda: mesh_fem_3d(250, seed=4),      # n not a multiple of p
        "circuit_like": lambda: circuit_like(90, 4, seed=6)}  # a band as wide as the matrix


@pytest.mark.parametrize("p", [16, 32])
@pytest.mark.parametrize("name", list(PACK))
def test_csr_to_band_bitwise(name, p):
    a = PACK[name]()
    jb, tb = jband.csr_to_band(a, p=p), bandlu.csr_to_band(csr_from_respatpu(a), p=p)
    assert (jb.n, jb.p, jb.ml, jb.mu) == (tb.n, tb.p, tb.ml, tb.mu)
    assert jb.data.tobytes() == tb.data.tobytes()
    assert tb.nb == jb.nb and tb.width == jb.width


@pytest.mark.parametrize("policy", ["fp32", "fp32_ftz", "bf16", "fp64"])
@pytest.mark.parametrize("name", list(PACK))
def test_device_scatter_packing_bitwise(name, policy):
    """The device-side scatter gives the bits of the host packing, and both
    give respatpu's upload (fp64 against hi + lo, which carries about 48
    bits: 1e-13 relative)."""
    a = PACK[name]()
    t = csr_from_respatpu(a)
    host = bandlu.band_to_device(bandlu.csr_to_band(t, p=16), policy, "cpu")
    dev = bandlu.csr_to_device_band(t, policy, "cpu", p=16)
    assert torch.equal(host.data, dev.data) and dev.data.dtype == dev.policy.dtype
    jd = jband.band_to_device(jband.csr_to_band(a, p=16), "df64" if policy == "fp64" else policy)
    ours = band_from_respatpu(jd, device="cpu")
    assert (ours.n, ours.p, ours.ml, ours.mu) == (dev.n, dev.p, dev.ml, dev.mu)
    if policy == "fp64":
        assert float((ours.data - dev.data).abs().max()) <= 1e-13 * float(dev.data.abs().max())
    else:
        assert torch.equal(ours.data, dev.data)


def test_band_memory_bytes():
    assert bandlu.band_memory_bytes(1000, 100, 100, p=128) == 8 * 128 * 3 * 128 * 4
    assert bandlu.band_memory_bytes(1000, 100, 100, p=128, fp64=True) == 8 * 128 * 3 * 128 * 8
    assert (jband.band_memory_bytes(1000, 100, 100, p=128, double_word=True)
            == bandlu.band_memory_bytes(1000, 100, 100, p=128, fp64=True))


def _planted(p, seed):
    """A diagonally dominant block whose first pivot is planted, and one
    whose later pivot cancels to exactly zero."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((p, p)) + 4 * np.sqrt(p) * np.eye(p)


# the first pivot: zero, exactly eps, eps / 2, negative tiny, exactly -eps,
# twice eps (kept), and an ordinary one
EPS = 2.0 ** -13
PLANTS = [0.0, EPS, EPS / 2, -EPS / 2, -EPS, 2 * EPS, None]


@pytest.mark.parametrize("plant", PLANTS, ids=lambda v: "plain" if v is None else f"{v:g}")
@pytest.mark.parametrize("p", [16, 32])
def test_block_lu_plain_matches_lu_unpivoted(p, plant):
    """Same operations in the same order as dflinalg.lu_unpivoted: 1e-6
    relative leaves room only for XLA's choice of fused multiply-adds."""
    d = _planted(p, seed=p)
    if plant is not None:
        d[0, 0] = plant
    d32 = d.astype(np.float32)
    jlu, jbad = dflinalg.lu_unpivoted(jnp.asarray(d32), jnp.float32(EPS))
    tlu, tbad = bandlu.block_lu_plain(torch.from_numpy(d32)[None], EPS)
    jlu = np.asarray(jlu, np.float64)
    assert int(jbad) == int(tbad[0]) == (0 if plant is None or abs(plant) > EPS else 1)
    assert np.abs(tlu[0].double().numpy() - jlu).max() <= 1e-6 * np.abs(jlu).max()
    # a zero pivot becomes +eps, a negative tiny one -eps
    if plant is not None and abs(plant) <= EPS:
        assert float(tlu[0, 0, 0]) == (-EPS if plant < 0 else EPS)


def test_block_lu_plain_zero_pivot_from_cancellation():
    d = np.array([[2.0, 4.0, 1.0], [1.0, 2.0, 3.0], [0.5, 1.0, 4.0]], np.float32)
    jlu, jbad = dflinalg.lu_unpivoted(jnp.asarray(d), jnp.float32(1e-4))
    tlu, tbad = bandlu.block_lu_plain(torch.from_numpy(d)[None], 1e-4)
    assert int(jbad) == int(tbad[0]) == 1  # pivot 1 cancels to exactly zero -> +eps
    np.testing.assert_allclose(tlu[0].numpy(), np.asarray(jlu), rtol=1e-6)
    assert float(tlu[0, 1, 1]) == pytest.approx(1e-4)


def test_block_lu_wrapper_batches_strides_and_checks():
    rng = np.random.default_rng(3)
    band = torch.from_numpy(rng.standard_normal((5, 16, 48)) + np.tile(9 * np.eye(16), 3))
    view = band[:, :, 16:32]  # read in place: row stride 48
    lu, cnt = bandlu.block_lu(view, 1e-13)
    ref, rcnt = bandlu.block_lu_plain(view.contiguous(), 1e-13)
    assert torch.equal(lu, ref) and torch.equal(cnt, rcnt) and lu.is_contiguous()
    for i in range(5):  # L U gives the block back
        low = torch.tril(lu[i], -1) + torch.eye(16, dtype=torch.float64)
        assert torch.allclose(low @ torch.triu(lu[i]), view[i], atol=1e-12)
    bf = bandlu.block_lu(view.to(torch.bfloat16), 1e-4)[0]
    assert bf.dtype == torch.float32  # bf16 blocks are read as fp32
    with pytest.raises(ValueError):
        bandlu.block_lu(torch.zeros(16, 16), 1e-4)
    with pytest.raises(TypeError):
        bandlu.block_lu(torch.zeros(1, 4, 4, dtype=torch.float16), 1e-4)


def _dense_unpivoted_lu(dense):
    lu = dense.astype(np.float64).copy()
    for k in range(lu.shape[0]):
        lu[k + 1:, k] /= lu[k, k]
        lu[k + 1:, k + 1:] -= np.outer(lu[k + 1:, k], lu[k, k + 1:])
    return lu


def _band_as_dense(band, data):
    n, p, ml = band.n, band.p, band.ml
    got = np.zeros((n, n))
    for i in range(n):
        r, pr = i // p, i % p
        j = (r - ml) * p + np.arange(data.shape[2])
        ok = (j >= 0) & (j < n)
        got[i, j[ok]] = data[r, pr, ok]
    return got


# factor values against respatpu's: fp32 differs by rounding order only;
# bf16 rounds what it stores at the same places, so one bf16 ulp (2^-8) of
# max|LU| covers a differently rounded fp32 intermediate; fp64 against the
# double-float factor
FACTOR_TOL = {"fp32": 2e-5, "bf16": 1e-2, "fp64": 1e-12}


FACTOR_MATRICES = {"random_banded": lambda: random_banded(70, 5, 4, seed=2),
                   "laplacian_2d": lambda: laplacian_2d(9, 8)}


@pytest.mark.parametrize("policy", list(FACTOR_TOL))
@pytest.mark.parametrize("p", [16, 32])
@pytest.mark.parametrize("name", list(FACTOR_MATRICES))
def test_band_lu_matches_respatpu_and_dense(name, p, policy):
    a = FACTOR_MATRICES[name]()
    t = csr_from_respatpu(a)
    jres = jband.band_lu(jband.band_to_device(jband.csr_to_band(a, p=p),
                                              "df64" if policy == "fp64" else policy))
    dev = bandlu.csr_to_device_band(t, policy, "cpu", p=p)
    before = dev.data.clone()
    tres = bandlu.band_lu(dev)
    assert torch.equal(dev.data, before)  # the uploaded band is left as it was
    jlu = band_from_respatpu(jres.lu, device="cpu").data.double().numpy()
    tlu = tres.lu.data.double().numpy()
    scale = np.abs(jlu).max()
    assert np.abs(tlu - jlu).max() <= FACTOR_TOL[policy] * scale
    assert tres.n_pivot_perturbed == int(jres.n_pivot_perturbed) == 0
    ref = _dense_unpivoted_lu(t.toarray())
    tol = {"fp32": 2e-3, "bf16": 5e-2, "fp64": 1e-12}[policy]
    np.testing.assert_allclose(_band_as_dense(tres.lu, tlu), ref, rtol=tol,
                               atol=tol * np.abs(ref).max())


def test_band_lu_counts_perturbed_pivots_like_respatpu():
    """A matrix with zero diagonal entries: same count on both sides."""
    a = random_banded(90, 4, 3, seed=8, diag_dominant=False)
    t = csr_from_respatpu(a)
    jres = jband.band_lu(jband.band_to_device(jband.csr_to_band(a, p=16), "fp32"),
                         pivot_eps=0.05)
    tres = bandlu.band_lu(bandlu.csr_to_device_band(t, "fp32", "cpu", p=16), pivot_eps=0.05)
    assert tres.n_pivot_perturbed == int(jres.n_pivot_perturbed) > 0


@pytest.mark.parametrize("p", [16, 32])
@pytest.mark.parametrize("nrhs", [1, 5])
def test_band_solve_fp32_matches_respatpu(nrhs, p):
    """The plain versions of K2 (one right-hand side) and K10 (several) on a
    band of ml = mu = 3 (p = 16) or 2 (p = 32) blocks: fp32 against
    respatpu's ``_solve_core`` on XLA:CPU and against the dense solve; fp64
    against the dense solve. With several right-hand sides, a forward sweep
    from the first block row that is not zero equals the one from row 0 bit
    for bit."""
    a = random_banded(150, 40, 6, seed=15)
    t = csr_from_respatpu(a)
    jres = jband.band_lu(jband.band_to_device(jband.csr_to_band(a, p=p), "fp32"))
    tres = bandlu.band_lu(bandlu.csr_to_device_band(t, "fp32", "cpu", p=p))
    assert (tres.lu.ml, tres.lu.mu) == ((3, 3) if p == 16 else (2, 2))
    rng = np.random.default_rng(2)
    b = rng.standard_normal((150, nrhs) if nrhs > 1 else 150)
    xj = np.asarray(jband.band_solve(jres.lu, jnp.asarray(b, jnp.float32)), np.float64)
    xt = bandlu.band_solve(tres.lu, torch.from_numpy(b).float())
    assert xt.dtype == torch.float32 and xt.shape == b.shape
    xt = xt.double().numpy()
    ref = np.linalg.solve(t.toarray(), b)
    # against respatpu: fp32 rounding in another order; against numpy: the
    # JAX tests' own 1e-3
    assert np.abs(xt - xj).max() <= 1e-5 * np.abs(xj).max()
    np.testing.assert_allclose(xt, ref, rtol=1e-3, atol=1e-3 * np.abs(ref).max())
    lu64 = bandlu.band_lu(bandlu.csr_to_device_band(t, "fp64", "cpu", p=p)).lu
    x64 = bandlu.band_solve(lu64, torch.from_numpy(b)).numpy()
    assert np.abs(x64 - ref).max() <= 1e-12 * np.abs(ref).max()
    if nrhs > 1:
        # K10's launch plan: SPIKE's tips on an H100 (132 SMs) take 18 tiles
        # of 128 columns with 7 row slots each, V's sweep from its first row
        # too; at most FEW_COLS columns the few-column regime, a slot an SM
        # up to ml + 1; a narrow band 32-column tiles; slots never more than
        # a row's panels and the diagonal, or the rows
        assert bandlu.multi_plan(203, 18, 2304, 0, 132) == (128, 18, 7)
        assert bandlu.multi_plan(203, 18, 2304, 185, 132) == (128, 18, 7)
        assert bandlu.multi_plan(812, 18, 4, 0, 132) == (bandlu.FEW_COLS, 1, 19)
        assert bandlu.multi_plan(812, 18, 1, 0, 132)[0] == bandlu.FEW_COLS
        assert bandlu.multi_plan(8, 3, 300, 0, 132)[0] == 32
        for nb, m, k, r0, sms in ((5, 1, 37, 0, 132), (60, 19, 2304, 30, 80), (3, 9, 9, 2, 4)):
            cols, tiles, slots = bandlu.multi_plan(nb, m, k, r0, sms)
            assert tiles == -(-k // cols) and 1 <= slots <= min(m + 1, nb - r0)
        for lu in (tres.lu, lu64):
            r0 = lu.nb - lu.mu
            bp = torch.zeros((lu.nb * p, nrhs), dtype=lu.policy.accum_dtype)
            bp[r0 * p:] = torch.from_numpy(rng.standard_normal(((lu.nb - r0) * p, nrhs)))
            bits = torch.int64 if bp.dtype == torch.float64 else torch.int32
            full = bandlu.band_sweep_plain(lu, bp, True)
            assert torch.equal(bandlu.band_sweep_multi(lu, bp, True, r0).view(bits),
                               full.view(bits))
            assert not full[:r0 * p].view(bits).any()  # +0, not -0


def test_band_solve_fp64_matches_respatpu_df64():
    a = random_banded(150, 6, 4, seed=4)
    t = csr_from_respatpu(a)
    jres = jband.band_lu(jband.band_to_device(jband.csr_to_band(a, p=32), "df64"))
    tres = bandlu.band_lu(bandlu.csr_to_device_band(t, "fp64", "cpu", p=32))
    b = np.random.default_rng(1).standard_normal(150)
    xj = df_to_f64(jband.band_solve(jres.lu, df_from_f64(b)))
    xt = bandlu.band_solve(tres.lu, torch.from_numpy(b)).numpy()
    ref = np.linalg.solve(t.toarray(), b)
    np.testing.assert_allclose(xt, ref, rtol=1e-10, atol=1e-10 * np.abs(ref).max())
    assert np.abs(xt - xj).max() <= 1e-11 * np.abs(ref).max()  # double-float carries ~48 bits


@pytest.mark.parametrize("direction", ["respatpu_factor_port_solve", "port_factor_respatpu_solve"])
def test_interop_band_roundtrip(direction):
    """A factor made by one package is solved by the other."""
    a = laplacian_2d(16, 12)
    t = csr_from_respatpu(a)
    b = np.random.default_rng(5).standard_normal(a.nrows)
    ref = np.linalg.solve(t.toarray(), b)
    if direction == "respatpu_factor_port_solve":
        for jpol in ("fp32", "df64"):
            jres = jband.band_lu(jband.band_to_device(jband.csr_to_band(a, p=16), jpol))
            lu = band_from_respatpu(jres.lu, device="cpu")
            assert lu.policy.name == ("fp64" if jpol == "df64" else "fp32")
            x = bandlu.band_solve(lu, torch.from_numpy(b).to(lu.policy.accum_dtype))
            tol = 1e-10 if jpol == "df64" else 1e-3
            np.testing.assert_allclose(x.double().numpy(), ref, rtol=tol, atol=tol)
    else:
        for policy in ("fp32", "fp64"):
            tres = bandlu.band_lu(bandlu.csr_to_device_band(t, policy, "cpu", p=16))
            arrays = band_to_numpy(tres.lu)
            jlu = jband.DeviceBand(tres.lu.n, 16, tres.lu.ml, tres.lu.mu,
                                   "df64" if policy == "fp64" else "fp32",
                                   tuple(jnp.asarray(x) for x in arrays))
            if policy == "fp64":
                assert np.abs(df_to_numpy(*arrays) - tres.lu.data.numpy()).max() <= 1e-13
                x = df_to_f64(jband.band_solve(jlu, df_from_f64(b)))
                np.testing.assert_allclose(x, ref, rtol=1e-9, atol=1e-9)
            else:
                x = np.asarray(jband.band_solve(jlu, jnp.asarray(b, jnp.float32)), np.float64)
                np.testing.assert_allclose(x, ref, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("policy", ["fp32", "fp32_ftz", "bf16", "fp64"])
def test_band_solve_transpose(policy):
    """K11's plain version (``band_sweep_t_plain``, both sweeps) against the
    dense A^T solve in every policy, against respatpu's own transposed band
    route (its band factor's CSR through two ``sptrsv`` triangles) in fp32,
    and a subnormal partial under fp32 and fp32_ftz."""
    ra = random_banded(130, 40, 5, seed=6)
    a = csr_from_respatpu(ra)
    lu = bandlu.band_lu(bandlu.csr_to_device_band(a, policy, "cpu", p=16)).lu
    assert lu.ml >= 2 and lu.mu >= 2
    s = np.random.default_rng(7).standard_normal(130)
    z = bandlu.band_solve_transpose(lu, torch.from_numpy(s).to(lu.policy.accum_dtype))
    ref = np.linalg.solve(a.toarray().T, s)
    tol = {"fp64": 1e-10, "bf16": 5e-2}.get(policy, 1e-3)  # the stored factor's precision
    np.testing.assert_allclose(z.double().numpy(), ref, rtol=tol, atol=tol * np.abs(ref).max())
    if policy == "fp32":
        zj = jsolve.BandLuFactorization(ra, "fp32", p=16).solve_transpose(s)
        zt = tsolve.BandLuFactorization(a, "fp32", p=16, device="cpu").solve_transpose(s)
        assert np.abs(zt - zj).max() <= 1e-4 * np.abs(zj).max()
    if policy in ("fp32", "fp32_ftz"):
        # a planted subnormal partial: z0 = s0 / u00 lands at a quarter of the
        # smallest normal; fp32_ftz flushes it (and so all of z), fp32 keeps it
        u00 = abs(float(lu.data[0, 0, lu.ml * lu.p]))
        sp = torch.zeros(130, dtype=torch.float32)
        sp[0] = FP32_MIN_NORMAL / 4 * u00
        z0 = bandlu.band_solve_transpose(lu, sp)
        if policy == "fp32":
            assert 0 < abs(float(z0[0])) < FP32_MIN_NORMAL
        else:
            assert not z0.any()


def test_fp32_ftz_flushes_band_and_rhs():
    """A subnormal band entry is stored as zero and a subnormal right-hand
    side entry is read as zero, so the result equals the one with exact
    zeros in their place; under plain fp32 the entries stay."""
    a = csr_from_respatpu(random_banded(60, 4, 3, seed=9))
    a.data[5] = 1e-40
    ftz = bandlu.csr_to_device_band(a, "fp32_ftz", "cpu", p=16)
    keep = bandlu.csr_to_device_band(a, "fp32", "cpu", p=16)
    assert int((keep.data != 0).sum()) == int((ftz.data != 0).sum()) + 1
    b = np.random.default_rng(3).standard_normal(60)
    b[7] = 1e-40
    lu = bandlu.band_lu(ftz).lu
    x = bandlu.band_solve(lu, torch.from_numpy(b).float())
    a.data[5], b[7] = 0.0, 0.0
    lu0 = bandlu.band_lu(bandlu.csr_to_device_band(a, "fp32", "cpu", p=16)).lu
    x0 = bandlu.band_solve(lu0, torch.from_numpy(b).float())
    assert torch.equal(lu.data, lu0.data) and torch.equal(x, x0)
    tiny = torch.finfo(torch.float32).tiny
    assert not bool(((lu.data != 0) & (lu.data.abs() < tiny)).any())


def test_wrappers_refuse_what_does_not_fit():
    """The band wrappers refuse on every device what their kernels do not
    take, each error naming the argument; K10 (``band_sweep_multi``) and K11
    (``band_sweep_t``) check b's shape, type, device and layout, the block
    size and, for K10, nrhs and first_row; K2 and K11 the inverses."""
    a = csr_from_respatpu(laplacian_2d(8, 8))
    lu = bandlu.band_lu(bandlu.csr_to_device_band(a, "fp32", "cpu", p=16)).lu
    with pytest.raises(ValueError):
        bandlu.band_solve(lu, torch.zeros(63))
    bad = bandlu.DeviceBand(lu.n, lu.p, lu.ml, lu.mu, lu.policy, lu.data.double())
    with pytest.raises(ValueError):
        bandlu.band_sweep(bad, torch.zeros(64), True)
    with pytest.raises(ValueError):
        bandlu.band_lu(bandlu.DeviceBand(lu.n, lu.p, lu.ml + 1, lu.mu, lu.policy, lu.data))
    good = torch.zeros(64, 3)

    def multi(b, forward=True, first_row=0):
        return bandlu.band_sweep_multi(lu, b, forward, first_row)

    def sweep_t(b):
        return bandlu.band_sweep_t(lu, b, True)

    for fn, b, err, match in (
            (multi, good.double(), TypeError, "b must be torch.float32"),
            (multi, good[:-1], ValueError, "b must be contiguous of shape"),
            (multi, torch.zeros(64), ValueError, "nrhs >= 1"),
            (multi, torch.zeros(64, 0), ValueError, "nrhs >= 1"),
            (multi, torch.zeros(3, 64).T, ValueError, "not contiguous"),
            (multi, torch.zeros(64, 3, device="meta"), ValueError, "b is on meta"),
            (sweep_t, torch.zeros(64).double(), TypeError, "b must be torch.float32"),
            (sweep_t, torch.zeros(65), ValueError, "b must be contiguous of shape"),
            (sweep_t, torch.zeros(128)[::2], ValueError, "not contiguous"),
            (sweep_t, torch.zeros(64, device="meta"), ValueError, "b is on meta")):
        with pytest.raises(err, match=match):
            fn(b)
    with pytest.raises(ValueError, match="first_row"):
        multi(good, first_row=lu.nb)
    with pytest.raises(ValueError, match="first_row"):
        multi(good, forward=False, first_row=1)
    with pytest.raises(ValueError, match="first_row"):
        bandlu.band_solve(lu, torch.zeros(64), first_row=1)
    # K2 and K11 apply the inverses of the diagonal triangles: a band without
    # them, or with inverses of another type or shape, is refused, never
    # solved by substitution
    for inv, err, match in ((None, ValueError, "no inverses"),
                            (lu.inv.double(), TypeError, "inverses must be torch.float32"),
                            (lu.inv[:-1].contiguous(), ValueError, "inverses must be contiguous"),
                            (lu.inv.transpose(2, 3), ValueError, "inverses must be contiguous")):
        for sweep in (bandlu.band_sweep, bandlu.band_sweep_t):
            with pytest.raises(err, match=match):
                sweep(dataclasses.replace(lu, inv=inv), torch.zeros(64), True)
    with pytest.raises(ValueError, match="no inverses"):
        bandlu.band_solve_transpose(dataclasses.replace(lu, inv=None), torch.zeros(lu.n))
    with pytest.raises(TypeError, match="inverses must be torch.float64"):  # re-typed, not remade
        bandlu.band_solve(dataclasses.replace(lu, policy=get_policy("fp64"),
                                              data=lu.data.double()), torch.zeros(64).double())
    wide = csr_from_respatpu(random_banded(300, 150, 5, seed=3))
    big = bandlu.band_lu(bandlu.csr_to_device_band(wide, "fp32", "cpu", p=144)).lu
    with pytest.raises(ValueError, match="lu.p"):
        bandlu.band_sweep_multi(big, torch.zeros(big.nb * 144, 2), True)
    with pytest.raises(ValueError, match="lu.p"):
        bandlu.band_solve_transpose(big, torch.zeros(300))
    assert set(bandlu.LAUNCHES.values()) == {0}  # nothing on the CPU counts as a launch


SWEEP_TOL = {"fp32": 2e-5, "fp32_ftz": 2e-5, "bf16": 2e-5, "fp64": 1e-12}


def test_band_lu_inverses_are_the_diagonal_triangles_inverses():
    """``band_lu`` keeps the inverses of every block row's diagonal
    triangles (``lu.inv``: unit lower ``L_rr^-1``, upper ``U_rr^-1``) in the
    accumulator type, flushed under fp32_ftz: each times its triangle is the
    identity, and the sweeps K2 makes of them (``out[r] = D_r^-1 acc``, here
    in torch ops) reproduce ``band_sweep_plain``'s substitution within the
    sweep tolerance, on the card tests' sweep cases in every policy;
    ``with_inverses`` makes the same inverses anew, bit for bit."""
    cases = [(synth.random_banded(100, 30, 6, seed=1), 128),
             (synth.skew_banded(500, 70, 20, 7, seed=2), 16),
             (synth.random_banded(100, 99, 10, seed=4), 16),
             (synth.laplacian_2d(40, 23), 32),
             (synth.random_banded(1000, 300, 9, seed=5), 128)]
    rng = np.random.default_rng(3)
    for a, p in cases:
        for policy, tol in SWEEP_TOL.items():
            lu = bandlu.band_lu(bandlu.csr_to_device_band(a, policy, "cpu", p=p)).lu
            acc = lu.policy.accum_dtype
            assert lu.inv.dtype == acc and lu.inv.shape == (lu.nb, 2, p, p)
            assert lu.inv.is_contiguous()
            assert torch.equal(bandlu.with_inverses(lu).inv, lu.inv)
            d = lu.data[:, :, lu.ml * p:(lu.ml + 1) * p].double()
            lower = torch.tril(d, -1) + torch.eye(p, dtype=torch.float64)
            upper = torch.triu(d)
            eye = torch.eye(p, dtype=torch.float64).expand_as(d)
            ident = 1e-12 if policy == "fp64" else 1e-5
            for k, tri in ((0, lower), (1, upper)):
                got = lu.inv[:, k].double() @ tri
                scale = lu.inv[:, k].double().abs().amax((1, 2)) * tri.abs().amax((1, 2))
                assert bool(((got - eye).abs().amax((1, 2)) <= ident * p * scale).all()), \
                    (policy, p, k)
            if lu.policy.flush_to_zero:
                tiny = torch.finfo(torch.float32).tiny
                assert not bool(((lu.inv != 0) & (lu.inv.abs() < tiny)).any())
            b = torch.from_numpy(rng.standard_normal(lu.nb * p)).to(acc)
            for fwd in (True, False):
                out = torch.zeros_like(b)
                w = lu.ml if fwd else lu.mu
                for r in (range(lu.nb) if fwd else range(lu.nb - 1, -1, -1)):
                    k = min(w, r) if fwd else min(w, lu.nb - 1 - r)
                    row = lu.data[r].to(acc)
                    if fwd:
                        panel, prev = row[:, (lu.ml - k) * p:lu.ml * p], out[(r - k) * p:r * p]
                    else:
                        panel = row[:, (lu.ml + 1) * p:(lu.ml + 1 + k) * p]
                        prev = out[(r + 1) * p:(r + 1 + k) * p]
                    rhs = b[r * p:(r + 1) * p] - (panel @ prev if k else 0)
                    out[r * p:(r + 1) * p] = lu.inv[r, 0 if fwd else 1] @ rhs
                ref = bandlu.band_sweep_plain(lu, b, fwd)
                err = float((out - ref).abs().max() / ref.abs().max())
                assert err <= tol, (policy, p, fwd, err)
