"""The DIA stencil path on the CPU against respatpu on the same inputs: the
diagonal build, the DIA SpMV (the plain version of K9) alone and with its
CSR remainder, ``to_device(fmt="auto")``'s choice, the fp32_ftz flush, the
bf16 accumulation and the byte gate of ``spmv_timed``. The kernel itself is
held to the plain version on a card (tests/test_torch_cuda.py,
chip_smoke.py).

Tolerances are max|y_port - y_ref| / max|y_ref|: fp32 2e-5 (both take x in
fp32 and sum in fp32, in other orders); fp64 against respatpu's double-float
1e-12 and against the host fp64 oracle 1e-14; fp32_ftz equal to respatpu's
ELL path (its DIA path does not flush: R7) on integer-valued inputs with
subnormal entries, whose sums are exact in any order; bf16 (values rounded
to bf16, x and the sums fp32) 1e-6 of the oracle on those values, where
respatpu's DIA, which rounds x to bf16 and sums in bf16 (R10), is further
off than 2^-10."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from respatpu import precision as jprec
from respatpu.bench.synth import laplacian_2d, laplacian_3d, random_banded
from respatpu.formats import COOMatrix as JCOO
from respatpu.formats import coo_to_csr as jcoo_to_csr
from respatpu.kernels import dia as jdia
from respatpu.kernels import spmv as jspmv
from respatpu.kernels.gsell import gsell_to_device, spmv_gsell

from respatpu_torch import solve, timing
from respatpu_torch.formats import COOMatrix, CSRMatrix, coo_to_csr
from respatpu_torch.interop import csr_from_respatpu, df_to_numpy
from respatpu_torch.kernels import dia as D
from respatpu_torch.kernels.spmv import (DeviceCsr, DeviceDia, spmv, spmv_csr_reference,
                                         spmv_sol_bytes, to_device)


def _rel(y, ref):
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(y - ref).max() / max(np.abs(ref).max(), 1e-300))


def _port(a, policy, x, fmt="dia"):
    dev = to_device(csr_from_respatpu(a), policy, "cpu", fmt=fmt)
    return spmv(dev, torch.from_numpy(np.asarray(x, np.float64)).to(dev.policy.accum_dtype))


def _rect(m=300, n=380, seed=6):
    """Rectangular: five full diagonals (offsets -2 .. 100) and stragglers
    (respatpu's padded x takes at most nrows + the largest |offset| columns)."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for off in (-2, 0, 1, 7, 100):
        r = np.arange(max(0, -off), min(m, n - off))
        rows.append(r)
        cols.append(r + off)
    rows.append(rng.integers(0, m, 40))
    cols.append(rng.integers(0, n, 40))
    r, c = np.concatenate(rows), np.concatenate(cols)
    return jcoo_to_csr(JCOO((m, n), r.astype(np.int32), c.astype(np.int32),
                            rng.uniform(-1.0, 1.0, r.size)))


def _stencil_with_stragglers(nx=30, ny=25, k=60, seed=8):
    """A 5-point Laplacian and k entries off its diagonals: DIA by the auto
    rule, with a remainder."""
    a = laplacian_2d(nx, ny)
    rng = np.random.default_rng(seed)
    coo = a.tocoo()
    n = a.nrows
    r = np.concatenate([coo.row, rng.integers(0, n, k)])
    c = np.concatenate([coo.col, rng.integers(0, n, k)])
    v = np.concatenate([coo.val, rng.uniform(-0.5, 0.5, k)])
    return jcoo_to_csr(JCOO((n, n), r.astype(np.int32), c.astype(np.int32), v))


@pytest.mark.parametrize("name", ["laplacian_2d", "stragglers", "rect"])
def test_build_dia_matches_respatpu(name):
    a = {"laplacian_2d": lambda: laplacian_2d(20, 17),
         "stragglers": _stencil_with_stragglers, "rect": _rect}[name]()
    j, t = jdia.build_dia(a), D.build_dia(csr_from_respatpu(a))
    assert np.array_equal(t.offsets, j.offsets) and t.nnz_dia == j.nnz_dia
    assert t.diags.shape == j.diags.shape and np.array_equal(t.diags, j.diags)
    assert (t.remainder is None) == (j.remainder is None)
    if j.remainder is not None:
        for field in ("indptr", "indices", "data"):
            assert np.array_equal(getattr(t.remainder, field), getattr(j.remainder, field))
    offs, cov = D.dia_coverage(csr_from_respatpu(a))
    joffs, jcov = jdia.dia_coverage(a)
    assert np.array_equal(offs, joffs) and cov == jcov
    if name == "laplacian_2d":  # the 5-point stencil, every entry on a diagonal
        assert len(t.offsets) == 5 and t.remainder is None and t.nnz_dia == a.nnz


def test_dia_spmv_fp32(rng):
    a = laplacian_3d(9, 8, 7)
    x = rng.standard_normal(a.shape[1])
    jy = np.asarray(jdia.dia_spmv(jdia.dia_to_device(jdia.build_dia(a), "fp32"),
                                  jnp.asarray(x, jnp.float32)), np.float64)
    y = _port(a, "fp32", x.astype(np.float32))
    assert y.dtype == torch.float32
    ref = spmv_csr_reference(csr_from_respatpu(a), x)
    assert _rel(y, jy) <= 2e-5 and _rel(y, ref) <= 2e-5


def test_dia_spmv_fp64(rng):
    a = laplacian_2d(13, 11)
    x = rng.standard_normal(a.shape[1])
    jy = jdia.dia_spmv(jdia.dia_to_device(jdia.build_dia(a), "df64"), jprec.df_from_f64(x))
    y = _port(a, "fp64", x)
    assert _rel(y, df_to_numpy(jy.hi, jy.lo)) <= 1e-12
    assert _rel(y, spmv_csr_reference(csr_from_respatpu(a), x)) <= 1e-14


@pytest.mark.parametrize("policy", ["fp32", "fp64"])
def test_hybrid_with_remainder(rng, policy):
    """Partial diagonal coverage and stragglers: the remainder summed by the
    DIA kernel too; a rectangular matrix too. Each remainder row is the
    diagonals' sum plus its entries' products added one after the other in
    CSR order from +0 (checked in numpy, one rounding a step); the other
    rows are the diagonals' sum alone; tile_ptr gives each tile of TILE rows
    its remainder rows."""
    for a in (_stencil_with_stragglers(), _stencil_with_stragglers(20, 18, 30, seed=9), _rect()):
        jdev = jspmv.to_device(a, "df64" if policy == "fp64" else "fp32", fmt="dia")
        assert isinstance(jdev, jspmv.DeviceHybrid) and jdev.rem is not None
        x = rng.standard_normal(a.shape[1])
        t = csr_from_respatpu(a)
        tdev = to_device(t, policy, "cpu", fmt="dia")
        assert isinstance(tdev, DeviceDia) and tdev.rem is not None
        xt = torch.from_numpy(x).to(tdev.policy.accum_dtype)
        y = spmv(tdev, xt)
        ref = spmv_csr_reference(t, x)
        if policy == "fp64":
            jy = jspmv.spmv(jdev, jprec.df_from_f64(x))
            assert _rel(y, df_to_numpy(jy.hi, jy.lo)) <= 1e-12 and _rel(y, ref) <= 1e-14
        else:
            jy = np.asarray(jspmv.spmv(jdev, jnp.asarray(x, jnp.float32)), np.float64)
            assert _rel(y, jy) <= 2e-5 and _rel(y, ref) <= 2e-5
        r = D.build_dia(t).remainder
        y_dia = D.dia_spmv_plain(dataclasses.replace(tdev, rem=None), xt).numpy()
        want = y_dia.copy()
        dt = y_dia.dtype.type
        for i in np.flatnonzero(np.diff(r.indptr)):
            s = dt(0)
            for e in range(r.indptr[i], r.indptr[i + 1]):
                s = dt(s + dt(dt(r.data[e]) * xt.numpy()[r.indices[e]]))
            want[i] = dt(y_dia[i] + s)
        assert np.array_equal(y.numpy(), want)
        rows, tp = tdev.rem.rows.numpy(), tdev.rem.tile_ptr.numpy()
        assert np.array_equal(rows, np.flatnonzero(np.diff(r.indptr)))
        assert tp.size == -(-t.nrows // D.TILE) + 1 and tp[0] == 0 and tp[-1] == rows.size
        assert all(((rows[tp[k]:tp[k + 1]] // D.TILE) == k).all() for k in range(tp.size - 1))


def test_auto_format_selection():
    """respatpu's rule: DIA when diagonals of occupancy >= 0.25 hold >= 90%
    of the entries and store at most 3 values an entry; the port's other
    format is CSR where respatpu's are its TPU layouts."""
    cases = {"stencil_2d": laplacian_2d(30, 30), "stencil_3d": laplacian_3d(6, 5, 4),
             "scattered": random_banded(500, 200, 4, seed=1),
             "banded": random_banded(300, 6, 8, seed=7), "stragglers": _stencil_with_stragglers(),
             "rect": _rect()}
    for name, a in cases.items():
        jdia_chosen = isinstance(jspmv.to_device(a, "fp32", fmt="auto"), jspmv.DeviceHybrid)
        dev = to_device(csr_from_respatpu(a), "fp32", "cpu")  # fmt="auto" is the default
        assert isinstance(dev, DeviceDia) == jdia_chosen, name
        assert isinstance(dev, DeviceCsr) != jdia_chosen, name
    assert isinstance(to_device(csr_from_respatpu(cases["stencil_2d"]), "fp32", "cpu"),
                      DeviceDia)
    assert isinstance(to_device(csr_from_respatpu(cases["scattered"]), "fp32", "cpu"), DeviceCsr)
    assert isinstance(to_device(csr_from_respatpu(cases["stencil_2d"]), "fp32", "cpu",
                                fmt="csr"), DeviceCsr)


def _with_subnormals(a, rng):
    v = rng.integers(-4, 5, a.nnz).astype(np.float64)
    v[::5] = 1e-40
    x = rng.integers(-3, 4, a.shape[1]).astype(np.float64)
    x[::7] = -1e-40
    return type(a)(a.shape, a.indptr, a.indices, v), x


def test_dia_fp32_ftz_against_ell(rng):
    """R7: respatpu's DIA does not flush, its ELL path does; the port's DIA
    equals the ELL path, and without the flush the subnormal products stay."""
    for a in (laplacian_2d(25, 20), random_banded(300, 6, 8, seed=7)):
        s, xs = _with_subnormals(a, rng)
        ref = np.asarray(jspmv.spmv(jspmv.to_device(s, "fp32_ftz", fmt="ell"),
                                    xs.astype(np.float32)), np.float64)
        got = _port(s, "fp32_ftz", xs).double().numpy()
        np.testing.assert_array_equal(got, ref)
        assert not np.array_equal(_port(s, "fp32", xs).double().numpy(),
                                  spmv_csr_reference(csr_from_respatpu(s), xs))


def test_dia_bf16_accumulates_in_fp32(rng):
    """R10: bf16 values, x and the sums in fp32 (the port's policy, as its
    CSR kernel and respatpu's GSELL do); respatpu's DIA rounds x to bf16 and
    sums in bf16, and lands further from the oracle."""
    a = laplacian_2d(40, 30)
    vb = np.asarray(torch.from_numpy(rng.uniform(0.5, 1.5, a.nnz)).float().bfloat16().double())
    a = type(a)(a.shape, a.indptr, a.indices, vb)  # bf16-representable values
    x = rng.standard_normal(a.shape[1]).astype(np.float32).astype(np.float64)
    ref = spmv_csr_reference(csr_from_respatpu(a), x)
    y = _port(a, "bf16", x)
    assert y.dtype == torch.float32 and _rel(y, ref) <= 1e-6
    gsell = np.asarray(spmv_gsell(gsell_to_device(a, "bf16"), x.astype(np.float32)), np.float64)
    assert _rel(y, gsell) <= 2e-5
    jy = np.asarray(jdia.dia_spmv(jdia.dia_to_device(jdia.build_dia(a), "bf16"),
                                  jnp.asarray(x, jnp.float32)), np.float64)
    assert _rel(jy, ref) > 2.0 ** -10 > 100 * _rel(y, ref)


def test_byte_gate_on_dia_upload(monkeypatch):
    """``spmv_timed`` gates a DIA product against the DIA byte model: the
    diagonals, x and y, and the remainder's rows, row pointer, columns and
    values; not the CSR model, which counts an index an entry."""
    seen = []
    real = solve.check_plausible
    monkeypatch.setattr(solve, "check_plausible",
                        lambda tm, nbytes, bw: seen.append(nbytes) or real(tm, nbytes, bw))
    for a, rem in ((laplacian_2d(60, 50), False), (_stencil_with_stragglers(), True)):
        t = csr_from_respatpu(a)
        dev = to_device(t, "fp32", "cpu")
        assert isinstance(dev, DeviceDia) and (dev.rem is not None) == rem
        m, n = t.shape
        want = dev.ndiag * m * 4 + (m + n) * 4
        if rem:
            nr = int(np.count_nonzero(np.diff(D.build_dia(t).remainder.indptr)))
            assert dev.rem.nrows == nr
            want += nr * 4 + (nr + 1) * 8 + dev.rem.nnz * 8
        assert spmv_sol_bytes(dev, 4) == want
        csr = timing.spmv_csr_sol_bytes(m, n, t.nnz, 4, 4)
        assert spmv_sol_bytes(to_device(t, "fp32", "cpu", fmt="csr"), 4) == csr
        if not rem:
            assert want < csr
        seen.clear()
        x = np.random.default_rng(0).standard_normal(n)
        y, tm = solve.spmv_timed(t, x, "fp32", device="cpu", reps=2)
        assert seen == [want] and tm.floor_s == pytest.approx(
            want / (1.05 * timing.device_bandwidth("cpu")))
        assert _rel(y, spmv_csr_reference(t, x)) <= 2e-5


def test_dia_edges():
    """No diagonal kept (everything in the remainder), an empty matrix, and
    the wrapper's checks."""
    rng = np.random.default_rng(3)
    m = 200
    rows, cols = rng.integers(0, m, 300), rng.integers(0, m, 300)
    a = coo_to_csr(COOMatrix((m, m), rows.astype(np.int32), cols.astype(np.int32),
                             rng.standard_normal(300)))
    dev = to_device(a, "fp64", "cpu", fmt="dia")
    assert dev.ndiag == 0 and dev.rem.nnz == a.nnz
    x = torch.from_numpy(rng.standard_normal(m))
    assert _rel(spmv(dev, x), spmv_csr_reference(a, x.numpy())) <= 1e-14
    empty = CSRMatrix((0, 5), np.zeros(1, np.int64), np.zeros(0, np.int32), np.zeros(0))
    d0 = to_device(empty, "fp32", "cpu", fmt="dia")
    assert spmv(d0, torch.zeros(5)).shape == (0,)
    lap = to_device(csr_from_respatpu(laplacian_2d(6, 5)), "fp32", "cpu")
    with pytest.raises(TypeError):
        D.dia_spmv(lap, torch.zeros(30, dtype=torch.float64))
    with pytest.raises(ValueError):
        D.dia_spmv(lap, torch.zeros(29))
    with pytest.raises(ValueError):  # a remainder whose row pointer is not int64
        D.dia_spmv(dataclasses.replace(dev, rem=dataclasses.replace(dev.rem, ptr=dev.rem.ptr.int())),
                   x)
