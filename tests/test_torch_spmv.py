"""The port's SpMV (plain version, on the CPU) against respatpu's GSELL
Pallas kernels (interpret mode off-TPU) on the same matrices and x.

Tolerances are max|y_port - y_ref| / max|y_ref|:

* fp32, bf16: 2e-5, as in tests/test_gsell.py. Both sides take x in fp32
  and sum in fp32; only the order of the sums differs. For bf16 the matrix
  is first rounded to bf16-representable values, because respatpu's GSELL
  keeps the entries it spills in fp32 (gsell.py:565) while its packed
  entries are bf16; the port's own rounding is checked on its own.
* fp64 vs df64 GSELL: 1e-12, df64 carrying ~49 bits.
* fp64 vs the host fp64 oracle: 1e-14.
* fp32_ftz vs respatpu's ELL path (the JAX path that flushes; GSELL leaves
  the flush to the TPU): equal, on integer-valued inputs with subnormal
  entries in A and x, whose sums are exact in any order.
"""
import os
import re

import numpy as np
import pytest
import torch

from respatpu import precision as jprec
from respatpu.formats import CSRMatrix as JCSR
from respatpu.kernels import spmv as jspmv
from respatpu.kernels.gsell import gsell_to_device, spmv_gsell
from respatpu.kernels.gsell_df import gsell_df_to_device, spmv_gsell_df

from respatpu_torch.bench import synth
from respatpu_torch.formats import COOMatrix, CSRMatrix, coo_to_csr
from respatpu_torch.interop import df_to_numpy
from respatpu_torch.kernels.spmv import (CAP, MAX_ROWS, DeviceDia, row_blocks, spmv,
                                         spmv_csr_reference, spmv_plain, to_device)


def _rect_empty_rows():
    rng = np.random.default_rng(11)
    m, n, nnz = 900, 1700, 7000
    rows = rng.integers(0, m, nnz)
    rows = rows[rows % 7 != 3]  # every 7th row from 3 on stays empty
    cols = rng.integers(0, n, rows.size)
    return coo_to_csr(COOMatrix((m, n), rows.astype(np.int32),
                                cols.astype(np.int32), rng.standard_normal(rows.size)))


def _wide_row():
    # 48 entries a row keeps respatpu's hub split (gsell.py:244-263) off, so
    # the 1500-wide row goes through GSELL's virtual rows and not through a
    # 1500-step df64 spill chain that takes minutes to compile
    rng = np.random.default_rng(12)
    n = 2000
    rows = np.repeat(np.arange(n), 48)
    cols = rng.integers(0, n, rows.size)
    wide = rng.choice(n, 1500, replace=False)
    r = np.concatenate([rows, np.full(1500, 17)])
    c = np.concatenate([cols, wide])
    return coo_to_csr(COOMatrix((n, n), r.astype(np.int32), c.astype(np.int32),
                                rng.standard_normal(r.size)))


MATRICES = {
    "mesh_fem_3d": lambda: synth.mesh_fem_3d(3000, seed=3),
    "circuit_hubs": lambda: synth.circuit_like(4000, 6, seed=4, hub_fraction=1e-3),
    "powerlaw": lambda: synth.powerlaw(3000, 8, seed=5),
    "rect_empty_rows": _rect_empty_rows,
    "wide_row_1500": _wide_row,
}
CHECKS = ["fp32_gsell", "bf16_gsell", "fp64_gsell_df", "fp64_oracle", "fp32_ftz_ell"]


def _jcsr(a: CSRMatrix) -> JCSR:
    return JCSR(a.shape, a.indptr.astype(np.int32), a.indices.copy(), a.data.copy())


def _port(a: CSRMatrix, policy: str, x: np.ndarray) -> np.ndarray:
    dev = to_device(a, policy, "cpu", fmt="csr")
    xt = torch.from_numpy(np.asarray(x, np.float64)).to(dev.policy.accum_dtype)
    y = spmv(dev, xt)
    assert torch.equal(y, spmv_plain(dev, xt))  # the CPU wrapper is the plain version
    assert y.dtype == dev.policy.accum_dtype
    return y.double().numpy()


def _rel(y, ref):
    return np.abs(y - ref).max() / max(np.abs(ref).max(), 1e-300)


def _with_subnormals(a: CSRMatrix, rng):
    """Integer values in [-4, 4] with every 5th value 1e-40 (subnormal in
    fp32); x likewise with every 7th entry subnormal."""
    v = rng.integers(-4, 5, a.nnz).astype(np.float64)
    v[::5] = 1e-40
    x = rng.integers(-3, 4, a.shape[1]).astype(np.float64)
    x[::7] = -1e-40
    return CSRMatrix(a.shape, a.indptr, a.indices, v), x


@pytest.mark.parametrize("check", CHECKS)
@pytest.mark.parametrize("name", list(MATRICES))
def test_port_spmv_matches_respatpu(name, check):
    a = MATRICES[name]()
    rng = np.random.default_rng(7)
    x = rng.standard_normal(a.shape[1])
    if check in ("fp32_gsell", "bf16_gsell"):
        policy = check.split("_")[0]
        if policy == "bf16":
            vb = to_device(a, "bf16", "cpu").vals
            assert torch.equal(vb, torch.from_numpy(a.data.astype(np.float32)).bfloat16())
            a = CSRMatrix(a.shape, a.indptr, a.indices, vb.double().numpy())
        x32 = x.astype(np.float32)
        ref = np.asarray(spmv_gsell(gsell_to_device(_jcsr(a), policy), x32), np.float64)
        assert _rel(_port(a, policy, x32), ref) <= 2e-5
    elif check == "fp64_gsell_df":
        yd = spmv_gsell_df(gsell_df_to_device(_jcsr(a)), jprec.df_from_f64(x))
        assert _rel(_port(a, "fp64", x), df_to_numpy(*yd)) <= 1e-12
    elif check == "fp64_oracle":
        assert _rel(_port(a, "fp64", x), spmv_csr_reference(a, x)) <= 1e-14
    else:
        s, xs = _with_subnormals(a, rng)
        ref = np.asarray(jspmv.spmv(jspmv.to_device(_jcsr(s), "fp32_ftz", fmt="ell"),
                                    xs.astype(np.float32)), np.float64)
        got = _port(s, "fp32_ftz", xs)
        np.testing.assert_array_equal(got, ref)
        # the flush is what makes them equal: without it the subnormal
        # products would be kept
        assert not np.array_equal(_port(s, "fp32", xs), spmv_csr_reference(s, xs))


def test_ftz_flushes_products():
    # normal value and x whose fp32 product (1e-40) is subnormal: kept under
    # fp32, flushed under fp32_ftz
    a = CSRMatrix((2, 2), np.array([0, 1, 2], np.int64), np.array([0, 1], np.int32),
                  np.array([1e-20, 1.0]))
    x = np.array([1e-20, 2.0])
    assert _port(a, "fp32", x)[0] > 0
    np.testing.assert_array_equal(_port(a, "fp32_ftz", x), [0.0, 2.0])


def test_to_device_formats():
    a = synth.laplacian_3d(4, 4, 4)
    dev = to_device(a, "fp32", "cpu", fmt="csr")
    assert dev.indptr.dtype == torch.int64 and dev.indices.dtype == torch.int32
    assert dev.vals.dtype == torch.float32 and dev.shape == a.shape
    # a stencil: "auto" and "dia" give the DIA path (kernels/dia.py), with
    # every entry on its seven diagonals
    for fmt in ("auto", "dia"):
        dia = to_device(a, "fp32", "cpu", fmt=fmt)
        assert isinstance(dia, DeviceDia) and dia.rem is None and dia.ndiag == 7
        assert dia.shape == a.shape and dia.diags.dtype == torch.float32
    for fmt in ("gsell", "bell", "rgell", "ell"):
        with pytest.raises(ValueError):
            to_device(a, "fp32", "cpu", fmt=fmt)
    assert to_device(a, "df64", "cpu", fmt="csr").vals.dtype == torch.float64
    assert to_device(a, "bf16", "cpu", fmt="csr").vals.dtype == torch.bfloat16


# --- the kernel's row partition (a pure function of the row pointer) --------

PARTITION_GENERATORS = {
    "fem": lambda seed: synth.mesh_fem_3d(2500, seed=seed),
    "circuit": lambda seed: synth.circuit_like(3000, 5, seed=seed),
    "hub_rows": lambda seed: synth.circuit_like(3000, 4, seed=seed, hub_fraction=4e-3,
                                                hub_degree=180),
}
# the kernel's sizes, and small ones that give these matrices long rows,
# row-bound blocks and many blocks
SIZES = [(CAP, MAX_ROWS), (64, 256), (96, 8)]


def _check_partition(indptr, cap, max_rows):
    """Blocks cover every row once and in order; a block holds at most
    ``cap`` entries unless it is one long row, and at most ``max_rows``."""
    indptr = np.asarray(indptr, np.int64)
    m = indptr.size - 1
    b = row_blocks(indptr, cap, max_rows)
    assert b.dtype == np.int32 and b[0] == 0 and b[-1] == m
    rows = np.diff(b)
    assert (rows > 0).all() if m else b.size == 1
    entries = indptr[b[1:]] - indptr[b[:-1]]
    assert (rows <= max_rows).all()
    assert ((entries <= cap) | (rows == 1)).all()
    # greedy: no block could have taken the next row as well
    nxt = np.minimum(b[1:-1].astype(np.int64) + 1, m)
    fits = (indptr[nxt] - indptr[b[:-2]] <= cap) & (rows[:-1] < max_rows)
    assert not fits.any()
    return b


def _spmv_by_blocks(a, x, b):
    """y summed block by block: what a cover of the rows must reproduce."""
    y = np.full(a.shape[0], np.nan)
    for r0, r1 in zip(b[:-1], b[1:]):
        for r in range(r0, r1):
            s, e = a.indptr[r], a.indptr[r + 1]
            y[r] = np.dot(a.data[s:e], x[a.indices[s:e]])
    return y


@pytest.mark.parametrize("sizes", SIZES, ids=lambda s: f"cap{s[0]}_rows{s[1]}")
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("gen", list(PARTITION_GENERATORS))
def test_row_blocks_cover_rows_within_sizes(gen, seed, sizes):
    a = PARTITION_GENERATORS[gen](seed)
    b = _check_partition(a.indptr, *sizes)
    x = np.random.default_rng(seed).standard_normal(a.shape[1])
    np.testing.assert_array_equal(_spmv_by_blocks(a, x, b), spmv_csr_reference(a, x))
    if sizes == (CAP, MAX_ROWS):
        dev = to_device(a, "fp32", "cpu")
        assert dev.row_blocks.dtype == torch.int32 and dev.row_blocks.device.type == "cpu"
        np.testing.assert_array_equal(dev.row_blocks.numpy(), b)
    elif gen == "hub_rows":
        lens = np.diff(a.indptr)
        assert (lens > sizes[0]).any()  # the long-row case is really reached


def _indptr(lens):
    return np.concatenate([[0], np.cumsum(np.asarray(lens, np.int64))])


EDGES = {
    "no_rows": ([], [0]),
    "one_empty_row": ([0], [0, 1]),
    "one_row": ([5], [0, 1]),
    "rows_no_entries": ([0] * (2 * MAX_ROWS + 3), [0, MAX_ROWS, 2 * MAX_ROWS, 2 * MAX_ROWS + 3]),
    "row_of_cap": ([3, CAP, 3], [0, 1, 2, 3]),
    "row_of_cap_alone": ([CAP], [0, 1]),
    "row_of_cap_plus_1": ([3, CAP + 1, 3], [0, 1, 2, 3]),
    "cap_filled_exactly": ([CAP // 2, CAP // 2, 1], [0, 2, 3]),
    "empty_run_after_full_block": ([CAP] + [0] * (MAX_ROWS + 5) + [2],
                                   [0, MAX_ROWS, MAX_ROWS + 7]),
    "short_last_block": ([8] * (MAX_ROWS + 1), [0, MAX_ROWS, MAX_ROWS + 1]),
}


@pytest.mark.parametrize("name", list(EDGES))
def test_row_blocks_edges(name):
    lens, want = EDGES[name]
    b = _check_partition(_indptr(lens), CAP, MAX_ROWS)
    assert b.tolist() == want


EDGE_SHAPES = list(synth.row_block_edges(CAP, MAX_ROWS))


@pytest.mark.parametrize("policy", ["fp32", "fp64"])
@pytest.mark.parametrize("name", EDGE_SHAPES)
def test_edge_shapes_on_the_cpu(name, policy):
    """The shapes the card's checks use: partitioned within the sizes, and
    the plain version (the CPU wrapper) against the host oracle."""
    a = synth.row_block_edges(CAP, MAX_ROWS)[name]
    b = _check_partition(a.indptr, CAP, MAX_ROWS)
    x = np.random.default_rng(3).standard_normal(a.shape[1]) + 1.0
    np.testing.assert_array_equal(_spmv_by_blocks(a, x, b), spmv_csr_reference(a, x))
    ref = spmv_csr_reference(a, x)
    assert _rel(_port(a, policy, x), ref) <= (1e-14 if policy == "fp64" else 2e-5)
    if name == "row_cap_and_cap+1":
        assert {CAP, CAP + 1} <= set(np.diff(a.indptr[b]).tolist())


def test_to_device_carries_row_blocks_of_empty_matrices():
    for shape, lens in (((0, 4), []), ((5, 4), [0] * 5)):
        a = CSRMatrix(shape, _indptr(lens), np.zeros(0, np.int32), np.zeros(0))
        dev = to_device(a, "fp64", "cpu")
        assert dev.row_blocks.tolist() == ([0, shape[0]] if shape[0] else [0])
        y = spmv(dev, torch.ones(4, dtype=torch.float64))
        assert y.shape == (shape[0],) and bool((y == 0).all())


def test_partition_sizes_match_the_kernel_source():
    src = os.path.join(os.path.dirname(os.path.abspath(synth.__file__)), os.pardir,
                       "kernels", "csrc", "spmv_csr.cu")
    with open(src) as f:
        text = f.read()
    threads = int(re.search(r"#define RESPA_SPMV_THREADS (\d+)", text).group(1))
    per_thread = int(re.search(r"#define RESPA_SPMV_PER_THREAD (\d+)", text).group(1))
    assert "kCap = kThreads * kPerThread" in text and "kMaxRows = kThreads" in text
    assert (CAP, MAX_ROWS) == (threads * per_thread, threads)
    assert "atomic" not in text.split("#include", 1)[1]  # fixed-order sums only
