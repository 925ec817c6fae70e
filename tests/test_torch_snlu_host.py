"""The multifrontal path's host layer (``respatpu_torch.analysis``,
``kernels.snlu``, the host half of ``kernels.snlu_device``) against
respatpu's on the same seeded matrices: orderings, symbolic fill, matching,
supernode partition and frontal plan, array for array. respatpu's side is
numpy and its native host library throughout: no JAX computation runs here."""
import numpy as np
import pytest

import respatpu.analysis as janalysis
from respatpu.bench.synth import circuit_like, laplacian_2d, mesh_fem_3d, powerlaw
from respatpu.kernels import snlu as jsnlu
from respatpu.kernels.snlu_device import _pad_dim as j_pad_dim
from respatpu.kernels.snlu_device import build_frontal_plan as j_build_frontal_plan

from respatpu_torch import analysis
from respatpu_torch.interop import (csr_from_respatpu, partition_from_respatpu,
                                    plan_from_respatpu)
from respatpu_torch.io import native
from respatpu_torch.kernels import snlu, snlu_device

MATRICES = {
    "mesh_fem_3d": lambda: mesh_fem_3d(300, avg_degree=10.0, seed=3),
    "circuit_weak": lambda: circuit_like(400, 5, seed=4),
    "circuit_dominant": lambda: circuit_like(350, 5, seed=4, diag="dominant"),
    "laplacian_2d": lambda: laplacian_2d(15, 12),
    "powerlaw": lambda: powerlaw(260, 4, seed=6),
}
NAMES = list(MATRICES)


@pytest.fixture(autouse=True)
def host_library():
    """Array-for-array equality holds between the two native libraries; the
    packages' Python fallbacks are other algorithms."""
    if not native.available():
        pytest.skip("no host C++ compiler for the port's host library")


@pytest.fixture(scope="module")
def pairs():
    """name -> (respatpu matrix, port matrix)."""
    out = {}
    for name, make in MATRICES.items():
        a = make()
        out[name] = (a, csr_from_respatpu(a))
    return out


@pytest.fixture(scope="module")
def analysed(pairs):
    """name -> (respatpu partition, port partition), both with matching on the
    unsymmetric patterns as ``factorize`` would."""
    out = {}
    for name, (a, t) in pairs.items():
        if janalysis.structural_symmetry(a) < 0.9:
            a = janalysis.apply_matching_scaling(a, *janalysis.weighted_matching_scaling(a)[:3])
            t = analysis.apply_matching_scaling(t, *analysis.weighted_matching_scaling(t)[:3])
        out[name] = (jsnlu.analyze_supernodes(a), snlu.analyze_supernodes(t))
    return out


def _same_csr(j, t):
    np.testing.assert_array_equal(j.indptr, t.indptr)
    assert j.indices.tobytes() == t.indices.astype(j.indices.dtype).tobytes()
    assert j.data.tobytes() == t.data.tobytes()


@pytest.mark.parametrize("method", ["amd", "nd", "fillauto"])
@pytest.mark.parametrize("name", NAMES)
def test_fill_orderings_match_respatpu(pairs, name, method):
    a, t = pairs[name]
    pj, pt = janalysis.ordering(a, method), analysis.ordering(t, method)
    np.testing.assert_array_equal(pj, pt)
    assert sorted(pt.tolist()) == list(range(a.nrows))


def test_nd_ordering_takes_the_separator_path(monkeypatch):
    """fillauto picks nested dissection only from 20,000 rows; ask for it on
    a mesh large enough for separators to be cut."""
    a = mesh_fem_3d(3000, seed=9)
    t = csr_from_respatpu(a)
    pj, pt = janalysis.nd_ordering(a, leaf_size=64), analysis.nd_ordering(t, leaf_size=64)
    np.testing.assert_array_equal(pj, pt)
    assert not np.array_equal(pt, analysis.mindeg_ordering(t))


@pytest.mark.parametrize("name", NAMES)
def test_symbolic_fill_matches_respatpu(pairs, name):
    a, t = pairs[name]
    fj, ft = janalysis.symbolic_fill_lu(a), analysis.symbolic_fill_lu(t)
    _same_csr(fj, ft)
    assert ft.indptr.dtype == np.int64 and ft.nnz >= t.nnz
    # A's values sit at their positions, zeros at the fill
    dense = np.zeros(t.shape)
    rows = np.repeat(np.arange(t.nrows), ft.row_lengths())
    dense[rows, ft.indices] = ft.data
    np.testing.assert_array_equal(dense, t.toarray())


@pytest.mark.parametrize("name", ["circuit_dominant"])
def test_symbolic_fill_without_the_native_library(pairs, name, monkeypatch):
    """The row-merge fallback fills a symmetric pattern like the native
    elimination-tree routine, and an unsymmetric one inside it."""
    _, t = pairs[name]
    fast = analysis.symbolic_fill_lu(t)
    monkeypatch.setattr(analysis, "_USE_NATIVE", False)
    slow = analysis.symbolic_fill_lu(t)
    key = lambda f: set(zip(np.repeat(np.arange(f.nrows), f.row_lengths()).tolist(),  # noqa: E731
                            f.indices.tolist()))
    if analysis.structural_symmetry(t) == 1.0:
        assert key(slow) == key(fast)
    else:
        assert key(slow) <= key(fast)


@pytest.mark.parametrize("name", NAMES)
def test_matching_and_scaling_match_respatpu(pairs, name):
    a, t = pairs[name]
    cj, drj, dcj, okj = janalysis.weighted_matching_scaling(a)
    ct, drt, dct, okt = analysis.weighted_matching_scaling(t)
    np.testing.assert_array_equal(cj, ct)
    assert drj.tobytes() == drt.tobytes() and dcj.tobytes() == dct.tobytes() and okj == okt
    sj = janalysis.apply_matching_scaling(a, cj, drj, dcj)
    st = analysis.apply_matching_scaling(t, ct, drt, dct)
    _same_csr(sj, st)
    # the matched entries are on the diagonal at magnitude ~1 after the scaling
    diag = np.abs(st.toarray().diagonal())
    assert okt and diag.min() > 0.05 and np.abs(st.data).max() <= 1.0 + 1e-12


def test_matching_flags_a_structurally_singular_matrix():
    a = csr_from_respatpu(laplacian_2d(4, 4))
    keep = a.indices != 3  # no entry in column 3: no perfect matching
    rows = np.repeat(np.arange(16), a.row_lengths())[keep]
    from respatpu_torch.formats import COOMatrix, coo_to_csr
    s = coo_to_csr(COOMatrix((16, 16), rows.astype(np.int32), a.indices[keep], a.data[keep]))
    cperm, dr, dc, ok = analysis.weighted_matching_scaling(s)
    assert not ok and cperm.tolist() == list(range(16))
    assert np.isfinite(dr).all() and np.isfinite(dc).all()
    with pytest.raises(ValueError, match="square"):
        analysis.weighted_matching_scaling(coo_to_csr(COOMatrix(
            (2, 3), np.array([0, 1], np.int32), np.array([0, 2], np.int32), np.ones(2))))


@pytest.mark.parametrize("amalg", [0, 32])
@pytest.mark.parametrize("name", NAMES)
def test_analyze_supernodes_matches_respatpu(pairs, name, amalg):
    a, t = pairs[name]
    pj = jsnlu.analyze_supernodes(a, amalg=amalg)
    pt = snlu.analyze_supernodes(t, amalg=amalg)
    np.testing.assert_array_equal(pj.perm, pt.perm)
    np.testing.assert_array_equal(pj.snode_ptr, pt.snode_ptr)
    np.testing.assert_array_equal(pj.sn_parent, pt.sn_parent)
    _same_csr(pj.filled, pt.filled)
    assert len(pj.rowstruct) == len(pt.rowstruct) and len(pj.levels) == len(pt.levels)
    for rj, rt in zip(pj.rowstruct, pt.rowstruct):
        np.testing.assert_array_equal(rj, rt)
    for lj, lt in zip(pj.levels, pt.levels):
        np.testing.assert_array_equal(lj, lt)
    assert pj.fill_nnz == pt.fill_nnz and pt.nsn == pj.nsn
    np.testing.assert_array_equal(pj.front_sizes(), pt.front_sizes())


@pytest.mark.parametrize("name", NAMES)
def test_etree_and_postorder_match_respatpu(analysed, name):
    pj, pt = analysed[name]
    ej, et = jsnlu.etree(pj.filled), snlu.etree(pt.filled)
    np.testing.assert_array_equal(ej, et)
    np.testing.assert_array_equal(jsnlu.postorder(ej), snlu.postorder(et))
    # a postordered tree: every parent after its children, and already in postorder
    assert ((et > np.arange(et.size)) | (et < 0)).all()
    np.testing.assert_array_equal(snlu.postorder(et), np.arange(et.size))


@pytest.mark.parametrize("x", [-3, 0, 1, 8, 9, 129, 8192, 20000])
def test_pad_dim_is_respatpus_ladder(x):
    assert snlu_device._pad_dim(x) == j_pad_dim(x)
    assert int(snlu_device._pad_dims(np.array([x]))[0]) == j_pad_dim(x)


@pytest.mark.parametrize("name", NAMES)
def test_frontal_plan_matches_respatpu(analysed, name):
    """Shapes, the assembly map, the padded pivots' positions, the solves'
    index arrays and the extend-add positions equal respatpu's once its pool
    layout (supernode order) is mapped onto the port's (group by group)."""
    pj, pt = analysed[name]
    jp = j_build_frontal_plan(pj)
    tp = snlu_device.build_frontal_plan(pt)
    np.testing.assert_array_equal(jp.wp, tp.wp)
    np.testing.assert_array_equal(jp.rp, tp.rp)
    assert jp.pool_size == tp.pool_size and tp.off.dtype == np.int64
    np.testing.assert_array_equal(jp.asm_src, tp.asm_src)
    mp = tp.wp + tp.rp
    # the front that holds each assembled entry, and its place inside it
    owner_j = np.searchsorted(jp.off, jp.asm_dst, side="right") - 1
    by_off = np.argsort(tp.off)
    owner_t = by_off[np.searchsorted(tp.off[by_off], tp.asm_dst, side="right") - 1]
    np.testing.assert_array_equal(owner_j, owner_t)
    np.testing.assert_array_equal(jp.asm_dst - jp.off[owner_j], tp.asm_dst - tp.off[owner_t])
    ones_j = np.searchsorted(jp.off, jp.ones_dst, side="right") - 1
    ones_t = by_off[np.searchsorted(tp.off[by_off], tp.ones_dst, side="right") - 1]
    np.testing.assert_array_equal(ones_j, ones_t)
    np.testing.assert_array_equal(jp.ones_dst - jp.off[ones_j], tp.ones_dst - tp.off[ones_t])
    assert len(jp.groups) == len(tp.groups)
    for gj, gt in zip(jp.groups, tp.groups):
        assert (gj.level, gj.wp, gj.rp) == (gt.level, gt.wp, gt.rp)
        assert sorted(gj.snodes.tolist()) == sorted(gt.snodes.tolist())
        where = {int(s): k for k, s in enumerate(gj.snodes)}
        rows = [where[int(s)] for s in gt.snodes]  # respatpu's batch row of each member
        np.testing.assert_array_equal(gj.piv[rows], gt.piv)
        np.testing.assert_array_equal(gj.rsx[rows], gt.rsx)
        for k, s in enumerate(gt.snodes):
            p, r = int(pt.sn_parent[s]), pt.rowstruct[s].size
            if p < 0:
                assert (gt.lp[k] == -1).all() and gt.poff[k] == -1 and gt.pmp[k] == 0
                continue
            assert gt.poff[k] == tp.off[p] and gt.pmp[k] == mp[p]
            # respatpu's destination box of this front against off + lp_i * mp + lp_j
            np.testing.assert_array_equal(
                jp.off[p] + gt.lp[k, :r, None].astype(np.int64) * mp[p] + gt.lp[k, None, :r],
                _schur_dst(gj, rows[k], r, jp.pool_size))
            assert (gt.lp[k, r:] == -1).all()


def _schur_dst(gj, row, r, pool_size):
    """respatpu's r x r destination box of one front, out of its padded map."""
    dst = gj.schur_dst[row].astype(np.int64)
    live = dst[dst != pool_size]
    assert live.size == r * r
    return live.reshape(r, r)


@pytest.mark.parametrize("name", NAMES)
def test_frontal_plan_layout(analysed, name):
    """What the device code relies on: groups are contiguous in the pool in
    plan order, members sorted by parent with the roots first, one segment a
    parent, and the reduction lists every update row once, in its bin, in plan
    order."""
    _, pt = analysed[name]
    plan = snlu_device.build_frontal_plan(pt)
    n, at = pt.n, 0
    seen = np.zeros(plan.pool_size, dtype=bool)
    seen[plan.asm_dst] = True
    assert np.unique(plan.asm_dst).size == plan.asm_dst.size
    assert not seen[plan.ones_dst].any()
    for g in plan.groups:
        mp2 = g.mp * g.mp
        assert g.g0 == at
        np.testing.assert_array_equal(plan.off[g.snodes], at + mp2 * np.arange(g.nfronts))
        at += g.nfronts * mp2
        par = pt.sn_parent[g.snodes]
        assert (np.diff(par) >= 0).all()
        nroot = int((par < 0).sum())
        if nroot < g.nfronts:
            assert g.seg_ptr[0] == nroot and g.seg_ptr[-1] == g.nfronts
            for s0, s1 in zip(g.seg_ptr[:-1], g.seg_ptr[1:]):
                assert len(set(par[s0:s1].tolist())) == 1
            assert len(set(par[g.seg_ptr[:-1]].tolist())) == g.seg_ptr.size - 1
        else:
            assert g.seg_ptr.tolist() == [0]
        flat = g.rsx.ravel()
        assert np.unique(g.red_rows).size == g.red_rows.size
        dealt = g.red_rows[snlu_device.warp_deal(g.red_rows.size)]  # ascending within a bin
        assert sum((np.diff(dealt) < 0).tolist()) <= len(snlu_device.RED_BINS) - 1
        assert g.red_bins.sum() == g.red_rows.size and g.red_ptr[-1] == (flat < n).sum()
        for k, row in enumerate(g.red_rows):
            src = g.red_src[g.red_ptr[k]:g.red_ptr[k + 1]]
            assert (flat[src] == row).all() and (np.diff(src) > 0).all()
        for arr, dt in ((g.piv, np.int32), (g.rsx, np.int32), (g.lp, np.int32),
                        (g.poff, np.int64), (g.pmp, np.int32), (g.seg_ptr, np.int32),
                        (g.red_rows, np.int32), (g.red_ptr, np.int64), (g.red_src, np.int32),
                        (g.red_bins, np.int64)):
            assert arr.dtype == dt and arr.flags.c_contiguous
    assert at == plan.pool_size
    assert [g.level for g in plan.groups] == sorted(g.level for g in plan.groups)


@pytest.mark.parametrize("name", NAMES)
def test_assembly_map_native_and_numpy_agree(analysed, name, monkeypatch):
    _, pt = analysed[name]
    fast = snlu_device.build_frontal_plan(pt)
    monkeypatch.setattr(snlu_device, "_USE_NATIVE", False)
    slow = snlu_device.build_frontal_plan(pt)
    np.testing.assert_array_equal(fast.asm_dst, slow.asm_dst)
    np.testing.assert_array_equal(fast.off, slow.off)


@pytest.mark.parametrize("itemsize,budget,refused", [(8, 1 << 10, True), (4, None, False)])
def test_pool_memory_guard_names_the_size(analysed, itemsize, budget, refused):
    _, pt = analysed["mesh_fem_3d"]
    if not refused:
        assert snlu_device.build_frontal_plan(pt, itemsize, budget).pool_size > 0
        return
    with pytest.raises(MemoryError, match=r"front pool would need \d+\.\d GiB") as err:
        snlu_device.build_frontal_plan(pt, itemsize, budget)
    assert "against a budget of" in str(err.value)


@pytest.mark.parametrize("name", NAMES)
def test_numpy_oracle_matches_respatpus(analysed, pairs, name):
    """The host multifrontal factorization, the port's independent check:
    the same factors and solution as respatpu's numpy oracle, and a solution
    of the system."""
    pj, pt = analysed[name]
    aj, at = pj.filled, pt.filled  # the permuted (and matched) matrices, with explicit zeros
    fj = jsnlu.multifrontal_factor(aj, pj)
    ft = snlu.multifrontal_factor(at, pt)
    assert fj.n_pivot_perturbed == ft.n_pivot_perturbed
    for bj, bt in zip(fj.lu11 + fj.l21 + fj.u12, ft.lu11 + ft.l21 + ft.u12):
        assert bj.tobytes() == bt.tobytes()
    b = np.random.default_rng(5).standard_normal(pt.n)
    xj, xt = jsnlu.multifrontal_solve(fj, b), snlu.multifrontal_solve(ft, b)
    assert xj.tobytes() == xt.tobytes()
    # filled holds P A P^T: the oracle's x solves the unpermuted system
    dense = np.zeros((pt.n, pt.n))
    rows = np.repeat(np.arange(pt.n), at.row_lengths())
    dense[rows, at.indices] = at.data
    inv = np.empty(pt.n, dtype=np.int64)
    inv[pt.perm] = np.arange(pt.n)
    orig = dense[np.ix_(inv, inv)]
    assert np.abs(orig @ xt - b).max() <= 1e-9 * max(np.abs(xt).max(), 1.0) * np.abs(orig).max()


def test_interop_carries_partition_and_plan(analysed):
    pj, pt = analysed["circuit_weak"]
    carried = partition_from_respatpu(pj)
    np.testing.assert_array_equal(carried.perm, pt.perm)
    np.testing.assert_array_equal(carried.snode_ptr, pt.snode_ptr)
    plan = plan_from_respatpu(j_build_frontal_plan(pj))
    np.testing.assert_array_equal(plan.asm_dst, snlu_device.build_frontal_plan(pt).asm_dst)


@pytest.mark.parametrize("call", ["symbolic_fill", "sparse_assignment", "frontal_asm_dst"])
def test_native_routines_refuse_mismatched_arrays(call):
    indptr, indices = np.array([0, 1, 2], np.int64), np.array([0, 1], np.int32)
    bad = np.array([0, 1], np.int64)  # one row pointer short
    with pytest.raises(ValueError):
        if call == "sparse_assignment":
            native.sparse_assignment(2, bad, indices, np.ones(2))
        elif call == "frontal_asm_dst":
            z = np.zeros(1, np.int64)
            native.frontal_asm_dst(2, bad, indices, np.array([0, 2]), np.array([0, 0]),
                                   np.empty(0, np.int64), z, z, z)
        else:
            getattr(native, call)(2, bad, indices)
    assert native.symbolic_fill(2, indptr, indices)[1].tolist() == [0, 1]
