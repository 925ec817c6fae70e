"""The device half of the multifrontal LU on the CPU: the plain versions of
the extend-add, frontal sweep and row-reduction kernels against dense numpy
loops written here, the group factorization and the group solves against
respatpu's ``_factor_fronts`` / ``_fwd_group`` / ``_bwd_group`` on the same
numpy inputs (CPU JAX, two group shapes), the fp64 pool against the numpy
oracle, and repeatability. The wrappers run their plain versions here because
the tensors lie on the CPU; the kernels themselves are held to the plain
versions on a card (tests/test_torch_cuda.py, chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from respatpu.bench.synth import circuit_like, laplacian_2d, mesh_fem_3d
from respatpu.kernels import snlu_device as jdev

from respatpu_torch import timing
from respatpu_torch.bench.synth import frontal_group
from respatpu_torch.interop import csr_from_respatpu, pool_from_respatpu
from respatpu_torch.kernels import bandlu, snlu, snlu_device as dev
from respatpu_torch.precision import FP32_MIN_NORMAL

# (fronts, wp, rp, parents): one front; many children of two parents; roots
# without update rows; wp = 24; the widest a sweep block solves; wider
SHAPES = [(1, 8, 8, 1), (40, 8, 16, 2), (3, 24, 0, 0), (6, 24, 32, 4), (5, 128, 48, 3),
          (2, 192, 96, 1)]
# a hub: 120 children of 16 update rows under one parent of 40, sharing entries
HUB = (120, 8, 16, 1)
WITH_PARENTS = [s for s in SHAPES if s[3]] + [HUB]
DTYPES = [torch.float32, torch.float64]
# kernel arithmetic in fp32 against numpy in fp64; fp64 against fp64
TOL = {torch.float32: 2e-5, torch.float64: 1e-12}


def _group(shape, dtype, seed=1):
    g = frontal_group(*shape, seed=seed)
    t = {k: torch.from_numpy(v) for k, v in g.items() if isinstance(v, np.ndarray)}
    t["pool"], t["y"] = t["pool"].to(dtype), t["y"].to(dtype)
    return g, t


def _front(g, b, pool=None):
    mp = g["wp"] + g["rp"]
    pool = g["pool"] if pool is None else pool
    return pool[b * mp * mp:(b + 1) * mp * mp].reshape(mp, mp)


def _close(got, ref, dtype):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert np.abs(got - ref).max() <= TOL[dtype] * max(np.abs(ref).max(), 1.0)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", WITH_PARENTS, ids=str)
def test_extend_add_is_the_dense_scatter(shape, dtype):
    g, t = _group(shape, dtype)
    nf, wp, rp = shape[:3]
    pool = t["pool"].clone()
    dev.extend_add(pool, 0, nf, wp, rp, t["lp"], t["poff"], t["pmp"], t["seg_ptr"],
                   gather=(g["ga_base"], t["ga_dst"], t["ga_src"], t["ga_ptr"]))
    ref = t["pool"].numpy().copy()
    for b in range(nf):
        lp = g["lp"][b][g["lp"][b] >= 0]
        pm = int(g["pmp"][b])
        parent = ref[g["poff"][b]:g["poff"][b] + pm * pm].reshape(pm, pm)
        parent[np.ix_(lp, lp)] += _front(g, b, t["pool"].numpy())[wp:wp + lp.size, wp:wp + lp.size]
    # the same additions in the same order: equal bit for bit
    assert pool.numpy().tobytes() == ref.tobytes()
    np.testing.assert_array_equal(pool[:nf * (wp + rp) ** 2], t["pool"][:nf * (wp + rp) ** 2])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_forward_sweep_and_reduction_are_the_dense_loop(shape, dtype):
    g, t = _group(shape, dtype)
    nf, wp, rp = shape[:3]
    n = g["n"]
    y = t["y"].clone()
    upd = dev.front_sweep(t["pool"], y, 0, nf, wp, rp, t["piv"], t["rsx"], True,
                          control=dev.control_zeros(t["pool"], nf, wp, rp))
    assert upd.shape == (nf, rp)
    dev.rows_reduce(y, upd, t["red_rows"], t["red_ptr"], t["red_src"])
    ref = g["y"].copy()
    for b in range(nf):
        f = _front(g, b)
        pv, rs = g["piv"][b], g["rsx"][b]
        z = np.linalg.solve(np.tril(f[:wp, :wp], -1) + np.eye(wp), ref[pv])
        ref[pv[pv < n]] = z[pv < n]
        np.add.at(ref, rs[rs < n], (-f[wp:, :wp] @ z)[rs < n])
    _close(y, ref, dtype)
    assert float(y[-1]) == 0.0  # the padding's slot


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_backward_sweep_is_the_dense_loop(shape, dtype):
    g, t = _group(shape, dtype)
    nf, wp, rp = shape[:3]
    n = g["n"]
    y = t["y"].clone()
    assert dev.front_sweep(t["pool"], y, 0, nf, wp, rp, t["piv"], t["rsx"], False,
                           control=dev.control_zeros(t["pool"], nf, wp, rp)) is None
    ref = g["y"].copy()
    for b in range(nf):
        f = _front(g, b)
        pv, rs = g["piv"][b], g["rsx"][b]
        z = np.linalg.solve(np.triu(f[:wp, :wp]), ref[pv] - f[:wp, wp:] @ ref[rs])
        ref[pv[pv < n]] = z[pv < n]
    _close(y, ref, dtype)
    assert float(y[-1]) == 0.0


@pytest.mark.parametrize("forward", [True, False], ids=["UT_forward", "LT_backward"])
@pytest.mark.parametrize("shape", [SHAPES[1], SHAPES[3], SHAPES[5]], ids=str)
def test_transposed_sweeps_are_the_dense_loop(shape, forward):
    g, t = _group(shape, torch.float64)
    nf, wp, rp = shape[:3]
    n = g["n"]
    y = t["y"].clone()
    upd = dev.front_sweep_t_plain(t["pool"], y, 0, nf, wp, rp, t["piv"], t["rsx"], forward)
    if forward:
        dev.rows_reduce(y, upd, t["red_rows"], t["red_ptr"], t["red_src"])
    ref = g["y"].copy()
    for b in range(nf):
        f = _front(g, b)
        pv, rs = g["piv"][b], g["rsx"][b]
        if forward:  # U^T z = s
            z = np.linalg.solve(np.triu(f[:wp, :wp]).T, ref[pv])
            np.add.at(ref, rs[rs < n], (-f[:wp, wp:].T @ z)[rs < n])
        else:  # L^T w = z
            z = np.linalg.solve((np.tril(f[:wp, :wp], -1) + np.eye(wp)).T,
                                ref[pv] - f[wp:, :wp].T @ ref[rs])
        ref[pv[pv < n]] = z[pv < n]
    _close(y, ref, torch.float64)
    # a subnormal partial under fp32_ftz comes out as 0; under fp32 it stays.
    # Forward it is z0 = s0 / u00 at the first pivot; backward the planted
    # entry itself, which L^T's unit diagonal passes through
    g32, t32 = _group(shape, torch.float32)
    row0 = int(g32["piv"][0, 0])
    d0 = abs(float(_front(g32, 0)[0, 0])) if forward else 1.0
    got = {}
    for flush in (False, True):
        y = torch.zeros_like(t32["y"])
        y[row0] = FP32_MIN_NORMAL / 4 * d0
        dev.front_sweep_t_plain(t32["pool"], y, 0, nf, wp, rp, t32["piv"], t32["rsx"],
                                forward, flush)
        got[flush] = float(y[row0])
    assert 0 < abs(got[False]) < FP32_MIN_NORMAL and got[True] == 0.0


def test_a_zero_pivot_diagonal_is_read_as_one():
    """An all-zero (padding) front solves as the identity backward, as
    respatpu's gather of a padded batch row does."""
    g, t = _group((2, 8, 8, 1), torch.float64)
    pool = t["pool"].clone()
    pool[:2 * 16 * 16] = 0
    y = t["y"].clone()
    dev.front_sweep(pool, y, 0, 2, 8, 8, t["piv"], t["rsx"], False,
                    control=dev.control_zeros(pool, 2, 8, 8))
    np.testing.assert_array_equal(y, t["y"])


def test_sweep_regime_and_tiles_follow_the_group_shape():
    """The sweep kernel's regime, fixed at plan time from a group's shape: a
    warp a front up to 32 pivots with one tile, a thread block up to
    ``MAX_TRI`` with a many-row panel cut into tiles of at least
    ``TILE_ROWS`` rows (no more than fill the card with the group's fronts),
    the wide kernel past ``MAX_TRI``; every group of a plan carries it."""
    cases = {(10681, 8, 16): ("warp", 1), (1000, 8, 384): ("warp", 1), (6, 24, 32): ("warp", 1),
             (2, 64, 6144): ("block", 96), (1, 8, 6144): ("block", 96), (40, 64, 700): ("block", 7),
             (5, 128, 48): ("block", 1), (3, 24, 0): ("warp", 1), (1, 20480, 384): ("wide", 1),
             (3, 6144, 0): ("wide", 1), (2, 129, 8): ("wide", 1)}
    for shape, want in cases.items():
        assert dev.sweep_regime(*shape) == want, shape
    for make in MATRICES.values():
        plan = dev.build_frontal_plan(snlu.analyze_supernodes(csr_from_respatpu(make())))
        for g in plan.groups:
            assert (g.regime, g.tiles) == dev.sweep_regime(g.nfronts, g.wp, g.rp)
            assert (g.regime == "wide") == (g.wp > dev.MAX_TRI)
            assert g.regime != "warp" or (g.wp <= 32 and g.tiles == 1)
            assert g.tiles == 1 or g.rp >= g.tiles * dev.TILE_ROWS


def test_gather_lists_cover_every_corner_entry_once_in_child_order():
    """The extend-add's gather lists, made at plan time: every corner entry
    in use of a front with a parent is one source, once, of the parent entry
    it adds into; an entry's sources come in plan order (rank k is its k-th
    child), the entries ordered by their number of sources, most first.
    Walking the lists as the kernel does (an entry's sources added one after
    the other, in rank order) gives the plain version's pool bit for bit.
    The regime follows the group's shape: gather where a parent has
    ``GATHER_KIDS`` or more children in the group, for corners of at most
    ``GATHER_RP`` rows whose lists fit ``GATHER_CAP`` words a corner entry,
    rows otherwise; every group of a plan carries it."""
    for shape in WITH_PARENTS:
        g = frontal_group(*shape, seed=2)
        nf, wp, rp = shape[:3]
        mp = wp + rp
        base, dst, src, ptr = g["ga_base"], g["ga_dst"], g["ga_src"], g["ga_ptr"]
        lens = np.diff(ptr)
        assert (lens[:-1] >= lens[1:]).all() and lens[0] == dst.size == np.unique(dst).size
        want = {}
        for b in range(nf):
            l = g["lp"][b][g["lp"][b] >= 0]
            for i, li in enumerate(l):
                for j, lj in enumerate(l):
                    at = int(g["poff"][b] + li * g["pmp"][b] + lj)
                    want.setdefault(at, []).append(b * mp * mp + (wp + i) * mp + wp + j)
        got = {}
        for k in range(lens.size):
            for d in range(lens[k]):
                got.setdefault(int(base + dst[d]), []).append(int(src[ptr[k] + d]))
        assert got == want, shape  # each source once, in the children's order
        assert src.size == sum(len(v) for v in want.values())
        pool = g["pool"].astype(np.float32)
        ref = torch.from_numpy(pool.copy())
        t = {k: torch.from_numpy(v) for k, v in g.items() if isinstance(v, np.ndarray)}
        dev.extend_add_plain(ref, 0, nf, wp, rp, t["lp"], t["poff"], t["pmp"], t["seg_ptr"])
        walked = pool.copy()
        for at, sources in got.items():
            v = walked[at]
            for s_ in sources:
                v = np.float32(v + pool[s_])
            walked[at] = v
        assert walked.tobytes() == ref.numpy().tobytes(), shape
    # dc1's populous group: 10,681 fronts, at most 167 children a parent
    assert dev.add_regime(10681, 16, 167, 2 * 10681 * 256) == "gather"
    assert dev.add_regime(10681, 16, 167, 2 * 10681 * 256 + 1) == "rows"
    assert dev.add_regime(10681, 16, dev.GATHER_KIDS - 1, 10) == "rows"
    assert dev.add_regime(2, dev.GATHER_RP * 2, 10, 10) == "rows"
    assert dev.add_regime(5, 8, 10, None) == "rows"
    regimes = set()
    # the test plans, and a circuit whose lowest level has parents of 17-40 children
    for make in (*MATRICES.values(), lambda: circuit_like(3000, 6, seed=2)):
        plan = dev.build_frontal_plan(snlu.analyze_supernodes(csr_from_respatpu(make())))
        for g in plan.groups:
            regimes.add(g.add)
            lists = (dev.gather_lists(g.lp, g.poff, g.pmp, g.seg_ptr, g.wp, g.rp)
                     if g.seg_ptr.size > 1 and g.rp else None)
            words = None if lists is None else sum(int(x.size) for x in lists[1:])
            most = int(np.diff(g.seg_ptr).max(initial=0))
            assert g.add == (dev.add_regime(g.nfronts, g.rp, most, words) if lists else "rows")
            kept = (g.ga_base, g.ga_dst, g.ga_src, g.ga_ptr)
            if g.add == "gather":
                assert kept[0] == lists[0]
                assert all(np.array_equal(x, y) for x, y in zip(kept[1:], lists[1:]))
            else:
                assert g.ga_dst.size == g.ga_src.size == g.ga_ptr.size == 0
    assert regimes == {"gather", "rows"}


def test_reduction_bins_cover_every_row_once_in_plan_order():
    """The reduction's rows, cut at plan time by their number of sources:
    every destination row once; dealt to the kernel's warps (``warp_deal``)
    longest bin first and ascending within a bin, so that the long rows are
    spread one a warp; each row's sources in plan order. The plain version
    sums a row of the first bin one source after the other, as the kernel's
    lane does, bit for bit; the longer ones within fp32 rounding."""
    rng = np.random.default_rng(5)
    nf, rp, n = 60, 40, 500
    # a few hub rows that many fronts update, and many rows that one or two do
    rsx = np.where(rng.random((nf, rp)) < 0.2, rng.integers(0, 4, (nf, rp)),
                   rng.integers(4, n, (nf, rp)))
    rsx[:, -5:] = n  # padding
    rows, ptr, src, bins = dev.reduction_csr(rsx.astype(np.int32), n)
    flat = rsx.ravel()
    np.testing.assert_array_equal(np.sort(rows), np.unique(flat[flat < n]))
    lens = np.diff(ptr)
    limits = [most for most, _ in dev.RED_BINS[:-1]]
    bin_of = np.searchsorted(limits, lens)
    np.testing.assert_array_equal(np.bincount(bin_of, minlength=3), bins)
    assert (bins > 0).all()
    deal = dev.warp_deal(rows.size)
    np.testing.assert_array_equal(np.sort(deal), np.arange(rows.size))
    key = np.lexsort((rows[deal], -bin_of[deal]))
    np.testing.assert_array_equal(key, np.arange(rows.size))
    assert bin_of[::32].tolist()[:bins[2]] == [2] * bins[2]  # a long row leads each warp
    for k, row in enumerate(rows):
        s = src[ptr[k]:ptr[k + 1]]
        assert (flat[s] == row).all() and (np.diff(s) > 0).all()
    upd = rng.standard_normal((nf, rp)).astype(np.float32)
    y = torch.zeros(n + 1)
    dev.rows_reduce_plain(y, torch.from_numpy(upd), *(torch.from_numpy(a) for a in (rows, ptr, src)))
    u = upd.ravel()
    for k in range(rows.size):
        terms = u[src[ptr[k]:ptr[k + 1]]]
        if bin_of[k] == 0:
            want = np.float32(0)
            for v in terms:
                want = np.float32(want + v)
            assert y[rows[k]].item() == want
        else:
            assert abs(y[rows[k]].item() - terms.astype(np.float64).sum()) <= \
                1e-5 * np.abs(terms).sum()


def test_a_zero_diagonal_of_a_wide_front_is_read_as_one_as_respatpu_does():
    """One zero-diagonal rule at every width: a zero on the diagonal of a
    front wider than ``MAX_TRI`` is read as 1 by the backward sweep, as
    respatpu's ``_bwd_group`` reads it (CPU JAX, the same fp32 inputs)."""
    nf, wp, rp = 1, 192, 16
    mp = wp + rp
    g = frontal_group(nf, wp, rp, 1, seed=11)
    pool = g["pool"].astype(np.float32)
    pool[37 * mp + 37] = 0.0
    y0 = g["y"].astype(np.float32)
    y = torch.from_numpy(y0.copy())
    tp = torch.from_numpy(pool)
    dev.front_sweep(tp, y, 0, nf, wp, rp, torch.from_numpy(g["piv"]), torch.from_numpy(g["rsx"]),
                    False, control=dev.control_zeros(tp, nf, wp, rp))
    ref = np.asarray(jdev._bwd_group(jnp.asarray(y0), jnp.asarray(pool), jnp.zeros(1, jnp.int32),
                                     jnp.asarray(g["piv"]), jnp.asarray(g["rsx"]), wp=wp, mp=mp))
    n = g["n"]
    assert np.isfinite(ref).all() and np.abs(y.numpy()[:n] - ref[:n]).max() <= \
        2e-5 * np.abs(ref[:n]).max()
    u = pool[:mp * mp].reshape(mp, mp).astype(np.float64)
    np.fill_diagonal(u[:wp, :wp], np.where(np.diag(u[:wp, :wp]) == 0, 1.0, np.diag(u[:wp, :wp])))
    pv, rs = g["piv"][0], g["rsx"][0]
    yy = g["y"].astype(np.float32).astype(np.float64)
    z = np.linalg.solve(np.triu(u[:wp, :wp]), yy[pv] - u[:wp, wp:] @ yy[rs])
    live = pv < n
    assert np.abs(y.numpy()[pv[live]] - z[live]).max() <= 2e-5 * np.abs(z).max()


# ---------------------------------------------------------------------------
# against respatpu's jitted group functions (CPU JAX), two group shapes
# ---------------------------------------------------------------------------

JAX_SHAPES = [(6, 24, 32, 4), (3, 128, 48, 2)]


@pytest.fixture(scope="module", params=JAX_SHAPES, ids=str)
def jax_group(request):
    """One synthetic group in fp32 and what respatpu computes from it: the
    factored fronts with their counts, and the forward and backward group
    solves from those factors, of the system and of its transpose."""
    shape = request.param
    nf, wp, rp = shape[:3]
    mp = wp + rp
    g = frontal_group(*shape, seed=7)
    fronts = g["pool"][:nf * mp * mp].reshape(nf, mp, mp).astype(np.float32)
    eps = np.float32(1e-4)
    lu, cnt = jdev._factor_fronts(jnp.asarray(fronts), eps, wp, mp, jdev._pick_nb(wp))
    lu = np.asarray(lu)
    pool = np.concatenate([lu.ravel(), np.zeros(g["pool"].size - lu.size, np.float32)])
    offs = (np.arange(nf) * mp * mp).astype(np.int32)
    y0 = g["y"].astype(np.float32)
    yf = jdev._fwd_group(jnp.asarray(y0), jnp.asarray(pool), jnp.asarray(offs),
                         jnp.asarray(g["piv"]), jnp.asarray(g["rsx"]), wp=wp, mp=mp)
    yb = jdev._bwd_group(jnp.asarray(y0), jnp.asarray(pool), jnp.asarray(offs),
                         jnp.asarray(g["piv"]), jnp.asarray(g["rsx"]), wp=wp, mp=mp)
    yft = jdev._fwd_group_t(jnp.asarray(y0), jnp.asarray(pool), jnp.asarray(offs),
                            jnp.asarray(g["piv"]), jnp.asarray(g["rsx"]), wp=wp, mp=mp)
    ybt = jdev._bwd_group_t(jnp.asarray(y0), jnp.asarray(pool), jnp.asarray(offs),
                            jnp.asarray(g["piv"]), jnp.asarray(g["rsx"]), wp=wp, mp=mp)
    return dict(shape=shape, g=g, fronts=fronts, eps=float(eps), lu=lu, cnt=np.asarray(cnt),
                pool=pool, y0=y0, yf=np.asarray(yf), yb=np.asarray(yb), yft=np.asarray(yft),
                ybt=np.asarray(ybt))


def test_factor_group_matches_respatpus_factor_fronts(jax_group):
    """Factors agree to fp32 rounding (respatpu updates by 8-32-wide panels
    with masked rank-1 steps, the port by 128-wide blocks): 2e-5 of max|F| on
    these diagonally dominant fronts. Counts are equal."""
    j = jax_group
    nf, wp, rp = j["shape"][:3]
    pool = torch.from_numpy(j["fronts"].copy()).reshape(-1)
    cnt = dev.factor_group(pool, 0, nf, wp, rp, j["eps"])
    ours = pool.view(nf, wp + rp, wp + rp).numpy()
    assert np.abs(ours - j["lu"]).max() <= 2e-5 * np.abs(j["lu"]).max()
    np.testing.assert_array_equal(cnt.numpy(), j["cnt"])
    assert int(cnt.sum()) == 0


@pytest.mark.parametrize("forward,transposed", [(True, False), (False, False), (True, True),
                                               (False, True)],
                         ids=["forward", "backward", "transposed_forward", "transposed_backward"])
def test_group_sweeps_match_respatpus(jax_group, forward, transposed):
    """From respatpu's factored fronts the port's group solve gives
    respatpu's y (its scatter-add of the updates against the ordered
    reduction: fp32 sums in another order, 2e-5): ``front_sweep`` (K4's
    plain version) against ``_fwd_group`` / ``_bwd_group``, and
    ``front_sweep_t`` (K12's) against ``_fwd_group_t`` / ``_bwd_group_t``."""
    j = jax_group
    nf, wp, rp = j["shape"][:3]
    t = {k: torch.from_numpy(v) for k, v in j["g"].items() if isinstance(v, np.ndarray)}
    y = torch.from_numpy(j["y0"].copy())
    pool = torch.from_numpy(j["pool"])
    sweep = dev.front_sweep_t if transposed else dev.front_sweep
    upd = sweep(pool, y, 0, nf, wp, rp, t["piv"], t["rsx"], forward,
                control=dev.control_zeros(pool, nf, wp, rp))
    if forward:
        dev.rows_reduce(y, upd, t["red_rows"], t["red_ptr"], t["red_src"])
    ref = j[("yf" if forward else "yb") + ("t" if transposed else "")]
    n = j["g"]["n"]
    assert np.abs(y.numpy()[:n] - ref[:n]).max() <= 2e-5 * np.abs(ref[:n]).max()


@pytest.mark.parametrize("plant", [0.0, 0.5, -0.5, None], ids=["zero", "+eps/2", "-eps/2", "none"])
def test_perturbed_pivot_counts_match_respatpus(plant):
    """A planted pivot of 0 or +-eps/2 in the first front's first position is
    perturbed (0 to +eps, the sign kept otherwise) and counted once by both
    packages; padded pivots never count."""
    shape = (3, 24, 32, 2)
    nf, wp, rp = shape[:3]
    mp = wp + rp
    eps = 2.0 ** -10  # exact in fp32
    g = frontal_group(*shape, seed=11)
    fronts = g["pool"][:nf * mp * mp].reshape(nf, mp, mp).astype(np.float32)
    fronts[0, 0, 1:] = 0  # keep the planted pivot's row out of the rest
    fronts[0, 1:, 0] = 0
    if plant is not None:
        fronts[0, 0, 0] = plant * eps
    lu, cnt = jdev._factor_fronts(jnp.asarray(fronts), np.float32(eps), wp, mp,
                                  jdev._pick_nb(wp))
    pool = torch.from_numpy(fronts.copy()).reshape(-1)
    ours = dev.factor_group(pool, 0, nf, wp, rp, eps)
    want = [0 if plant is None else 1, 0, 0]
    assert ours.tolist() == np.asarray(cnt).tolist() == want
    got = float(pool.view(nf, mp, mp)[0, 0, 0])
    assert got == float(np.asarray(lu)[0, 0, 0])
    if plant is not None:
        assert got == (-eps if plant < 0 else eps)


@pytest.mark.parametrize("shape", [(3, 24, 32), (2, 128, 48), (1, 300, 20), (2, 16, 0)], ids=str)
def test_factor_group_is_the_dense_partial_lu(shape):
    """Blocked, 128 pivots at a time, against an unblocked numpy partial LU
    in fp64; the Schur corner included."""
    nf, wp, rp = shape
    mp = wp + rp
    rng = np.random.default_rng(wp)
    fronts = rng.standard_normal((nf, mp, mp)) + 4 * np.sqrt(mp) * np.eye(mp)
    ref = fronts.copy()
    for t in range(wp):
        ref[:, t + 1:, t] /= ref[:, t, t, None]
        ref[:, t + 1:, t + 1:] -= ref[:, t + 1:, t, None] * ref[:, t, None, t + 1:]
    for dtype in DTYPES:
        pool = torch.from_numpy(fronts).to(dtype).reshape(-1).clone()
        cnt = dev.factor_group(pool, 0, nf, wp, rp, 1e-13)
        assert int(cnt.sum()) == 0
        _close(pool.view(nf, mp, mp), ref, dtype)


# ---------------------------------------------------------------------------
# whole factorizations on small matrices
# ---------------------------------------------------------------------------

MATRICES = {
    "mesh_fem_3d": lambda: mesh_fem_3d(260, avg_degree=10.0, seed=3),
    "circuit_dominant": lambda: circuit_like(300, 5, seed=4, diag="dominant"),
    "laplacian_2d": lambda: laplacian_2d(14, 11),
}


@pytest.fixture(scope="module", params=list(MATRICES))
def factored(request):
    a = csr_from_respatpu(MATRICES[request.param]())
    part = snlu.analyze_supernodes(a)
    plan = dev.build_frontal_plan(part)
    return a, part, plan


def test_fp64_pool_matches_the_numpy_oracle(factored):
    """The device code's factors in fp64 against the host oracle's, entry for
    entry of the filled pattern, within 1e-12; and its solution."""
    a, part, plan = factored
    oracle = snlu.multifrontal_factor(a, part)
    pool, nbad = dev.frontal_factor_pool(plan, torch.float64, "cpu")
    assert nbad == oracle.n_pivot_perturbed == 0
    fronts = pool.numpy()
    for s in range(part.nsn):
        w, r = int(np.diff(part.snode_ptr)[s]), part.rowstruct[s].size
        wp, mp = int(plan.wp[s]), int(plan.wp[s] + plan.rp[s])
        f = fronts[plan.off[s]:plan.off[s] + mp * mp].reshape(mp, mp)
        scale = max(np.abs(oracle.lu11[s]).max(), 1.0)
        assert np.abs(f[:w, :w] - oracle.lu11[s]).max() <= 1e-12 * scale
        assert np.abs(f[wp:wp + r, :w] - oracle.l21[s]).max(initial=0) <= 1e-12 * scale
        assert np.abs(f[:w, wp:wp + r] - oracle.u12[s]).max(initial=0) <= 1e-12 * scale
    b = np.random.default_rng(2).standard_normal(a.nrows)
    x = np.empty(a.nrows)
    x[part.perm] = dev.FrontalSolver(plan, pool).solve_device(
        torch.from_numpy(b[part.perm])).numpy()
    ref = snlu.multifrontal_solve(oracle, b)
    assert np.abs(x - ref).max() <= 1e-12 * np.abs(ref).max()


def test_fp32_pool_matches_respatpus_values_from_pool():
    """respatpu factors its own assembled pool (CPU JAX) and the port the
    same assembled fronts, carried over by ``interop``: factor values agree
    within 2e-5 of max|F| (fp32 rounding in another order; the matrix is
    diagonally dominant, growth ~1). One small matrix: each of respatpu's
    device factorizations leaves thousands of memory mappings in the
    process."""
    a = csr_from_respatpu(MATRICES["laplacian_2d"]())
    part = snlu.analyze_supernodes(a)
    plan = dev.build_frontal_plan(part)
    import respatpu.kernels.snlu as jsnlu
    from respatpu.formats import CSRMatrix as JCSR
    ja = JCSR(a.shape, a.indptr.astype(np.int32), a.indices, a.data)
    jplan = jdev.build_frontal_plan(jsnlu.analyze_supernodes(ja))
    jpool, jbad = jdev.frontal_factor_pool(jplan)
    jvals = jdev.values_from_pool(jplan, jpool)
    # the same assembled fronts into the port's layout, factored there
    eps = dev.default_pivot_eps(float(np.abs(part.filled.data).max()), torch.float32)
    assembled = np.zeros(jplan.pool_size, np.float32)
    assembled[jplan.asm_dst] = jplan.part.filled.data
    assembled[jplan.ones_dst] = max(1.0, eps * 1.001)
    tplan, tpool = pool_from_respatpu(jplan, assembled, device="cpu")
    np.testing.assert_array_equal(tpool, dev.assemble_pool(plan, torch.float32, "cpu", eps))
    tpool, tbad = dev.frontal_factor_pool(tplan, torch.float32, "cpu", pool=tpool)
    tvals = dev.values_from_pool(tplan, tpool)
    assert tbad == jbad == 0
    assert np.abs(tvals - jvals).max() <= 2e-5 * np.abs(jvals).max()
    # and the factored pool carried over is solved alike by both packages
    b = np.random.default_rng(4).standard_normal(a.nrows).astype(np.float32)
    xj = np.asarray(jdev.FrontalSolver(jplan, jpool).solve_device(jnp.asarray(b)))
    _, carried = pool_from_respatpu(jplan, np.asarray(jpool), device="cpu")
    xt = dev.FrontalSolver(tplan, carried).solve_device(torch.from_numpy(b)).numpy()
    assert np.abs(xt - xj).max() <= 2e-5 * np.abs(xj).max()


def test_factorization_and_solves_repeat_bit_for_bit(factored):
    a, part, plan = factored
    p1, _ = dev.frontal_factor_pool(plan, torch.float32, "cpu")
    p2, _ = dev.frontal_factor_pool(plan, torch.float32, "cpu")
    assert torch.equal(p1, p2)
    solver = dev.FrontalSolver(plan, p1)
    b = torch.from_numpy(np.random.default_rng(3).standard_normal(a.nrows)).float()
    assert torch.equal(solver.solve_device(b), solver.solve_device(b))
    assert torch.equal(solver.solve_t_device(b), solver.solve_t_device(b))
    assert solver.launches_per_solve == sum(2 + (g.rp > 0) for g in plan.groups)
    assert set(dev.LAUNCHES.values()) == {0} and set(bandlu.LAUNCHES.values()) == {0}


def test_a_solve_on_the_cpu_is_the_plain_walk_and_no_graph():
    """On the CPU both solves are the plain sweeps and reductions walked
    group by group, bit for bit, on every matrix, and none is captured,
    replayed or counted as an eager card solve."""
    for name, make in MATRICES.items():
        a = csr_from_respatpu(make())
        plan = dev.build_frontal_plan(snlu.analyze_supernodes(a))
        pool, _ = dev.frontal_factor_pool(plan, torch.float32, "cpu")
        solver = dev.FrontalSolver(plan, pool)
        b = torch.from_numpy(np.random.default_rng(5).standard_normal(a.nrows)).float()
        with timing.recording() as rec:
            x, z = solver.solve_device(b), solver.solve_t_device(b)
        assert not {"frontal_capture", "frontal_replay", "frontal_eager"} & set(rec.counts), name
        assert rec.launches == {}, name
        on = plan.on_device("cpu")
        order = list(range(len(plan.groups)))
        for got, plain in ((x, dev.front_sweep_plain), (z, dev.front_sweep_t_plain)):
            y = torch.zeros(a.nrows + 1)
            y[:a.nrows] = b
            for fwd, walk in ((True, order), (False, order[::-1])):
                for gi in walk:
                    g = plan.groups[gi]
                    upd = plain(pool, y, g.g0, g.nfronts, g.wp, g.rp, on[gi]["piv"],
                                on[gi]["rsx"], fwd)
                    if fwd and g.rp:
                        dev.rows_reduce_plain(y, upd, on[gi]["red_rows"], on[gi]["red_ptr"],
                                              on[gi]["red_src"])
            assert torch.equal(got, y[:a.nrows]), (name, plain.__name__)


def test_transpose_solve_solves_the_transposed_system(factored):
    a, part, plan = factored
    pool, _ = dev.frontal_factor_pool(plan, torch.float64, "cpu")
    b = np.random.default_rng(8).standard_normal(a.nrows)
    z = np.empty(a.nrows)
    z[part.perm] = dev.FrontalSolver(plan, pool).solve_t_device(
        torch.from_numpy(b[part.perm])).numpy()
    dense = a.toarray()
    assert np.abs(dense.T @ z - b).max() <= 1e-10 * np.abs(dense).max() * np.abs(z).max()


def test_values_from_pool_inverts_the_assembly(factored):
    a, part, plan = factored
    eps = 1e-4
    pool = dev.assemble_pool(plan, torch.float64, "cpu", eps)
    np.testing.assert_array_equal(dev.values_from_pool(plan, pool), part.filled.data)
    assert float(pool.sum()) == pytest.approx(part.filled.data.sum() + plan.ones_dst.size)
    assert plan.asm_src.tolist() == list(range(part.filled.nnz))


# ---------------------------------------------------------------------------
# flush-to-zero and refusals
# ---------------------------------------------------------------------------


def _subnormal(t):
    return bool(((t != 0) & (t.abs() < FP32_MIN_NORMAL)).any())


def test_flush_to_zero_in_the_plain_versions():
    """Subnormal sums of the extend-add, subnormal right-hand-side entries
    and subnormal updates are flushed to exact zeros under ``flush``; without
    it they survive."""
    shape = (40, 8, 16, 2)
    nf, wp, rp = shape[:3]
    kids = nf * (wp + rp) ** 2
    g, t = _group(shape, torch.float32)
    pool = t["pool"].clone()
    pool[kids:] = 0
    corner = pool[:kids].view(nf, wp + rp, wp + rp)[:, wp:, wp:]
    corner[:] = 1e-40
    idx = (t["lp"], t["poff"], t["pmp"], t["seg_ptr"])
    kept, flushed = pool.clone(), pool.clone()
    dev.extend_add(kept, 0, nf, wp, rp, *idx, flush=False)
    dev.extend_add(flushed, 0, nf, wp, rp, *idx, flush=True)
    assert _subnormal(kept[kids:]) and not flushed[kids:].any()
    y = torch.full_like(t["y"], 1e-40)
    y[-1] = 0
    for forward in (True, False):
        yk, yf = y.clone(), y.clone()
        ctl = dev.control_zeros(t["pool"], nf, wp, rp)
        uk = dev.front_sweep(t["pool"], yk, 0, nf, wp, rp, t["piv"], t["rsx"], forward, False,
                             control=ctl)
        uf = dev.front_sweep(t["pool"], yf, 0, nf, wp, rp, t["piv"], t["rsx"], forward, True,
                             control=ctl)
        rows = t["piv"][t["piv"] < g["n"]].long()
        assert _subnormal(yk[rows]) and not yf[rows].any()
        if forward:
            assert _subnormal(uk) and not uf.any()
            tiny = torch.full_like(uk, 1e-41)
            dev.rows_reduce(yf, tiny, t["red_rows"], t["red_ptr"], t["red_src"], True)
            assert not yf[t["red_rows"].long()].any()


@pytest.mark.parametrize("what", ["pool_2d", "group_outside_pool", "lp_dtype", "y_dtype",
                                  "bf16_pool"])
def test_wrappers_refuse_what_the_kernels_do_not_take(what):
    g, t = _group((6, 24, 32, 4), torch.float32)
    nf, wp, rp = 6, 24, 32
    idx = [t["lp"], t["poff"], t["pmp"], t["seg_ptr"]]
    y = t["y"].clone()
    if what == "pool_2d":
        with pytest.raises(ValueError, match="flat"):
            dev.extend_add(t["pool"].view(1, -1), 0, nf, wp, rp, *idx)
    elif what == "group_outside_pool":
        with pytest.raises(ValueError, match="does not lie"):
            dev.front_sweep(t["pool"], y, t["pool"].numel(), nf, wp, rp, t["piv"], t["rsx"], True,
                            control=dev.control_zeros(t["pool"], nf, wp, rp))
    elif what == "lp_dtype":
        idx[0] = idx[0].long()
        with pytest.raises(ValueError, match="lp must be"):
            dev.extend_add(t["pool"], 0, nf, wp, rp, *idx)
    elif what == "piv_shape":
        with pytest.raises(ValueError, match="piv must be"):
            dev.front_sweep(t["pool"], y, 0, nf, wp, rp, t["piv"][:, :-1].contiguous(),
                            t["rsx"], False, control=dev.control_zeros(t["pool"], nf, wp, rp))
    elif what == "y_dtype":
        with pytest.raises(ValueError, match="y must be"):
            dev.front_sweep(t["pool"], y.double(), 0, nf, wp, rp, t["piv"], t["rsx"], True,
                            control=dev.control_zeros(t["pool"], nf, wp, rp))
    elif what == "red_ptr_length":
        upd = torch.zeros(nf, rp)
        with pytest.raises(ValueError, match="one entry more"):
            dev.rows_reduce(y, upd, t["red_rows"], t["red_ptr"][:-1].contiguous(), t["red_src"])
    else:
        assert dev._instance(t["pool"], True) == "f32_ftz"
        with pytest.raises(TypeError, match="no frontal kernel"):
            dev._instance(t["pool"].bfloat16(), False)
        with pytest.raises(TypeError, match="flush-to-zero"):
            dev._instance(t["pool"].double(), True)
