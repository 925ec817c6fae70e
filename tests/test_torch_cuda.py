"""The hand-written kernels (CSR SpMV, block LU, band sweep for one and for
several right-hand sides, the transposed band sweep, extend-add, frontal
sweep and its transposed form, row reduction, ILU(0) sweep, triangular
solve, scheduled LU, DIA SpMV) against their plain versions on a CUDA card,
and the distributed stack with four shards on one card.

Marked ``cuda``: without a card each test skips with a reason. On a machine
with one, run ``python -m pytest --noconftest tests/test_torch_cuda.py -q``
(``tests/conftest.py`` imports JAX, which this file does not need).
"""
import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from respatpu_torch.bench import synth
from respatpu_torch.formats import COOMatrix, coo_to_csr
from respatpu_torch import analysis, solve, timing
from respatpu_torch.kernels import bandlu as B
from respatpu_torch.kernels import dia as DI
from respatpu_torch.kernels import ilu0 as I
from respatpu_torch.kernels import splu as SP
from respatpu_torch.kernels import sptrsv as S
from respatpu_torch.precision import get_policy
from respatpu_torch.kernels import snlu, snlu_device as F
from respatpu_torch.kernels import spmv as K

pytestmark = pytest.mark.cuda

TOL = {"fp32": 2e-5, "fp32_ftz": 2e-5, "bf16": 2e-5, "fp64": 1e-14}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _matrix():
    """Rectangular, with empty rows, rows wider than 32 and a 5000-entry row."""
    rng = np.random.default_rng(9)
    m, n = 4000, 9000
    lens = rng.integers(0, 70, m)
    lens[::5] = 0
    rows = np.concatenate([np.repeat(np.arange(m), lens), np.full(5000, 7)])
    cols = np.concatenate([rng.integers(0, n, lens.sum()), rng.choice(n, 5000, replace=False)])
    return coo_to_csr(COOMatrix((m, n), rows.astype(np.int32), cols.astype(np.int32),
                                rng.uniform(0.5, 1.5, rows.size)))


EDGES = ["row_cap_and_cap+1", "empty_run", "one_row", "one_row_wide", "rows_no_entries",
         "short_last_block", "wide_among_short"]


def test_edge_names_are_the_generators():
    assert EDGES == list(synth.row_block_edges(K.CAP, K.MAX_ROWS))


# The rectangular matrix and the edge shapes take every policy in one case
# (the collected count is held in a range; see ROADMAP's test-count trap).
_ONE_POLICY = ["mesh"]
_KERNEL_CASES = ([(name, [policy]) for name in _ONE_POLICY for policy in TOL]
                 + [(name, list(TOL)) for name in ["rect"] + EDGES])


@pytest.mark.parametrize("name,policies", _KERNEL_CASES,
                         ids=[f"{n}-{'-'.join(ps) if len(ps) == 1 else 'all'}"
                              for n, ps in _KERNEL_CASES])
def test_kernel_matches_plain(card, name, policies):
    a = (_matrix() if name == "rect" else synth.mesh_fem_3d(5000, seed=2) if name == "mesh"
         else synth.row_block_edges(K.CAP, K.MAX_ROWS)[name])
    x64 = np.random.default_rng(1).standard_normal(a.shape[1]) + 1.0
    for policy in policies:
        dev = K.to_device(a, policy, card, fmt="csr")
        x = torch.from_numpy(x64).to(dev.policy.accum_dtype).to(card)
        before = K.LAUNCHES[policy]
        y = K.spmv(dev, x)
        torch.cuda.synchronize()
        assert K.LAUNCHES[policy] == before + 1, policy
        ref = (torch.from_numpy(K.spmv_csr_reference(a, x64)) if policy == "fp64"
               else K.spmv_plain(dev, x).double().cpu())
        err = float((y.double().cpu() - ref).abs().max() / max(float(ref.abs().max()), 1e-300))
        assert err <= TOL[policy], policy
        assert bool((y.cpu()[torch.diff(dev.indptr).cpu() == 0] == 0).all()), policy
        if policy == "fp64":
            assert torch.equal(y, K.spmv(dev, x))


def test_wrapper_rejects_bad_input(card):
    dev = K.to_device(synth.laplacian_3d(5, 5, 5), "fp32", card, fmt="csr")
    with pytest.raises(TypeError):
        K.spmv(dev, torch.zeros(125, dtype=torch.float64, device=card))
    with pytest.raises(ValueError):
        K.spmv(dev, torch.zeros(124, device=card))
    with pytest.raises(ValueError):
        K.spmv(dev, torch.zeros(125))
    x = torch.zeros(125, device=card)
    for bad in (dataclasses.replace(dev, indices=dev.indices.cpu()),
                dataclasses.replace(dev, row_blocks=dev.row_blocks.long()),
                dataclasses.replace(dev, row_blocks=dev.row_blocks.cpu()),
                dataclasses.replace(dev, vals=dev.vals.repeat(2)[::2])):
        with pytest.raises(ValueError):
            K.spmv(bad, x)


LU_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-5, torch.float64: 1e-13}
SWEEP_TOL = {"fp32": 2e-5, "fp32_ftz": 2e-5, "bf16": 2e-5, "fp64": 1e-12}


@pytest.mark.parametrize("dtype,flush", [(torch.float32, False), (torch.float32, True),
                                         (torch.bfloat16, False), (torch.float64, False)],
                         ids=["fp32", "fp32_ftz", "bf16", "fp64"])
def test_block_lu_matches_plain(card, dtype, flush):
    """Blocks whose first pivot is planted: zero, exactly eps, eps / 2,
    negative tiny, exactly -eps, twice eps (kept), and an ordinary one; then
    three blocks that send fp32's fast division back to ``__fdiv_rn`` (a
    numerator of 2^-70 and one of 2^70 in the last row, below every pivot
    and, in a panel, in one warp's rows alone; a pivot of 2^65); for every
    block size (5, 16 and 32: a warp a block; 100, not a multiple of the
    16-pivot panel, and 128: panels), count (1, 10) and layout (read in
    place from a band, contiguous), each case named in its message; the
    factors bit for bit the plain version's."""
    eps = 1e-13 if dtype == torch.float64 else 2.0 ** -13
    name = "respa_block_lu_" + ("f64" if dtype == torch.float64 else "f32_ftz" if flush else "f32")
    for p in (5, 16, 32, 100, 128):
        for nblocks in (1, 10):
            for layout in ("in_band", "contiguous"):
                case = f"p={p} nblocks={nblocks} layout={layout}"
                rng = np.random.default_rng(p)
                blk = rng.standard_normal((nblocks, p, 3 * p)) + np.tile(4 * np.sqrt(p) * np.eye(p),
                                                                          3)
                for i, plant in enumerate([0.0, eps, eps / 2, -eps / 2, -eps, 2 * eps][:nblocks]):
                    blk[i, 0, p] = plant
                if nblocks == 10:
                    blk[7, p - 1, p] = 2.0 ** -70
                    blk[8, p - 1, p] = 2.0 ** 70
                    blk[9, p // 2, p + p // 2] = 2.0 ** 65
                x = torch.from_numpy(blk).to(dtype).to(card)[:, :, p:2 * p]
                if layout == "contiguous":
                    x = x.contiguous()
                before = B.LAUNCHES[name]
                lu, cnt = B.block_lu(x, eps, flush)
                torch.cuda.synchronize()
                assert B.LAUNCHES[name] == before + 1, case
                ref, rcnt = B.block_lu_plain(x, eps, flush)
                assert torch.equal(cnt, rcnt) and int(cnt.sum()) >= min(nblocks, 5), case
                assert torch.equal(_bits(lu), _bits(ref)), case
                again = B.block_lu(x, eps, flush)
                assert torch.equal(lu, again[0]) and torch.equal(cnt, again[1]), case


def _sweep_matrix(name):
    return {"one_block_row": (synth.random_banded(100, 30, 6, seed=1), 128),
            "ml_ne_mu": (synth.skew_banded(500, 70, 20, 7, seed=2), 16),
            "ml_eq_nb": (synth.random_banded(100, 99, 10, seed=4), 16),
            "laplacian_2d": (synth.laplacian_2d(40, 23), 32),
            "banded_p128": (synth.random_banded(1000, 300, 9, seed=5), 128)}[name]


SWEEP_CASES = ["one_block_row", "ml_ne_mu", "ml_eq_nb", "laplacian_2d", "banded_p128"]


@pytest.mark.parametrize("policy", list(SWEEP_TOL))
@pytest.mark.parametrize("name", SWEEP_CASES)
def test_band_sweep_matches_plain(card, name, policy):
    """The forward and the backward sweep, each direction named in its
    message; on the factor, and on the factor with perturbed pivots planted
    in its diagonal blocks (``U_rr``'s diagonal at +-eps, as ``band_lu``
    leaves a pivot it perturbs, the inverses made anew)."""
    a, p = _sweep_matrix(name)
    lu = B.band_lu(B.csr_to_device_band(a, policy, card, p=p)).lu
    planted = lu.data.clone()
    eps = (1e-13 if policy == "fp64" else 1e-4) * float(lu.data.abs().max())
    for k, (r, i) in enumerate(((0, 1), (lu.nb // 2, p // 2), (lu.nb - 1, p - 3))):
        planted[r, i, lu.ml * p + i] = eps if k % 2 else -eps
    bands = (lu, B.with_inverses(dataclasses.replace(lu, data=planted)))
    b = torch.from_numpy(np.random.default_rng(3).standard_normal(lu.nb * p))
    b = b.to(lu.policy.accum_dtype).to(card)
    for band, what in zip(bands, ("factor", "perturbed pivots")):
        for fwd in (True, False):
            key = f"respa_band_sweep_{'fwd' if fwd else 'bwd'}_{TOL_INST[policy]}"
            before = B.LAUNCHES[key]
            y = B.band_sweep(band, b, fwd)
            torch.cuda.synchronize()
            assert B.LAUNCHES[key] == before + 1, key
            ref = B.band_sweep_plain(band, b, fwd)
            err = float((y - ref).abs().max() / ref.abs().max())
            assert err <= SWEEP_TOL[policy], (key, what, err)
            assert torch.equal(y, B.band_sweep(band, b, fwd)), (key, what)


@pytest.mark.parametrize("name", SWEEP_CASES)
def test_band_factor_and_solve_on_the_card(card, name):
    """The factorization on the card against the one on the CPU, and the
    solve's residual against the dense matrix, in fp32 and fp64 (each named
    in its message)."""
    a, p = _sweep_matrix(name)
    for policy in ("fp32", "fp64"):
        lu = B.band_lu(B.csr_to_device_band(a, policy, card, p=p)).lu
        plain = B.band_lu(B.csr_to_device_band(a, policy, "cpu", p=p)).lu
        scale = float(plain.data.float().abs().max())
        assert float((lu.data.cpu().float() - plain.data.float()).abs().max()) <= 1e-2 * scale, \
            policy
        b = torch.from_numpy(np.random.default_rng(3).standard_normal(lu.nb * p))
        b = b.to(lu.policy.accum_dtype).to(card)
        x = B.band_solve(lu, b[:a.nrows])
        dense = torch.from_numpy(a.toarray())
        resid = ((dense @ x.double().cpu() - b[:a.nrows].double().cpu()).norm()
                 / b[:a.nrows].norm().cpu())
        assert float(resid) <= {"fp64": 1e-12, "bf16": 5e-2}.get(policy, 1e-4), policy


TOL_INST = {"fp32": "f32", "fp32_ftz": "f32_ftz", "bf16": "bf16", "fp64": "f64"}


def _bits(t):
    """A float tensor's bits, so that +0 and -0 differ."""
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


def test_band_sweep_multi_matches_plain(card):
    """K10 against ``band_sweep_plain`` on every sweep case, policy and
    direction, at 1, 3 and 4 right-hand sides (the few-column regime) and
    37, 64 and 300 (tiles of 32 columns), and on a band of 19 panels a side
    with 2,304 (tiles of 128 columns with row slots, on a card of 132 SMs),
    twice bit for bit, each launch counted; a forward sweep from
    ``first_row`` equals the one from row 0 bit for bit where b's rows before
    it are zero."""
    wide = synth.random_banded(1000, 300, 9, seed=5)
    cases = [(name, *_sweep_matrix(name), (1, 3, 4, 37, 64, 300)) for name in SWEEP_CASES]
    cases.append(("wide_band_p16", wide, 16, (2304,)))
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for name, a, p, widths in cases:
        for policy in SWEEP_TOL:
            lu = B.band_lu(B.csr_to_device_band(a, policy, card, p=p)).lu
            acc = lu.policy.accum_dtype
            for nrhs in widths:
                case = f"{name} {policy} nrhs={nrhs}"
                if sms == 132:  # an H100 SXM: the regime each width is there for
                    cols = B.multi_plan(lu.nb, lu.ml, nrhs, 0, sms)[0]
                    assert cols == (B.FEW_COLS if nrhs <= B.FEW_COLS else
                                    128 if nrhs == 2304 else 32), (case, cols)
                rng = np.random.default_rng(nrhs)
                b = torch.from_numpy(rng.standard_normal((lu.nb * p, nrhs))).to(acc).to(card)
                for fwd in (True, False):
                    key = f"respa_band_sweep_multi_{'fwd' if fwd else 'bwd'}_{TOL_INST[policy]}"
                    before = B.LAUNCHES[key]
                    y = B.band_sweep_multi(lu, b, fwd)
                    torch.cuda.synchronize()
                    assert B.LAUNCHES[key] == before + 1, (case, key)
                    ref = B.band_sweep_plain(lu, b, fwd)
                    err = float((y - ref).abs().max() / ref.abs().max())
                    assert err <= SWEEP_TOL[policy], (case, key, err)
                    assert torch.equal(_bits(y), _bits(B.band_sweep_multi(lu, b, fwd))), (case, key)
                r0 = lu.nb // 2
                b[:r0 * p] = 0
                assert torch.equal(_bits(B.band_sweep_multi(lu, b, True, r0)),
                                   _bits(B.band_sweep_multi(lu, b, True))), case


def test_band_solve_of_several_right_hand_sides_launches_k10(card, monkeypatch):
    """``band_solve`` with a 2-D b goes through K10, both sweeps, and no
    plain version of the port runs; the solve's residual is the one-column
    solve's."""
    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    a, p = _sweep_matrix("laplacian_2d")
    lu = B.band_lu(B.csr_to_device_band(a, "fp32", card, p=p)).lu
    rhs = torch.from_numpy(np.random.default_rng(4).standard_normal((a.nrows, 5))).float()
    for mod in (B, F, K):
        for name in dir(mod):
            if name.endswith("_plain"):
                monkeypatch.setattr(mod, name, refuse)
    before = dict(B.LAUNCHES)
    x = B.band_solve(lu, rhs.to(card))
    torch.cuda.synchronize()
    for d in ("fwd", "bwd"):
        assert B.LAUNCHES[f"respa_band_sweep_multi_{d}_f32"] == before[
            f"respa_band_sweep_multi_{d}_f32"] + 1
    dense = torch.from_numpy(a.toarray())
    resid = (dense @ x.double().cpu() - rhs.double()).norm(dim=0) / rhs.double().norm(dim=0)
    assert float(resid.max()) <= 1e-4


def test_band_sweep_t_matches_plain(card):
    """K11 against ``band_sweep_t_plain`` on every sweep case, and on a band
    of blocks of 10 (not a multiple of 4: the panels read a value at a time),
    in every policy and direction, twice bit for bit, each launch counted;
    ``band_solve_transpose`` solves A^T z = s."""
    cases = {name: _sweep_matrix(name) for name in SWEEP_CASES}
    cases["p10"] = (synth.random_banded(300, 40, 8, seed=6), 10)
    for name, (a, p) in cases.items():
        for policy in SWEEP_TOL:
            lu = B.band_lu(B.csr_to_device_band(a, policy, card, p=p)).lu
            acc = lu.policy.accum_dtype
            b = torch.from_numpy(np.random.default_rng(5).standard_normal(lu.nb * p))
            b = b.to(acc).to(card)
            if policy == "fp32_ftz":
                b[::7] = 1e-40  # subnormal entries, flushed on load
            for fwd in (True, False):
                key = f"respa_band_sweep_t_{'fwd' if fwd else 'bwd'}_{TOL_INST[policy]}"
                before = B.LAUNCHES[key]
                y = B.band_sweep_t(lu, b, fwd)
                torch.cuda.synchronize()
                assert B.LAUNCHES[key] == before + 1, (name, key)
                ref = B.band_sweep_t_plain(lu, b, fwd)
                err = float((y - ref).abs().max() / ref.abs().max())
                assert err <= SWEEP_TOL[policy], (name, key, err)
                assert torch.equal(_bits(y), _bits(B.band_sweep_t(lu, b, fwd))), (name, key)
            if policy in ("fp32", "fp64"):
                s = b[:a.nrows].clone()
                z = B.band_solve_transpose(lu, s)
                dense = torch.from_numpy(a.toarray())
                resid = (dense.T @ z.double().cpu() - s.double().cpu()).norm() / s.norm().cpu()
                assert float(resid) <= (1e-12 if policy == "fp64" else 1e-4), (name, policy)


def test_band_wrappers_reject_bad_input(card):
    a = synth.laplacian_2d(12, 12)
    lu = B.band_lu(B.csr_to_device_band(a, "fp32", card, p=16)).lu
    good = torch.zeros(lu.nb * 16, device=card)
    with pytest.raises(TypeError):
        B.band_sweep(lu, good.double(), True)
    with pytest.raises(ValueError):
        B.band_sweep(lu, good.cpu(), True)
    with pytest.raises(ValueError):
        B.band_sweep(lu, good[:-1], True)
    with pytest.raises(ValueError):
        B.band_sweep(lu, torch.zeros(2 * lu.nb * 16, device=card)[::2], True)
    with pytest.raises(ValueError):  # the band's type must be the policy's
        B.band_sweep(dataclasses.replace(lu, data=lu.data.double()), good, True)
    with pytest.raises(ValueError, match="no inverses"):  # never substitution instead
        B.band_sweep(dataclasses.replace(lu, inv=None), good, True)
    with pytest.raises(TypeError, match="inverses must be"):
        B.band_sweep(dataclasses.replace(lu, inv=lu.inv.double()), good, True)
    with pytest.raises(ValueError, match="inverses must be"):
        B.band_sweep(dataclasses.replace(lu, inv=lu.inv[:, :1].contiguous()), good, True)
    blocks = torch.eye(16, device=card).repeat(2, 1, 1)
    with pytest.raises(ValueError):  # last stride must be 1
        B.block_lu(blocks.transpose(1, 2).contiguous().transpose(1, 2), 1e-4)
    with pytest.raises(ValueError):
        B.block_lu(torch.eye(130, device=card)[None], 1e-4)
    with pytest.raises(TypeError):
        B.block_lu(blocks.half(), 1e-4)
    with pytest.raises(TypeError):
        B.block_lu(blocks.double(), 1e-13, flush=True)
    before = dict(B.LAUNCHES)
    B.block_lu(blocks.cpu(), 1e-4)  # a CPU tensor runs the plain version: no launch
    assert B.LAUNCHES == before


def test_tf32_is_refused(card):
    a = synth.laplacian_2d(8, 8)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            B.band_lu(B.csr_to_device_band(a, "fp32", card, p=16))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


# ---------------------------------------------------------------------------
# the frontal kernels
# ---------------------------------------------------------------------------

FRONT_INST = {"f32": (torch.float32, False), "f32_ftz": (torch.float32, True),
              "f64": (torch.float64, False)}
FRONT_TOL = {torch.float32: 2e-5, torch.float64: 1e-12}
# (fronts, wp, rp, parents): one front; hundreds of children of two parents
# (warp regime); roots without update rows; wp = 24; the widest a thread block
# solves; a panel over 10 tiles; wide fronts, without update rows too; a hub
# of 180 children of one parent; the warp regime at wp = 32 with a panel of
# two passes; 333 update rows over 5 tiles of 67; a wide front of odd widths;
# a wide root of 10 row blocks
FRONT_SHAPES = [(1, 8, 8, 1), (700, 8, 16, 2), (3, 24, 0, 0), (6, 24, 32, 4),
                (5, 128, 48, 3), (2, 48, 640, 1), (2, 192, 96, 1), (1, 200, 0, 0),
                (3, 300, 70, 2), (180, 8, 16, 1), (50, 32, 40, 3), (1, 40, 333, 1),
                (2, 333, 77, 1), (1, 640, 0, 0)]
# SHA-256 of K4's outputs on FRONT_SHAPES (:func:`_k4_digest`) from the build
# before K12 had kernels of its own, when K4's kernels also served K12: the
# same bits now say that K4's code did not change with K12's.
K4_DIGESTS = {"f32": "1c8a1715ec423bccb7d2893590809a711c195cd1308f7476456dea84b492ba9a",
              "f32_ftz": "fe25784270ce379e48f9a8a722f55e75765f1b8fde600d0f8b9d3b7ced1a203c",
              "f64": "7937f52b98274e4d468deb911f201ba6b275d22f6f2cfe1de1019600428c17d5"}


def _front_group(shape, dtype, card):
    g = synth.frontal_group(*shape, seed=sum(shape))
    t = {k: torch.from_numpy(v).to(card) for k, v in g.items() if isinstance(v, np.ndarray)}
    t["pool"], t["y"] = t["pool"].to(dtype), t["y"].to(dtype)
    t["ga_base"] = torch.tensor(g.get("ga_base", 0))  # a host scalar
    return t


def _held(got, ref, dtype):
    return float((got - ref).abs().max()) <= FRONT_TOL[dtype] * max(float(ref.abs().max()), 1.0)


def test_frontal_kernels_match_plain(card):
    """Extend-add bit for bit (the same additions in the same order), sweeps
    and reduction within tolerance, every one twice, bitwise equal, each
    wrapper counting its launches; over all the shapes, in every instance."""
    for inst in FRONT_INST:
        for shape in FRONT_SHAPES:
            _check_frontal_kernels(card, shape, inst)


def _check_frontal_kernels(card, shape, inst):
    dtype, flush = FRONT_INST[inst]
    nf, wp, rp, npar = shape
    t = _front_group(shape, dtype, card)
    grp = (0, nf, wp, rp)
    before = dict(F.LAUNCHES)
    if npar:  # both regimes (the gather lists up to GATHER_RP rows) and the rows
        idx = (t["lp"], t["poff"], t["pmp"], t["seg_ptr"])
        ref = t["pool"].clone()
        F.extend_add_plain(ref, *grp, *idx, flush)
        regimes = [None]
        if "ga_dst" in t:
            regimes.insert(0, (t["ga_base"], t["ga_dst"], t["ga_src"], t["ga_ptr"]))
        for lists in regimes:
            out = [t["pool"].clone() for _ in range(2)]
            F.extend_add(out[0], *grp, *idx, flush, lists)
            F.extend_add(out[1], *grp, *idx, flush, lists)
            torch.cuda.synchronize()
            assert torch.equal(out[0], out[1]) and torch.equal(out[0], ref), lists is None
        assert F.LAUNCHES[f"respa_extend_add_{inst}"] == \
            before[f"respa_extend_add_{inst}"] + 2 * len(regimes)
    for fwd in (True, False):
        name = f"respa_front_sweep_{'fwd' if fwd else 'bwd'}_{inst}"
        ys = [t["y"].clone() for _ in range(3)]
        u0 = F.front_sweep(t["pool"], ys[0], *grp, t["piv"], t["rsx"], fwd, flush,
                           control=F.control_zeros(t["pool"], *grp[1:]))
        u1 = F.front_sweep(t["pool"], ys[1], *grp, t["piv"], t["rsx"], fwd, flush,
                           control=F.control_zeros(t["pool"], *grp[1:]))
        u2 = F.front_sweep_plain(t["pool"], ys[2], *grp, t["piv"], t["rsx"], fwd, flush)
        torch.cuda.synchronize()
        assert torch.equal(ys[0], ys[1]) and _held(ys[0], ys[2], dtype)
        assert float(ys[0][-1]) == 0.0
        assert F.LAUNCHES[name] == before[name] + 2
        if fwd and rp:
            assert torch.equal(u0, u1) and _held(u0, u2, dtype)
            red = (t["red_rows"], t["red_ptr"], t["red_src"])
            same = ys[0].clone()  # the reduction sums in its plain version's order
            F.rows_reduce(ys[0], u0, *red, flush)
            F.rows_reduce(ys[1], u0, *red, flush)
            F.rows_reduce_plain(ys[2], u0, *red, flush)
            F.rows_reduce_plain(same, u0, *red, flush)
            torch.cuda.synchronize()
            assert torch.equal(ys[0], ys[1]) and _held(ys[0], ys[2], dtype)
            assert torch.equal(ys[0], same)


def _k4_digest(inst, card):
    """SHA-256 over K4's outputs on every shape of FRONT_SHAPES in one
    instance: the forward sweep's y and upd, then the backward sweep's y."""
    dtype, flush = FRONT_INST[inst]
    h = hashlib.sha256()
    for shape in FRONT_SHAPES:
        nf, wp, rp, _ = shape
        t = _front_group(shape, dtype, card)
        grp = (0, nf, wp, rp)
        for fwd in (True, False):
            y = t["y"].clone()
            u = F.front_sweep(t["pool"], y, *grp, t["piv"], t["rsx"], fwd, flush,
                              control=F.control_zeros(t["pool"], *grp[1:]))
            for out in (y, u) if fwd else (y,):
                h.update(out.cpu().numpy().tobytes())
    return h.hexdigest()


def test_front_sweep_bits_are_unchanged(card):
    """K4's outputs on FRONT_SHAPES in every instance are the bits saved
    in K4_DIGESTS."""
    for inst in FRONT_INST:
        assert _k4_digest(inst, card) == K4_DIGESTS[inst], inst


def test_front_sweep_t_matches_plain(card):
    """K12 against ``front_sweep_t_plain`` on every shape and instance, in
    each regime, twice bit for bit, y's spare slot untouched, each launch
    counted; and the transposed solve of a factored pool launches K12 only,
    against the plain solve."""
    for inst in FRONT_INST:
        dtype, flush = FRONT_INST[inst]
        for shape in FRONT_SHAPES:
            nf, wp, rp, _ = shape
            t = _front_group(shape, dtype, card)
            grp = (0, nf, wp, rp)
            for fwd in (True, False):
                name = f"respa_front_sweep_t_{'fwd' if fwd else 'bwd'}_{inst}"
                before = F.LAUNCHES[name]
                ys = [t["y"].clone() for _ in range(3)]
                u = [F.front_sweep_t(t["pool"], ys[k], *grp, t["piv"], t["rsx"], fwd, flush,
                                     control=F.control_zeros(t["pool"], *grp[1:]))
                     for k in range(2)]
                u.append(F.front_sweep_t_plain(t["pool"], ys[2], *grp, t["piv"], t["rsx"], fwd,
                                               flush))
                torch.cuda.synchronize()
                case = (shape, inst, fwd)
                assert F.LAUNCHES[name] == before + 2, case
                assert torch.equal(ys[0], ys[1]) and _held(ys[0], ys[2], dtype), case
                assert float(ys[0][-1]) == 0.0, case
                if fwd and rp:
                    assert torch.equal(u[0], u[1]) and _held(u[0], u[2], dtype), case
    a = synth.mesh_fem_3d(3000, seed=5)
    plan = F.build_frontal_plan(snlu.analyze_supernodes(a))
    pool, _ = F.frontal_factor_pool(plan, torch.float64, card)
    b = torch.from_numpy(np.random.default_rng(2).standard_normal(a.nrows))
    before = dict(F.LAUNCHES)
    z = F.FrontalSolver(plan, pool).solve_t_device(b.to(card))
    torch.cuda.synchronize()
    for name, more in (("respa_front_sweep_t_fwd_f64", len(plan.groups)),
                       ("respa_front_sweep_t_bwd_f64", len(plan.groups)),
                       ("respa_front_sweep_fwd_f64", 0)):
        assert F.LAUNCHES[name] == before[name] + more, name
    ref = F.FrontalSolver(plan, pool.cpu()).solve_t_device(b)
    assert _held(z.cpu(), ref, torch.float64)


def test_launch_sweep_is_the_kernels_part_of_a_wide_front(card):
    """A front wider than ``MAX_TRI``: ``launch_sweep`` into the output
    ``front_sweep`` allocates gives what ``front_sweep`` gives, bit for bit,
    and counts once; each launch draws tickets zeroed for it alone."""
    nf, wp, rp = 2, 192, 96
    t = _front_group((nf, wp, rp, 1), torch.float32, card)
    grp = (0, nf, wp, rp)
    y, ref = t["y"].clone(), t["y"].clone()
    want = F.front_sweep(t["pool"], ref, *grp, t["piv"], t["rsx"], True,
                         control=F.control_zeros(t["pool"], nf, wp, rp))
    upd = torch.empty((nf, rp), device=card)
    before = F.LAUNCHES["respa_front_sweep_fwd_f32"]
    F.launch_sweep(t["pool"], y, *grp, t["piv"], t["rsx"], True, False, upd,
                   F.control_zeros(t["pool"], nf, wp, rp))
    torch.cuda.synchronize()
    assert F.LAUNCHES["respa_front_sweep_fwd_f32"] == before + 1
    assert torch.equal(upd, want) and torch.equal(y, ref)


def test_a_wide_front_sweep_calls_no_library_triangle(card, monkeypatch):
    """On the card every width is the kernel's: ``front_sweep`` on wide
    groups, with and without update rows, never reaches
    ``torch.linalg.solve_triangular``."""
    def refuse(*args, **kwargs):
        raise AssertionError("torch.linalg.solve_triangular called on the card")

    groups = [_front_group(shape, torch.float32, card) for shape in ((2, 300, 70, 1),
                                                                   (1, 200, 0, 0))]
    monkeypatch.setattr(torch.linalg, "solve_triangular", refuse)
    for t, (nf, wp, rp) in zip(groups, ((2, 300, 70), (1, 200, 0))):
        for fwd in (True, False):
            F.front_sweep(t["pool"], t["y"], 0, nf, wp, rp, t["piv"], t["rsx"], fwd,
                          control=F.control_zeros(t["pool"], nf, wp, rp))
    torch.cuda.synchronize()


def test_frontal_factor_and_solve_on_the_card(card):
    """The factorization on the card against the plain one on the CPU, twice
    bit for bit, and the solve against the plain solve from the same pool;
    every instance, on a FEM and a circuit matrix."""
    for a in (synth.mesh_fem_3d(3000, seed=5), synth.circuit_like(2500, 5, seed=4,
                                                                  diag="dominant")):
        plan = F.build_frontal_plan(snlu.analyze_supernodes(a))
        for dtype, flush in FRONT_INST.values():
            _check_factor_and_solve(card, a, plan, dtype, flush)


def _check_factor_and_solve(card, a, plan, dtype, flush):
    on_card, nbad = F.frontal_factor_pool(plan, dtype, card, flush=flush)
    again, _ = F.frontal_factor_pool(plan, dtype, card, flush=flush)
    plain, nplain = F.frontal_factor_pool(plan, dtype, "cpu", flush=flush)
    assert torch.equal(on_card, again) and nbad == nplain
    assert _held(on_card.cpu(), plain, dtype)
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(a.nrows)).to(dtype)
    solver = F.FrontalSolver(plan, on_card, flush)
    x = solver.solve_device(b.to(card))
    assert torch.equal(x, solver.solve_device(b.to(card)))
    ref = F.FrontalSolver(plan, on_card.cpu(), flush).solve_device(b)
    assert _held(x.cpu(), ref, dtype)
    # two solves on two streams at once equal the sequential ones bit for
    # bit: each solve's tickets and mailboxes are its own (P3)
    b2 = b.flip(0).to(card)
    x2 = solver.solve_device(b2)
    got = _on_two_streams(lambda: solver.solve_device(b.to(card)), lambda: solver.solve_device(b2))
    assert torch.equal(got[0], x) and torch.equal(got[1], x2)


def test_a_frontal_solve_replays_its_graph_bit_for_bit(card):
    """A circuit whose plan has groups in all three of K4's regimes, in every
    instance, both directions (K4, K12): three solves of different b through
    the graph each equal the eager loop bit for bit, the first unchanged
    after the later ones, with 1 capture and 2 replays counted and
    ``LAUNCHES`` raised by the eager loop's launches a solve; two solves on
    two new streams at once equal the sequential ones; a solve inside a
    caller's own capture runs the loop and replays with it."""
    a = synth.circuit_like(2500, 5, seed=4, diag="dominant")
    plan = F.build_frontal_plan(snlu.analyze_supernodes(a))
    regimes = {F.sweep_regime(g.nfronts, g.wp, g.rp)[0] for g in plan.groups}
    assert regimes == {"warp", "block", "wide"}
    rng = np.random.default_rng(6)
    for inst, (dtype, flush) in FRONT_INST.items():
        pool, _ = F.frontal_factor_pool(plan, dtype, card, flush=flush)
        solver = F.FrontalSolver(plan, pool, flush)
        bs = [torch.from_numpy(rng.standard_normal(a.nrows)).to(dtype).to(card)
              for _ in range(3)]
        for sweep, solve in ((F.front_sweep, solver.solve_device),
                             (F.front_sweep_t, solver.solve_t_device)):
            case = (inst, sweep.__name__)
            before = dict(F.LAUNCHES)
            eager = [solver._eager(b, sweep).clone() for b in bs]
            torch.cuda.synchronize()
            one = {k: (n - before[k]) // 3 for k, n in F.LAUNCHES.items() if n != before[k]}
            assert sum(one.values()) == solver.launches_per_solve, case
            before = dict(F.LAUNCHES)
            with timing.recording() as rec:
                got = [solve(b) for b in bs]
            torch.cuda.synchronize()
            assert rec.counts == {"frontal_capture": 1, "frontal_replay": 2}, case
            assert {k: n - before[k] for k, n in F.LAUNCHES.items()
                    if n != before[k]} == {k: 3 * n for k, n in one.items()}, case
            assert all(torch.equal(x, e) for x, e in zip(got, eager)), case
            pair = _on_two_streams(lambda: solve(bs[0]), lambda: solve(bs[1]))
            assert torch.equal(pair[0], eager[0]) and torch.equal(pair[1], eager[1]), case
            theirs, b2 = torch.cuda.CUDAGraph(), bs[2].clone()
            with timing.recording() as rec:
                with torch.cuda.graph(theirs):
                    x2 = solve(b2)
            assert rec.counts == {"frontal_eager": 1}, case
            theirs.replay()
            torch.cuda.synchronize()
            assert torch.equal(x2, eager[2]), case


def _on_two_streams(first, second):
    """Run ``first`` and ``second`` on two new streams at once; their results."""
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    out = []
    for stream, fn in zip(streams, (first, second)):
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            out.append(fn())
    torch.cuda.synchronize()
    return out


def test_multifrontal_slice_on_the_card(card):
    """factorize -> snlu with matching -> solve_refined on a weak-diagonal
    circuit, every kernel of the path counted."""
    a = synth.circuit_like(3000, 5, seed=13)
    b, _ = solve.make_rhs_for_known_x(a)
    before = dict(F.LAUNCHES, **B.LAUNCHES, spmv=K.LAUNCHES["fp64"])
    fac = solve.factorize(a, "fp32", method="auto", max_band_bytes=1 << 20)
    x, rep = solve.solve_refined(a, b, fac=fac)
    assert rep.notes.startswith("method=snlu,matching+ruiz") and rep.residual <= 1e-10
    after = dict(F.LAUNCHES, **B.LAUNCHES, spmv=K.LAUNCHES["fp64"])
    for name in ("respa_block_lu_f32", "respa_extend_add_f32", "respa_front_sweep_fwd_f32",
                 "respa_front_sweep_bwd_f32", "respa_rows_reduce_f32", "spmv"):
        assert after[name] > before[name], name
    assert 0 < fac.condest() <= 1


def test_frontal_wrappers_reject_bad_input_and_tf32(card):
    t = _front_group((6, 24, 32, 4), torch.float32, card)
    with pytest.raises(ValueError):  # y on another device
        F.front_sweep(t["pool"], t["y"].cpu(), 0, 6, 24, 32, t["piv"], t["rsx"], True,
                      control=F.control_zeros(t["pool"], 6, 24, 32))
    with pytest.raises(TypeError):  # no bf16 pool
        F.front_sweep(t["pool"].bfloat16(), t["y"].bfloat16(), 0, 6, 24, 32, t["piv"], t["rsx"],
                      True, control=F.control_zeros(t["pool"].bfloat16(), 6, 24, 32))
    with pytest.raises(TypeError):
        F.rows_reduce(t["y"].double(), torch.zeros(6, 32, dtype=torch.float64, device=card),
                      t["red_rows"], t["red_ptr"], t["red_src"], flush=True)
    before = dict(F.LAUNCHES)
    cpu = {k: v.cpu() for k, v in t.items()}
    F.front_sweep(cpu["pool"], cpu["y"], 0, 6, 24, 32, cpu["piv"], cpu["rsx"], True,
                  control=F.control_zeros(cpu["pool"], 6, 24, 32))
    assert F.LAUNCHES == before  # a CPU tensor runs the plain version: no launch
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            solve.factorize(synth.laplacian_2d(8, 8), method="snlu")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


ILU_INST = {"f32": "fp32", "f32_ftz": "fp32_ftz", "bf16": "bf16", "f64": "fp64"}


def _triangle(kind, n=3000, seed=0):
    """Lower triangles: random with rows that hold no off-diagonal entry, a
    600-entry hub row (last) and a zero diagonal entry (row 5); a chain of n
    levels; one level."""
    rng = np.random.default_rng(seed)
    if kind == "chain":
        rows = np.r_[np.arange(n), np.arange(1, n)]
        cols = np.r_[np.arange(n), np.arange(n - 1)]
    elif kind == "one_level":
        rows, cols = np.arange(n), np.arange(n)
    else:
        r, c = rng.integers(0, n, 6 * n), rng.integers(0, n, 6 * n)
        rows = np.r_[np.maximum(r, c), np.full(600, n - 1), np.arange(n)]
        cols = np.r_[np.minimum(r, c), rng.choice(n - 1, 600, replace=False), np.arange(n)]
        keep = (rows % 7 != 3) | (rows == cols)
        rows, cols = rows[keep], cols[keep]
    vals = rng.uniform(0.5, 1.5, rows.size) * rng.choice((-1.0, 1.0), rows.size)
    vals[rows == cols] += 3.0
    t = coo_to_csr(COOMatrix((n, n), rows.astype(np.int32), cols.astype(np.int32), vals))
    t.data[t.indptr[5]:t.indptr[6]][t.indices[t.indptr[5]:t.indptr[6]] == 5] = 0.0
    return t


def _upper(t):
    """The lower triangle turned by 180 degrees: upper, its hub row kept."""
    n = t.nrows
    coo = t.tocoo()
    return coo_to_csr(COOMatrix((n, n), (n - 1 - coo.row).astype(np.int32),
                                (n - 1 - coo.col).astype(np.int32), coo.val))


def test_ilu_kernels_match_plain(card):
    """K6 (one ILU(0) sweep) and K7 (the one-launch triangular solve) bit
    for bit with their plain versions in every instance, twice, each counting
    its launches, the slot past the output untouched (K7 on a hub row, empty
    rows, a zero diagonal, a chain of runs and one level, lower and upper);
    K7 on two streams at once equal to the sequential solves; the link probe
    on two SMs; subnormals flushed under fp32_ftz."""
    a = synth.circuit_like(4000, 5, seed=2, diag="dominant")
    sched = I.ilu_schedule_to_device(analysis.chow_patel_schedule(a), card)
    for inst, policy in ILU_INST.items():
        p = get_policy(policy)
        av = p.cast_host(a.data).to(card)
        old = (av.to(torch.float64) * 1.01).to(p.dtype)
        name = f"respa_ilu0_sweep_{inst}"
        before = I.LAUNCHES[name]
        outs = []
        for _ in range(2):
            out = torch.full((a.nnz + 1,), 7.0, dtype=p.dtype, device=card)
            _, res = I.ilu0_sweep(sched, av, old, 0.5, True, p.flush_to_zero, True, out=out)
            outs.append((out, res))
        want, wres = I.ilu0_sweep_plain(sched, av, old, 0.5, True, p.flush_to_zero, True)
        torch.cuda.synchronize()
        assert I.LAUNCHES[name] == before + 2
        for out, res in outs:
            assert torch.equal(out[:-1], want) and float(out[-1]) == 7.0, inst
            assert torch.equal(res, wres), inst
    b64 = np.random.default_rng(1).standard_normal(3000)
    for kind in ("random", "chain", "one_level"):
        t = _triangle(kind)
        for lower in (True, False):
            tri = t if lower else _upper(t)
            for unit in (False, True):
                for inst, policy in ILU_INST.items():
                    d = S.tri_to_device(tri, lower, unit, policy, device=card)
                    b = torch.from_numpy(b64).to(d.policy.accum_dtype).to(card)
                    name = f"respa_tri_solve_{'lower' if lower else 'upper'}_{inst}"
                    before = S.LAUNCHES[name]
                    ys = []
                    for _ in range(2):
                        y = torch.full((3001,), 7.0, dtype=b.dtype, device=card)
                        S.tri_solve(d, b, out=y)
                        ys.append(y)
                    want = S.tri_solve_plain(d, b)
                    torch.cuda.synchronize()
                    assert S.LAUNCHES[name] == before + 2
                    for y in ys:
                        assert torch.equal(y[:-1], want) and float(y[-1]) == 7.0, (kind, inst)
    d = S.tri_to_device(_triangle("random"), True, False, "fp32", device=card)
    b = torch.from_numpy(b64).float().to(card)
    b2 = b.flip(0).contiguous()
    y1, y2 = S.tri_solve(d, b), S.tri_solve(d, b2)
    got = _on_two_streams(lambda: S.tri_solve(d, b), lambda: S.tri_solve(d, b2))
    assert torch.equal(got[0], y1) and torch.equal(got[1], y2)
    # the link probe: two SMs, a one-way hand-over of 0.05-5 us
    latency, sm_a, sm_b = S.link_latency(card, rounds=2000)
    assert sm_a != sm_b and 5e-8 < latency < 5e-6
    # a subnormal partial: y1 = 0 - n10 y0 = -1e-39 under fp32, 0 under fp32_ftz
    l2 = coo_to_csr(COOMatrix((2, 2), np.array([0, 1, 1], np.int32), np.array([0, 0, 1], np.int32),
                              np.array([1.0, 1e-20, 1.0])))
    for policy, nonzero in (("fp32", True), ("fp32_ftz", False)):
        y = S.tri_solve(S.tri_to_device(l2, policy=policy, device=card),
                        torch.tensor([1e-19, 0.0], device=card))
        assert (float(y[1]) != 0.0) == nonzero


def test_splu_kernel_matches_plain(card):
    """K8 (the scheduled LU in one launch) bit for bit with its plain
    version in every instance, twice, counting its launches, the slot past
    the output untouched: exact ILU(0) of a circuit with hub rows, and of one
    with a hub row and column (an entry of 1,502 pairs, past the kernel's
    staging budget: streamed in chunks), the exact LU of a band's fill
    (entries of up to 40 pairs: the warp's path), of a wider band's (long
    entries of 86 pairs at the median) and of a grid's, each plan cut at the
    package's pair budget and at the smallest one (SHORT: every long entry a
    task of its own); a perturbed pivot counted; a subnormal pivot flushed
    and clamped under fp32_ftz; K8 on two streams at once equal to the
    sequential factorizations."""
    c = synth.circuit_like(4000, 5, seed=2, diag="dominant")
    coo, rng = c.tocoo(), np.random.default_rng(7)
    hub = rng.choice(c.nrows - 1, 1500, replace=False)
    arrow = coo_to_csr(COOMatrix(
        c.shape, np.r_[coo.row, np.full(hub.size, c.nrows - 1), hub].astype(np.int32),
        np.r_[coo.col, hub, np.full(hub.size, c.nrows - 1)].astype(np.int32),
        np.r_[coo.val, rng.uniform(-1.0, 1.0, 2 * hub.size)]))
    pats = {"ilu0_circuit": c, "ilu0_circuit_hub": arrow,
            "lu_banded": analysis.symbolic_fill_lu(synth.random_banded(400, 40, 12, seed=5)),
            "lu_banded_wide": analysis.symbolic_fill_lu(synth.random_banded(400, 165, 12, seed=5)),
            "lu_grid": analysis.symbolic_fill_lu(synth.laplacian_2d(40, 35))}
    assert np.diff(analysis.chow_patel_schedule(arrow).ptr).max() > SP.MAX_BUDGET
    for (pname, f), budget in [(kv, b) for kv in pats.items() for b in (SP.SHORT, SP.PAIR_BUDGET)]:
        d = SP.splu_to_device(SP._plan_cut(f.nrows, analysis.chow_patel_schedule(f), budget), card)
        for inst, policy in ILU_INST.items():
            p = get_policy(policy)
            av = p.cast_host(f.data).to(card)
            eps = 1e-4 * float(np.abs(f.data).max())
            name = f"respa_splu_factor_{inst}"
            before = SP.LAUNCHES[name]
            outs = []
            for _ in range(2):
                out = torch.full((f.nnz + 1,), 7.0, dtype=p.dtype, device=card)
                SP.splu_factor(d, av, eps, p.flush_to_zero, out=out)
                outs.append(out)
            want = SP.splu_factor_plain(d, av, eps, p.flush_to_zero)
            torch.cuda.synchronize()
            assert SP.LAUNCHES[name] == before + 2, (pname, budget, inst)
            for out in outs:
                assert torch.equal(out[:-1], want) and float(out[-1]) == 7.0, \
                    (pname, budget, inst)
    f = pats["lu_grid"]
    d = SP.splu_to_device(SP.build_scheduled_lu(f), card)
    a1 = torch.from_numpy(f.data).to(card)
    a2 = (a1 * 1.5).contiguous()
    y1, y2 = SP.splu_factor(d, a1, 1e-13), SP.splu_factor(d, a2, 1e-13)
    got = _on_two_streams(lambda: SP.splu_factor(d, a1, 1e-13),
                          lambda: SP.splu_factor(d, a2, 1e-13))
    assert torch.equal(got[0], y1) and torch.equal(got[1], y2)
    # a zero pivot used by L entries (counted), and a subnormal one under fp32_ftz
    z = solve.CSRMatrix((2, 2), np.array([0, 2, 4]), np.array([0, 1, 0, 1], np.int32),
                        np.array([0.0, 1.0, 1.0, 1.0]))
    res, _ = SP.scheduled_lu_factor(z, policy="fp64", pivot_eps=0.5, device=card)
    assert res.n_pivot_perturbed == 1 and float(res.values[2]) == 2.0
    s = solve.CSRMatrix((2, 2), np.array([0, 1, 3]), np.array([0, 0, 1], np.int32),
                        np.array([1e-39, 1e-10, 1.0]))
    r32, _ = SP.scheduled_lu_factor(s, policy="fp32", pivot_eps=1e-44, device=card)
    rftz, _ = SP.scheduled_lu_factor(s, policy="fp32_ftz", pivot_eps=1e-44, device=card)
    assert r32.n_pivot_perturbed == 0 and rftz.n_pivot_perturbed == 1
    assert float(rftz.values[0]) == 0.0 and float(r32.values[0]) > 0.0


def test_dia_kernel_matches_plain(card):
    """K9 (the DIA SpMV) bit for bit with its plain version in every
    instance, twice, counting its launches: a 3-D stencil, a rectangular
    matrix, a stencil with a remainder (summed inside the kernel), no
    diagonal kept (rows of several remainder entries); subnormals flushed
    under fp32_ftz."""
    rng = np.random.default_rng(4)
    lap = synth.laplacian_2d(60, 50)
    coo = lap.tocoo()
    extra = rng.integers(0, lap.nrows, (2, 200))
    stragglers = coo_to_csr(COOMatrix(lap.shape, np.r_[coo.row, extra[0]].astype(np.int32),
                                      np.r_[coo.col, extra[1]].astype(np.int32),
                                      np.r_[coo.val, rng.uniform(-0.5, 0.5, 200)]))
    rows = np.r_[np.arange(500), np.arange(500), np.arange(480)]
    rect = coo_to_csr(COOMatrix((500, 700), rows.astype(np.int32),
                                np.r_[np.arange(500), np.arange(500) + 150,
                                      np.arange(480) + 220].astype(np.int32),
                                rng.uniform(-1.0, 1.0, rows.size)))
    scattered = coo_to_csr(COOMatrix((300, 300), rng.integers(0, 300, 400).astype(np.int32),
                                     rng.integers(0, 300, 400).astype(np.int32),
                                     rng.standard_normal(400)))
    for mname, a in {"stencil_3d": synth.laplacian_3d(30, 20, 10), "rect": rect,
                     "stragglers": stragglers, "scattered": scattered}.items():
        x64 = rng.standard_normal(a.shape[1])
        x64[::9] = 1e-40
        for inst, policy in ILU_INST.items():
            dev = K.to_device(a, policy, card, fmt="dia")
            x = torch.from_numpy(x64).to(dev.policy.accum_dtype).to(card)
            name = f"respa_dia_spmv_{inst}"
            before = DI.LAUNCHES[name]
            ys = [DI.dia_spmv(dev, x) for _ in range(2)]
            want = DI.dia_spmv_plain(dev, x)
            torch.cuda.synchronize()
            assert DI.LAUNCHES[name] == before + 2, (mname, inst)
            assert all(torch.equal(y, want) for y in ys), (mname, inst)
            assert torch.equal(K.spmv(dev, x), ys[0]), (mname, inst)
            ref = K.spmv_csr_reference(a, x.double().cpu().numpy())
            err = float(np.abs(ys[0].double().cpu().numpy() - ref).max() / np.abs(ref).max())
            assert err <= TOL[policy] or policy == "bf16", (mname, inst, err)
    one = K.to_device(solve.CSRMatrix((1, 1), np.array([0, 1]), np.array([0], np.int32),
                                      np.array([1e-20])), "fp32_ftz", card, fmt="dia")
    assert float(K.spmv(one, torch.tensor([1e-20], device=card))[0]) == 0.0
    keep = K.to_device(solve.CSRMatrix((1, 1), np.array([0, 1]), np.array([0], np.int32),
                                       np.array([1e-20])), "fp32", card, fmt="dia")
    assert float(K.spmv(keep, torch.tensor([1e-20], device=card))[0]) != 0.0


def test_persisted_factors_solve_on_the_card_like_the_live_ones(card, tmp_path, monkeypatch):
    """A saved scheduled sparse LU (every policy) and a band LU (fp32,
    fp64) load onto the card and solve bit for bit like the live factors:
    the same values, the same K7 schedules and K2 launches; a matched
    multifrontal factor loads onto K7 triangles of its pool's type (fp32
    for bf16) and refines to 1e-12, and an fp64 one forced onto its frontal
    pool keeps fp64."""
    from respatpu_torch import persist
    lap = synth.laplacian_2d(40, 35)
    b, _ = solve.make_rhs_for_known_x(lap)
    for policy in ("fp32", "fp32_ftz", "bf16", "fp64"):
        live = solve.factorize(lap, policy, method="sparse", device=card)
        path = str(tmp_path / f"sparse_{policy}.npz")
        persist.save_sparse_factorization(path, live)
        before = dict(S.LAUNCHES)
        fac = persist.load_sparse_factorization(path, lap, device=card)
        x = fac.solve(b)
        assert sum(S.LAUNCHES.values()) == sum(before.values()) + 2, policy
        assert np.array_equal(x, live.solve(b)) and fac.policy == live.policy, policy
    for policy in ("fp32", "fp64"):
        live = solve.factorize(lap, policy, method="band", device=card)
        path = str(tmp_path / f"band_{policy}.npz")
        persist.save_band_factorization(path, live)
        fac = persist.load_band_factorization(path, lap, device=card)
        assert fac._lu.data.device.type == "cuda" and torch.equal(fac._lu.data, live._lu.data)
        assert np.array_equal(fac.solve(b), live.solve(b)), policy
        _, rep = solve.solve_refined(lap, b, fac=fac)
        assert rep.residual <= 1e-12, policy
    circ = synth.circuit_like(3000, 5, seed=4)
    bc, _ = solve.make_rhs_for_known_x(circ)
    for policy, no_room in (("fp32", False), ("bf16", False), ("fp64", True)):
        live = solve.SupernodalLuFactorization(circ, policy=policy, matching=True, device=card)
        path = str(tmp_path / f"snlu_{policy}.npz")
        persist.save_sparse_factorization(path, live)
        with monkeypatch.context() as mp:
            if no_room:
                mp.setattr(persist, "_tri_budget", lambda device: 0)
            fac = persist.load_sparse_factorization(path, circ, device=card)
        _, rep = solve.solve_refined(circ, bc, fac=fac)
        assert rep.residual <= 1e-12, policy
        if not no_room:
            assert fac._l.vals.dtype == live._dtype, policy  # bf16's pool is fp32
        else:
            assert isinstance(fac, persist.LoadedFrontalLu)
            assert fac._frontal.pool.dtype == torch.float64 and fac._frontal.pool.is_cuda
            assert np.array_equal(fac.solve(bc), live.solve(bc))


def _dist_results(mesh, a, lap, band):
    """The distributed stack's results on ``mesh``, on the host."""
    from respatpu_torch import dist, dist_lu, dist_snlu_sub
    x = np.random.default_rng(1).standard_normal(a.nrows)
    out = {}
    for policy in ("fp32", "fp64"):
        op = dist.DistSpmv(a, mesh, policy=policy)
        out[policy] = op.unshard(op(op.shard_vector(x)))
    out["cg"] = dist.dist_cg(lap, solve.make_rhs_for_known_x(lap)[0], mesh=mesh, tol=1e-6,
                             max_iters=2000)
    out["bicgstab"] = dist.dist_bicgstab(a, solve.make_rhs_for_known_x(a)[0], mesh=mesh)
    fac = dist_lu.DistBandLu(band, mesh=mesh, p=32)
    out["spike"] = fac.solve(solve.make_rhs_for_known_x(band)[0])
    sub = dist_snlu_sub.DistSubtreeLu(a, mesh=mesh)
    out["subtree"] = sub.factor_values()
    out["subtree_solve"] = sub.solve(solve.make_rhs_for_known_x(a)[0])
    return out


def test_distributed_stack_on_one_card(card):
    """Four shards on one card, small: the distributed SpMV (fp32, fp64)
    against the single-card product and bit for bit from call to call, CG and
    BiCGSTAB with block-Jacobi ILU(0), SPIKE refined, and the subtree-sharded
    LU (two factorizations bit for bit, refined); each kernel of the path
    launched. On a host with several cards, the same four shards spread over
    them give the same bits (the subtree solve's copies between cards
    included)."""
    from respatpu_torch import dist, dist_lu, dist_snlu_sub
    from respatpu_torch.kernels import ilu0 as I
    mesh = dist.make_mesh(4, "cuda:0")
    assert mesh.describe() == "4 shards on 1 card"
    for counts in (K.LAUNCHES, B.LAUNCHES, F.LAUNCHES, I.LAUNCHES):
        for k in counts:
            counts[k] = 0
    a = synth.mesh_fem_3d(3000, seed=5)
    x = np.random.default_rng(1).standard_normal(a.nrows)
    for policy, tol in (("fp32", 1e-6), ("fp64", 1e-14)):
        op = dist.DistSpmv(a, mesh, policy=policy)
        xs = op.shard_vector(x)
        y = op(xs)
        assert all(torch.equal(u, v) for u, v in zip(y, op(xs))), policy
        one = K.to_device(a, policy, card, fmt="csr")
        ref = K.spmv(one, torch.from_numpy(x).to(one.policy.accum_dtype).to(card)).cpu().numpy()
        got = op.unshard(y)
        assert np.abs(got - ref).max() <= tol * np.abs(ref).max(), policy
    lap = synth.laplacian_2d(60, 50)
    b = solve.make_rhs_for_known_x(lap)[0]
    xc, it = dist.dist_cg(lap, b, mesh=mesh, tol=1e-6, max_iters=2000)
    assert solve.relative_residual(lap, xc, b) <= 1e-5 and 0 < it < 2000
    xb, it = dist.dist_bicgstab(a, solve.make_rhs_for_known_x(a)[0], mesh=mesh)
    assert solve.relative_residual(a, xb, solve.make_rhs_for_known_x(a)[0]) <= 1e-5
    band = synth.random_banded(5000, bandwidth=60, nnz_per_row=7, seed=3)
    fac = dist_lu.DistBandLu(band, mesh=mesh, p=32)
    xr, rep = dist_lu.dist_solve_refined(band, solve.make_rhs_for_known_x(band)[0], fac=fac)
    assert rep.residual <= 1e-10
    sub = dist_snlu_sub.DistSubtreeLu(a, mesh=mesh)
    vals = sub.factor_values()
    sub.refactorize_timed()
    np.testing.assert_array_equal(sub.factor_values(), vals)
    bb = solve.make_rhs_for_known_x(a)[0]
    sub.solve_refined(bb)
    assert sub.report.residual <= 1e-10
    torch.cuda.synchronize()
    assert K.LAUNCHES["fp32"] > 0 and K.LAUNCHES["fp64"] > 0, K.LAUNCHES
    for counts, names in ((B.LAUNCHES, ("respa_block_lu_f32", "respa_band_sweep_fwd_f32",
                                        "respa_band_sweep_bwd_f32")),
                          (F.LAUNCHES, ("respa_extend_add_f32", "respa_front_sweep_fwd_f32",
                                        "respa_front_sweep_bwd_f32", "respa_rows_reduce_f32")),
                          (I.LAUNCHES, ("respa_ilu0_sweep_f32",))):
        for name in names:
            assert counts[name] > 0, name
    cards = torch.cuda.device_count()
    if cards > 1:
        spread = dist.make_mesh(4, "cuda")
        assert spread.describe() == f"4 shards on {min(cards, 4)} cards"
        one = _dist_results(mesh, a, lap, band)
        many = _dist_results(spread, a, lap, band)
        for key, got in many.items():
            want = one[key]
            if isinstance(got, tuple):
                assert got[1] == want[1], key
                got, want = got[0], want[0]
            np.testing.assert_array_equal(got, want, err_msg=key)
