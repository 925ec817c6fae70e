"""The hand-written kernels (CSR SpMV, block LU, band sweep) against their
plain versions on a CUDA card.

Marked ``cuda``: without a card each test skips with a reason. On a machine
with one, run ``python -m pytest --noconftest tests/test_torch_cuda.py -q``
(``tests/conftest.py`` imports JAX, which this file does not need).
"""
import dataclasses

import numpy as np
import pytest
import torch

from respatpu_torch.bench import synth
from respatpu_torch.formats import COOMatrix, coo_to_csr
from respatpu_torch.kernels import bandlu as B
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


@pytest.mark.parametrize("policy", list(TOL))
@pytest.mark.parametrize("name", ["rect", "mesh"] + EDGES)
def test_kernel_matches_plain(card, name, policy):
    a = (_matrix() if name == "rect" else synth.mesh_fem_3d(5000, seed=2) if name == "mesh"
         else synth.row_block_edges(K.CAP, K.MAX_ROWS)[name])
    x64 = np.random.default_rng(1).standard_normal(a.shape[1]) + 1.0
    dev = K.to_device(a, policy, card)
    x = torch.from_numpy(x64).to(dev.policy.accum_dtype).to(card)
    before = K.LAUNCHES[policy]
    y = K.spmv(dev, x)
    torch.cuda.synchronize()
    assert K.LAUNCHES[policy] == before + 1
    ref = (torch.from_numpy(K.spmv_csr_reference(a, x64)) if policy == "fp64"
           else K.spmv_plain(dev, x).double().cpu())
    err = float((y.double().cpu() - ref).abs().max() / max(float(ref.abs().max()), 1e-300))
    assert err <= TOL[policy]
    assert bool((y.cpu()[torch.diff(dev.indptr).cpu() == 0] == 0).all())
    if policy == "fp64":
        assert torch.equal(y, K.spmv(dev, x))


def test_wrapper_rejects_bad_input(card):
    dev = K.to_device(synth.laplacian_3d(5, 5, 5), "fp32", card)
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
@pytest.mark.parametrize("layout", ["in_band", "contiguous"])
@pytest.mark.parametrize("nblocks", [1, 7])
@pytest.mark.parametrize("p", [16, 32, 128])
def test_block_lu_matches_plain(card, p, nblocks, layout, dtype, flush):
    """Blocks whose first pivot is planted: zero, exactly eps, eps / 2,
    negative tiny, exactly -eps, twice eps (kept), and an ordinary one."""
    eps = 1e-13 if dtype == torch.float64 else 2.0 ** -13
    rng = np.random.default_rng(p)
    blk = rng.standard_normal((nblocks, p, 3 * p)) + np.tile(4 * np.sqrt(p) * np.eye(p), 3)
    for i, plant in enumerate([0.0, eps, eps / 2, -eps / 2, -eps, 2 * eps][:nblocks]):
        blk[i, 0, p] = plant
    x = torch.from_numpy(blk).to(dtype).to(card)[:, :, p:2 * p]
    if layout == "contiguous":
        x = x.contiguous()
    name = "respa_block_lu_" + ("f64" if dtype == torch.float64 else "f32_ftz" if flush else "f32")
    before = B.LAUNCHES[name]
    lu, cnt = B.block_lu(x, eps, flush)
    torch.cuda.synchronize()
    assert B.LAUNCHES[name] == before + 1
    ref, rcnt = B.block_lu_plain(x, eps, flush)
    assert torch.equal(cnt, rcnt) and int(cnt.sum()) >= min(nblocks, 5)
    assert float((lu - ref).abs().max() / ref.abs().max()) <= LU_TOL[dtype]
    again = B.block_lu(x, eps, flush)
    assert torch.equal(lu, again[0]) and torch.equal(cnt, again[1])


def _sweep_matrix(name):
    return {"one_block_row": (synth.random_banded(100, 30, 6, seed=1), 128),
            "ml_ne_mu": (synth.skew_banded(500, 70, 20, 7, seed=2), 16),
            "ml_eq_nb": (synth.random_banded(100, 99, 10, seed=4), 16),
            "laplacian_2d": (synth.laplacian_2d(40, 23), 32),
            "banded_p128": (synth.random_banded(1000, 300, 9, seed=5), 128)}[name]


SWEEP_CASES = ["one_block_row", "ml_ne_mu", "ml_eq_nb", "laplacian_2d", "banded_p128"]


@pytest.mark.parametrize("fwd", [True, False], ids=["fwd", "bwd"])
@pytest.mark.parametrize("policy", list(SWEEP_TOL))
@pytest.mark.parametrize("name", SWEEP_CASES)
def test_band_sweep_matches_plain(card, name, policy, fwd):
    a, p = _sweep_matrix(name)
    lu = B.band_lu(B.csr_to_device_band(a, policy, card, p=p)).lu
    b = torch.from_numpy(np.random.default_rng(3).standard_normal(lu.nb * p))
    b = b.to(lu.policy.accum_dtype).to(card)
    key = f"respa_band_sweep_{'fwd' if fwd else 'bwd'}_{TOL_INST[policy]}"
    before = B.LAUNCHES[key]
    y = B.band_sweep(lu, b, fwd)
    torch.cuda.synchronize()
    assert B.LAUNCHES[key] == before + 1
    ref = B.band_sweep_plain(lu, b, fwd)
    assert float((y - ref).abs().max() / ref.abs().max()) <= SWEEP_TOL[policy]
    assert torch.equal(y, B.band_sweep(lu, b, fwd))


@pytest.mark.parametrize("policy", ["fp32", "fp64"])
@pytest.mark.parametrize("name", SWEEP_CASES)
def test_band_factor_and_solve_on_the_card(card, name, policy):
    """The factorization on the card against the one on the CPU, and the
    solve's residual against the dense matrix."""
    a, p = _sweep_matrix(name)
    lu = B.band_lu(B.csr_to_device_band(a, policy, card, p=p)).lu
    plain = B.band_lu(B.csr_to_device_band(a, policy, "cpu", p=p)).lu
    scale = float(plain.data.float().abs().max())
    assert float((lu.data.cpu().float() - plain.data.float()).abs().max()) <= 1e-2 * scale
    b = torch.from_numpy(np.random.default_rng(3).standard_normal(lu.nb * p))
    b = b.to(lu.policy.accum_dtype).to(card)
    x = B.band_solve(lu, b[:a.nrows])
    dense = torch.from_numpy(a.toarray())
    resid = (dense @ x.double().cpu() - b[:a.nrows].double().cpu()).norm() / b[:a.nrows].norm().cpu()
    assert float(resid) <= {"fp64": 1e-12, "bf16": 5e-2}.get(policy, 1e-4)


TOL_INST = {"fp32": "f32", "fp32_ftz": "f32_ftz", "bf16": "bf16", "fp64": "f64"}


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
