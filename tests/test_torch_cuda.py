"""The CSR SpMV kernel against its plain version on a CUDA card.

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
