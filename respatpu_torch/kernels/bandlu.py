"""Blocked banded LU factorization and solve on the card (direct solver path).

The counterpart of ``respatpu/kernels/bandlu.py``: after a bandwidth-reducing
ordering the matrix is stored as a block-aligned dense band, and the
factorization is a sequence of dense P x P block operations. Fill-in of an
unpivoted band LU stays inside the band, so no symbolic factorization is
needed.

Layout: ``band[r, p, w]`` holds A[r*P + p, (r - ml)*P + w] for a block row r,
with ml/mu = lower/upper block bandwidths (both >= 1) and W = (ml + mu + 1)*P.
Padded rows (beyond n) carry an identity diagonal.

Factorization (loop over block rows; right-looking):

    D            = band[r][:, ml*P:(ml+1)*P]         # diagonal block
    L_D, U_D     = unpivoted dense LU of D (static pivot perturbation)
    Y            = L_D^-1 @ band[r][:, (ml+1)P:]     # U block-row, one TRSM
    for d = 1..ml:                                   # L block-column + update
        X_d      = band[r+d][:, (ml-d)P:(ml-d+1)P] @ U_D^-1     # TRSM
        band[r+d][:, (ml-d+1)P : (ml-d+1+mu)P] -= X_d @ Y       # GEMM

No pivoting: like PARDISO's default, tiny pivots are perturbed
(test_pardiso.c:144-148) and accuracy is recovered by mixed-precision
iterative refinement (solve.py).

Hand-written CUDA kernels take the dependent chains that have no workable
form in torch ops:

* ``block_lu`` (K1, ``csrc/band_lu.cu``): the unpivoted LU of a P x P block
  with perturbation and its count (respatpu's ``dflinalg.lu_unpivoted``), P
  dependent pivots;
* ``band_sweep`` (K2, ``csrc/band_lu.cu``): the forward or the backward
  block substitution for one right-hand side (respatpu's ``_solve_core``),
  nb dependent block rows in one launch; it applies the inverses of the
  diagonal blocks' triangles that :func:`band_lu` makes once a factorization
  (:func:`with_inverses`), as a product with no dependent chain;
* ``band_sweep_multi`` (K10, ``csrc/band_multi.cu``): the same for several
  right-hand sides (``_solve_core`` with nrhs > 1: SPIKE's tips): tiles of
  32 or 128 columns whose row slots walk the block rows, or, for at most
  ``FEW_COLS`` columns, K2's pipeline carrying them all (:func:`multi_plan`);
* ``band_sweep_t`` (K11, ``csrc/band_lu.cu``): the sweeps of the transposed
  system, ``U^T`` forward and ``L^T`` backward, read straight from the band
  (the condition estimate's transposed solves); it applies the same inverses
  transposed.

Each has its plain PyTorch version beside it (``block_lu_plain``,
``band_sweep_plain`` for K2 and K10, ``band_sweep_t_plain``). A wrapper
launches its kernel for a CUDA tensor and runs the plain version for a CPU
tensor; nothing else chooses. The TRSMs and the trailing product of the
factorization are large dense operations and go to
``torch.linalg.solve_triangular`` and ``torch.baddbmm`` with TF32 off, as
respatpu leaves them to XLA.

Precisions: fp32, fp32_ftz and bf16 store the band in the policy's type and
compute in fp32; fp64 is native (it replaces respatpu's double-float path).
Under bf16 the blocks are read as fp32, ``Y`` and ``X_d`` are computed from the
unrounded fp32 factor of the diagonal block, and only what is stored is
rounded, as in respatpu.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..formats import CSRMatrix
from ..precision import Policy, ftz, get_policy

__all__ = ["BandMatrix", "csr_to_band", "band_memory_bytes", "band_extent",
           "DeviceBand", "band_to_device", "csr_to_device_band", "band_lu",
           "band_solve", "band_solve_transpose", "BandLuResult", "block_lu",
           "block_lu_plain", "band_sweep", "band_sweep_plain", "band_sweep_multi",
           "band_sweep_t", "band_sweep_t_plain", "multi_plan", "with_inverses", "LAUNCHES",
           "MAX_P", "FEW_COLS"]

MAX_P = 128  # largest block the kernels take (kMaxP of csrc/band_lu.cu)
FEW_COLS = 4  # K10's few-column regime (kFewCols of csrc/band_multi.cu)
TILE_COLS = (32, 128)  # K10's tile widths for more columns

_INST = {"fp32": "f32", "fp32_ftz": "f32_ftz", "bf16": "bf16", "fp64": "f64"}
# bf16 blocks are read as fp32, so the fp32 instances factor them
_LU_ENTRIES = ("respa_block_lu_f32", "respa_block_lu_f32_ftz", "respa_block_lu_f64")
_SWEEP_ENTRY = {(d, p): f"respa_band_sweep_{d}_{i}"
                for d in ("fwd", "bwd") for p, i in _INST.items()}
_MULTI_ENTRY = {(d, p): f"respa_band_sweep_multi_{d}_{i}"
                for d in ("fwd", "bwd") for p, i in _INST.items()}
_T_ENTRY = {(d, p): f"respa_band_sweep_t_{d}_{i}"
            for d in ("fwd", "bwd") for p, i in _INST.items()}

# Kernel launches per entry point of the library, raised by the wrappers right
# after each launch succeeds and nowhere else.
LAUNCHES = {name: 0 for name in (*_LU_ENTRIES, *sorted(_SWEEP_ENTRY.values()),
                                 *sorted(_MULTI_ENTRY.values()), *sorted(_T_ENTRY.values()))}


@dataclasses.dataclass
class BandMatrix:
    """Host block-aligned band storage."""

    n: int
    p: int  # block size
    ml: int  # lower block bandwidth
    mu: int  # upper block bandwidth
    data: np.ndarray  # float64[nb, p, (ml+mu+1)*p]

    @property
    def nb(self) -> int:
        return self.data.shape[0]

    @property
    def width(self) -> int:
        return self.data.shape[2]


def band_memory_bytes(n: int, bl: int, bu: int, p: int = 128,
                      fp64: bool = False) -> int:
    """Bytes of the band of an n x n matrix with scalar bandwidths bl, bu:
    4 an element, 8 under fp64 (the number respatpu counts for its two fp32
    words)."""
    ml = max(1, -(-bl // p))
    mu = max(1, -(-bu // p))
    nb = -(-n // p)
    return nb * p * (ml + mu + 1) * p * (8 if fp64 else 4)


def band_extent(a: CSRMatrix, p: int):
    """``(rows, cols, ml, mu, nb)`` of the band packing of ``a``."""
    n = a.nrows
    if a.shape[0] != a.shape[1]:
        raise ValueError("band LU requires a square matrix")
    rows = np.repeat(np.arange(n, dtype=np.int64), a.row_lengths())
    cols = a.indices.astype(np.int64)
    diff = cols - rows
    bl = int(max(0, -diff.min())) if diff.size else 0
    bu = int(max(0, diff.max())) if diff.size else 0
    return rows, cols, max(1, -(-bl // p)), max(1, -(-bu // p)), -(-n // p)


def csr_to_band(a: CSRMatrix, p: int = 128) -> BandMatrix:
    """Pack CSR into block-aligned band storage (host, float64). For tests
    and small inputs: at catalogue size the host band is gigabytes, and
    :func:`csr_to_device_band` scatters on the device instead."""
    n = a.nrows
    rows, cols, ml, mu, nb = band_extent(a, p)
    w = (ml + mu + 1) * p
    data = np.zeros((nb, p, w), dtype=np.float64)
    r = rows // p
    data[r, rows % p, cols - (r - ml) * p] = a.data
    pad = np.arange(n, nb * p)  # identity padding rows
    data[pad // p, pad % p, ml * p + pad % p] = 1.0
    return BandMatrix(n=n, p=p, ml=ml, mu=mu, data=data)


@dataclasses.dataclass
class DeviceBand:
    """A band (or its LU factors) on one device under a precision policy.

    ``inv`` is None until :func:`with_inverses` makes it (:func:`band_lu`
    does for every factor): the inverses of the diagonal blocks' triangles,
    unit lower ``L_rr^-1`` and upper ``U_rr^-1``, which K2 applies.
    ``dataclasses.replace`` with other ``data`` keeps the old inverses; K2
    refuses them if their type no longer fits, and :func:`with_inverses`
    makes them anew."""

    n: int
    p: int
    ml: int
    mu: int
    policy: Policy
    data: torch.Tensor  # policy.dtype[nb, p, (ml+mu+1)*p], contiguous
    inv: Optional[torch.Tensor] = None  # accum_dtype[nb, 2, p, p], contiguous

    @property
    def nb(self) -> int:
        return int(self.data.shape[0])

    @property
    def width(self) -> int:
        return int(self.data.shape[2])

    @property
    def device(self) -> torch.device:
        return self.data.device


def band_to_device(b: BandMatrix, policy: Union[str, Policy] = "fp32",
                   device: Union[str, torch.device] = "cuda") -> DeviceBand:
    """Cast a host band under ``policy`` and upload it."""
    policy = get_policy(policy)
    data = policy.cast_host(b.data).to(torch.device(device))
    return DeviceBand(n=b.n, p=b.p, ml=b.ml, mu=b.mu, policy=policy, data=data)


def csr_to_device_band(a: CSRMatrix, policy: Union[str, Policy] = "fp32",
                       device: Union[str, torch.device] = "cuda",
                       p: int = 128) -> DeviceBand:
    """Pack CSR into a band on ``device`` without a host band: upload the
    entries' positions and policy-cast values, scatter them into a zeroed
    band of the policy's type, then set the identity on the padded rows.
    Bitwise the same as ``band_to_device(csr_to_band(a, p), policy)``."""
    policy = get_policy(policy)
    device = torch.device(device)
    n = a.nrows
    rows, cols, ml, mu, nb = band_extent(a, p)
    w = (ml + mu + 1) * p
    flat = rows * w + (cols - (rows // p - ml) * p)  # (r*p + pr)*w + wc
    data = torch.zeros(nb * p * w, dtype=policy.dtype, device=device)
    data.index_put_((torch.from_numpy(flat).to(device),),
                    policy.cast_host(a.data).to(device))
    pad = torch.arange(n, nb * p, device=device)
    data[pad * w + ml * p + pad % p] = 1.0
    return DeviceBand(n=n, p=p, ml=ml, mu=mu, policy=policy,
                      data=data.view(nb, p, w))


class BandLuResult(NamedTuple):
    lu: DeviceBand  # factor values: unit-lower L below the diagonal, U on and above
    n_pivot_perturbed: int


# ---------------------------------------------------------------------------
# Kernel 1: unpivoted LU of P x P blocks with static pivot perturbation
# ---------------------------------------------------------------------------


def _library():
    from . import _build
    lib = _build.load()
    if lib.respa_band_max_p() != MAX_P:
        raise RuntimeError(f"band_lu.cu was built for blocks up to "
                           f"{lib.respa_band_max_p()}, the wrappers expect {MAX_P}")
    if lib.respa_band_multi_few_cols() != FEW_COLS:
        raise RuntimeError(f"band_multi.cu carries {lib.respa_band_multi_few_cols()} columns "
                           f"in its few-column regime, the wrapper expects {FEW_COLS}")
    return lib


def _check_blocks(blocks: torch.Tensor):
    if blocks.dim() != 3 or blocks.shape[1] != blocks.shape[2]:
        raise ValueError(f"blocks must be [B, P, P], got {tuple(blocks.shape)}")
    if blocks.dtype not in (torch.float32, torch.bfloat16, torch.float64):
        raise TypeError(f"no block LU for {blocks.dtype}")


def block_lu_plain(blocks: torch.Tensor, eps: float,
                   flush: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block-LU kernel's function in plain torch ops, on any device.

    ``blocks`` [B, P, P] in fp32, bf16 (read as fp32) or fp64. Returns
    ``(lu, n_perturbed)``: ``lu`` [B, P, P] contiguous in the accumulator
    type with unit-lower L below the diagonal and U on and above it, and
    int32 ``n_perturbed`` [B]. Per pivot, in respatpu's order
    (dflinalg.py:54-66): a pivot with ``|piv| <= eps`` becomes ``-eps`` if it
    is negative and ``+eps`` otherwise (so a zero pivot becomes ``+eps``) and
    is counted; the column below it is divided by it; the trailing block
    gets the rank-1 update. ``flush`` flushes subnormals of the input and of
    every quotient, product and difference."""
    _check_blocks(blocks)
    acc = torch.float64 if blocks.dtype == torch.float64 else torch.float32
    m = ftz(blocks.to(acc).clone(memory_format=torch.contiguous_format), flush)
    nb, p, _ = m.shape
    e = torch.tensor(eps, dtype=acc, device=m.device)
    count = torch.zeros(nb, dtype=torch.int32, device=m.device)
    for j in range(p):
        piv = m[:, j, j]
        bad = piv.abs() <= e
        piv = torch.where(bad, torch.where(piv < 0, -e, e), piv)
        m[:, j, j] = piv
        count += bad.to(torch.int32)
        if j + 1 < p:
            lcol = ftz(m[:, j + 1:, j] / piv[:, None], flush)
            prod = ftz(lcol[:, :, None] * m[:, j, None, j + 1:], flush)
            m[:, j + 1:, j + 1:] = ftz(m[:, j + 1:, j + 1:] - prod, flush)
            m[:, j + 1:, j] = lcol
    return m, count


def block_lu(blocks: torch.Tensor, eps: float,
             flush: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unpivoted LU of each P x P block with static pivot perturbation; see
    :func:`block_lu_plain` for what it returns.

    ``blocks`` may be a strided view [B, P, P] whose last stride is 1 (a
    diagonal block read in place from the band). On a CUDA device this
    launches the block-LU kernel on the current stream, one thread block a
    matrix block, and raises if the input does not fit it or the launch
    fails. On the CPU it runs :func:`block_lu_plain`."""
    _check_blocks(blocks)
    if blocks.device.type == "cpu":
        return block_lu_plain(blocks, eps, flush)
    if blocks.device.type != "cuda":
        raise ValueError(f"no block LU for device {blocks.device}")
    nb, p, _ = blocks.shape
    if not 1 <= p <= MAX_P:
        raise ValueError(f"block size must be in [1, {MAX_P}], got {p}")
    sb, ld, sc = blocks.stride()
    if nb == 0 or sc != 1 or ld < p or (nb > 1 and sb < 0):
        raise ValueError("blocks must be non-empty with unit last stride and "
                         f"row stride >= P, got shape {tuple(blocks.shape)} "
                         f"strides {blocks.stride()}")
    if flush and blocks.dtype != torch.float32:
        raise TypeError("flush-to-zero exists for fp32 blocks only")
    acc = torch.float64 if blocks.dtype == torch.float64 else torch.float32
    name = ("respa_block_lu_f64" if acc == torch.float64 else
            "respa_block_lu_f32_ftz" if flush else "respa_block_lu_f32")
    lu = torch.empty((nb, p, p), dtype=acc, device=blocks.device)
    count = torch.empty(nb, dtype=torch.int32, device=blocks.device)
    rc = getattr(_library(), name)(
        blocks.device.index, nb, p, blocks.data_ptr(),
        int(blocks.dtype == torch.bfloat16), ld, sb, float(eps),
        lu.data_ptr(), count.data_ptr(),
        torch.cuda.current_stream(blocks.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    LAUNCHES[name] += 1
    return lu, count


# ---------------------------------------------------------------------------
# Factorization
# ---------------------------------------------------------------------------


def _check_band(band: DeviceBand):
    d = band.data
    w = (band.ml + band.mu + 1) * band.p
    if (d.dim() != 3 or d.shape[1:] != (band.p, w) or not d.is_contiguous()
            or d.dtype != band.policy.dtype or band.ml < 1 or band.mu < 1
            or d.shape[0] * band.p < band.n):
        raise ValueError("DeviceBand data does not match its sizes and policy")
    if d.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 is on; the "
                           "band factorization needs full fp32 products")


def band_lu(band: DeviceBand, pivot_eps: Optional[float] = None) -> BandLuResult:
    """Factor the band; the result holds unit-lower L and U in the band's
    layout and the number of perturbed pivots. ``band`` is left as it was:
    the factors are made in place in a copy of it.

    ``pivot_eps`` defaults to 1e-4 (1e-13 under fp64) times max(max|A|, 1).

    Per block row: the block-LU kernel on the diagonal block, one
    unit-lower TRSM for the U block row, then one right-upper TRSM and one
    batched product that update all the block rows below at once through
    strided views of the band (distinct rows: no overlap), cut off at the
    band's end."""
    _check_band(band)
    pol = band.policy
    p, ml, mu, nb = band.p, band.ml, band.mu, band.nb
    w = (ml + mu + 1) * p
    data = band.data.clone()
    acc = pol.accum_dtype
    fl = pol.flush_to_zero
    if pivot_eps is None:
        # aminmax allocates nothing of the band's size; abs().max() would
        lo, hi = torch.aminmax(data)
        amax = max(abs(float(lo)), abs(float(hi)))
        pivot_eps = (1e-13 if acc == torch.float64 else 1e-4) * max(amax, 1.0)
    flat = data.view(-1)
    counts = []
    for r in range(nb):
        row = data[r]
        lu_d, bad = block_lu(row[None, :, ml * p:(ml + 1) * p], pivot_eps, fl)
        lu_d = lu_d[0]
        counts.append(bad)
        t = row[:, (ml + 1) * p:]
        y = ftz(torch.linalg.solve_triangular(lu_d, t.to(acc), upper=False,
                                              unitriangular=True), fl)
        row[:, ml * p:(ml + 1) * p] = lu_d
        t.copy_(y)
        k = min(ml, nb - 1 - r)
        if k == 0:
            continue
        # S_d = band[r+d][:, (ml-d)P:(ml-d+1)P], d = 1..k, as one view
        off = (r + 1) * p * w + (ml - 1) * p
        s = flat.as_strided((k, p, p), (p * w - p, w, 1), off)
        c = flat.as_strided((k, p, mu * p), (p * w - p, w, 1), off + p)
        x = ftz(torch.linalg.solve_triangular(
            lu_d, s.to(acc).reshape(k * p, p), upper=True, left=False), fl)
        s.copy_(x.view(k, p, p))
        if data.dtype == acc and not fl:
            c.baddbmm_(x.view(k, p, p), y.expand(k, p, mu * p), alpha=-1.0)
        else:
            c.copy_(ftz(torch.baddbmm(c.to(acc), x.view(k, p, p),
                                      y.expand(k, p, mu * p), alpha=-1.0), fl))
    nbad = int(torch.stack(counts).sum()) if counts else 0
    return BandLuResult(with_inverses(dataclasses.replace(band, data=data)), nbad)


def with_inverses(lu: DeviceBand) -> DeviceBand:
    """``lu`` with the inverses of its diagonal triangles made anew from its
    data: ``inv[:, 0]`` the unit lower ``L_rr^-1`` (the forward sweep's),
    ``inv[:, 1]`` the upper ``U_rr^-1`` (the backward sweep's), in the
    accumulator type, flushed under fp32_ftz. One batched triangular solve of
    the nb diagonal blocks (read as the accumulator type, so bf16 blocks as
    fp32) against the identity for each, in fp64 and then rounded once, so
    that an inverse is as close to the exact one as its type allows.
    :func:`band_lu` calls it; so does whatever builds a factored band
    otherwise (a loaded or converted factor, or one re-typed by
    ``dataclasses.replace``)."""
    _check_band(lu)
    p, ml = lu.p, lu.ml
    d = lu.data[:, :, ml * p:(ml + 1) * p].to(lu.policy.accum_dtype).double()
    eye = torch.eye(p, dtype=torch.float64, device=lu.device).expand_as(d)
    inv = torch.empty((lu.nb, 2, p, p), dtype=lu.policy.accum_dtype, device=lu.device)
    for k, upper in enumerate((False, True)):
        inv[:, k] = torch.linalg.solve_triangular(d, eye, upper=upper, unitriangular=not upper)
    return dataclasses.replace(lu, inv=ftz(inv, lu.policy.flush_to_zero))


def _check_inverses(lu: DeviceBand) -> None:
    """What K2 and K11 take of ``lu.inv``, refused the same on every device."""
    inv, acc = lu.inv, lu.policy.accum_dtype
    if inv is None:
        raise ValueError("the band carries no inverses of its diagonal triangles; band_lu makes "
                         "them, with_inverses makes them for a band from elsewhere")
    if inv.dtype != acc:
        raise TypeError(f"the inverses must be {acc} for a {lu.policy.name} band, got {inv.dtype}")
    want = (lu.nb, 2, lu.p, lu.p)
    if tuple(inv.shape) != want or not inv.is_contiguous() or inv.device != lu.device:
        raise ValueError(f"the inverses must be contiguous {list(want)} on {lu.device}, got "
                         f"{list(inv.shape)} on {inv.device}")


# ---------------------------------------------------------------------------
# Kernel 2: banded block substitution for one right-hand side
# ---------------------------------------------------------------------------


def band_sweep_plain(lu: DeviceBand, b: torch.Tensor, forward: bool,
                     first_row: int = 0) -> torch.Tensor:
    """The function of the sweep kernels (K2 for one right-hand side, K10
    for several) in plain torch ops, on any device.

    ``b`` is padded, [nb*P] or [nb*P, nrhs], in the accumulator type.
    Forward: ``y[r] = L_D^-1 (b[r] - band[r][:, :ml*P] @ y[(r-ml)*P : r*P])``
    for r = 0..nb-1 with the unit lower triangle of the diagonal block
    (columns before the matrix start are skipped). Backward:
    ``x[r] = U_D^-1 (b[r] - band[r][:, (ml+1)*P:] @ x[(r+1)*P : ...])`` for
    r = nb-1..0. Band values are read as the accumulator type.

    ``first_row`` (forward only) says that b's block rows before it are
    zero: the sweep starts there and y's rows before it are +0, as the sweep
    from row 0 computes them, so the result is the same bit for bit."""
    p, ml, mu, nb = lu.p, lu.ml, lu.mu, lu.nb
    acc = lu.policy.accum_dtype
    fl = lu.policy.flush_to_zero
    if first_row and not forward:
        raise ValueError("first_row is for the forward sweep only")
    single = b.dim() == 1
    rhs = (b[:, None] if single else b).to(acc)
    out = torch.zeros_like(rhs)
    for r in (range(first_row, nb) if forward else range(nb - 1, -1, -1)):
        row = lu.data[r]
        if forward:
            k = min(ml, r)
            panel, prev = row[:, (ml - k) * p:ml * p], out[(r - k) * p:r * p]
        else:
            k = min(mu, nb - 1 - r)
            panel, prev = row[:, (ml + 1) * p:(ml + 1 + k) * p], out[(r + 1) * p:(r + 1 + k) * p]
        a = rhs[r * p:(r + 1) * p]
        if k:
            a = ftz(a - ftz(panel.to(acc) @ prev, fl), fl)
        d = row[:, ml * p:(ml + 1) * p].to(acc)
        out[r * p:(r + 1) * p] = ftz(torch.linalg.solve_triangular(
            d, a, upper=not forward, unitriangular=forward), fl)
    return out[:, 0] if single else out


def band_sweep(lu: DeviceBand, b: torch.Tensor, forward: bool) -> torch.Tensor:
    """One block substitution sweep over the factored band for one padded
    right-hand side ``b`` [nb*P] in the accumulator type; see
    :func:`band_sweep_plain` for the function.

    ``lu`` must carry the inverses of its diagonal triangles (``lu.inv``,
    :func:`band_lu` makes them); a band without them, or with inverses of
    another type or shape, is refused on every device. On a CUDA device this
    is one launch of the sweep kernel on the current stream, which applies
    the inverses (it raises if the inputs do not fit it or the launch
    fails); on the CPU it runs the plain version. Sums are taken in an order
    fixed by the shape, so a sweep repeats bit for bit."""
    _check_band(lu)
    _check_inverses(lu)
    if lu.device.type == "cpu":
        return band_sweep_plain(lu, b, forward)
    if lu.device.type != "cuda":
        raise ValueError(f"no band sweep for device {lu.device}")
    acc = lu.policy.accum_dtype
    p, nb = lu.p, lu.nb
    if b.dtype != acc:
        raise TypeError(f"{lu.policy.name} sweep takes b as {acc}, got {b.dtype}")
    if b.device != lu.device:
        raise ValueError(f"b is on {b.device}, the band on {lu.device}")
    if b.shape != (nb * p,) or not b.is_contiguous():
        raise ValueError(f"b must be contiguous of shape ({nb * p},), got {tuple(b.shape)}")
    if not 1 <= p <= MAX_P:
        raise ValueError(f"block size must be in [1, {MAX_P}], got {p}")
    name = _SWEEP_ENTRY["fwd" if forward else "bwd", lu.policy.name]
    out = torch.empty_like(b)
    # the kernel's mailbox: a (word, tag) pair for every 32-bit word of out
    mail = torch.zeros(2 * nb * p * (b.element_size() // 4), dtype=torch.int32,
                       device=lu.device)
    rc = getattr(_library(), name)(
        lu.device.index, nb, p, lu.ml, lu.mu, lu.data.data_ptr(), lu.inv.data_ptr(),
        b.data_ptr(), out.data_ptr(), mail.data_ptr(),
        torch.cuda.current_stream(lu.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    LAUNCHES[name] += 1
    return out


# ---------------------------------------------------------------------------
# Kernel 10: banded block substitution for several right-hand sides
# ---------------------------------------------------------------------------


def _check_rhs(lu: DeviceBand, b: torch.Tensor, shape: Tuple[int, ...]) -> None:
    """What K10 and K11 take, refused the same on every device: ``b`` of
    ``shape`` in the band's accumulator type on the band's device,
    contiguous, and blocks of at most ``MAX_P``."""
    _check_band(lu)
    acc = lu.policy.accum_dtype
    if not 1 <= lu.p <= MAX_P:
        raise ValueError(f"lu.p (the block size) must be in [1, {MAX_P}], got {lu.p}")
    if b.dtype != acc:
        raise TypeError(f"b must be {acc} for a {lu.policy.name} band, got {b.dtype}")
    if b.device != lu.device:
        raise ValueError(f"b is on {b.device}, the band on {lu.device}")
    if tuple(b.shape) != shape or not b.is_contiguous():
        raise ValueError(f"b must be contiguous of shape {shape}, got {tuple(b.shape)}"
                         f"{'' if b.is_contiguous() else ', not contiguous'}")


def multi_plan(nb: int, m: int, nrhs: int, first_row: int, sms: int) -> Tuple[int, int, int]:
    """K10's launch for a sweep of ``nrhs`` columns over ``nb - first_row``
    block rows with ``m`` panels a row (ml forward, mu backward) on a card of
    ``sms`` SMs: ``(cols, tiles, slots)``.

    At most ``FEW_COLS`` columns take the few-column regime (``cols`` =
    ``FEW_COLS``, one tile, ``slots`` blocks taking the rows in turn, one an
    SM, at most one a panel and the diagonal). More take tiles of 32 or 128
    columns, each tile's rows spread over ``slots`` blocks as long as the
    tiles leave SMs free; the width is the one whose slowest block has the
    least to do: its tile's columns times the rows it walks (no fewer than a
    row's near panel and triangle, about 3 / (m + 1) of the rows, which lie
    on the chain whatever the slots), times the waves of tiles. Ties go to the
    wider tile, which reads the band fewer times."""
    rows = nb - first_row
    if nrhs <= FEW_COLS:
        return FEW_COLS, 1, max(1, min(m + 1, rows, sms))
    best = None
    for cols in TILE_COLS:
        tiles = -(-nrhs // cols)
        slots = max(1, min(sms // tiles, m + 1, rows))
        walk = max(-(-rows // slots), -(-3 * rows // (m + 1)))
        cost = cols * walk * -(-tiles // sms)
        if best is None or cost <= best[0]:
            best = (cost, cols, tiles, slots)
    return best[1:]


_SMS = {}


def _sm_count(device: torch.device) -> int:
    if device.index not in _SMS:
        _SMS[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device.index]


def band_sweep_multi(lu: DeviceBand, b: torch.Tensor, forward: bool,
                     first_row: int = 0) -> torch.Tensor:
    """One block substitution sweep over the factored band for several
    padded right-hand sides ``b`` [nb*P, nrhs] (nrhs >= 1, row-major, in the
    accumulator type); see :func:`band_sweep_plain` for the function and
    ``first_row``.

    On a CUDA device this is one launch of K10 on the current stream in the
    regime :func:`multi_plan` picks (it raises if the inputs do not fit it or
    the launch fails); on the CPU it runs the plain version. Sums are taken
    in an order fixed by the shape, so a sweep repeats bit for bit."""
    nrhs = int(b.shape[1]) if b.dim() == 2 else 0
    if nrhs < 1:
        raise ValueError(f"b must be [nb*P, nrhs] with nrhs >= 1, got {tuple(b.shape)}")
    _check_rhs(lu, b, (lu.nb * lu.p, nrhs))
    if not 0 <= first_row < lu.nb or (first_row and not forward):
        raise ValueError(f"first_row must be 0, or in [0, {lu.nb}) for a forward sweep; got "
                         f"{first_row}")
    if lu.device.type == "cpu":
        return band_sweep_plain(lu, b, forward, first_row)
    if lu.device.type != "cuda":
        raise ValueError(f"no band sweep for device {lu.device}")
    name = _MULTI_ENTRY["fwd" if forward else "bwd", lu.policy.name]
    cols, tiles, slots = multi_plan(lu.nb, lu.ml if forward else lu.mu, nrhs, first_row,
                                    _sm_count(lu.device))
    out = torch.empty_like(b)
    out[:first_row * lu.p].zero_()  # rows the kernel does not reach
    if cols == FEW_COLS:
        # the mailbox: a (word, tag) pair for every 32-bit word of nb x p x FEW_COLS values
        words = 2 * lu.nb * lu.p * FEW_COLS * (b.element_size() // 4)
    else:
        words = lu.nb * tiles  # a flag for each block row and tile: published when solved
    ready = torch.zeros(words, dtype=torch.int32, device=lu.device)
    rc = getattr(_library(), name)(
        lu.device.index, lu.nb, lu.p, lu.ml, lu.mu, nrhs, first_row, cols, slots,
        lu.data.data_ptr(), b.data_ptr(), out.data_ptr(), ready.data_ptr(),
        torch.cuda.current_stream(lu.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    LAUNCHES[name] += 1
    return out


def band_solve(lu: DeviceBand, b: torch.Tensor, first_row: int = 0) -> torch.Tensor:
    """Solve A x = b given the factored band: ``b`` is (n,) or (n, nrhs) on
    the band's device; x comes back in the accumulator type.

    One right-hand side goes through :func:`band_sweep` (K2 on a card),
    several through :func:`band_sweep_multi` (K10 on a card). ``first_row``
    (several right-hand sides only) is the first block row of b that is not
    zero, which the forward sweep starts from (SPIKE's V: its right-hand
    side fills the last mu block rows only)."""
    acc = lu.policy.accum_dtype
    if b.dim() not in (1, 2) or b.shape[0] != lu.n:
        raise ValueError(f"b must be ({lu.n},) or ({lu.n}, nrhs), got {tuple(b.shape)}")
    if b.device != lu.device:
        raise ValueError(f"b is on {b.device}, the band on {lu.device}")
    if first_row and b.dim() == 1:
        raise ValueError("first_row is for several right-hand sides")
    bp = torch.zeros((lu.nb * lu.p, *b.shape[1:]), dtype=acc, device=lu.device)
    bp[:lu.n] = ftz(b.to(acc), lu.policy.flush_to_zero)
    if b.dim() == 1:
        return band_sweep(lu, band_sweep(lu, bp, True), False)[:lu.n]
    y = band_sweep_multi(lu, bp, True, first_row)
    return band_sweep_multi(lu, y, False)[:lu.n]


# ---------------------------------------------------------------------------
# Kernel 11: the transposed sweeps, one right-hand side
# ---------------------------------------------------------------------------


def band_sweep_t_plain(lu: DeviceBand, b: torch.Tensor, forward: bool) -> torch.Tensor:
    """K11's function in plain torch ops, on any device: one sweep of the
    transposed system ``A^T = U^T L^T`` for a padded ``b`` [nb*P] in the
    accumulator type, left-looking, in K11's order of block rows.

    Forward, ``U^T z = b`` (lower, non-unit): ``z[r] = U_rr^-T (b[r] -
    sum_d band[r-d][:, (ml+d)P:(ml+d+1)P]^T z[r-d])``, d = 1..min(mu, r).
    Backward, ``L^T x = b`` (unit upper): ``x[r] = L_rr^-T (b[r] - sum_d
    band[r+d][:, (ml-d)P:(ml-d+1)P]^T x[r+d])``, d = 1..min(ml, nb-1-r).
    The blocks a row takes lie one in each block row, as one strided view.
    Under fp32_ftz b, every block's sum and every solved block are flushed."""
    p, ml, mu, nb = lu.p, lu.ml, lu.mu, lu.nb
    acc = lu.policy.accum_dtype
    fl = lu.policy.flush_to_zero
    w = (ml + mu + 1) * p
    flat = lu.data.view(-1)
    rhs = ftz(b.to(acc), fl)
    out = torch.zeros_like(rhs)
    for r in (range(nb) if forward else range(nb - 1, -1, -1)):
        k = min(mu, r) if forward else min(ml, nb - 1 - r)
        a = rhs[r * p:(r + 1) * p]
        if k:
            # the blocks in block row order, each one block row down and one
            # block column left of the one before: forward band[r-d][:, (ml+d)P:]
            # for d = k..1 against z[r-k .. r-1], backward band[r+d][:, (ml-d)P:]
            # for d = 1..k against x[r+1 .. r+k]
            if forward:
                off, vec = (r - k) * p * w + (ml + k) * p, out[(r - k) * p:r * p]
            else:
                off, vec = (r + 1) * p * w + (ml - 1) * p, out[(r + 1) * p:(r + 1 + k) * p]
            blocks = flat.as_strided((k, p, p), (p * w - p, w, 1), off)
            a = ftz(a - ftz(blocks.to(acc).reshape(k * p, p).mT @ vec, fl), fl)
        d = lu.data[r][:, ml * p:(ml + 1) * p].to(acc)
        out[r * p:(r + 1) * p] = ftz(torch.linalg.solve_triangular(
            d.mT, a[:, None], upper=not forward, unitriangular=not forward)[:, 0], fl)
    return out


def band_sweep_t(lu: DeviceBand, b: torch.Tensor, forward: bool) -> torch.Tensor:
    """One sweep of the transposed system over the factored band for one
    padded right-hand side ``b`` [nb*P] in the accumulator type, forward
    ``U^T`` or backward ``L^T``; see :func:`band_sweep_t_plain`.

    ``lu`` must carry the inverses of its diagonal triangles (``lu.inv``, as
    for :func:`band_sweep`); a band without them is refused on every device.
    On a CUDA device this is one launch of K11 on the current stream, which
    applies them transposed, ``(U_rr^-1)^T`` forward and ``(L_rr^-1)^T``
    backward (it raises if the inputs do not fit it or the launch fails); on
    the CPU it runs the plain version. Sums are taken in an order fixed by
    the shape, so a sweep repeats bit for bit; it agrees with the plain
    substitution within the sweep tolerance, as K2 does."""
    _check_rhs(lu, b, (lu.nb * lu.p,))
    _check_inverses(lu)
    if lu.device.type == "cpu":
        return band_sweep_t_plain(lu, b, forward)
    if lu.device.type != "cuda":
        raise ValueError(f"no band sweep for device {lu.device}")
    name = _T_ENTRY["fwd" if forward else "bwd", lu.policy.name]
    out = torch.empty_like(b)
    # the kernel's mailbox: a (word, tag) pair for every 32-bit word of out
    mail = torch.zeros(2 * lu.nb * lu.p * (b.element_size() // 4), dtype=torch.int32,
                       device=lu.device)
    rc = getattr(_library(), name)(
        lu.device.index, lu.nb, lu.p, lu.ml, lu.mu, lu.data.data_ptr(), lu.inv.data_ptr(),
        b.data_ptr(), out.data_ptr(), mail.data_ptr(),
        torch.cuda.current_stream(lu.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    LAUNCHES[name] += 1
    return out


def band_solve_transpose(lu: DeviceBand, s: torch.Tensor) -> torch.Tensor:
    """Solve A^T z = s from the same factors: A^T = U^T L^T, forward with the
    lower triangular U^T, backward with the unit upper L^T, both read
    straight from the band by :func:`band_sweep_t` (K11 on a card). Under
    fp32_ftz s is flushed on entry. The Hager condition estimate's solves."""
    _check_band(lu)
    if s.shape != (lu.n,) or s.device != lu.device:
        raise ValueError(f"s must be ({lu.n},) on {lu.device}")
    v = torch.zeros(lu.nb * lu.p, dtype=lu.policy.accum_dtype, device=lu.device)
    v[:lu.n] = ftz(s.to(v.dtype), lu.policy.flush_to_zero)
    return band_sweep_t(lu, band_sweep_t(lu, v, True), False)[:lu.n]
