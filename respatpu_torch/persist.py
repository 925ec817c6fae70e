"""Factorization persistence: factorize once, solve many, across processes.

The counterpart of ``respatpu/persist.py``. The reference's only resume
mechanism is append-mode CSV (SURVEY.md §5.4); here factorizations themselves
are saved (``np.savez_compressed``, respatpu's arrays under respatpu's names)
so that a sweep can restart without factoring again and a serving process can
load a prebuilt factor: PARDISO's phase-33 reuse.

A file is bound to the matrix it was factored from: its pattern
(``matrix_hash``) and its values (``values_hash``), each the first 16 hex
digits of a SHA-256. Loading refuses, with a ``ValueError`` naming the file, a
matrix whose pattern or values differ, a file that lacks either hash, and a
sparse factor whose filled pattern no longer has the hash it was saved with.
respatpu binds to the pattern alone and accepts a file without a hash, so a
matrix with the same pattern and other values is solved with the wrong factor
(ROADMAP R3); the port does neither.

A loaded factor keeps its saved policy and the flush that goes with it, and
plugs into ``solve.solve_refined`` and the GMRES-IR fallback. It cannot be
factored again (``refactorize_timed`` raises): the matrix on the device and
the plan are not saved.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Union

import numpy as np
import torch

from . import solve as slv
from .analysis import apply_matching_scaling, permute_csr
from .formats import CSRMatrix
from .kernels.bandlu import DeviceBand, with_inverses
from .kernels.snlu import analyze_supernodes
from .kernels.snlu_device import FrontalSolver, build_frontal_plan
from .precision import FP32, Policy, get_policy

__all__ = ["save_band_factorization", "load_band_factorization",
           "save_sparse_factorization", "load_sparse_factorization",
           "save_csr", "load_csr_npz", "LoadedBandLu", "LoadedSparseLu", "LoadedFrontalLu"]

_FORMAT_VERSION = 2  # respatpu's files are version 1 and carry no values hash


def save_csr(path: str, a: CSRMatrix) -> None:
    np.savez_compressed(path, kind="csr", version=_FORMAT_VERSION,
                        shape=np.asarray(a.shape), indptr=a.indptr,
                        indices=a.indices, data=a.data)


def load_csr_npz(path: str) -> CSRMatrix:
    z = np.load(path)
    if str(z["kind"]) != "csr":
        raise ValueError(f"{os.path.basename(path)!r} holds a {z['kind']}, not a CSR matrix")
    return CSRMatrix(tuple(int(x) for x in z["shape"]),
                     np.ascontiguousarray(z["indptr"], np.int64),
                     np.ascontiguousarray(z["indices"], np.int32),
                     np.ascontiguousarray(z["data"], np.float64))


def _type_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for x in arrays:
        h.update(x.tobytes())
    return h.hexdigest()[:16]


def _pattern_hash(indptr, indices) -> str:
    """respatpu's pattern hash: the row pointer as int64, the columns as int32."""
    return _digest(np.ascontiguousarray(indptr, np.int64), np.ascontiguousarray(indices, np.int32))


def _values_hash(data) -> str:
    return _digest(np.ascontiguousarray(data, np.float64))


def _binding(a: CSRMatrix) -> dict:
    return dict(matrix_hash=_pattern_hash(a.indptr, a.indices), values_hash=_values_hash(a.data))


def _read(path: str, kind: str):
    """(arrays, meta) of a file of ``kind``."""
    z = np.load(path)
    meta = json.loads(str(z["meta"]))
    if meta.get("kind") != kind:
        raise ValueError(f"{os.path.basename(path)!r} holds a {meta.get('kind')!r}, "
                         f"not a {kind!r}")
    return z, meta


def _check_matrix_binding(meta: dict, a: CSRMatrix, path: str) -> None:
    """Refuse to solve ``a`` with a factor saved from another matrix: one
    whose pattern or values differ, or one the file does not name."""
    name = os.path.basename(path)
    for key, got in _binding(a).items():
        want = meta.get(key)
        if want is None:
            raise ValueError(f"persisted factorization {name!r} has no {key}: it is bound to "
                             "no matrix, refusing to solve with it")
        if want != got:
            raise ValueError(f"persisted factorization {name!r} was saved from a matrix with "
                             f"{key} {want}, but the matrix passed to load has {got}: "
                             "refusing to solve with mismatched factors")


def _report(meta: dict, path: str) -> slv.SolveReport:
    return slv.SolveReport(policy=meta["policy"], notes="loaded from " + os.path.basename(path),
                           n_pivot_perturbed=int(meta["n_pivot_perturbed"]))


class _Loaded:
    def refactorize_timed(self) -> float:
        raise RuntimeError("a loaded factorization cannot be factored again: neither the "
                           "matrix on the device nor the plan is saved")


# ---------------------------------------------------------------------------
# Band LU
# ---------------------------------------------------------------------------


class LoadedBandLu(_Loaded, slv.BandLuFactorization):
    """A band LU read from a file: the factor on the device (K2 solves it),
    the permutation and the permuted matrix on the host (``solve_refined``
    takes its residuals in the permuted system)."""

    def __init__(self, a: CSRMatrix, perm: np.ndarray, lu: DeviceBand, report: slv.SolveReport):
        self.policy = lu.policy
        self.a = a
        self.device = lu.device
        self.report = report
        self.perm = perm
        natural = bool((perm == np.arange(a.nrows)).all())
        self._ap = a if natural else permute_csr(a, perm)
        self._dev = None
        self._lu = lu
        self.report.factor_bytes = lu.data.numel() * lu.data.element_size()


def save_band_factorization(path: str, fac) -> None:
    """Save a ``solve.BandLuFactorization``: the factor band (``band0``, in
    the policy's type; bf16 widened to fp32, which is exact) and the
    permutation."""
    lu = fac._lu
    data = lu.data.detach().cpu()
    band0 = (data if data.dtype == torch.float64 else data.float()).numpy()
    meta = dict(version=_FORMAT_VERSION, kind="band_lu", n=lu.n, p=lu.p, ml=lu.ml, mu=lu.mu,
                policy=lu.policy.name, n_pivot_perturbed=int(fac.report.n_pivot_perturbed),
                **_binding(fac.a))
    np.savez_compressed(path, meta=json.dumps(meta), perm=fac.perm, band0=band0)


def load_band_factorization(path: str, a: CSRMatrix,
                            device: Union[str, torch.device] = "cuda") -> LoadedBandLu:
    """The band factor saved in ``path``, bound to ``a``, on ``device``."""
    z, meta = _read(path, "band_lu")
    _check_matrix_binding(meta, a, path)
    policy = get_policy(meta["policy"])
    data = torch.from_numpy(z["band0"]).to(policy.dtype).contiguous().to(torch.device(device))
    # the inverses of the diagonal triangles K2 applies are not in the file:
    # they are made anew from the loaded factor
    lu = with_inverses(DeviceBand(n=int(meta["n"]), p=int(meta["p"]), ml=int(meta["ml"]),
                                  mu=int(meta["mu"]), policy=policy, data=data))
    return LoadedBandLu(a, np.asarray(z["perm"]), lu, _report(meta, path))


# ---------------------------------------------------------------------------
# Sparse LU (multifrontal or scheduled)
# ---------------------------------------------------------------------------


def _set_common(fac, a, z, meta, policy, device, path):
    fac.policy = policy
    fac.a = a
    fac.device = torch.device(device)
    fac.report = _report(meta, path)
    fac.perm = np.asarray(z["perm"])
    fac._perm_dev = torch.from_numpy(fac.perm.astype(np.int64)).to(fac.device)
    fac.matched = bool(meta["matched"])
    if fac.matched:
        fac._cperm, fac._dr, fac._dc = (np.asarray(z["cperm"]), np.asarray(z["dr"]),
                                        np.asarray(z["dc"]))
        fac._cperm_dev, fac._dr_dev, fac._dc_dev = (
            torch.from_numpy(np.ascontiguousarray(v)).to(fac.device)
            for v in (fac._cperm, fac._dr, fac._dc))
    fac._order, fac._amalg = meta["order"], meta["amalg"]  # written back by a save


def _tri_budget(device: torch.device) -> int:
    """Device bytes the loaded triangles may take: nine tenths of the
    device's free memory (4 GiB on the CPU)."""
    if device.type == "cuda":
        return int(0.9 * torch.cuda.mem_get_info(device)[0])
    return 4 << 30


class LoadedSparseLu(_Loaded, slv._TriangleSolves):
    """A sparse LU read from a file, solved from its two triangles (K7 on
    unit-lower L and on U of the stored values, scheduled once here), as
    ``solve.SparseLuFactorization`` solves; a matched factor unwinds its
    scaling and permutations around them. The triangles hold the values in
    the type the saved factor held and solved them in (``values_type``):
    the policy's, except a bf16 multifrontal factor's, which are fp32, so
    that they are not rounded to bf16 here."""

    def __init__(self, a, z, meta, filled: CSRMatrix, vals: np.ndarray, policy: Policy,
                 device, path: str):
        _set_common(self, a, z, meta, policy, device, path)
        tri_policy = policy if _type_name(policy.dtype) == meta["values_type"] else FP32
        itemsize = torch.finfo(tri_policy.dtype).bits // 8
        need = filled.nnz * (itemsize + 4) + 2 * filled.nrows * (itemsize + 16)
        budget = _tri_budget(self.device)
        if need > budget:
            raise MemoryError(f"the factor's triangles would need {need / 2**30:.2f} GiB on the "
                              f"device, past {budget / 2**30:.2f} GiB")
        self._filled, self._fill_vals = filled, vals
        self._l, self._u = slv.lu_triangles_to_device(filled, vals, tri_policy, self.device)
        self._lt = None
        self.report.factor_bytes = filled.nnz * itemsize


class LoadedFrontalLu(_Loaded, slv.SupernodalLuFactorization):
    """A sparse LU read from a file whose triangles do not fit, solved from
    a frontal pool instead (K4, K5): the symbolic analysis run again on the
    (matched) matrix, which must give the saved permutation and fill, and
    the stored values scattered into the pool through the plan's assembly
    map, in the factor's own type (fp64 for an fp64 factor). Nothing is
    factored again."""

    def __init__(self, a, z, meta, filled: CSRMatrix, vals: np.ndarray, policy: Policy,
                 device, path: str):
        _set_common(self, a, z, meta, policy, device, path)
        a_work = (apply_matching_scaling(a, self._cperm, self._dr, self._dc)
                  if self.matched else a)
        part = analyze_supernodes(a_work, order=self._order, amalg=self._amalg)
        if not (np.array_equal(part.perm, self.perm)
                and np.array_equal(part.filled.indptr, filled.indptr)
                and np.array_equal(part.filled.indices, filled.indices)):
            raise ValueError(f"persisted factorization {os.path.basename(path)!r}: its symbolic "
                             "analysis could not be reproduced (ordering changed between save "
                             "and load?)")
        self._dtype = policy.accum_dtype  # bf16 values were factored in fp32
        self.part = part
        self._plan = build_frontal_plan(part, itemsize=torch.finfo(self._dtype).bits // 8)
        pool = torch.zeros(self._plan.pool_size, dtype=self._dtype)
        pool[torch.from_numpy(self._plan.asm_dst)] = torch.from_numpy(vals).to(self._dtype)
        pool[torch.from_numpy(self._plan.ones_dst)] = 1.0  # padding pivots: rows and columns 0
        self._frontal = FrontalSolver(self._plan, pool.to(self.device),
                                      flush=policy.flush_to_zero)
        self.report.factor_bytes = self._plan.pool_size * pool.element_size()
        self.report.notes += (",apply=frontal_"
                              + ("fp64" if self._dtype == torch.float64 else "fp32"))


def save_sparse_factorization(path: str, fac, compressed: bool = True) -> None:
    """Save a sparse direct factorization: a
    ``solve.SupernodalLuFactorization`` (its values pulled from the pool
    once), a ``solve.SparseLuFactorization``, a ``dist_snlu_sub.DistSubtreeLu``
    (each shard's pool pulled once) or a loaded one. Stored: the filled
    pattern (``findptr``, ``findices``), the factored values on it (``fvals``,
    fp64), the fill-reducing permutation, and the matching's ``cperm``,
    ``dr``, ``dc`` when matched: everything a solving process needs to
    rebuild the triangular solves without factoring again. ``compressed``
    False writes the arrays as they are (zlib takes most of the time of a
    large factor's save; both load alike). A ``DistSubtreeLu`` whose mesh
    spans ranks raises ``ValueError``: its pools lie in several processes."""
    mesh = getattr(fac, "mesh", None)
    if mesh is not None and mesh.ranks > 1:
        raise ValueError(f"save_sparse_factorization: the factor's pools lie on {mesh.ranks} "
                         "ranks (each holds its own shards'); saving a factor sharded over "
                         "ranks is not supported")
    filled = fac.part.filled if hasattr(fac, "part") else fac._filled
    vals = np.asarray(fac.factor_values(), np.float64)
    # the type the factor holds its values in: a multifrontal pool's (fp32
    # for bf16), else the triangles'
    values_type = _type_name(fac._dtype if hasattr(fac, "_dtype") else fac._l.policy.dtype)
    meta = dict(version=_FORMAT_VERSION, kind="sparse_lu", policy=fac.policy.name,
                matched=bool(fac.matched), n_pivot_perturbed=int(fac.report.n_pivot_perturbed),
                pattern_hash=_pattern_hash(filled.indptr, filled.indices), **_binding(fac.a),
                order=fac._order, amalg=fac._amalg, values_type=values_type)
    arrays = dict(findptr=filled.indptr, findices=filled.indices, fvals=vals, perm=fac.perm)
    if fac.matched:
        arrays.update(cperm=fac._cperm, dr=fac._dr, dc=fac._dc)
    (np.savez_compressed if compressed else np.savez)(path, meta=json.dumps(meta), **arrays)


def load_sparse_factorization(path: str, a: CSRMatrix,
                              device: Union[str, torch.device] = "cuda"):
    """The sparse factor saved in ``path``, bound to ``a``, on ``device``.

    Its triangles go to the device for K7 (:class:`LoadedSparseLu`); where
    they would take more than nine tenths of the device's free memory or
    the device runs out of memory, a multifrontal factor is solved from a
    frontal pool of its own type instead (:class:`LoadedFrontalLu`). A
    scheduled factor has no supernodal analysis to re-run: its memory
    error stands."""
    z, meta = _read(path, "sparse_lu")
    _check_matrix_binding(meta, a, path)
    findptr = np.ascontiguousarray(z["findptr"], np.int64)
    findices = np.ascontiguousarray(z["findices"], np.int32)
    if _pattern_hash(findptr, findices) != meta.get("pattern_hash"):
        raise ValueError(f"persisted factorization {os.path.basename(path)!r}: the filled "
                         "pattern does not have the hash it was saved with (file corrupted)")
    vals = np.ascontiguousarray(z["fvals"], np.float64)
    filled = CSRMatrix((a.nrows, a.ncols), findptr, findices, vals)
    policy = get_policy(meta["policy"])
    device = torch.device(device)
    try:
        return LoadedSparseLu(a, z, meta, filled, vals, policy, device, path)
    except Exception as e:
        if not slv._memlike(e) or meta["amalg"] is None:
            raise
    return LoadedFrontalLu(a, z, meta, filled, vals, policy, device, path)
