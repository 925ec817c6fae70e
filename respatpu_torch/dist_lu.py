"""Distributed direct band LU over a mesh of shards: the SPIKE algorithm.

The counterpart of ``respatpu/dist_lu.py``, which fills the reference's MUMPS
slot (job=4 analyze + factorize, test_mumps.c:121-128; job=3 solve,
:136-143) with the partitioned band algorithm of Polizzi and Sameh:

1. respatpu's ordering (RCM for ``order="rcm"``, the default, else the
   natural order; the single-card band path keeps the narrower of the two
   instead, ``solve.band_ordering``) and the block-aligned band layout
   (``kernels/bandlu.py``), split into P contiguous partitions of ``nb_loc``
   block rows, one a shard;
2. the entries that cross a partition edge carved out into dense coupling
   blocks (:func:`_split_coupling`): ``B_j`` (mu*p square, couples partition
   j to the first rows of j+1) and ``C_j`` (ml*p square, to the last rows of
   j-1), so that each shard owns an independent band A_j;
3. factor: every shard factors its band (``bandlu.band_lu``: the block-LU
   kernel K1 and cuBLAS TRSMs and products) and computes the tips, the top
   mu*p and bottom ml*p rows, of ``V_j = A_j^-1 [0; B_j]`` and ``W_j =
   A_j^-1 [C_j; 0]`` by multi-right-hand-side band solves (``band_solve``:
   K10, the blocks of a tile of the tips' columns walking its rows; V's
   forward sweep starts at its first nonzero block row). One ``all_gather`` of
   the tips assembles the reduced system R (identity plus the tips, of order
   P*(ml+mu)*p), LU-factored by ``torch.linalg`` once on every place;
4. solve: g_j = A_j^-1 b_j (two launches of K2, or of K10 for several
   right-hand sides), an ``all_gather`` of g's
   tips, the reduced solve once a place, and each shard back-substitutes
   ``x_j = A_j^-1 (b_j - [0; B_j u_{j+1}] - [C_j d_{j-1}; 0])``; x is
   gathered onto every rank.

On a mesh over ranks each rank sets up and factors its own partitions and
holds the right-hand side and x whole, so that the refinement runs on every
rank alike, with the same bits.

As in respatpu, the shards' perturbed pivots are summed into the report, and
accuracy comes from refinement (:func:`dist_solve_refined`: fp64 residuals on
the CSR SpMV kernel, K0). respatpu refuses its df64 policy for the factor;
here every band policy factors natively, fp64 included.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .analysis import permute_csr, rcm_ordering
from .dist import Mesh, make_mesh
from .formats import CSRMatrix
from .kernels import bandlu
from .precision import Policy, ftz, get_policy
from .solve import SolveReport, band_ordering, relative_residual, solve_refined

__all__ = ["DistBandLu", "dist_factorize_band", "dist_solve_refined"]


def _split_coupling(a: CSRMatrix, ndev: int, nb_loc: int, p: int, ml: int, mu: int,
                    parts: Sequence[int]):
    """The band entries and coupling blocks of the partitions ``parts``, on
    the host.

    Returns, for each partition j of them, ``(flat, vals, B_j, C_j)``: the flat
    positions in its band [nb_loc, p, (ml+mu+1)*p] of its entries (the
    identity on the padding rows past n included) and their values, and the
    dense coupling blocks ``B_j`` [mu*p, mu*p] (its last mu block rows
    against the first mu block columns of partition j+1) and ``C_j``
    [ml*p, ml*p] (its first ml block rows against the last ml block columns
    of partition j-1), fp64."""
    n = a.nrows
    w = (ml + mu + 1) * p
    rows = np.repeat(np.arange(n, dtype=np.int64), a.row_lengths())
    cols = a.indices.astype(np.int64)
    part = rows // (nb_loc * p)
    pad = np.arange(n, ndev * nb_loc * p, dtype=np.int64)
    out = []
    for j in parts:
        r0, r1 = j * nb_loc, (j + 1) * nb_loc
        sel = part == j
        rj, cj, vj = rows[sel], cols[sel], a.data[sel]
        cb = cj // p
        right, left = cb >= r1, cb < r0
        loc = ~(right | left)
        flat = (rj[loc] - r0 * p) * w + (cj[loc] - (rj[loc] // p - ml) * p)
        vals = vj[loc]
        pj = pad[(pad >= r0 * p) & (pad < r1 * p)]
        flat = np.concatenate([flat, (pj - r0 * p) * w + ml * p + pj % p])
        vals = np.concatenate([vals, np.ones(pj.size)])
        b = np.zeros((mu * p, mu * p))
        b[rj[right] - (r1 - mu) * p, cj[right] - r1 * p] = vj[right]
        c = np.zeros((ml * p, ml * p))
        c[rj[left] - r0 * p, cj[left] - (r0 - ml) * p] = vj[left]
        out.append((flat, vals, b, c))
    return out


@dataclasses.dataclass
class _Part:
    lu: bandlu.DeviceBand  # the factored band of the partition
    b: torch.Tensor  # B_j [mu*p, mu*p], accumulator type
    c: torch.Tensor  # C_j [ml*p, ml*p]


class DistBandLu:
    """Distributed direct solver: the band ordering + partitioned band LU
    (SPIKE), with respatpu's phases (analyze on the host, factorize, solve)
    in a ``SolveReport``.

    ``max_reduced`` caps the reduced system's order P*(ml+mu)*p and
    ``max_band_bytes`` the band (unpadded, counted in fp32, as respatpu
    counts it): past either this raises ``MemoryError``. ``order`` is
    respatpu's: RCM for ``"rcm"``, else the natural order. ``phases`` holds
    the factorization's seconds: ``band_lu`` (every shard's band), ``tips``
    (the multi-right-hand-side solves), ``reduced`` (the gather, assembly
    and LU of R), each ended by a device synchronize."""

    def __init__(self, a: CSRMatrix, mesh: Optional[Mesh] = None,
                 policy: Union[str, Policy] = "fp32",
                 order: str = "rcm", p: int = 128,
                 pivot_eps: Optional[float] = None,
                 max_reduced: int = 16384,
                 max_band_bytes: int = 8 << 30):
        policy = get_policy(policy)
        if a.shape[0] != a.shape[1]:
            raise ValueError(f"band LU requires a square matrix, got {a.shape}")
        self.policy = policy
        self.a = a
        self.mesh = mesh = mesh or make_mesh()
        self.ndev = ndev = mesh.size
        self.device = mesh.local_places[0].device
        self.report = SolveReport(policy=f"{policy.name}+spike{ndev}")
        for place in mesh.local_places:
            if place.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
                raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 is on; the band "
                                   "factorization needs full fp32 products")
        acc = policy.accum_dtype

        t0 = time.perf_counter()
        if order == "rcm":
            self.perm = rcm_ordering(a)
            self._ap = permute_csr(a, self.perm)
        else:
            self.perm = np.arange(a.nrows, dtype=np.int32)
            self._ap = a
        _, bl, bu = band_ordering(self._ap, "natural")
        ml, mu = max(1, -(-bl // p)), max(1, -(-bu // p))
        nb = -(-a.nrows // p)
        # tips must not overlap: nb_loc >= ml + mu
        nb_loc = max(-(-nb // ndev), ml + mu)
        w = (ml + mu + 1) * p
        need = nb * p * w * 4
        if need > max_band_bytes:
            raise MemoryError(f"band storage would need {need / 2**30:.1f} GiB across the mesh "
                              f"(bandwidth {bl}+{bu} after ordering)")
        s0 = (ml + mu) * p
        if ndev * s0 > max_reduced:
            raise MemoryError(f"reduced system order {ndev * s0} exceeds {max_reduced}; the "
                              "bandwidth is too large for the dense reduced solve: use the "
                              "iterative distributed stack (dist.py)")
        self.n, self.p, self.ml, self.mu, self.nb_loc = a.nrows, p, ml, mu, nb_loc
        self.reduced_order = ndev * s0
        if pivot_eps is None:
            amax = float(np.abs(a.data).max()) if a.nnz else 1.0
            pivot_eps = (1e-13 if acc == torch.float64 else 1e-4) * max(amax, 1.0)
        mesh.check_plan("DistBandLu", policy.name, self.perm, p, ml, mu, nb_loc)
        split = _split_coupling(self._ap, ndev, nb_loc, p, ml, mu, mesh.local_shards)
        bands, couplings = [None] * ndev, [None] * ndev
        mesh.fork()
        for j, (flat, vals, b, c) in zip(mesh.local_shards, split):
            dev = mesh.shards[j].device
            with mesh.on(j):
                data = torch.zeros(nb_loc * p * w, dtype=policy.dtype, device=dev)
                data[torch.from_numpy(flat).to(dev)] = policy.cast_host(vals).to(dev)
                bands[j] = bandlu.DeviceBand(n=nb_loc * p, p=p, ml=ml, mu=mu, policy=policy,
                                             data=data.view(nb_loc, p, w))
                couplings[j] = (torch.from_numpy(b).to(acc).to(dev),
                                torch.from_numpy(c).to(acc).to(dev))
        mesh.join()
        mesh.synchronize()
        self.report.t_analyze = time.perf_counter() - t0

        # ---- factorize (job=4): local band LU, the tips, the reduced system ----
        t0 = time.perf_counter()
        self.phases = {}
        mesh.fork()
        results = mesh.map(lambda j, band: bandlu.band_lu(band, pivot_eps), bands)
        del bands
        self._parts: List[Optional[_Part]] = [None] * ndev
        for j in mesh.local_shards:
            self._parts[j] = _Part(results[j].lu, *couplings[j])
        mesh.join()
        mesh.synchronize()
        self.phases["band_lu"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        mesh.fork()
        tips = mesh.map(lambda j: self._tips(j))
        mesh.join()
        mesh.synchronize()
        self.phases["tips"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        mesh.fork()
        gathered = mesh.all_gather(tips)
        self._rlu = mesh.each_device(lambda g: self._reduced(g), gathered)
        mesh.join()
        mesh.synchronize()
        self.phases["reduced"] = time.perf_counter() - t1
        self.report.t_factorize = time.perf_counter() - t0
        amax = float(np.abs(a.data).max()) if a.nnz else 1.0
        umax = 0.0
        for j in mesh.local_shards:
            lo, hi = torch.aminmax(self._parts[j].lu.data)
            umax = max(umax, abs(float(lo)), abs(float(hi)))
        # every rank's pivots and largest entry, for the one report every rank holds
        counts = mesh.rank_values([sum(results[j].n_pivot_perturbed for j in mesh.local_shards),
                                   umax])
        self.report.n_pivot_perturbed = int(counts[:, 0].sum())
        self.report.pivot_growth = float(counts[:, 1].max()) / max(amax, 1e-300)
        item = torch.finfo(acc).bits // 8
        self.reduced_bytes = self.reduced_order ** 2 * item
        self.report.factor_bytes = (
            ndev * self._parts[mesh.local_shards[0]].lu.data.element_size() * nb_loc * p * w
            + len(mesh.places) * self.reduced_bytes + ndev * (mu * mu + ml * ml) * p * p * item)

    def _tips(self, j: int) -> torch.Tensor:
        """Shard j's tips, flat: the top mu*p and bottom ml*p rows of V_j and
        of W_j (zero for the last and the first partition, which have no
        right and no left neighbour)."""
        part, p, ml, mu, nb = self._parts[j], self.p, self.ml, self.mu, self.nb_loc
        acc = self.policy.accum_dtype
        dev = part.b.device
        out = []
        for k, (blk, edge) in enumerate(((part.b, j < self.ndev - 1), (part.c, j > 0))):
            width = blk.shape[1]
            if not edge:
                out.append(torch.zeros((mu + ml) * p * width, dtype=acc, device=dev))
                continue
            rhs = torch.zeros((nb * p, width), dtype=acc, device=dev)
            if k == 0:  # V = A^-1 [0; B]: the forward sweep starts at B's block rows
                rhs[-mu * p:] = blk
            else:  # W = A^-1 [C; 0]
                rhs[:ml * p] = blk
            sol = bandlu.band_solve(part.lu, rhs, max(nb - mu, 0) if k == 0 else 0)
            out.append(torch.cat([sol[:mu * p].reshape(-1), sol[-ml * p:].reshape(-1)]))
        return torch.cat(out)

    def _reduced(self, gathered: torch.Tensor):
        """R = I + the tips at their places, LU-factored (partial pivoting)."""
        p, ml, mu, ndev = self.p, self.ml, self.mu, self.ndev
        s0 = (ml + mu) * p
        tips = gathered.view(ndev, -1)
        R = torch.eye(ndev * s0, dtype=gathered.dtype, device=gathered.device)
        nv = s0 * mu * p
        for j in range(ndev):
            v = tips[j, :nv].view(s0, mu * p)
            wj = tips[j, nv:].view(s0, ml * p)
            if j < ndev - 1:
                R[j * s0:(j + 1) * s0, (j + 1) * s0:(j + 1) * s0 + mu * p] += v
            if j > 0:
                R[j * s0:(j + 1) * s0, (j - 1) * s0 + mu * p:j * s0] += wj
        return torch.linalg.lu_factor(R)

    def _solve_parts(self, bs: List[torch.Tensor]) -> List[torch.Tensor]:
        """The SPIKE solve on the shards' padded pieces of b ([nb_loc*p] or
        [nb_loc*p, k], accumulator type); returns the pieces of x. Runs
        inside the caller's fork and join."""
        mesh, p, ml, mu = self.mesh, self.p, self.ml, self.mu
        s0 = (ml + mu) * p
        ndev = self.ndev

        def local(j, b):
            return bandlu.band_solve(self._parts[j].lu, b)

        g = mesh.map(local, bs)
        tips = mesh.map(lambda j, g: torch.cat([g[:mu * p], g[-ml * p:]]), g)
        y = mesh.each_device(lambda t, f: torch.linalg.lu_solve(
            f[0], f[1], t.reshape(ndev * s0, -1)), mesh.all_gather(tips), self._rlu)

        def back(j, b, y):
            part = self._parts[j]
            bf = b.reshape(b.shape[0], -1).clone()
            if j < ndev - 1:
                bf[-mu * p:] -= part.b @ y[(j + 1) * s0:(j + 1) * s0 + mu * p]
            if j > 0:
                bf[:ml * p] -= part.c @ y[(j - 1) * s0 + mu * p:j * s0]
            return local(j, bf.reshape(b.shape).contiguous())

        return mesh.map(back, bs, y)

    def _pieces(self, bp: torch.Tensor) -> List[Optional[torch.Tensor]]:
        """A permuted right-hand side ([n] or [n, k] at this rank's first
        place) padded and cut into its shards' pieces, on their devices."""
        npts = self.ndev * self.nb_loc * self.p
        acc = self.policy.accum_dtype
        mesh = self.mesh
        first = mesh.lead[mesh.local_places[0]]
        with mesh.on(first):
            full = torch.zeros((npts, *bp.shape[1:]), dtype=acc, device=bp.device)
            full[:self.n] = ftz(bp.to(acc), self.policy.flush_to_zero)
        m = self.nb_loc * self.p
        out: List[Optional[torch.Tensor]] = [None] * self.ndev
        for j in mesh.local_shards:
            mesh.wait(j, [first])
            out[j] = mesh.take(full[j * m:(j + 1) * m], first, j, count=False)
        return out

    def solve_device(self, bp: torch.Tensor) -> torch.Tensor:
        """Solve in permuted coordinates: ``bp`` [n] or [n, k] at this rank's
        first place in, x in the accumulator type there out (on a mesh over
        ranks, every rank passes the same b and gets the whole x)."""
        mesh = self.mesh
        mesh.fork()
        x = mesh.gather(self._solve_parts(self._pieces(bp)))[:self.n]
        mesh.join()
        return x

    def solve_original_device(self, r: torch.Tensor) -> torch.Tensor:
        """Solve A x = r in the original coordinates, fp64 tensors at this
        rank's first place in and out (``solve_refined``'s correction)."""
        if getattr(self, "_perm_dev", None) is None:
            self._perm_dev = torch.from_numpy(self.perm.astype(np.int64)).to(self.device)
        x = torch.empty_like(r)
        x[self._perm_dev] = self.solve_device(r[self._perm_dev]).double()
        return x

    def solve(self, b: np.ndarray) -> np.ndarray:
        """Solve A x = b (host in and out, one or several right-hand sides):
        the MUMPS job=3 slot."""
        t0 = time.perf_counter()
        b2 = np.asarray(b, np.float64)
        xp = self.solve_device(torch.from_numpy(b2[self.perm]).to(self.device))
        xh = xp.detach().to("cpu", torch.float64).numpy()
        x = np.empty_like(xh)
        x[self.perm] = xh
        self.report.t_solve = time.perf_counter() - t0
        if b2.ndim == 1:
            self.report.residual = relative_residual(self.a, x, b2)
        return x


def dist_factorize_band(a: CSRMatrix, mesh: Optional[Mesh] = None, **kw) -> DistBandLu:
    return DistBandLu(a, mesh=mesh, **kw)


def dist_solve_refined(a: CSRMatrix, b: np.ndarray,
                       fac: Optional[DistBandLu] = None,
                       mesh: Optional[Mesh] = None,
                       tol: float = 1e-12, max_iters: int = 40
                       ) -> Tuple[np.ndarray, SolveReport]:
    """Distributed factorization + fp64 iterative refinement: the
    correction solves on the mesh (SPIKE), the residuals in fp64 at each
    rank's first place (K0), one host wait an iteration, and GMRES-IR if
    plain refinement stalls (``solve.solve_refined``). Reaches reference
    fp64 residuals from the fp32 factorization. Over ranks every rank runs
    the same refinement on the same bits and returns the same x."""
    if fac is None:
        fac = DistBandLu(a, mesh=mesh)
    x, rep = solve_refined(a, b, fac=fac, tol=tol, max_iters=max_iters)
    rep.policy = fac.report.policy + "+ir_fp64"
    return x, rep
