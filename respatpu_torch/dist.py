"""Distributed sparse linear algebra over a mesh of shards: the row-partitioned
SpMV with its halo exchange, block-Jacobi ILU(0), CG and BiCGSTAB.

The counterpart of ``respatpu/dist.py``, which fills the reference's only
distributed slot (MUMPS over MPI, test_mumps.c:87-158) with a 1-D device mesh,
``shard_map`` and XLA collectives. Here one process drives a :class:`Mesh` of P
shards, each a torch device and a CUDA stream of its own. A shard's body is a
step of a loop over the shards, run on its stream; a collective is a copy
between shards, ordered across streams by CUDA events, so that nothing makes
the host wait but a convergence test. With more shards than cards the shards
share the cards round-robin (``"4 shards on 1 card"``): that runs the
distributed path, with its exchanges and its per-shard launches, on one card,
but it is not a scaling measurement. On several cards the same copies go
between cards.

Rules every module of the distributed stack keeps:

* every sum across shards (``Mesh.psum``, a dot product, a remote
  extend-add) is taken in shard order with no floating-point atomics, so two
  runs give the same bits;
* a replicated value (:class:`Replicated`) is stored once per distinct
  device, not once per shard;
* respatpu's double-float paths are native fp64.

The row partition is respatpu's: contiguous bands of ``n_loc = ceil(n/P)``
rows, x and y split the same way, and the same halo requests
(``send_idx``, ``send_mask``, ``halo``). Each shard's rows are a CSR over
``concat(x_loc, recv)`` (respatpu pads them into ELL), so the local product
runs on the CSR SpMV kernel (K0), and each pair of shards exchanges its own
count of entries, not the padded ``halo`` for every pair. The interior rows
(all columns local) are one K0 launch that needs no halo; the boundary rows
are a second launch after the exchange.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .formats import COOMatrix, CSRMatrix, coo_to_csr, split_triangular
from .kernels.ilu0 import ilu0_factor
from .kernels.spmv import DeviceCsr, spmv, to_device
from .precision import Policy, get_policy

__all__ = ["Shard", "Mesh", "Replicated", "make_mesh", "RowPartitionPlan",
           "build_row_partition", "DistSpmv", "dist_spmv", "BlockJacobiIlu",
           "dist_cg", "dist_bicgstab"]


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Shard:
    index: int
    device: torch.device
    stream: Optional["torch.cuda.Stream"]  # None on the CPU


class Replicated:
    """A value held once on every distinct device of a mesh (the output of
    a collective); ``at(d)`` is the copy on shard d's device."""

    def __init__(self, mesh: "Mesh", values: Dict[torch.device, torch.Tensor]):
        self.mesh = mesh
        self.values = values

    def at(self, d: int) -> torch.Tensor:
        return self.values[self.mesh.shards[d].device]

    @property
    def first(self) -> torch.Tensor:
        """The copy on the mesh's first device."""
        return self.values[self.mesh.devices[0]]


class Mesh:
    """P shards over a list of torch devices, one stream a shard on a card.

    A shard's work runs under :meth:`on`; :meth:`fork` starts a distributed
    operation (every shard's stream waits for its device's current stream)
    and :meth:`join` ends it (every device's current stream waits for its
    shards). Between the two, the collectives order the streams they connect
    by events and count the bytes they copy in ``bytes_moved``."""

    def __init__(self, devices: Sequence[Union[str, torch.device]]):
        devices = [torch.device(d) for d in devices]
        if not devices:
            raise ValueError("a mesh needs at least one shard")
        shards = []
        for i, dev in enumerate(devices):
            if dev.type == "cuda":
                if dev.index is None:
                    dev = torch.device("cuda", torch.cuda.current_device())
                stream = torch.cuda.Stream(dev)
            elif dev.type == "cpu":
                stream = None
            else:
                raise ValueError(f"no mesh on {dev}")
            shards.append(Shard(i, dev, stream))
        self.shards: List[Shard] = shards
        self.devices: List[torch.device] = list(dict.fromkeys(s.device for s in shards))
        # the first shard on each device computes the device's replicated values
        self.lead: Dict[torch.device, int] = {}
        for s in shards:
            self.lead.setdefault(s.device, s.index)
        self.bytes_moved = 0

    @property
    def size(self) -> int:
        return len(self.shards)

    def __len__(self) -> int:
        return len(self.shards)

    def describe(self) -> str:
        """"4 shards on 1 card", "8 shards on the CPU"."""
        p = self.size
        if self.devices[0].type == "cpu":
            return f"{p} shard{'s' * (p != 1)} on the CPU"
        c = len(self.devices)
        return f"{p} shard{'s' * (p != 1)} on {c} card{'s' * (c != 1)}"

    @contextlib.contextmanager
    def on(self, d: int):
        """Run what follows as shard d: on its device and its stream."""
        s = self.shards[d]
        if s.stream is None:
            yield
            return
        with torch.cuda.device(s.device), torch.cuda.stream(s.stream):
            yield

    def fork(self) -> None:
        for s in self.shards:
            if s.stream is not None:
                s.stream.wait_stream(torch.cuda.current_stream(s.device))

    def join(self) -> None:
        for s in self.shards:
            if s.stream is not None:
                torch.cuda.current_stream(s.device).wait_stream(s.stream)

    def wait(self, d: int, srcs: Sequence[int]) -> None:
        """Shard d's stream waits for the work queued so far on each of the
        shards ``srcs``."""
        mine = self.shards[d].stream
        if mine is None:
            return
        for s in srcs:
            if s != d:
                mine.wait_stream(self.shards[s].stream)

    def take(self, t: torch.Tensor, src: int, d: int, count: bool = True) -> torch.Tensor:
        """``t``, made on shard ``src`` (which shard d has waited for), for use
        on shard d: the same tensor on the same device, else a copy made with
        both shards' streams current (the copy runs on src's and d's stream
        waits for it). Counts its bytes in ``bytes_moved`` unless told not to."""
        if count:
            self.bytes_moved += t.numel() * t.element_size()
        s, o = self.shards[d], self.shards[src]
        if t.device == s.device:
            if s.stream is not None:
                t.record_stream(s.stream)
            return t
        with self.on(d), (torch.cuda.stream(o.stream) if o.stream is not None
                          else contextlib.nullcontext()):
            return t.to(s.device, non_blocking=True)

    def map(self, fn: Callable, *args) -> list:
        """``[fn(d, *args at d) for each shard d]``, each under :meth:`on`; an
        argument is a list (indexed by shard), a :class:`Replicated` (its copy
        on d's device) or anything else (passed as it is)."""
        out = []
        for d in range(self.size):
            picked = [a[d] if isinstance(a, list) else a.at(d) if isinstance(a, Replicated)
                      else a for a in args]
            with self.on(d):
                out.append(fn(d, *picked))
        return out

    def all_to_all(self, send: List[List[Optional[torch.Tensor]]]
                   ) -> List[List[Optional[torch.Tensor]]]:
        """``recv[d][s] = send[s][d]`` moved to shard d (None where nothing
        is sent). A shard's own entry is handed over without being counted."""
        p = self.size
        recv: List[List[Optional[torch.Tensor]]] = [[None] * p for _ in range(p)]
        for d in range(p):
            srcs = [s for s in range(p) if send[s][d] is not None]
            with self.on(d):
                self.wait(d, srcs)
                for s in srcs:
                    recv[d][s] = self.take(send[s][d], s, d, count=s != d)
        return recv

    def all_gather(self, xs: Sequence[torch.Tensor]) -> Replicated:
        """Every shard's tensor concatenated in shard order, once on every
        device."""
        return self._replicate(xs, torch.cat)

    def psum(self, xs: Sequence[torch.Tensor]) -> Replicated:
        """The sum of the shards' tensors, added in shard order (a left fold,
        no atomics), once on every device."""

        def fold(parts):
            acc = parts[0]
            for t in parts[1:]:
                acc = acc + t
            return acc

        return self._replicate(xs, fold)

    def _per_device(self, fn: Callable) -> Replicated:
        """``fn(device, lead)`` once on every device, on the stream of its
        first shard (``lead``), which the device's other shards then wait for."""
        out = {}
        for dev in self.devices:
            lead = self.lead[dev]
            with self.on(lead):
                out[dev] = fn(dev, lead)
            for s in self.shards:
                if s.device == dev and s.index != lead:
                    self.wait(s.index, [lead])
        return Replicated(self, out)

    def _replicate(self, xs, combine) -> Replicated:
        def one(dev, lead):
            self.wait(lead, range(self.size))
            return combine([self.take(x, s, lead) for s, x in enumerate(xs)])

        return self._per_device(one)

    def each_device(self, fn: Callable, *reps: Replicated) -> Replicated:
        """``fn`` of replicated values, computed once on every device."""
        return self._per_device(lambda dev, lead: fn(*[r.values[dev] for r in reps]))

    def synchronize(self) -> None:
        """The host waits for every card of the mesh."""
        for dev in self.devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def test(self, fn: Callable, *reps: Replicated) -> bool:
        """A convergence test: ``bool(fn(...))`` of replicated values on the
        first device, the one wait of the host."""
        with self.on(self.lead[self.devices[0]]):
            return bool(fn(*[r.first for r in reps]))

    def dot(self, u: List[torch.Tensor], v: List[torch.Tensor]) -> Replicated:
        """The fp32 dot product of two sharded vectors: a dot a shard, then
        :meth:`psum`."""
        return self.psum(self.map(lambda d, a, b: torch.dot(a.float(), b.float()), u, v))


def make_mesh(n_devices: Optional[int] = None, device: Union[str, torch.device] = "cuda"
              ) -> Mesh:
    """A mesh of ``n_devices`` shards on ``device``.

    ``"cuda"`` puts the shards on the cards round-robin (by default one a
    card); ``"cuda:k"`` puts them all on card k; ``"cpu"`` on the host (by
    default one). A mesh on a card raises when there is none: it never falls
    back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: CUDA is not available; pass device='cpu' to run "
                               "the kernels' plain versions on the host")
        cards = ([device] if device.index is not None else
                 [torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    elif device.type == "cpu":
        cards = [device]
    else:
        raise ValueError(f"no mesh on {device}")
    n = len(cards) if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    return Mesh([cards[i % len(cards)] for i in range(n)])


# ---------------------------------------------------------------------------
# The row partition
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RowPartitionPlan:
    """Host-side plan of a 1-D row partition over ``ndev`` shards.

    ``halo``, ``send_idx`` and ``send_mask`` are respatpu's arrays (the
    padded exchange it runs); the port exchanges ``requests`` as they are.
    ``local[d]`` is shard d's rows (``n_loc`` of them, the last shard's padded
    with empty rows) as a CSR over ``concat(x_loc, recv)``, where ``recv``
    holds the requested entries from each other shard in shard order."""

    n: int
    ndev: int
    n_loc: int  # rows and x entries a shard (the last shard padded)
    halo: int  # H: most entries one shard sends another (respatpu's padding)
    send_idx: np.ndarray  # int32[ndev, ndev, H]: local x indices s sends to d
    send_mask: np.ndarray  # float32[ndev, ndev, H]
    requests: List[List[np.ndarray]]  # [d][s]: sorted global columns d needs from s
    local: List[CSRMatrix]  # [d]: n_loc x (n_loc + recv entries)

    @property
    def exchange_entries(self) -> int:
        """x entries one distributed product moves between shards."""
        return sum(r.size for row in self.requests for r in row)

    def interior(self, d: int) -> np.ndarray:
        """bool[n_loc]: the rows of shard d whose columns are all local."""
        loc = self.local[d]
        remote = np.repeat(np.arange(self.n_loc), loc.row_lengths())[loc.indices >= self.n_loc]
        out = np.ones(self.n_loc, bool)
        out[remote] = False
        return out


def build_row_partition(a: CSRMatrix, ndev: int) -> RowPartitionPlan:
    """The halo plan and each shard's local CSR (host, once a matrix)."""
    n = a.nrows
    if a.shape[0] != a.shape[1]:
        raise ValueError("the row partition assumes a square matrix")
    n_loc = -(-n // ndev)
    indptr = a.indptr.astype(np.int64)
    cols_all = a.indices.astype(np.int64)
    requests: List[List[np.ndarray]] = [[np.empty(0, np.int64)] * ndev for _ in range(ndev)]
    local = []
    for d in range(ndev):
        lo, hi = min(d * n_loc, n), min((d + 1) * n_loc, n)
        e0, e1 = indptr[lo], indptr[hi]
        ecol = cols_all[e0:e1]
        own = ecol // n_loc
        remote = own != d
        need = np.unique(ecol[remote])  # sorted, so grouped by owner in shard order
        cut = np.searchsorted(need, np.arange(ndev + 1) * n_loc)
        for s in range(ndev):
            if s != d:
                requests[d][s] = need[cut[s]:cut[s + 1]]
        mapped = ecol - lo
        mapped[remote] = n_loc + np.searchsorted(need, ecol[remote])
        ptr = np.zeros(n_loc + 1, np.int64)
        ptr[1:hi - lo + 1] = indptr[lo + 1:hi + 1] - e0
        ptr[hi - lo + 1:] = e1 - e0
        local.append(CSRMatrix((n_loc, n_loc + need.size), ptr, mapped.astype(np.int32),
                               a.data[e0:e1].copy()))
    halo = max(1, max((r.size for row in requests for r in row), default=1))
    send_idx = np.zeros((ndev, ndev, halo), np.int32)
    send_mask = np.zeros((ndev, ndev, halo), np.float32)
    for s in range(ndev):
        for d in range(ndev):
            if s != d:
                req = requests[d][s]
                send_idx[s, d, :req.size] = req - s * n_loc
                send_mask[s, d, :req.size] = 1.0
    return RowPartitionPlan(n=n, ndev=ndev, n_loc=n_loc, halo=halo, send_idx=send_idx,
                            send_mask=send_mask, requests=requests, local=local)


def _rows(a: CSRMatrix, keep: np.ndarray, ncols: int, compact: bool) -> CSRMatrix:
    """The rows of ``a`` where ``keep``, ``ncols`` wide: only those rows
    where ``compact``, else all of them with the others emptied."""
    lens = a.row_lengths()[keep] if compact else np.where(keep, a.row_lengths(), 0)
    sel = np.repeat(keep, a.row_lengths())
    ptr = np.r_[0, np.cumsum(lens)].astype(np.int64)
    return CSRMatrix((ptr.size - 1, ncols), ptr, a.indices[sel], a.data[sel])


# ---------------------------------------------------------------------------
# Distributed SpMV
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _ShardSpmv:
    interior: DeviceCsr  # n_loc rows (the boundary rows empty) over x_loc
    boundary: Optional[DeviceCsr]  # the boundary rows over concat(x_loc, recv)
    bnd_rows: Optional[torch.Tensor]  # int64: their local rows
    send_idx: Optional[torch.Tensor]  # int64: x_loc entries sent, peers in shard order
    send_off: List[int]  # [d]: where the entries for shard d start in what is sent


class DistSpmv:
    """Device-resident distributed SpMV: y = A x over a mesh, x and y split
    by the row partition (a list of one ``n_loc`` vector a shard).

    ``policy``: fp32, fp32_ftz, bf16 (K0's single-word instances, x and y
    fp32) or fp64 (respatpu's df64). A call is, on every shard, one K0 launch
    on the interior rows, the halo exchange (each shard gathers what its
    peers asked for; each receiver concatenates it behind its own x), then
    one K0 launch on the boundary rows."""

    def __init__(self, a: CSRMatrix, mesh: Mesh, policy: Union[str, Policy] = "fp32"):
        self.policy = get_policy(policy)
        self.mesh = mesh
        self.n = a.nrows
        self.plan = build_row_partition(a, mesh.size)
        p, n_loc = mesh.size, self.plan.n_loc
        self._shards: List[_ShardSpmv] = []
        mesh.fork()
        for d in range(p):
            dev = mesh.shards[d].device
            loc = self.plan.local[d]
            inner = self.plan.interior(d)
            with mesh.on(d):
                interior = to_device(_rows(loc, inner, n_loc, False), self.policy, dev, fmt="csr")
                bnd = np.flatnonzero(~inner)
                boundary = bnd_rows = None
                if bnd.size:
                    boundary = to_device(_rows(loc, ~inner, loc.ncols, True), self.policy, dev,
                                         fmt="csr")
                    bnd_rows = torch.from_numpy(bnd).to(dev)
                sends = [self.plan.requests[e][d] - d * n_loc if e != d else np.empty(0, np.int64)
                         for e in range(p)]
                off = np.r_[0, np.cumsum([s.size for s in sends])].tolist()
                idx = (torch.from_numpy(np.concatenate(sends).astype(np.int64)).to(dev)
                       if off[-1] else None)
            self._shards.append(_ShardSpmv(interior, boundary, bnd_rows, idx, off))
        mesh.join()

    @property
    def exchange_bytes(self) -> int:
        """Bytes of x one call moves between shards."""
        return self.plan.exchange_entries * torch.finfo(self.policy.accum_dtype).bits // 8

    def shard_vector(self, x) -> List[torch.Tensor]:
        """A host vector (length n) split into the shards' padded pieces of
        the policy's x type, each on its shard's device."""
        xp = np.zeros(self.plan.ndev * self.plan.n_loc, np.float64)
        xp[:self.n] = np.asarray(x, np.float64)
        n_loc = self.plan.n_loc
        acc = self.policy.accum_dtype
        return self.mesh.map(lambda d: torch.from_numpy(xp[d * n_loc:(d + 1) * n_loc]).to(
            self.mesh.shards[d].device).to(acc))

    def unshard(self, y: Sequence[torch.Tensor]) -> np.ndarray:
        self.mesh.join()
        return torch.cat([t.detach().to("cpu", torch.float64) for t in y]).numpy()[:self.n]

    def __call__(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        mesh, p = self.mesh, self.mesh.size
        mesh.fork()
        ys, sent = [], []
        for d in range(p):
            sh = self._shards[d]
            with mesh.on(d):
                sent.append(xs[d].index_select(0, sh.send_idx) if sh.send_idx is not None
                            else None)
                ys.append(spmv(sh.interior, xs[d]))
        send = [[None] * p for _ in range(p)]
        for s in range(p):
            off = self._shards[s].send_off
            for d in range(p):
                if off[d + 1] > off[d]:  # a shard sends itself nothing
                    send[s][d] = sent[s][off[d]:off[d + 1]]
        recv = mesh.all_to_all(send)
        for d in range(p):
            sh = self._shards[d]
            if sh.boundary is None:
                continue
            with mesh.on(d):
                xe = torch.cat([xs[d]] + [t for t in recv[d] if t is not None])
                ys[d].index_copy_(0, sh.bnd_rows, spmv(sh.boundary, xe))
        mesh.join()
        return ys


def dist_spmv(a: CSRMatrix, x: np.ndarray, mesh: Optional[Mesh] = None) -> np.ndarray:
    """One distributed fp32 SpMV round trip (host in and out), for tests and
    sweeps."""
    mesh = mesh or make_mesh()
    op = DistSpmv(a, mesh)
    return op.unshard(op(op.shard_vector(x)))


# ---------------------------------------------------------------------------
# Block-Jacobi ILU(0)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _ShardIlu:
    lower: Optional[DeviceCsr]  # strict L of the block (unit diagonal implied)
    upper: Optional[DeviceCsr]  # strict U
    dinv: torch.Tensor  # fp32[n_loc]: 1 / U's diagonal (1 where it is 0, and on padding)


class BlockJacobiIlu:
    """Distributed preconditioner: each shard's diagonal block factored by
    ILU(0) (the Chow-Patel sweeps of ``kernels.ilu0`` on K6, fp32), applied
    with no communication (block-Jacobi).

    As in respatpu: a block's missing diagonal entries (and the padding
    rows') are set to 1 before the factorization; the apply is
    ``apply_sweeps`` truncated Jacobi sweeps with the strict L (z <- r - L z)
    and then with the strict U (w <- dinv (z - U w)), each product one K0
    launch. The Krylov loop supplies the global coupling through
    :class:`DistSpmv`."""

    def __init__(self, a: CSRMatrix, plan: RowPartitionPlan, mesh: Mesh,
                 sweeps: int = 8, apply_sweeps: int = 8):
        self.mesh = mesh
        self.apply_sweeps = apply_sweeps
        self.n_loc = n_loc = plan.n_loc
        n = plan.n
        rows_all = np.repeat(np.arange(n, dtype=np.int64), a.row_lengths())
        self._shards: List[_ShardIlu] = []
        mesh.fork()
        for d in range(plan.ndev):
            lo, hi = min(d * n_loc, n), min((d + 1) * n_loc, n)
            sel = (rows_all >= lo) & (rows_all < hi) & (a.indices >= lo) & (a.indices < hi)
            r = (rows_all[sel] - lo).astype(np.int32)
            c = (a.indices[sel] - lo).astype(np.int32)
            v = a.data[sel]
            have = np.zeros(n_loc, bool)
            have[r[r == c]] = True
            missing = np.flatnonzero(~have).astype(np.int32)
            blk = coo_to_csr(COOMatrix((n_loc, n_loc), np.concatenate([r, missing]),
                                       np.concatenate([c, missing]),
                                       np.concatenate([v, np.ones(missing.size)])))
            dev = mesh.shards[d].device
            with mesh.on(d):
                res, _ = ilu0_factor(blk, policy="fp32", sweeps=sweeps, device=dev)
                vals = res.values.detach().to("cpu", torch.float64).numpy()
                L, dfac, U = split_triangular(CSRMatrix(blk.shape, blk.indptr, blk.indices, vals))
                urow = np.repeat(np.arange(n_loc), U.row_lengths())
                off = U.indices != urow
                strict_u = coo_to_csr(COOMatrix((n_loc, n_loc), urow[off].astype(np.int32),
                                                U.indices[off], U.data[off]))
                dinv = np.ones(n_loc)
                dv = np.where(np.abs(dfac) > 0, dfac, 1.0)
                dinv[:hi - lo] = 1.0 / dv[:hi - lo]
                self._shards.append(_ShardIlu(
                    to_device(L, "fp32", dev, fmt="csr") if L.nnz else None,
                    to_device(strict_u, "fp32", dev, fmt="csr") if strict_u.nnz else None,
                    torch.from_numpy(dinv.astype(np.float32)).to(dev)))
        mesh.join()

    def _apply_shard(self, d: int, r: torch.Tensor) -> torch.Tensor:
        sh = self._shards[d]
        z = r
        if sh.lower is not None:
            for _ in range(self.apply_sweeps):
                z = r - spmv(sh.lower, z)
        w = sh.dinv * z
        if sh.upper is not None:
            for _ in range(self.apply_sweeps):
                w = sh.dinv * (z - spmv(sh.upper, w))
        return w

    def apply(self, rs: List[torch.Tensor]) -> List[torch.Tensor]:
        """M^-1 r on the mesh, fp32 pieces in and out, no exchange."""
        self.mesh.fork()
        out = self.mesh.map(lambda d, r: self._apply_shard(d, r.float()), rs)
        self.mesh.join()
        return out

    def apply_host(self, r: np.ndarray) -> np.ndarray:
        """Host-vector convenience wrapper around :meth:`apply`."""
        n_loc = self.n_loc
        rp = np.zeros(self.mesh.size * n_loc)
        rp[:r.size] = r
        rs = self.mesh.map(lambda d: torch.from_numpy(rp[d * n_loc:(d + 1) * n_loc]).float().to(
            self.mesh.shards[d].device))
        out = self.apply(rs)
        return torch.cat([t.to("cpu", torch.float64) for t in out]).numpy()[:r.size]


# ---------------------------------------------------------------------------
# Krylov solvers
# ---------------------------------------------------------------------------
# Each keeps its vectors sharded on the mesh; the scalars are psums of
# per-shard fp32 dots, computed again on each shard from the replicated
# values. The host waits once an iteration, for the convergence test, where
# respatpu's lax.while_loop tests its condition.


def _tol2(mesh: Mesh, nb2: Replicated, tol: float) -> Replicated:
    return mesh.each_device(lambda v: torch.tensor(tol, dtype=torch.float32, device=v.device) ** 2
                            * torch.where(v > 0, v, torch.ones_like(v)), nb2)


def dist_cg(a: CSRMatrix, b: np.ndarray, mesh: Optional[Mesh] = None,
            tol: float = 1e-6, max_iters: int = 200) -> Tuple[np.ndarray, int]:
    """Distributed conjugate gradient (no preconditioner, as respatpu's):
    the products on :class:`DistSpmv` (fp32), the dots psums in shard order.
    Stops when r.r <= tol^2 b.b or after ``max_iters``. Returns ``(x,
    iterations)``."""
    mesh = mesh or make_mesh()
    op = DistSpmv(a, mesh)
    bs = op.shard_vector(np.asarray(b, np.float64))
    mesh.fork()
    tol2 = _tol2(mesh, mesh.dot(bs, bs), tol)
    x = mesh.map(lambda d, v: torch.zeros_like(v), bs)
    r, p = bs, bs
    rz = mesh.dot(bs, bs)
    it = 0
    while it < max_iters and mesh.test(torch.gt, rz, tol2):
        ap = op(p)
        pap = mesh.dot(p, ap)
        x = mesh.map(lambda d, x, p, rz, pap: x + (rz / pap) * p, x, p, rz, pap)
        r = mesh.map(lambda d, r, ap, rz, pap: r - (rz / pap) * ap, r, ap, rz, pap)
        rz_new = mesh.dot(r, r)
        p = mesh.map(lambda d, r, p, new, old: r + (new / old) * p, r, p, rz_new, rz)
        rz, it = rz_new, it + 1
    mesh.join()
    return op.unshard(x), it


def dist_bicgstab(a: CSRMatrix, b: np.ndarray, mesh: Optional[Mesh] = None,
                  precondition: bool = True, tol: float = 1e-7,
                  max_iters: int = 400, op: Optional[DistSpmv] = None,
                  pre: Optional[BlockJacobiIlu] = None) -> Tuple[np.ndarray, int]:
    """Distributed BiCGSTAB with the block-Jacobi ILU(0) preconditioner
    (respatpu's iteration: rhat = b, x0 = 0, the half-step exit when s
    converges). ``op`` and ``pre`` may be prebuilt, so that a refinement
    loop builds neither again. Returns ``(x, iterations)``.

    x is the iterate of the smallest recursive residual so far: the last one
    when the tolerance is met (each earlier residual was above it), and
    respatpu's last iterate only then (ROADMAP D9). A run that stops at
    ``max_iters`` in fp32 can end far from its best iterate: on the ecology2
    stand-in, refinement rounds that took the last iterate diverged (the
    residual 2.5e4 after five), where the best iterates refine to 1e-11."""
    mesh = mesh or (op.mesh if op is not None else make_mesh())
    op = op or DistSpmv(a, mesh)
    if pre is None and precondition:
        pre = BlockJacobiIlu(a, op.plan, mesh)

    def pc(v):
        return pre.apply(v) if pre is not None else v

    bs = op.shard_vector(np.asarray(b, np.float64))
    mesh.fork()
    nb2 = mesh.dot(bs, bs)
    tol2 = _tol2(mesh, nb2, tol)
    ones = mesh.map(lambda d, v: torch.ones((), dtype=torch.float32, device=v.device), bs)
    x = mesh.map(lambda d, v: torch.zeros_like(v), bs)
    r = bs
    p, v = x, x
    rho = alpha = omega = ones
    rn2 = best2 = nb2
    best = x
    it = 0
    while it < max_iters and mesh.test(torch.gt, rn2, tol2):
        rho_new = mesh.dot(bs, r)
        beta = mesh.map(lambda d, rn, ro, al, om: (rn / ro) * (al / om), rho_new, rho, alpha, omega)
        p = mesh.map(lambda d, r, p, v, be, om: r + be * (p - om * v), r, p, v, beta, omega)
        ph = pc(p)
        v = op(ph)
        alpha = mesh.map(lambda d, rn, bv: rn / bv, rho_new, mesh.dot(bs, v))
        s = mesh.map(lambda d, r, al, v: r - al * v, r, alpha, v)
        x = mesh.map(lambda d, x, al, ph: x + al * ph, x, alpha, ph)
        sn2 = mesh.dot(s, s)
        sh = pc(s)
        t = op(sh)
        omega = mesh.map(lambda d, ts, tt: ts / tt, mesh.dot(t, s), mesh.dot(t, t))
        x2 = mesh.map(lambda d, x, om, sh: x + om * sh, x, omega, sh)
        r2 = mesh.map(lambda d, s, om, t: s - om * t, s, omega, t)
        done = mesh.map(lambda d, sn, t2: sn <= t2, sn2, tol2)
        x = mesh.map(lambda d, dn, x, x2: torch.where(dn, x, x2), done, x, x2)
        r = mesh.map(lambda d, dn, s, r2: torch.where(dn, s, r2), done, s, r2)
        rn2 = mesh.each_device(lambda sn, t2, rr: torch.where(sn <= t2, sn, rr),
                               sn2, tol2, mesh.dot(r2, r2))
        better = mesh.each_device(torch.lt, rn2, best2)
        best = mesh.map(lambda d, bt, x, bx: torch.where(bt, x, bx), better, x, best)
        best2 = mesh.each_device(torch.minimum, rn2, best2)
        rho, it = rho_new, it + 1
    mesh.join()
    return op.unshard(best), it
