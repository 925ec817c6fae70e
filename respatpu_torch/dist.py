"""Distributed sparse linear algebra over a mesh of shards: the row-partitioned
SpMV with its halo exchange, block-Jacobi ILU(0), CG and BiCGSTAB; and the
process group that lets a mesh span processes.

The counterpart of ``respatpu/dist.py``, which fills the reference's only
distributed slot (MUMPS over MPI, test_mumps.c:87-158) with a 1-D device mesh,
``shard_map`` and XLA collectives, and whose ``init_distributed``
(``jax.distributed.initialize``, the ``MPI_Init`` of test_mumps.c:87-88) spreads
that mesh over processes.

A :class:`Mesh` is P shards, each a torch device and a CUDA stream of its own.
A shard's body is a step of a loop over the shards, run on its stream; a
collective between shards of one process is a copy ordered across streams by
CUDA events, so that nothing makes the host wait but a convergence test. With
more shards than cards the shards share the cards round-robin (``"4 shards
on 1 card"``): that runs the distributed path, with its exchanges and its
per-shard launches, on one card, but it is not a scaling measurement.

After :func:`init_distributed`, ``make_mesh(n)`` spreads n shards over the
ranks of the process group, k = n / ranks a rank: shard d belongs to rank
d // k (respatpu's mesh orders its devices by process) and lies on that
rank's device. The one-process mesh is the case of a single rank that owns
every shard; the interface is the same. Each rank runs its own shards only
(``Mesh.map`` leaves ``None`` for the others) and every rank walks the same
host loops in the same order, so that each transfer meets its partner:

* a value is held once a *place* (:class:`Place`, a rank and a device: two
  ranks on one card are two places, since two processes cannot share a
  tensor);
* a transfer between ranks is point to point, and an exchange posts all of
  a rank's sends and receives at once (``batch_isend_irecv``); a receiver
  knows every shape from the host plan, which every rank builds alike and
  checks against the others' (:meth:`Mesh.check_plan`) when a distributed
  object is made;
* the transport is NCCL when every rank has a card of its own, else gloo:
  on the CPU, and for ranks that share a card (NCCL refuses two ranks on one
  device), where a card's tensor goes through a host copy each way.
  A failing transfer raises; nothing is rerouted.

Rules every module of the distributed stack keeps, on one process or many:

* every sum across shards (``Mesh.psum``, a dot product, a remote
  extend-add) is taken in shard order with no floating-point atomics, so two
  runs give the same bits; across ranks, ``psum`` is an all-gather and the
  same left fold on every place, never an ``all_reduce``, whose order NCCL
  does not fix, so a mesh over ranks gives the bits of the one-process mesh
  with as many shards;
* a replicated value (:class:`Replicated`) is stored once a place, not once
  a shard, and every rank holds the same bits, so every rank takes the same
  branch of a convergence test;
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
import datetime
import hashlib
import math
import os
import socket
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as tdist

from .formats import COOMatrix, CSRMatrix, coo_to_csr, split_triangular
from .kernels.ilu0 import ilu0_factor
from .kernels.spmv import DeviceCsr, spmv, to_device
from .precision import Policy, get_policy

__all__ = ["init_distributed", "shutdown_distributed", "process_count", "process_index",
           "Place", "Shard", "Mesh", "Replicated", "make_mesh", "RowPartitionPlan",
           "build_row_partition", "DistSpmv", "dist_spmv", "BlockJacobiIlu",
           "dist_cg", "dist_bicgstab"]


# ---------------------------------------------------------------------------
# The process group
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Ranks:
    """The process group :func:`init_distributed` set up."""
    rank: int
    world: int
    device: torch.device  # this rank's
    devices: List[torch.device]  # every rank's, as that rank names it
    hosts: List[str]  # every rank's host
    backend: str  # "gloo" or "nccl"


_RANKS: Optional[_Ranks] = None  # torch.distributed's default group is as global


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None, process_id: Optional[int] = None, *,
                     backend: Optional[str] = None, device: Union[str, torch.device] = "cuda",
                     timeout_s: float = 120, init_method: Optional[str] = None) -> None:
    """Join this process to a group of ``num_processes`` ranks as rank
    ``process_id``: respatpu's ``init_distributed``, on ``torch.distributed``.

    ``coordinator_address`` ("host:port") is rank 0's address, as in
    ``jax.distributed.initialize``; ``init_method`` may name another
    rendezvous instead (``"file:///path"``, a store in a file). With neither,
    the address, the world size and the rank come from torchrun's
    environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).
    ``device="cuda"`` puts the rank on card ``LOCAL_RANK % device_count()``
    (``LOCAL_RANK`` defaults to the rank) and raises without a card;
    ``"cpu"`` keeps it on the host. The transport is NCCL when every rank has
    a card of its own, else gloo; ``backend`` overrides the choice. Every
    call of the group waits at most ``timeout_s`` seconds for its partners
    and then raises."""
    global _RANKS
    if _RANKS is not None:
        raise RuntimeError("init_distributed: this process is in a group already")
    env = os.environ
    try:
        if init_method is None:
            if coordinator_address is None:
                coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
            init_method = f"tcp://{coordinator_address}"
        world = int(num_processes if num_processes is not None else env["WORLD_SIZE"])
        rank = int(process_id if process_id is not None else env["RANK"])
    except KeyError as e:
        raise ValueError(f"init_distributed: {e.args[0]} is not set; pass coordinator_address, "
                         "num_processes and process_id, or run under torchrun") from None
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: CUDA is not available; pass device='cpu' to "
                               "run the ranks on the host")
        local = int(env.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    elif device.type != "cpu":
        raise ValueError(f"init_distributed: no rank on {device}")
    timeout = datetime.timedelta(seconds=timeout_s)
    store, rank, world = next(tdist.rendezvous(init_method, rank, world, timeout=timeout))
    store.set_timeout(timeout)
    # every rank's place, read before the transport is chosen
    store.set(f"mesh_place_{rank}", f"{socket.gethostname()}|{device}")
    places = [store.get(f"mesh_place_{r}").decode().split("|", 1) for r in range(world)]
    hosts = [h for h, _ in places]
    devices = [torch.device(d) for _, d in places]
    if backend is None:
        own_cards = (all(d.type == "cuda" for d in devices)
                     and len({(h, str(d)) for h, d in zip(hosts, devices)}) == world)
        backend = "nccl" if own_cards else "gloo"
    tdist.init_process_group(backend, store=store, rank=rank, world_size=world, timeout=timeout)
    _RANKS = _Ranks(rank=rank, world=world, device=device, devices=devices, hosts=hosts,
                    backend=backend)


def shutdown_distributed() -> None:
    """Leave the process group (a no-op outside one)."""
    global _RANKS
    if _RANKS is not None:
        tdist.destroy_process_group()
        _RANKS = None


def process_count() -> int:
    """The ranks of the process group (1 outside one)."""
    return _RANKS.world if _RANKS is not None else 1


def process_index() -> int:
    """This process's rank (0 outside a group)."""
    return _RANKS.rank if _RANKS is not None else 0


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------


class Place(NamedTuple):
    """Where a replicated value is held: a rank and a device of it."""
    rank: int
    device: torch.device


@dataclasses.dataclass(frozen=True)
class Shard:
    index: int
    device: torch.device
    stream: Optional["torch.cuda.Stream"]  # None on the CPU and for another rank's shard
    rank: int = 0

    @property
    def place(self) -> Place:
        return Place(self.rank, self.device)


class Replicated:
    """A value held once on every place of this rank (the output of a
    collective); ``at(d)`` is the copy at shard d's place."""

    def __init__(self, mesh: "Mesh", values: Dict[Place, torch.Tensor]):
        self.mesh = mesh
        self.values = values

    def at(self, d: int) -> torch.Tensor:
        return self.values[self.mesh.shards[d].place]

    @property
    def first(self) -> torch.Tensor:
        """The copy at this rank's first place."""
        return self.values[self.mesh.local_places[0]]


def _digest(h, part) -> None:
    if isinstance(part, np.ndarray):
        h.update(f"{part.dtype}{part.shape}".encode())
        h.update(np.ascontiguousarray(part).tobytes())
    elif isinstance(part, (list, tuple)):
        h.update(f"[{len(part)}".encode())
        for p in part:
            _digest(h, p)
    else:
        h.update(repr(part).encode())


class Mesh:
    """P shards over a list of torch devices, one stream a shard on a card,
    on one rank or spread over the ranks of the process group (``ranks[d]``
    is shard d's; by default every shard is this process's).

    A shard's work runs under :meth:`on`; :meth:`fork` starts a distributed
    operation (every shard's stream waits for its device's current stream)
    and :meth:`join` ends it (every device's current stream waits for its
    shards); both cover this rank's shards. Between the two, the collectives
    order the streams they connect by events. ``bytes_moved`` counts the
    bytes handed between this rank's shards, ``bytes_sent`` those this rank
    sent to others."""

    def __init__(self, devices: Sequence[Union[str, torch.device]],
                 ranks: Optional[Sequence[int]] = None):
        devices = [torch.device(d) for d in devices]
        if not devices:
            raise ValueError("a mesh needs at least one shard")
        me = process_index()
        ranks = [me] * len(devices) if ranks is None else [int(r) for r in ranks]
        spans = sorted(set(ranks))
        if len(spans) > 1:
            world = process_count()
            k = len(devices) // world
            if k * world != len(devices) or ranks != [d // k for d in range(len(devices))]:
                raise ValueError(f"a mesh over ranks gives each of the group's {world} ranks an "
                                 f"equal run of shards in rank order, not {ranks}")
        shards = []
        for i, (dev, r) in enumerate(zip(devices, ranks)):
            stream = None
            if r == me:
                if dev.type == "cuda":
                    if dev.index is None:
                        dev = torch.device("cuda", torch.cuda.current_device())
                    stream = torch.cuda.Stream(dev)
                elif dev.type != "cpu":
                    raise ValueError(f"no mesh on {dev}")
            shards.append(Shard(i, dev, stream, r))
        self.shards: List[Shard] = shards
        self.rank = me
        self.ranks = len(spans)  # the ranks the mesh spans
        self.local_shards: List[int] = [s.index for s in shards if s.rank == me]
        self.places: List[Place] = list(dict.fromkeys(s.place for s in shards))
        self.local_places: List[Place] = [p for p in self.places if p.rank == me]
        if self.ranks > 1 and len(self.local_places) != 1:
            raise ValueError("a mesh over ranks puts each rank's shards on one device")
        # the first shard of each place computes the place's replicated values
        self.lead: Dict[Place, int] = {}
        for s in shards:
            self.lead.setdefault(s.place, s.index)
        self._group = _RANKS if self.ranks > 1 else None
        self.bytes_moved = 0
        self.bytes_sent = 0

    @property
    def size(self) -> int:
        return len(self.shards)

    def __len__(self) -> int:
        return len(self.shards)

    def is_local(self, d: int) -> bool:
        """Whether shard d is this rank's."""
        return self.shards[d].rank == self.rank

    def describe(self) -> str:
        """"4 shards on 1 card", "8 shards on the CPU", "4 shards over 2 ranks
        on 1 card (gloo through the host)"."""
        p = self.size
        what = f"{p} shard{'s' * (p != 1)}"
        cpu = self.places[0].device.type == "cpu"
        if self._group is None:
            c = len(self.places)
            return f"{what} on the CPU" if cpu else f"{what} on {c} card{'s' * (c != 1)}"
        what += f" over {self.ranks} ranks"
        if cpu:
            return f"{what} on the CPU ({self._group.backend})"
        c = len({(self._group.hosts[pl.rank], str(pl.device)) for pl in self.places})
        how = "gloo through the host" if self._group.backend == "gloo" else self._group.backend
        return f"{what} on {c} card{'s' * (c != 1)} ({how})"

    @contextlib.contextmanager
    def on(self, d: int):
        """Run what follows as shard d (one of this rank's): on its device and
        its stream."""
        s = self.shards[d]
        if s.rank != self.rank:
            raise ValueError(f"shard {d} is rank {s.rank}'s, not this rank's ({self.rank})")
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
        """Shard d's stream waits for the work queued so far on each of this
        rank's shards among ``srcs``."""
        mine = self.shards[d].stream
        if mine is None:
            return
        for s in srcs:
            if s != d and self.shards[s].stream is not None:
                mine.wait_stream(self.shards[s].stream)

    def take(self, t: Optional[torch.Tensor], src: int, d: int, count: bool = True,
             like: Optional[Tuple[Sequence[int], torch.dtype]] = None
             ) -> Optional[torch.Tensor]:
        """``t``, made on shard ``src`` (which shard d has waited for), for use
        on shard d: the same tensor on the same device, else a copy made with
        both shards' streams current (the copy runs on src's and d's stream
        waits for it). Counts its bytes in ``bytes_moved`` unless told not to.

        Between ranks it is one transfer, which both ranks call: src's sends
        ``t``, d's receives a tensor of ``like`` (shape, dtype) and returns
        it; any other rank, and the sender, get None."""
        s, o = self.shards[d], self.shards[src]
        if s.rank != o.rank:
            if o.rank == self.rank:
                with self.on(src):
                    self._exchange(src, {s.rank: [t]}, {})
            elif s.rank == self.rank:
                with self.on(d):
                    return self._exchange(d, {}, {o.rank: [like]})[o.rank][0]
            return None
        if count:
            self.bytes_moved += t.numel() * t.element_size()
        if t.device == s.device:
            if s.stream is not None:
                t.record_stream(s.stream)
            return t
        with self.on(d), (torch.cuda.stream(o.stream) if o.stream is not None
                          else contextlib.nullcontext()):
            return t.to(s.device, non_blocking=True)

    def _staged(self, device: torch.device) -> bool:
        """Whether a tensor on ``device`` goes through the host (gloo)."""
        return self._group.backend == "gloo" and device.type == "cuda"

    def _exchange(self, d: int, sends: Dict[int, List[torch.Tensor]],
                  recvs: Dict[int, List[Tuple[Sequence[int], torch.dtype]]]
                  ) -> Dict[int, List[torch.Tensor]]:
        """One batch of transfers between this rank and others, on shard d's
        stream (current): ``sends[r]`` flattened into one message to rank r,
        ``recvs[r]`` the (shape, dtype) of the tensors of rank r's message, in
        its order. Every send and receive is posted at once, then waited for.
        Returns the received tensors by rank, on d's device."""
        dev = self.shards[d].device
        staged = self._staged(dev)
        ops, bufs = [], {}
        for peer in sorted(sends):
            ts = sends[peer]
            if len({t.dtype for t in ts}) != 1:
                raise ValueError("one message carries one type")
            flat = torch.cat([t.reshape(-1) for t in ts])
            wire = flat.to("cpu") if staged else flat
            self.bytes_sent += wire.numel() * wire.element_size()
            ops.append(tdist.P2POp(tdist.isend, wire, peer))
        for peer in sorted(recvs):
            specs = recvs[peer]
            if len({dt for _, dt in specs}) != 1:
                raise ValueError("one message carries one type")
            numel = sum(math.prod(shape) for shape, _ in specs)
            bufs[peer] = torch.empty(numel, dtype=specs[0][1], device="cpu" if staged else dev)
            ops.append(tdist.P2POp(tdist.irecv, bufs[peer], peer))
        if ops:
            for work in tdist.batch_isend_irecv(ops):
                work.wait()
        out = {}
        for peer, specs in recvs.items():
            buf = bufs[peer].to(dev) if staged else bufs[peer]
            parts, at = [], 0
            for shape, _ in specs:
                m = math.prod(shape)
                parts.append(buf[at:at + m].view(tuple(shape)))
                at += m
            out[peer] = parts
        return out

    def _gather(self, t: torch.Tensor, count: bool) -> torch.Tensor:
        """``[ranks, *t.shape]``: every rank's ``t`` (one shape on all), in
        rank order, on t's device, on the current stream; what this rank
        sends counted in ``bytes_sent`` where ``count``."""
        staged = self._staged(t.device)
        wire = t.to("cpu") if staged else t.contiguous()
        out = [torch.empty_like(wire) for _ in range(self.ranks)]
        tdist.all_gather(out, wire)
        if count:
            self.bytes_sent += wire.numel() * wire.element_size() * (self.ranks - 1)
        return torch.stack(out).to(t.device)

    def map(self, fn: Callable, *args) -> list:
        """``[fn(d, *args at d) for each shard d]``, each under :meth:`on`,
        ``None`` for another rank's shard; an argument is a list (indexed by
        shard), a :class:`Replicated` (its copy at d's place) or anything else
        (passed as it is)."""
        out = [None] * self.size
        for d in self.local_shards:
            picked = [a[d] if isinstance(a, list) else a.at(d) if isinstance(a, Replicated)
                      else a for a in args]
            with self.on(d):
                out[d] = fn(d, *picked)
        return out

    def all_to_all(self, send: List[List[Optional[torch.Tensor]]],
                   expect: Optional[List[List[Optional[Tuple[Sequence[int], torch.dtype]]]]]
                   = None) -> List[List[Optional[torch.Tensor]]]:
        """``recv[d][s] = send[s][d]`` moved to shard d (None where nothing
        is sent), for this rank's shards d. A shard's own entry is handed over
        without being counted. ``send[s]`` is given for this rank's shards s;
        ``expect[d][s]``, the (shape, dtype) of what another rank's shard s
        sends shard d, for the others. What this rank sends another goes in
        one message, the pairs (s, d) in order, and every message to and from
        this rank is posted at once."""
        p = self.size
        recv: List[List[Optional[torch.Tensor]]] = [[None] * p for _ in range(p)]
        if self._group is not None:
            if expect is None:
                raise ValueError("all_to_all over ranks needs expect: the shapes this rank "
                                 "receives from the others")
            sends: Dict[int, List[torch.Tensor]] = {}
            recvs: Dict[int, list] = {}
            pairs: Dict[int, List[Tuple[int, int]]] = {}
            for s in self.local_shards:
                for d in range(p):
                    if send[s][d] is not None and not self.is_local(d):
                        sends.setdefault(self.shards[d].rank, []).append(send[s][d])
            for s in range(p):
                if self.is_local(s):
                    continue
                for d in self.local_shards:
                    if expect[d][s] is not None:
                        recvs.setdefault(self.shards[s].rank, []).append(expect[d][s])
                        pairs.setdefault(self.shards[s].rank, []).append((s, d))
            if sends or recvs:
                lead = self.local_shards[0]
                self.wait(lead, self.local_shards)
                with self.on(lead):
                    got = self._exchange(lead, sends, recvs)
                for r, sd in pairs.items():
                    for (s, d), t in zip(sd, got[r]):
                        if d != lead:
                            self.wait(d, [lead])
                            if self.shards[d].stream is not None:
                                t.record_stream(self.shards[d].stream)
                        recv[d][s] = t
        for d in self.local_shards:
            srcs = [s for s in self.local_shards if send[s][d] is not None]
            with self.on(d):
                self.wait(d, srcs)
                for s in srcs:
                    recv[d][s] = self.take(send[s][d], s, d, count=s != d)
        return recv

    def all_gather(self, xs: Sequence[Optional[torch.Tensor]]) -> Replicated:
        """Every shard's tensor concatenated in shard order, once on every
        place (across ranks every shard's tensor has one shape)."""
        return self._replicate(xs, torch.cat)

    def gather(self, xs: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
        """Every shard's tensor concatenated in shard order, at this rank's
        first place only (across ranks, on every rank), its bytes not
        counted."""
        return self._replicate(xs, torch.cat, first_only=True, count=False).first

    def psum(self, xs: Sequence[Optional[torch.Tensor]]) -> Replicated:
        """The sum of the shards' tensors, added in shard order (a left fold,
        no atomics), once on every place."""

        def fold(parts):
            acc = parts[0]
            for t in parts[1:]:
                acc = acc + t
            return acc

        return self._replicate(xs, fold)

    def _per_device(self, fn: Callable, first_only: bool = False) -> Replicated:
        """``fn(place, lead)`` once on every place of this rank (the first
        only where ``first_only``), on the stream of its first shard
        (``lead``), which the place's other shards then wait for."""
        out = {}
        for place in self.local_places[:1] if first_only else self.local_places:
            lead = self.lead[place]
            with self.on(lead):
                out[place] = fn(place, lead)
            for d in self.local_shards:
                if self.shards[d].place == place and d != lead:
                    self.wait(d, [lead])
        return Replicated(self, out)

    def _replicate(self, xs, combine, first_only: bool = False, count: bool = True
                   ) -> Replicated:
        if self._group is None:
            def one(place, lead):
                self.wait(lead, range(self.size))
                return combine([self.take(x, s, lead, count=count) for s, x in enumerate(xs)])

            return self._per_device(one, first_only)

        def across(place, lead):
            # one all-gather of this rank's shards' tensors, stacked, and the fold
            # over every shard's in shard order, as on one process
            mine = self.local_shards
            self.wait(lead, mine)
            if count:
                self.bytes_moved += sum(xs[d].numel() * xs[d].element_size() for d in mine)
            every = self._gather(torch.stack([xs[d] for d in mine]), count)
            return combine([t for part in every for t in part.unbind(0)])

        return self._per_device(across)

    def each_device(self, fn: Callable, *reps: Replicated) -> Replicated:
        """``fn`` of replicated values, computed once on every place."""
        return self._per_device(lambda place, lead: fn(*[r.values[place] for r in reps]))

    def synchronize(self) -> None:
        """The host waits for this rank's cards of the mesh."""
        for place in self.local_places:
            if place.device.type == "cuda":
                torch.cuda.synchronize(place.device)

    def test(self, fn: Callable, *reps: Replicated) -> bool:
        """A convergence test: ``bool(fn(...))`` of replicated values at this
        rank's first place, the one wait of the host. Every rank holds the
        same bits, so every rank takes the same branch."""
        with self.on(self.lead[self.local_places[0]]):
            return bool(fn(*[r.first for r in reps]))

    def dot(self, u: List[torch.Tensor], v: List[torch.Tensor]) -> Replicated:
        """The fp32 dot product of two sharded vectors: a dot a shard, then
        :meth:`psum`."""
        return self.psum(self.map(lambda d, a, b: torch.dot(a.float(), b.float()), u, v))

    def rank_values(self, values) -> np.ndarray:
        """``values`` (an fp64 host array of one shape on every rank) of every
        rank the mesh spans, stacked in rank order: a report's counts are
        summed from it."""
        v = torch.from_numpy(np.array(values, np.float64, ndmin=1))
        if self._group is None:
            return v.numpy()[None]
        place = self.local_places[0]
        with self.on(self.lead[place]):
            return self._gather(v.to(place.device) if self._group.backend == "nccl"
                                else v, False).cpu().numpy()

    def check_plan(self, what: str, *parts) -> None:
        """Raise unless every rank built the same host plan: ``parts``
        (arrays, lists of them, numbers, strings) hashed on each rank and the
        digests compared. Ranks that differ would wait on transfers that
        never come, or take the wrong bytes."""
        if self._group is None:
            return
        h = hashlib.sha256()
        _digest(h, list(parts))
        got = self.rank_values(np.frombuffer(h.digest(), np.uint8))
        if not (got == got[0]).all():
            raise RuntimeError(f"{what}: the ranks built different plans (their digests "
                               "differ); every rank must pass the same matrix and arguments")


def make_mesh(n_devices: Optional[int] = None,
              device: Optional[Union[str, torch.device]] = None) -> Mesh:
    """A mesh of ``n_devices`` shards on ``device``.

    In a process group (:func:`init_distributed`) the shards are spread over
    its ranks, ``n_devices / ranks`` a rank (by default one), each rank's on
    its own device; ``device``, where given, must be of the rank's kind.
    Otherwise ``"cuda"`` (the default) puts the shards on the cards
    round-robin (by default one a card); ``"cuda:k"`` puts them all on card
    k; ``"cpu"`` on the host (by default one). A mesh on a card raises when
    there is none: it never falls back to the CPU."""
    g = _RANKS
    if g is not None:
        if device is not None:
            want = torch.device(device)
            if want.type != g.device.type or (want.index is not None and want != g.device):
                raise ValueError(f"make_mesh: this rank runs on {g.device}, not {want}")
        n = g.world if n_devices is None else int(n_devices)
        if n < 1 or n % g.world:
            raise ValueError(f"make_mesh: {n} shards do not split evenly over {g.world} ranks")
        ranks = [d // (n // g.world) for d in range(n)]
        return Mesh([g.devices[r] for r in ranks], ranks)
    device = torch.device("cuda" if device is None else device)
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
        acc = self.policy.accum_dtype
        mesh.check_plan("DistSpmv", self.policy.name, n_loc, self.plan.requests)
        # what shard d receives from shard s, known to d from the plan
        self._expect = [[((r.size,), acc) if r.size else None for r in row]
                        for row in self.plan.requests]
        self._shards: List[Optional[_ShardSpmv]] = [None] * p
        mesh.fork()
        for d in mesh.local_shards:
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
            self._shards[d] = _ShardSpmv(interior, boundary, bnd_rows, idx, off)
        mesh.join()

    @property
    def exchange_bytes(self) -> int:
        """Bytes of x one call moves between shards."""
        return self.plan.exchange_entries * torch.finfo(self.policy.accum_dtype).bits // 8

    def shard_vector(self, x) -> List[Optional[torch.Tensor]]:
        """A host vector (length n) split into the shards' padded pieces of
        the policy's x type, each on its shard's device (this rank's
        shards; None for the others)."""
        xp = np.zeros(self.plan.ndev * self.plan.n_loc, np.float64)
        xp[:self.n] = np.asarray(x, np.float64)
        n_loc = self.plan.n_loc
        acc = self.policy.accum_dtype
        return self.mesh.map(lambda d: torch.from_numpy(xp[d * n_loc:(d + 1) * n_loc]).to(
            self.mesh.shards[d].device).to(acc))

    def unshard(self, y: Sequence[Optional[torch.Tensor]]) -> np.ndarray:
        """The host vector of a sharded one, gathered: the whole of it on
        every rank."""
        full = self.mesh.gather(y)
        self.mesh.join()
        return full.detach().to("cpu", torch.float64).numpy()[:self.n]

    def __call__(self, xs: List[Optional[torch.Tensor]]) -> List[Optional[torch.Tensor]]:
        mesh, p = self.mesh, self.mesh.size
        mesh.fork()
        ys: List[Optional[torch.Tensor]] = [None] * p
        send: List[List[Optional[torch.Tensor]]] = [[None] * p for _ in range(p)]
        for s in mesh.local_shards:
            sh = self._shards[s]
            with mesh.on(s):
                sent = xs[s].index_select(0, sh.send_idx) if sh.send_idx is not None else None
                ys[s] = spmv(sh.interior, xs[s])
            for d in range(p):
                if sh.send_off[d + 1] > sh.send_off[d]:  # a shard sends itself nothing
                    send[s][d] = sent[sh.send_off[d]:sh.send_off[d + 1]]
        recv = mesh.all_to_all(send, self._expect)
        for d in mesh.local_shards:
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
        mesh.check_plan("BlockJacobiIlu", n_loc, plan.ndev, sweeps, apply_sweeps)
        self._shards: List[Optional[_ShardIlu]] = [None] * plan.ndev
        mesh.fork()
        for d in mesh.local_shards:
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
                self._shards[d] = _ShardIlu(
                    to_device(L, "fp32", dev, fmt="csr") if L.nnz else None,
                    to_device(strict_u, "fp32", dev, fmt="csr") if strict_u.nnz else None,
                    torch.from_numpy(dinv.astype(np.float32)).to(dev))
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
        """Host-vector convenience wrapper around :meth:`apply` (the whole
        of M^-1 r on every rank)."""
        n_loc = self.n_loc
        rp = np.zeros(self.mesh.size * n_loc)
        rp[:r.size] = r
        rs = self.mesh.map(lambda d: torch.from_numpy(rp[d * n_loc:(d + 1) * n_loc]).float().to(
            self.mesh.shards[d].device))
        full = self.mesh.gather(self.apply(rs))
        self.mesh.join()
        return full.to("cpu", torch.float64).numpy()[:r.size]


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
