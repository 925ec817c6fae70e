"""The program's own spans and counters in the traced window, and what is
read from them.

``ProgramTracer`` is :class:`~spbench.trace.Tracer` with the program's
recording (``respatpu_torch.timing.recording()``) opened and closed with the
profiler; its trace, a :class:`ProgramTrace`, keeps what the recording holds
as ``program`` and names each stretch of the device's idle time by the
innermost program span over it. The spans are on ``time.time_ns()``, the
clock of the profiler's records and of the benchmark's own spans. Untraced
runs open no recording.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from .trace import Trace, Tracer, _overlap, _union

__all__ = ["ProgramTrace", "ProgramTracer", "ms_per_request", "count_per_request",
           "launches_per_request"]


def _paths(rec) -> List[str]:
    """Each span's name after its ancestors', ``/`` between them."""
    out: List[str] = []
    for name, parent in zip(rec.names, rec.parents):  # a parent begins before its children
        out.append(name if parent < 0 else f"{out[parent]}/{name}")
    return out


def _innermost(rec) -> Tuple[np.ndarray, np.ndarray]:
    """``(bounds, owners)``: from ``bounds[k]`` to the next bound the
    innermost open span is ``owners[k]`` (-1: none). Spans are numbered as
    they begin and nest, so one walk with a stack flattens them."""
    bounds: List[float] = []
    owners: List[int] = []
    stack: List[int] = []

    def close(parent: int) -> None:
        while stack and stack[-1] != parent:
            j = stack.pop()
            bounds.append(float(rec.ends[j]) if rec.ends[j] >= 0 else np.inf)
            owners.append(stack[-1] if stack else -1)

    for i, (start, parent) in enumerate(zip(rec.starts, rec.parents)):
        close(parent)
        bounds.append(float(start))
        owners.append(i)
        stack.append(i)
    close(-1)
    return np.asarray(bounds, np.float64), np.asarray(owners, np.int64)


class ProgramTrace(Trace):
    """A :class:`Trace` with the program's recording as ``program``."""

    program = None

    @classmethod
    def of(cls, trace: Trace, program) -> "ProgramTrace":
        new = cls.__new__(cls)
        new.__dict__.update(vars(trace))
        new.program = program
        return new

    def _gaps(self) -> Tuple[np.ndarray, np.ndarray]:
        """Starts and ends of the device's idle gaps inside the window."""
        keep = (self.ue > self.t0) & (self.us < self.t1)
        us, ue = self.us[keep], self.ue[keep]
        g0 = np.maximum(np.concatenate([[self.t0], ue]), self.t0)
        g1 = np.minimum(np.concatenate([us, [self.t1]]), self.t1)
        ok = g1 > g0
        return g0[ok], g1[ok]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """:meth:`Trace.idle_gaps`, each gap cut where a program span begins
        or ends and each piece named by the innermost program span over it:
        the benchmark's span that held the gap's start, the program span's
        path, and the last runtime call before the gap
        (``solve/solve_refined/upload/layout: cudaMemcpyAsync``); a piece
        under no program span keeps the gap's label. Summed by the part
        before the first ``/`` or ``:``, the idle time is the base class's."""
        rec = self.program
        if rec is None:
            return super().idle_gaps(top)
        g0, g1 = self._gaps()
        starts, names = self.host_ops
        at = np.searchsorted(starts, g0, side="right") - 1
        span_bounds = sorted((s, e, k) for k, v in self.spans.items() for s, e in v)
        sb0 = np.array([s for s, _, _ in span_bounds]) if span_bounds else np.zeros(0)
        si = np.searchsorted(sb0, g0, side="right") - 1
        bounds, owners = _innermost(rec)
        lo = np.searchsorted(bounds, g0, side="right")
        hi = np.searchsorted(bounds, g1, side="left")
        paths = _paths(rec)
        tot: Dict[str, float] = {}
        for i in range(g0.size):
            kind = "outside spans"
            if si[i] >= 0 and g0[i] < span_bounds[si[i]][1]:
                kind = span_bounds[si[i]][2]
            op = names[at[i]] if at[i] >= 0 else "none"
            # pieces: g0 to the first bound inside the gap, bound to bound, the last to g1;
            # the piece from bound j has owner j (the one before the gap for the first)
            cuts = [g0[i], *bounds[lo[i]:hi[i]], g1[i]]
            for k, j in enumerate(range(lo[i] - 1, hi[i])):
                if cuts[k + 1] <= cuts[k]:
                    continue
                owner = owners[j] if j >= 0 else -1
                key = f"{kind}/{paths[owner]}: {op}" if owner >= 0 else f"{kind}: {op}"
                tot[key] = tot.get(key, 0.0) + (cuts[k + 1] - cuts[k]) * 1e-9
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_unattributed(self) -> Optional[float]:
        """The share (%) of the window's device idle time, by overlap, that
        lies under no program span below a top-level one (``solve_refined``);
        None without device records, a recording or idle time."""
        rec = self.program
        if rec is None or not self.dev_names:
            return None
        idle = (self.t1 - self.t0) - self.busy_s * 1e9
        if idle <= 0:
            return None
        below = [i for i, p in enumerate(rec.parents) if p >= 0]
        ps, pe = _union(np.asarray([rec.starts[i] for i in below], np.float64),
                        np.asarray([rec.ends[i] for i in below], np.float64))
        ps, pe = np.maximum(ps, self.t0), np.minimum(pe, self.t1)
        ok = pe > ps
        ps, pe = ps[ok], pe[ok]
        under = float((pe - ps).sum()) - sum(_overlap(self.us, self.ue, s, e)
                                             for s, e in zip(ps, pe))
        return 100.0 * (idle - under) / idle


class ProgramTracer(Tracer):
    """:class:`Tracer` with the program's recording open over the window;
    its ``trace`` is a :class:`ProgramTrace`."""

    def __enter__(self):
        # imported here, so that the readers that import this module load, and
        # read nothing, on a program without the recorder
        from respatpu_torch.timing import recording
        with contextlib.ExitStack() as stack:
            self._program = stack.enter_context(recording())
            super().__enter__()
            stack.push(super().__exit__)
            self._open = stack.pop_all()    # a failed start leaves nothing open
        return self

    def __exit__(self, *exc):
        self._open.__exit__(*exc)           # the profiler, then the recording
        if self.trace is not None:
            self.trace = ProgramTrace.of(self.trace, self._program)
        return False


def _program(ctx):
    rec = getattr(ctx.trace, "program", None)
    return rec if rec is not None and ctx.steps else None


def ms_per_request(ctx, name: str) -> Optional[float]:
    """Milliseconds of the program's spans named ``name`` over the window's
    requests; None without a recording."""
    rec = _program(ctx)
    if rec is None:
        return None
    ns = sum(e - s for n, s, e in zip(rec.names, rec.starts, rec.ends) if n == name)
    return ns * 1e-6 / len(ctx.steps)


def count_per_request(ctx, name: str) -> Optional[float]:
    """The program's counter ``name`` over the window's requests; None
    without a recording."""
    rec = _program(ctx)
    if rec is None:
        return None
    return rec.counts.get(name, 0) / len(ctx.steps)


def launches_per_request(ctx) -> Optional[float]:
    """The port's kernel launches (each kernel module's ``LAUNCHES``, raised
    over the recording) over the window's requests; None without a
    recording."""
    rec = _program(ctx)
    if rec is None:
        return None
    return sum(rec.launches.values()) / len(ctx.steps)
