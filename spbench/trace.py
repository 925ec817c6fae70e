"""The traced window: spans of the benchmark's own around the program's
public calls, ``torch.profiler``'s device records, and what is read from them.

Device busy time is the union of the device's kernel, copy and memset
records, whatever their names; busy time inside a span is that union cut to
the span. The profiler records the device's activity and the CUDA runtime
calls only, not every host op, so that it slows the host-paced loops it
watches as little as it can. Spans (``solve``) and the window's
ends are taken on the host by ``time.time_ns()``, the clock the profiler's
records are given in. The raw records are read from the profiler's result
list, without building its per-op tree, so that a window of a million
kernels stays readable in seconds.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["Trace", "Spans", "span", "Tracer"]

_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Host spans by kind, on ``time.time_ns()``."""

    def __init__(self):
        self.by_kind: Dict[str, List[Tuple[float, float]]] = {}

    @contextlib.contextmanager
    def __call__(self, kind: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.by_kind.setdefault(kind, []).append((float(t0), float(time.time_ns())))


def span(kind: str, spans: Optional[Spans]):
    """A span around one call into the program (a no-op when not tracing)."""
    return contextlib.nullcontext() if spans is None else spans(kind)


def _union(starts: np.ndarray, ends: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Disjoint sorted intervals covering the given ones."""
    if starts.size == 0:
        return starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    new = np.empty(s.size, dtype=bool)
    new[0] = True
    new[1:] = s[1:] > reach[:-1]
    idx = np.flatnonzero(new)
    us = s[idx]
    ue = np.append(reach[idx[1:] - 1], reach[-1])
    return us, ue


def _overlap(us: np.ndarray, ue: np.ndarray, t0: float, t1: float) -> float:
    """Length of the union (us, ue) inside [t0, t1]."""
    lo = np.searchsorted(ue, t0, side="right")
    hi = np.searchsorted(us, t1, side="left")
    if hi <= lo:
        return 0.0
    s = np.maximum(us[lo:hi], t0)
    e = np.minimum(ue[lo:hi], t1)
    return float(np.clip(e - s, 0, None).sum())


class Trace:
    """What one traced window holds, on the trace's clock (ns)."""

    def __init__(self, dev_start, dev_end, dev_names, spans, host_ops, window):
        self.dev_start = np.asarray(dev_start, np.float64)
        self.dev_end = np.asarray(dev_end, np.float64)
        self.dev_names = list(dev_names)
        self.spans = spans                      # kind -> list of (start, end)
        self.host_ops = host_ops                # (starts sorted, names) of host ops
        self.t0, self.t1 = window
        self.us, self.ue = _union(self.dev_start, self.dev_end)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    @property
    def busy_s(self) -> float:
        return _overlap(self.us, self.ue, self.t0, self.t1) * 1e-9

    def busy_in(self, kind: str) -> Optional[float]:
        """Device busy seconds inside the spans of ``kind``; None without one."""
        spans = self.spans.get(kind) or []
        if not spans:
            return None
        return sum(_overlap(self.us, self.ue, s, e) for s, e in spans) * 1e-9

    def span_seconds(self, kind: str) -> List[float]:
        return [(e - s) * 1e-9 for s, e in self.spans.get(kind) or []]

    def device_ops(self, top: int = 10) -> List[List]:
        """The device operations that took the most time, by name."""
        tot: Dict[str, float] = {}
        for name, s, e in zip(self.dev_names, self.dev_start, self.dev_end):
            key = name.replace("(anonymous namespace)::", "").split("(")[0][:96]
            tot[key] = tot.get(key, 0.0) + (e - s) * 1e-9
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """The device's idle time inside the window, summed by what the host
        was doing as each gap began: the span it lay in and the last host op
        that had started."""
        us, ue = self.us, self.ue
        keep = (ue > self.t0) & (us < self.t1)
        us, ue = us[keep], ue[keep]
        g0 = np.concatenate([[self.t0], ue])
        g1 = np.concatenate([us, [self.t1]])
        g0 = np.maximum(g0, self.t0)
        g1 = np.minimum(g1, self.t1)
        ok = g1 > g0
        g0, g1 = g0[ok], g1[ok]
        starts, names = self.host_ops
        at = np.searchsorted(starts, g0, side="right") - 1
        span_bounds = sorted((s, e, k) for k, v in self.spans.items() for s, e in v)
        sb0 = np.array([s for s, _, _ in span_bounds]) if span_bounds else np.zeros(0)
        si = np.searchsorted(sb0, g0, side="right") - 1
        tot: Dict[str, float] = {}
        for i in range(g0.size):
            kind = "outside spans"
            if si[i] >= 0 and g0[i] < span_bounds[si[i]][1]:
                kind = span_bounds[si[i]][2]
            op = names[at[i]] if at[i] >= 0 else "none"
            key = f"{kind}: {op}"
            tot[key] = tot.get(key, 0.0) + (g1[i] - g0[i]) * 1e-9
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


class Tracer:
    """Profiles a window of the run: ``with tracer: ...`` then ``tracer.trace``;
    ``tracer.spans`` takes the spans. Without a card it records host ops."""

    def __init__(self, cuda: bool = True):
        self.trace: Optional[Trace] = None
        self.spans = Spans()
        self.cuda = cuda
        self._prof = None

    def _sync(self):
        if self.cuda:
            import torch
            torch.cuda.synchronize()

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self._sync()
        acts = [ProfilerActivity.CUDA] if self.cuda else [ProfilerActivity.CPU]
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = float(time.time_ns())
        return self

    def __exit__(self, *exc):
        self._sync()
        t1 = float(time.time_ns())
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.trace = read_profile(self._prof, self.spans.by_kind, (self._t0, t1))
        return False


def _ns(e, which: str) -> float:
    """An event's start or end in ns (``*_us`` where a torch has no ``*_ns``)."""
    fn = getattr(e, f"{which}_ns", None)
    if fn is not None:
        return float(fn())
    return float(getattr(e, f"{which}_us")()) * 1e3


def read_profile(prof, spans, window) -> Trace:
    """A :class:`Trace` from a finished ``torch.profiler.profile``: device
    records, and the host's records (runtime calls, or ops without a card)."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    dev_s, dev_e, dev_n = [], [], []
    host_s, host_n = [], []
    for e in events:
        # a torch without activity types (2.11, on the card) gives none: the device records
        # are then all kernels, copies and memsets (no annotation is recorded)
        kind = e.activity_type() if hasattr(e, "activity_type") else ""
        if e.device_type() == DeviceType.CUDA:
            if kind in _DEVICE_KINDS or not kind:
                dev_s.append(_ns(e, "start"))
                dev_e.append(_ns(e, "end"))
                dev_n.append(e.name())
        else:
            host_s.append(_ns(e, "start"))
            host_n.append(e.name())
    order = np.argsort(np.asarray(host_s, np.float64), kind="stable")
    host = (np.asarray(host_s, np.float64)[order], [host_n[i] for i in order])
    return Trace(dev_s, dev_e, dev_n, {k: sorted(v) for k, v in spans.items()}, host, window)
