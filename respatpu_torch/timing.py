"""Timing on the device, the CSR byte model, and a plausibility gate.

``time_op`` times each repetition with CUDA events around the op alone and
reports the median. Before each repetition, outside the event window, it
writes a scratch tensor several times the size of the card's L2 (50 MB on an
H100), so every repetition finds its operands in device memory, as a caller
that does other work between SpMVs would (the reference flushes its LLC
the same way, test_pardiso.c:29-38). On the CPU the same protocol runs with
the host clock and no flush.

The gate (``check_plausible``) raises when a time is below the least time
the op's bytes can take at the measured copy bandwidth. It never clamps a
time to a floor: respatpu's ``timing.py:116`` did, and reported 0.0 us/op
(ROADMAP R1).
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, List, Sequence, Tuple, Union

import torch

__all__ = ["OpTiming", "time_op", "stream_bandwidth", "device_bandwidth", "device_events",
           "kernel_times", "ProfilerUnavailable", "check_plausible",
           "spmv_csr_sol_bytes", "ImplausibleTiming"]

_FLUSH_BYTES = 256 << 20  # >= 5x the H100's 50 MB L2
_STREAM_BYTES = {"cuda": 1 << 30, "cpu": 1 << 26}
_GATE_SLACK = 1.05


class ImplausibleTiming(RuntimeError):
    """A measured time is faster than the op's bytes allow."""


@dataclasses.dataclass
class OpTiming:
    """Per-repetition seconds of one op, and what the gate held them to."""

    times: List[float]
    floor_s: float = 0.0  # least plausible time; 0 until checked

    @property
    def median(self) -> float:
        return statistics.median(self.times)

    @property
    def min(self) -> float:
        return min(self.times)

    @property
    def std(self) -> float:
        return statistics.pstdev(self.times)


def time_op(fn: Callable[[], object], device: Union[str, torch.device],
            warmup: int = 3, reps: int = 10) -> OpTiming:
    """Seconds per call of ``fn`` on ``device``, one sample per repetition."""
    device = torch.device(device)
    for _ in range(warmup):
        fn()
    times = []
    if device.type == "cuda":
        scratch = torch.empty(_FLUSH_BYTES // 4, dtype=torch.float32, device=device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for i in range(reps):
            scratch.fill_(float(i))  # evicts the op's operands from L2
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e-3)
        del scratch
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return OpTiming(times)


def stream_bandwidth(device: Union[str, torch.device], reps: int = 5) -> float:
    """Bytes/s of the best of ``reps`` device-to-device copies (1 GiB on a
    card, 64 MiB on the host), counting each byte read and written."""
    device = torch.device(device)
    nbytes = _STREAM_BYTES["cuda" if device.type == "cuda" else "cpu"]
    src = torch.ones(nbytes // 4, dtype=torch.float32, device=device)
    dst = torch.empty_like(src)
    t = time_op(lambda: dst.copy_(src), device, warmup=1, reps=reps)
    return 2 * nbytes / t.min


class ProfilerUnavailable(RuntimeError):
    """``torch.profiler`` gave no complete trace of the device, even when
    asked again."""


def device_events(fn: Callable[[], object],
                  complete: Callable[[List[Tuple[str, float]]], bool] = bool,
                  attempts: int = 3) -> List[Tuple[str, float]]:
    """Run ``fn`` under ``torch.profiler`` and return ``(name, seconds)`` of
    every kernel, copy and memset the card ran for it, in the order they
    started. A trace that is not ``complete`` (by default: one that holds no
    device activity; the tracer now and then drops records after many traces
    in one process) is taken again, ``fn`` included; after ``attempts`` such
    traces this raises :class:`ProfilerUnavailable`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out = sorted((e.time_range.start, e.name, e.time_range.elapsed_us() * 1e-6)
                     for e in prof.events() if e.device_type == DeviceType.CUDA)
        out = [(name, t) for _, name, t in out]
        if complete(out):
            return out
    raise ProfilerUnavailable(f"torch.profiler gave no complete trace in {attempts} runs")


def kernel_times(fns: Sequence[Callable[[], object]], name_part: str,
                 reps: int = 10, flush: str = "write") -> List[List[float]]:
    """For each of ``fns``, the seconds of each of the ``reps`` kernels whose
    name holds ``name_part``, one launched by each call with a cold L2, read
    from one profiler trace of all of them and so free of the event window's
    own few microseconds.

    ``flush="write"`` evicts as :func:`time_op` does, by writing the scratch
    tensor, which leaves the L2 full of modified lines that the kernel's
    reads must first push out to device memory. ``flush="read"`` sums the
    scratch tensor instead and leaves unmodified lines that cost nothing to
    evict."""
    if flush not in ("write", "read"):
        raise ValueError(f"flush must be 'write' or 'read', got {flush!r}")
    scratch = torch.zeros(_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    for fn in fns:
        fn()

    def run():
        for fn in fns:
            for i in range(reps):
                if flush == "write":
                    scratch.fill_(float(i))
                else:
                    scratch.sum()
                fn()

    def ours(events):
        return [t for name, t in events if name_part in name]

    times = ours(device_events(run, lambda ev: len(ours(ev)) == reps * len(fns)))
    return [times[i * reps:(i + 1) * reps] for i in range(len(fns))]


_bandwidth = {}  # device -> bytes/s, measured once per process


def device_bandwidth(device: Union[str, torch.device]) -> float:
    """:func:`stream_bandwidth` of ``device``, measured at the first call for
    that device and reused after it: the probe copies 1 GiB several times,
    far more device time than the SpMVs it gates."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _bandwidth:
        _bandwidth[device] = stream_bandwidth(device)
    return _bandwidth[device]


def check_plausible(t: OpTiming, nbytes: int, bandwidth: float) -> OpTiming:
    """Raise if any repetition of ``t`` moved ``nbytes`` faster than
    ``bandwidth`` (with 5% slack) allows; record the floor on ``t``."""
    floor = nbytes / (_GATE_SLACK * bandwidth)
    if t.min < floor:
        raise ImplausibleTiming(
            f"measured {t.min * 1e6:.3f} us for {nbytes} bytes, below the "
            f"{floor * 1e6:.3f} us that {bandwidth / 1e9:.1f} GB/s allows")
    t.floor_s = floor
    return t


def spmv_csr_sol_bytes(m: int, n: int, nnz: int, value_bytes: int,
                       vec_bytes: int) -> int:
    """Least bytes one CSR SpMV moves: int64 row pointer, int32 column
    indices, the values, x read once and y written once."""
    return (m + 1) * 8 + nnz * 4 + nnz * value_bytes + n * vec_bytes + m * vec_bytes
