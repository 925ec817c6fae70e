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
from typing import Callable, List, Union

import torch

__all__ = ["OpTiming", "time_op", "stream_bandwidth", "check_plausible",
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
