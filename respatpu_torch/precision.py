"""Precision policies: fp32, fp32 with flush-to-zero, bf16 values, and fp64.

The reference switches precision at compile time via ``#define FLOAT``
(test_pardiso.c:16, GPU/spmv.cu:11) and toggles subnormal flush-to-zero with
MXCSR inline asm (test_pardiso.c:19-24) or ``nvcc -ftz=true``
(GPU/Makefile:4-5). Here precision is a runtime policy object, as in
``respatpu.precision``.

The card has native fp64, so the high-precision policy is plain
``torch.float64``; ``df64`` (respatpu's double-float emulation) is accepted as
an alias of it. The kernels are built with ``-ftz=false`` (nvcc's default), so
``fp32_ftz`` flushes explicitly: values at upload (``Policy.cast_host``), and
x, each product and each partial sum inside the kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

__all__ = ["ftz", "Policy", "FP32", "FP32_FTZ", "BF16", "FP64", "get_policy",
           "downcast_check", "FP32_MAX", "FP32_MIN_NORMAL"]

FP32_MAX = float(np.finfo(np.float32).max)  # LAPACKE_slamch('O'), test_spmv.c:109
FP32_MIN_NORMAL = float(np.finfo(np.float32).tiny)


def ftz(x: torch.Tensor, enabled: bool = True) -> torch.Tensor:
    """Explicit subnormal flush-to-zero (MXCSR FTZ|DAZ equivalent,
    test_pardiso.c:19-24). Entries with |x| below the dtype's smallest
    normal become +0. No-op when disabled."""
    if not enabled:
        return x
    tiny = torch.finfo(x.dtype).tiny
    return torch.where(x.abs() < tiny, torch.zeros_like(x), x)


@dataclasses.dataclass(frozen=True)
class Policy:
    """Runtime precision policy.

    ``dtype`` is the stored value type. x, the accumulator and y share
    ``accum_dtype``: fp64 under the fp64 policy, fp32 under every other one
    (bf16 keeps only the values in bf16, as respatpu's GSELL kernel does,
    gsell.py:580,674)."""

    name: str
    dtype: torch.dtype
    flush_to_zero: bool = False

    @property
    def accum_dtype(self) -> torch.dtype:
        return torch.float64 if self.dtype == torch.float64 else torch.float32

    def cast_host(self, v: np.ndarray) -> torch.Tensor:
        """Host fp64 values -> host tensor of this policy's value type.

        bf16 rounds through fp32 (fp64 -> fp32 -> bf16), as respatpu's
        ``gsell_to_device`` does, so both packages store the same bits."""
        v = np.asarray(v)
        if self.dtype == torch.float64:
            return torch.from_numpy(np.ascontiguousarray(v, dtype=np.float64))
        out = np.ascontiguousarray(v, dtype=np.float32)
        if self.flush_to_zero:
            out = np.where(np.abs(out) < FP32_MIN_NORMAL, np.float32(0), out)
        t = torch.from_numpy(out)
        return t.to(self.dtype) if self.dtype != torch.float32 else t


FP32 = Policy("fp32", torch.float32)
FP32_FTZ = Policy("fp32_ftz", torch.float32, flush_to_zero=True)
BF16 = Policy("bf16", torch.bfloat16)
FP64 = Policy("fp64", torch.float64)

_POLICIES = {p.name: p for p in (FP32, FP32_FTZ, BF16, FP64)}
_POLICIES["df64"] = FP64  # alias: respatpu's emulated fp64 is native here


def get_policy(name: Union[str, Policy]) -> Policy:
    if isinstance(name, Policy):
        return name
    try:
        return _POLICIES[name.lower()]
    except KeyError:
        raise ValueError(f"unknown precision policy {name!r}; "
                         f"available: {sorted(_POLICIES)}") from None


def downcast_check(values: np.ndarray, dtype=np.float32):
    """Overflow-guarded downcast (host), the corrected version of
    test_spmv.c:109-145 (which checks A's values where it means x).

    Returns (cast_array, n_overflow). Overflowing magnitudes are clamped to
    +-max_finite and counted, matching the reference's guard intent."""
    v = np.asarray(values, dtype=np.float64)
    fmax = np.finfo(dtype).max
    over = np.abs(v) > fmax
    n_over = int(over.sum())
    out = np.clip(v, -fmax, fmax).astype(dtype)
    return out, n_over
