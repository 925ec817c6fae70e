"""Carry respatpu's host state and results into the port, so that the tests
can run both packages on the same inputs. Nothing here imports JAX: inputs are
read through their numpy views.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from .formats import CSRMatrix
from .kernels.bandlu import DeviceBand
from .precision import get_policy

__all__ = ["csr_from_respatpu", "df_to_numpy", "band_from_respatpu",
           "band_to_numpy"]


def csr_from_respatpu(obj) -> CSRMatrix:
    """The port's CSR from anything shaped like ``respatpu.formats.CSRMatrix``
    (``shape``, ``indptr``, ``indices``, ``data``)."""
    return CSRMatrix(shape=(int(obj.shape[0]), int(obj.shape[1])),
                     indptr=np.ascontiguousarray(obj.indptr, np.int64),
                     indices=np.ascontiguousarray(obj.indices, np.int32),
                     data=np.ascontiguousarray(obj.data, np.float64))


def df_to_numpy(hi, lo) -> np.ndarray:
    """A respatpu double-float pair (``DF(hi, lo)``) as float64."""
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


def band_from_respatpu(obj, device: Union[str, torch.device] = "cpu") -> DeviceBand:
    """The port's band from anything shaped like respatpu's ``DeviceBand``
    (``n``, ``p``, ``ml``, ``mu``, ``policy_name`` and ``data``, a tuple of
    arrays: one in the policy's type, or the double-float ``(hi, lo)``,
    which becomes fp64 by ``hi + lo``). A band factored by respatpu can then
    be solved by the port."""
    policy = get_policy(obj.policy_name)
    if len(obj.data) == 2:
        data = torch.from_numpy(df_to_numpy(*obj.data))
    else:
        # through fp32: numpy has no bfloat16, and every stored type widens exactly
        data = torch.from_numpy(np.asarray(obj.data[0], np.float32).copy())
    return DeviceBand(n=int(obj.n), p=int(obj.p), ml=int(obj.ml), mu=int(obj.mu),
                      policy=policy,
                      data=data.to(policy.dtype).contiguous().to(torch.device(device)))


def band_to_numpy(band: DeviceBand):
    """The arrays respatpu's ``DeviceBand.data`` would hold for this band:
    one array in the band's type (fp32 for bf16: the caller rounds), or for
    fp64 the ``(hi, lo)`` fp32 pair."""
    data = band.data.detach().cpu()
    if data.dtype == torch.float64:
        full = data.numpy()
        hi = full.astype(np.float32)
        return hi, (full - hi.astype(np.float64)).astype(np.float32)
    return (data.float().numpy(),)
