"""Carry respatpu's host state and results into the port, so that the tests
can run both packages on the same inputs. Nothing here imports JAX: inputs are
read through their numpy views.
"""
from __future__ import annotations

import numpy as np

from .formats import CSRMatrix

__all__ = ["csr_from_respatpu", "df_to_numpy"]


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
