"""Distributed SpMV at several shard counts; the counterpart of
``respatpu/bench/scaling.py`` (BASELINE.md: nnz/s at 1 chip, 1 host, N >= 2
hosts; the MUMPS-scaling slot of the reference protocol).

    python -m respatpu_torch scaling offshore --shards 1 2 4

A row is one shard count: the mesh (``dist.make_mesh``: the shards on the
cards round-robin), the halo, the bytes one product exchanges between shards,
and the seconds of one distributed product, a mean over ``reps`` products
ended by a device synchronize. respatpu's row keys are kept; it times a host
round trip a product, which the TPU's dispatch cache forced on it, and skips
the counts it has no devices for. Here a count above the cards runs, with
several shards a card, and its row says so: ``cards``, ``shards_per_card``,
and ``scaling_result`` false. Such a row times the distributed path on
shared cards (its exchanges and its per-shard launches), not a scaling.
It builds one-process meshes, and refuses to run in a process group.
"""
from __future__ import annotations

import json
import time
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from .. import dist
from . import corpus

__all__ = ["measure_scaling"]


def measure_scaling(name: str = "atmosmodd", device_counts: Sequence[int] = (1, 2, 4, 8),
                    max_synth_nnz: Optional[int] = 2_000_000, reps: int = 5,
                    verbose: bool = True, device: Union[str, torch.device] = "cuda"
                    ) -> List[dict]:
    if dist.process_count() > 1:
        raise RuntimeError("measure_scaling builds one-process meshes of several sizes; run it "
                           "outside a process group")
    a, synth = corpus.load_matrix(name, max_synth_nnz=max_synth_nnz)
    x = np.random.default_rng(0).standard_normal(a.shape[1])
    out = []
    for nd in device_counts:
        mesh = dist.make_mesh(nd, device)
        op = dist.DistSpmv(a, mesh)
        xs = op.shard_vector(x)
        op(xs)
        mesh.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            op(xs)
        mesh.synchronize()
        dt = (time.perf_counter() - t0) / reps
        cards = len(mesh.places)
        first = mesh.places[0].device
        kind = torch.cuda.get_device_name(first) if first.type == "cuda" else "cpu"
        row = dict(matrix=name, synthetic=synth, n=a.shape[0], nnz=a.nnz, devices=nd,
                   halo=op.plan.halo, t_spmv_s=round(dt, 6),
                   gnnz_per_s=round(a.nnz / dt / 1e9, 4), card=kind, cards=cards,
                   shards_per_card=-(-nd // cards), scaling_result=nd <= cards,
                   exchange_bytes=op.exchange_bytes, mesh=mesh.describe())
        out.append(row)
        if verbose:
            print(f"[scaling] {name} {mesh.describe()}: {dt * 1e3:.3f} ms "
                  f"({row['gnnz_per_s']} Gnnz/s, halo={op.plan.halo}, "
                  f"{op.exchange_bytes} bytes exchanged)"
                  + ("" if row["scaling_result"] else "; shards share a card: not a scaling"))
    return out


if __name__ == "__main__":
    import sys
    print(json.dumps(measure_scaling(sys.argv[1] if len(sys.argv) > 1 else "atmosmodd"),
                     indent=2))
