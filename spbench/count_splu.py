"""Count the scheduled sparse LU's work once and freeze it into its file.

    python -m spbench.count_splu <config name> [...]   # writes "work" into each file

``spbench/count_work.py`` for ``method="sparse"``
(``solve.SparseLuFactorization``): the frozen stand-in (base values, seed 0)
and the port's own analysis of it, as that class makes it at its default
ordering (``fillauto``): the symbolic fill of the permuted matrix, the
Chow-Patel pair lists of K8 and K7's level schedules of the fill's two strict
triangles. Nothing is factored, so no card is needed, but at a
configuration's size the pair lists take gigabytes of host memory.
Recorded:

* ``rows``, ``nnz``, ``csr64_bytes``: the matrix and one fp64 CSR product's
  least bytes (``count_work.csr64_bytes``);
* ``factor_flops``, ``factor_entries`` of the fill (``count_work.pattern_work``)
  and ``fill_nnz``;
* ``lower_strict``, ``upper_strict``, ``lower_levels``, ``upper_levels``: the
  entries of the two strict triangles and the dependent levels K7 walks in each;
* ``apply_bytes``: the least bytes one correction apply (K7 on L, then on U)
  reads and writes: each triangle's values and int32 columns, its int64 row
  pointers, its int32 permutation and its inverse diagonal, b read and y
  written in the accumulator type;
* ``schedule_bytes``: K8's pair lists as the port stores them on the card
  (``splu.estimate_schedule_bytes``, the 4 GiB guard's input);
* ``link_s``: the card's one-way hand-over through L2, the least time a level
  can take (``link_source`` says where it was measured).
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
if __package__ in (None, ""):
    sys.path.insert(0, str(HERE.parent))

from spbench import standin  # noqa: E402
from spbench.count_work import csr64_bytes, pattern_work  # noqa: E402

ORDER = "fillauto"                  # SparseLuFactorization's default ordering
LINK_S = 0.5696e-6
LINK_SOURCE = ("respatpu_torch.kernels.sptrsv.link_latency on an NVIDIA H100 80GB HBM3 at "
               "700 W: two single-thread blocks bounce a flag through L2, halved")


def tri_apply_bytes(n: int, strict: int, value_bytes: int, accum_bytes: int) -> int:
    """Least bytes of one K7 launch on a triangle of ``strict`` off-diagonal
    entries: values and int32 columns, int64 row pointers, int32 permutation,
    the inverse diagonal, b read and y written."""
    return (strict * (value_bytes + 4) + (n + 1) * 8 + n * 4 + n * value_bytes
            + 2 * n * accum_bytes)


def count(cfg: dict) -> dict:
    import torch

    from respatpu_torch import CSRMatrix
    from respatpu_torch.analysis import (chow_patel_schedule, ordering, permute_csr,
                                         symbolic_fill_lu)
    from respatpu_torch.formats import split_triangular
    from respatpu_torch.kernels.splu import estimate_schedule_bytes
    from respatpu_torch.kernels.sptrsv import _strict_and_diag, tri_schedule
    from respatpu_torch.precision import get_policy
    if cfg["method"] != "sparse":
        raise ValueError(f"count_splu counts method 'sparse', not {cfg['method']!r}")
    mat = standin.build_matrix(cfg["matrix"], 0)
    a = CSRMatrix(mat.shape, mat.indptr, mat.indices, mat.data)
    n = a.nrows
    filled = symbolic_fill_lu(permute_csr(a, ordering(a, ORDER)))
    work = {"rows": n, "nnz": a.nnz, "csr64_bytes": csr64_bytes(n, a.nnz), "order": ORDER}
    work.update(pattern_work(filled.indptr, filled.indices, n))
    work["fill_nnz"] = int(filled.nnz)
    policy = get_policy(cfg["policy"])
    value_bytes = torch.finfo(policy.dtype).bits // 8
    accum_bytes = torch.finfo(policy.accum_dtype).bits // 8
    low, _, up = split_triangular(filled)          # the triangles as the port splits them
    apply_bytes = 0
    for side, lower, strict in (("lower", True, low),
                                ("upper", False, _strict_and_diag(up, False, False)[0])):
        work[f"{side}_strict"] = int(strict.nnz)
        work[f"{side}_levels"] = int(tri_schedule(strict, lower).level_ptr.size - 1)
        apply_bytes += tri_apply_bytes(n, strict.nnz, value_bytes, accum_bytes)
    work["apply_bytes"] = apply_bytes
    work["schedule_bytes"] = int(estimate_schedule_bytes(chow_patel_schedule(filled)))
    work["link_s"] = LINK_S
    work["link_source"] = LINK_SOURCE
    return work


def main(argv=None) -> int:
    names = sys.argv[1:] if argv is None else argv
    for name in names:
        path = HERE / "configs" / f"{name}.json"
        with open(path) as f:
            cfg = json.load(f)
        cfg["work"] = count(cfg)
        with open(path, "w") as f:
            json.dump(cfg, f, indent=1)
            f.write("\n")
        print(name, json.dumps(cfg["work"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
