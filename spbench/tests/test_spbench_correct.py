"""``correct`` comes out false where it must: the control (the reference put
in the program's place one precision lower) and each fault a cell can have,
planted underneath the timed path of a whole run at a tiny size on the CPU.
The harness's look for a card is skipped (``device="cpu"``); the rest of a
run is driven as the command drives it."""
import time

import numpy as np
import pytest
import torch

from spbench import control, loadgen, reference, run, standin

CELLS = ["2cubes_sphere.rhs", "dc1.rhs"]
SMALL = {"2cubes_sphere.band_fp32": (3000, 40000), "dc1.snlu_fp32": (1500, 15000)}


def shrink(matrix: dict, n: int, nnz: int) -> None:
    """A configuration's matrix section at a tiny size."""
    matrix.update(target_n=n, target_nnz=nnz)
    matrix.pop("n"), matrix.pop("nnz")


def small_spec(cell: str):
    spec = run.cell_spec(cell)
    shrink(spec.config["matrix"], *SMALL[spec.config["name"]])
    return spec


def run_small(spec, seed=11):
    return run.run_cell(spec, seed=seed, seconds=0.4, trace=False, device="cpu",
                        t_start=time.perf_counter())


def in_window(monkeypatch, target, name, fault):
    """Plant ``fault`` as ``target.name`` once the window opens."""
    window = loadgen.Mix.window

    def broken(self, seconds):
        monkeypatch.setattr(target, name, fault(getattr(target, name)))
        return window(self, seconds)

    monkeypatch.setattr(loadgen.Mix, "window", broken)


@pytest.mark.parametrize("config", sorted(SMALL))
def test_the_control_is_not_correct(config):
    cfg = run.load_json(run.HERE / "configs" / f"{config}.json")
    shrink(cfg["matrix"], *SMALL[config])
    rows = list(control.readings(cfg, [21], [21], witness=True, device="cpu"))
    got = {r["who"]: r for r in rows}
    assert got["program"]["correct"] is True
    assert got["reference_fp32"]["correct"] is True   # the reference at fp32 passes
    assert got["control"]["correct"] is False          # one precision lower fails
    assert got["control"]["factor_berr_med"] > cfg["limits"]["factor_berr_med"]


def _solve_fault(kind):
    def fault(real):
        last = []

        def solve_refined(a, b, fac=None, **kw):
            if kind == "answer_reused":         # answers from a cache of the last request
                x, rep = real(a, b, fac=fac, **kw)
                last.append(x)
                return last[-2] if len(last) > 1 else x, rep
            if kind == "state_unchanged":      # returns its starting iterate
                x, rep = real(a, b, fac=fac, **kw)
                return np.zeros_like(x), rep
            if kind == "half_left_out":         # half the right-hand side dropped
                b = np.array(b)
                b[b.size // 2:] = 0.0
                return real(a, b, fac=fac, **kw)
            x, rep = real(a, b, fac=fac, **kw)   # an answer altered where produced
            x = np.array(x)
            k = int(np.argmax(np.abs(x)))
            x[k] *= 1.0 + 1e-6
            return x, rep
        return solve_refined
    return fault


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("kind", ["state_unchanged", "half_left_out", "answer_altered",
                                  "answer_reused"])
def test_a_broken_solve_is_not_correct(cell, kind, monkeypatch):
    from respatpu_torch import solve as S
    in_window(monkeypatch, S, "solve_refined", _solve_fault(kind))
    out = run_small(small_spec(cell))
    assert out["correct"] is False
    assert out["checks"]["refined_resid"]["value"] > out["checks"]["refined_resid"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    out = run_small(small_spec(cell), seed=2 ** 31 + 3)
    assert out["correct"] is True
    for c in out["checks"].values():
        assert 0 < c["value"] <= c["limit"]


def test_backward_error_and_residual_read_exact_answers_as_zero():
    m = standin.build_matrix({"name": "dc1", "kind": "circuit", "target_n": 500,
                              "target_nnz": 4000, "symmetric": False}, 1)
    ref = reference.PlainCsr(m.shape, m.indptr, m.indices, m.data)
    dense = np.zeros(m.shape)
    dense[m.rows(), m.indices] = m.data
    b = standin.rhs(m.n, 1, 1, 0)
    x = np.linalg.solve(dense, b)
    assert reference.residual(ref, x, b) < 1e-10
    assert max(reference.backward_errors(ref, x, b)) < 1e-12
    assert reference.residual(ref, np.full(m.n, np.nan), b) == float("inf")
