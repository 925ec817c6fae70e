"""The configuration ``lap2d_300.splu_fp32`` (the five-point Laplacian on the
scheduled exact sparse LU) at a 40 x 40 grid on the CPU: its file, a whole
run, the control's verdict, a planted fault, its frozen work counts and the
readers of its triangular solves. The 300 x 300 analysis takes seconds and
gigabytes, so no test makes it."""
import json
import time
from types import SimpleNamespace

import numpy as np
import pytest

from spbench import control, count_splu, loadgen, run, standin, trace
from spbench.program import ProgramTrace

CELL, CONFIG = "lap2d_300.rhs", "lap2d_300.splu_fp32"
SIDE = 40


def small(matrix: dict) -> dict:
    """A configuration's matrix section at a 40 x 40 grid."""
    matrix.update(target_n=SIDE * SIDE, target_nnz=5 * SIDE * SIDE)
    matrix.pop("n"), matrix.pop("nnz")
    return matrix


def small_spec():
    spec = run.cell_spec(CELL)
    small(spec.config["matrix"])
    return spec


def run_small(spec, seed):
    return run.run_cell(spec, seed=seed, seconds=0.3, trace=False, device="cpu",
                        t_start=time.perf_counter())


def test_the_configuration_states_the_matrix_it_builds():
    cfg = json.loads((run.HERE / "configs" / f"{CONFIG}.json").read_text())
    spec = dict(cfg["matrix"])
    a = standin.build_matrix(spec, 2 ** 31 + 1)      # the gallery matrix: no analysis
    assert (a.n, a.nnz) == (spec["n"], spec["nnz"]) == (300 * 300, 448800)
    assert cfg["method"] == "sparse" and cfg["reduced"] == []
    assert cfg["work"]["rows"] == spec["n"] and cfg["work"]["nnz"] == spec["nnz"]
    spec["nnz"] += 1
    with pytest.raises(ValueError):
        standin.build_matrix(spec, 1)
    tiny = standin.build_matrix(small(dict(cfg["matrix"])), 3)
    assert tiny.n == SIDE * SIDE


def test_a_sound_run_is_correct_and_the_control_is_not():
    out = run_small(small_spec(), seed=2 ** 31 + 3)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    for c in out["checks"].values():
        assert 0 < c["value"] <= c["limit"]

    cfg = small_spec().config
    got = {r["who"]: r for r in control.readings(cfg, [21], [21], witness=True, device="cpu")}
    assert got["program"]["correct"] is True
    assert got["reference_fp32"]["correct"] is True    # the reference at fp32 passes
    assert got["control"]["correct"] is False           # one precision lower fails


def test_a_correction_solve_that_returns_its_input_is_not_correct(monkeypatch):
    from respatpu_torch import solve as S
    window = loadgen.Mix.window

    def broken(self, seconds):                           # planted once the window opens
        monkeypatch.setattr(S._TriangleSolves, "solve_device", lambda fac, bp: bp)
        return window(self, seconds)

    monkeypatch.setattr(loadgen.Mix, "window", broken)
    out = run_small(small_spec(), seed=7)
    assert out["correct"] is False
    assert out["checks"]["refined_resid"]["value"] > out["checks"]["refined_resid"]["limit"]


def test_the_frozen_counts_are_the_ports_own_triangles():
    from respatpu_torch import CSRMatrix
    from respatpu_torch import solve as S
    cfg = small_spec().config
    work = count_splu.count(cfg)
    m = standin.build_matrix(cfg["matrix"], 0)
    fac = S.factorize(CSRMatrix(m.shape, m.indptr, m.indices, m.data), policy="fp32",
                      method="sparse", matching=False, device="cpu")
    assert work["fill_nnz"] == fac._filled.nnz == work["factor_entries"]
    assert (work["lower_strict"], work["upper_strict"]) == (fac._l.nnz, fac._u.nnz)
    assert (work["lower_levels"], work["upper_levels"]) == (fac._l.levels, fac._u.levels)
    assert work["fill_nnz"] == work["lower_strict"] + work["upper_strict"] + m.n
    # an apply reads each triangle's arrays once, writes y once: the tensors K7 is given
    n = m.n
    arrays = sum(t.vals.nbytes + t.cols.nbytes + t.ptr.nbytes + t.perm.nbytes + t.dinv.nbytes
                 for t in (fac._l, fac._u))
    assert work["apply_bytes"] == arrays + 2 * 2 * n * 4
    assert work["schedule_bytes"] > 0 and work["link_s"] == count_splu.LINK_S


def test_the_chain_share_and_the_tri_solve_spans_read_the_trace():
    """Two requests of 3 iterations: K7 records inside the benchmark's solve
    spans, one outside them, and a record of another kernel."""
    from respatpu_torch.timing import Recording
    names = ["void tri_solve_kernel<float, float, false, false>(int)", "spmv_dia",
             "void tri_solve_kernel<float, float, false, true>(int)", "tri_solve_kernel<>"]
    dev = [(100, 150), (150, 160), (160, 200), (600, 700)]
    tr = trace.Trace([s for s, _ in dev], [e for _, e in dev], names,
                     {"solve": [(50.0, 300.0), (400.0, 500.0)]}, (np.zeros(0), []),
                     (0.0, 1000.0))
    steps = [SimpleNamespace(iterations=3, converged=True)] * 2
    work = {"lower_levels": 3, "upper_levels": 2, "link_s": 1e-9}
    ctx = SimpleNamespace(trace=tr, steps=steps, work=work)
    read = run.metric_reader("tri_chain.splu")
    # 4 applies x 5 levels x 1 ns over the 90 ns of K7 inside the solve spans
    assert read(ctx) == pytest.approx(100.0 * 20 / 90)
    for empty in (SimpleNamespace(trace=None, steps=steps, work=work),
                  SimpleNamespace(trace=tr, steps=steps, work={}),
                  SimpleNamespace(trace=tr, steps=[], work=work)):
        assert read(empty) is None

    rec = Recording(names=["solve_refined", "tri_solve", "lower", "tri_solve"],
                    starts=[60, 100, 100, 200], ends=[290, 180, 140, 260],
                    parents=[-1, 0, 1, 0])
    ms = run.metric_reader("tri_solve_ms.splu")
    assert ms(SimpleNamespace(trace=ProgramTrace.of(tr, rec), steps=steps)) == \
        pytest.approx(140e-6 / 2)
    assert ms(SimpleNamespace(trace=tr, steps=steps)) is None
