"""The program's spans in the traced window (``spbench/program.py``): idle
gaps named by the innermost program span, the share of idle time no span
names, the readers of the program's spans and counter, and a traced run on
the CPU with the program's recording open."""
import time
from collections import defaultdict
from types import SimpleNamespace

import numpy as np
import pytest

from respatpu_torch import timing
from respatpu_torch.timing import Recording
from spbench import run, trace
from spbench.program import ProgramTrace, ProgramTracer

# the per-layer metrics that read the program's recording (not yet in BENCHMARK.json)
PROGRAM_METRICS = [
    {"name": "upload_ms.rhs", "unit": "ms", "better": "lower", "source": "program_span"},
    {"name": "host_residual_ms.rhs", "unit": "ms", "better": "lower", "source": "program_span"},
    {"name": "apply_ms.rhs", "unit": "ms", "better": "lower", "source": "program_span"},
    {"name": "syncs_per_solve.rhs", "unit": "syncs", "better": "lower",
     "source": "program_counter"},
    {"name": "launches_per_solve.rhs", "unit": "launches", "better": "lower",
     "source": "program_counter"},
    {"name": "idle_unattributed.rhs", "unit": "%", "better": "lower", "source": "device_trace"},
]


def synthetic():
    """Two requests in a 1000 ns window: the benchmark's ``solve`` spans, the
    program's spans nested inside them, six device records and the runtime
    calls before them."""
    rec = Recording(
        names=["solve_refined", "upload", "layout", "ir", "residual", "solve_refined", "upload"],
        starts=[110, 120, 120, 210, 210, 610, 620],
        ends=[490, 200, 160, 400, 300, 890, 700],
        parents=[-1, 0, 1, 0, 3, -1, 5], counts={"sync": 9},
        launches={"bandlu.respa_band_sweep_fwd_f32": 2, "spmv.fp64": 3})
    dev = [(0, 105), (170, 180), (250, 260), (450, 460), (520, 530), (650, 660), (950, 1000)]
    host = ([0.0, 175.0, 255.0, 455.0, 515.0, 655.0],
            ["cudaMemcpyAsync", "cudaMemcpyAsync", "cudaLaunchKernel", "cudaStreamSynchronize",
             "cudaLaunchKernel", "cudaMemcpyAsync"])
    tr = trace.Trace([s for s, _ in dev], [e for _, e in dev], ["k"] * len(dev),
                     {"solve": [(100.0, 500.0), (600.0, 900.0)]},
                     (np.asarray(host[0]), host[1]), (0.0, 1000.0))
    return tr, ProgramTrace.of(tr, rec)


def by_top_level(gaps):
    out = defaultdict(float)
    for label, seconds in gaps:
        out[label.split(":")[0].split("/")[0]] += seconds
    return dict(out)


def test_idle_gaps_are_named_by_the_innermost_program_span():
    plain, prog = synthetic()
    mc, lk, ss = "cudaMemcpyAsync", "cudaLaunchKernel", "cudaStreamSynchronize"
    # each gap cut at the program's span bounds: the gap from 105 to 170 is 5 ns in the
    # benchmark's span alone, 10 in solve_refined, 40 in layout and 10 in upload
    assert dict(prog.idle_gaps(top=100)) == pytest.approx({
        f"solve: {mc}": 65e-9, f"solve/solve_refined: {mc}": 210e-9,
        f"solve/solve_refined/upload/layout: {mc}": 40e-9,
        f"solve/solve_refined/upload: {mc}": 70e-9,
        f"solve/solve_refined/ir/residual: {mc}": 40e-9,
        f"solve/solve_refined/ir/residual: {lk}": 40e-9,
        f"solve/solve_refined/ir: {lk}": 100e-9, f"solve/solve_refined: {lk}": 50e-9,
        f"solve/solve_refined: {ss}": 30e-9, f"solve: {ss}": 30e-9,
        f"outside spans: {lk}": 80e-9, f"outside spans/solve_refined: {lk}": 10e-9,
        f"outside spans/solve_refined/upload: {lk}": 30e-9})
    assert dict(plain.idle_gaps(top=100)) == pytest.approx({
        f"solve: {mc}": 425e-9, f"solve: {lk}": 190e-9, f"solve: {ss}": 60e-9,
        f"outside spans: {lk}": 120e-9})
    assert by_top_level(prog.idle_gaps(top=100)) == pytest.approx(
        by_top_level(plain.idle_gaps(top=100)))
    assert ProgramTrace.of(plain, None).idle_gaps(top=100) == plain.idle_gaps(top=100)
    # idle 795 ns; under spans below solve_refined: 80 + 190 + 80 ns less 30 ns busy
    assert prog.idle_unattributed() == pytest.approx(100.0 * (795 - 320) / 795)
    assert ProgramTrace.of(plain, None).idle_unattributed() is None

    # the accepted readers read the same numbers with the program's spans as without
    ctx = dict(steps=[SimpleNamespace(iterations=3, converged=True)] * 2, window_s=1e-6,
               peaks={"hbm_bytes_per_s": 3.35e12}, work={"apply_bytes": 1e3, "csr64_bytes": 10})
    for name in ("device_idle.rhs", "solve_roofline.band", "refine_iters.rhs"):
        read = run.metric_reader(name)
        assert read(SimpleNamespace(trace=prog, **ctx)) == read(SimpleNamespace(trace=plain, **ctx))
    assert prog.busy_in("solve") == plain.busy_in("solve") == pytest.approx(45e-9)
    assert prog.busy_s == plain.busy_s


def test_program_readers_on_a_synthetic_context():
    plain, prog = synthetic()
    steps = [SimpleNamespace(iterations=4, converged=True)] * 2
    got = {m["name"]: run.metric_reader(m["name"])(SimpleNamespace(trace=prog, steps=steps))
           for m in PROGRAM_METRICS}
    assert got == pytest.approx({"upload_ms.rhs": 160e-6 / 2, "host_residual_ms.rhs": 0.0,
                                 "apply_ms.rhs": 0.0, "syncs_per_solve.rhs": 4.5,
                                 "launches_per_solve.rhs": 2.5,
                                 "idle_unattributed.rhs": 100.0 * 475 / 795})
    for tr in (plain, None, ProgramTrace.of(plain, None)):   # no recording: nothing to read
        for m in PROGRAM_METRICS:
            assert run.metric_reader(m["name"])(SimpleNamespace(trace=tr, steps=steps)) is None


@pytest.mark.parametrize("cell", ["2cubes_sphere.rhs", "dc1.rhs"])
def test_traced_run_on_the_cpu_reads_the_programs_spans(cell, monkeypatch):
    spec = run.cell_spec(cell)
    spec.config["matrix"].update(target_n=1500, target_nnz=15000)
    spec.config["matrix"].pop("n"), spec.config["matrix"].pop("nnz")
    spec.per_layer = spec.per_layer + PROGRAM_METRICS
    monkeypatch.setattr(trace, "Tracer", ProgramTracer)
    out = run.run_cell(spec, seed=2 ** 31 + 7, seconds=0.3, trace=True, device="cpu",
                       t_start=time.perf_counter())
    assert out["correct"] and not out["failed"]
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert {"upload_ms.rhs", "host_residual_ms.rhs", "apply_ms.rhs",
            "syncs_per_solve.rhs", "launches_per_solve.rhs"} <= set(got)
    assert got["launches_per_solve.rhs"] == 0       # the CPU runs the plain versions
    assert got["upload_ms.rhs"] > 0 and got["host_residual_ms.rhs"] > 0
    assert not any("roofline" in k or "idle" in k for k in got)   # no card, no device shares
    if cell == "2cubes_sphere.rhs":       # plain IR alone: a sync a residual, one for x
        assert got["syncs_per_solve.rhs"] == got["refine_iters.rhs"] + 1


def test_a_tracer_that_fails_to_start_leaves_no_recording_open(monkeypatch):
    def fail(self):
        raise RuntimeError("the profiler did not start")
    monkeypatch.setattr(trace.Tracer, "__enter__", fail)
    with pytest.raises(RuntimeError, match="did not start"):
        with ProgramTracer(cuda=False):
            pass
    assert timing._recording is None
