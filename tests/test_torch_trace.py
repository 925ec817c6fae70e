"""The port's spans and counters (``respatpu_torch.timing``: ``span``,
``count``, ``recording``) and where the refined solve records them. Two
tests, each a group of checks, so that the suite's collected count stays in
its safe range (ROADMAP, "The test-count trap")."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from respatpu_torch import solve, timing
from respatpu_torch.bench.synth import circuit_like, laplacian_2d
from respatpu_torch.kernels import snlu_device
from respatpu_torch.kernels import spmv as spmv_kernels


def _children(rec, i):
    return [rec.names[k] for k, p in enumerate(rec.parents) if p == i]


def _request(rec, i):
    """The top-level span that span ``i`` lies in: the request it belongs to."""
    while rec.parents[i] >= 0:
        i = rec.parents[i]
    return i


def test_recorder_off_nesting_clock_and_launches(monkeypatch):
    # off: one shared no-op, no clock read, nothing counted
    assert timing._recording is None
    with monkeypatch.context() as m:
        m.setattr(timing.time, "time_ns", lambda: pytest.fail("the clock was read"))
        first = timing.span("upload")
        assert timing.span("apply") is first
        with first:
            timing.count("sync")
    with timing.recording() as rec:
        pass
    assert rec.names == [] and rec.counts == {} and rec.launches == {}

    # nesting: parents and the request a span belongs to
    with timing.recording() as rec:
        for _ in range(2):
            with timing.span("solve_refined"):
                with timing.span("upload"):
                    with timing.span("layout"):
                        timing.count("sync")
                with timing.span("ir"):
                    timing.count("sync", 2)
    assert timing._recording is None and timing.span("x") is first
    assert rec.names == ["solve_refined", "upload", "layout", "ir"] * 2
    assert rec.parents == [-1, 0, 1, 0, -1, 4, 5, 4]
    assert [_request(rec, i) for i in range(8)] == [0, 0, 0, 0, 4, 4, 4, 4]
    assert rec.counts == {"sync": 6}
    for i, p in enumerate(rec.parents):
        assert rec.starts[i] <= rec.ends[i]
        if p >= 0:
            assert rec.starts[p] <= rec.starts[i] and rec.ends[i] <= rec.ends[p]
    with pytest.raises(RuntimeError):
        with timing.recording():
            with timing.recording():
                pass
    assert timing._recording is None

    # the profiler's clock: a torch op inside a span has its record inside it
    x = torch.randn(4096, dtype=torch.float64)
    with profile(activities=[ProfilerActivity.CPU]) as prof, timing.recording() as rec:
        with timing.span("residual"):
            torch.linalg.vector_norm(x)
    ops = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::linalg_vector_norm"]
    assert ops
    for e in ops:
        assert rec.starts[0] <= e.start_ns() <= e.end_ns() <= rec.ends[0]

    # launches: each kernel module's LAUNCHES raised inside the recording
    monkeypatch.setitem(spmv_kernels.LAUNCHES, "fp64", spmv_kernels.LAUNCHES["fp64"])
    name = next(iter(snlu_device.LAUNCHES))
    monkeypatch.setitem(snlu_device.LAUNCHES, name, snlu_device.LAUNCHES[name])
    spmv_kernels.LAUNCHES["fp64"] += 5        # before: not counted
    with timing.recording() as rec:
        spmv_kernels.LAUNCHES["fp64"] += 3
        snlu_device.LAUNCHES[name] += 2
    spmv_kernels.LAUNCHES["fp64"] += 7        # after: not counted
    assert rec.launches == {"spmv.fp64": 3, f"snlu_device.{name}": 2}


def _ill_conditioned(n=150):
    """A circuit with its columns scaled over six decades, factored without
    the matching that would undo the scaling: plain refinement of its fp32
    factorization stalls."""
    a = circuit_like(n, 5, seed=21, diag="dominant")
    a.data = a.data * np.logspace(0, -6, n)[a.indices]
    return a


def test_refined_solves_record_their_spans_and_syncs():
    # a band factor: plain IR converges
    a = laplacian_2d(12, 9)
    b, _ = solve.make_rhs_for_known_x(a)
    fac = solve.factorize(a, "fp32", method="band", device="cpu")
    with timing.recording() as rec:
        _, rep = solve.solve_refined(a, b, fac=fac)
    assert rep.converged and "gmres_ir" not in rep.notes
    assert rec.names[0] == "solve_refined" and rec.parents.count(-1) == 1
    assert _children(rec, 0) == ["upload", "ir", "to_host", "host_residual"]
    upload, ir = rec.names.index("upload"), rec.names.index("ir")
    assert _children(rec, upload) == ["layout"]
    assert _children(rec, ir) == ["residual", "apply"] * (rep.iterations - 1) + ["residual"]
    # the factorization's first refined solve builds A's fp64 operator, held after
    assert rec.counts == {"sync": rep.iterations + 1, "a_upload": 1}
    assert rec.launches == {}                  # the CPU runs the plain versions

    # a stalled multifrontal factor: plain IR, then GMRES-IR
    a = _ill_conditioned()
    b, _ = solve.make_rhs_for_known_x(a)
    fac = solve.factorize(a, "fp32", method="snlu", matching=False, device="cpu")
    with timing.recording() as rec:
        _, rep = solve.solve_refined(a, b, fac=fac, max_iters=3)
    assert "gmres_ir=" in rep.notes and rep.converged
    assert rec.parents.count(-1) == 1 and {_request(rec, i) for i in range(len(rec.names))} == {0}
    assert _children(rec, 0) == ["upload", "ir", "to_host", "host_residual", "gmres",
                                 "host_residual"]
    g = rec.names.index("gmres")
    kids = _children(rec, g)
    inner = int(rep.notes.split("gmres_ir=")[1].split("it")[0])
    outer = kids.count("lstsq")
    assert kids[0] == "upload" and kids[-1] == "to_host" and 1 <= outer < 4
    assert [k for k in kids[1:-1] if k != "lstsq"] == ["apply", "orthogonalize"] * inner
    gmres_upload = [i for i, p in enumerate(rec.parents) if p == g and rec.names[i] == "upload"]
    assert _children(rec, gmres_upload[0]) == []      # plain IR's operator, reused
    assert rec.names.count("upload") == 2 and rec.names.count("host_residual") == 2
    # plain IR: one a residual, one for x; GMRES-IR: b's norm, each cycle's residual norm and
    # the last one that meets the tolerance, one an inner iteration, H a cycle, and x
    assert rec.counts == {"sync": rep.iterations + 2 * outer + 4, "a_upload": 1, "a_reuse": 1}
