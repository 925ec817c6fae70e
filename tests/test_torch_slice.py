"""The dual-precision SpMV slice end to end on the CPU: a Matrix Market file
through the port's CLI and sweep, against respatpu's GSELL kernels on the
same file."""
import ast
import csv
import inspect

import numpy as np
import pytest
import torch

import respatpu.bench.runner as jrunner
import respatpu.io as jio
from respatpu import precision as jprec
from respatpu.kernels.gsell import gsell_to_device, spmv_gsell
from respatpu.kernels.gsell_df import gsell_df_to_device, spmv_gsell_df

from respatpu_torch import cli, solve, timing
from respatpu_torch.bench import runner, synth
from respatpu_torch.interop import df_to_numpy
from respatpu_torch.io import load_csr, write_mtx
from respatpu_torch.timing import (ImplausibleTiming, OpTiming, check_plausible,
                                   spmv_csr_sol_bytes)


@pytest.fixture(scope="module")
def mtx(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("slice") / "fem3000.mtx")
    write_mtx(path, synth.mesh_fem_3d(3000, seed=21))
    return path


def _respatpu_header():
    """The CSV header respatpu's sweep_spmv writes, read from its source."""
    tree = ast.parse(inspect.getsource(jrunner.sweep_spmv))
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "header":
            return ast.literal_eval(node.value)
    raise AssertionError("no header in respatpu.bench.runner.sweep_spmv")


def test_cli_spmv_matches_respatpu(mtx, capsys):
    cli.main(["spmv", mtx, "--device", "cpu", "--reps", "2"])
    out = capsys.readouterr().out
    port_err = float(out.split("mean_abs_err=")[1].split()[0])

    ja = jio.load_csr(mtx)
    a = load_csr(mtx)
    x = np.random.default_rng(42).standard_normal(a.shape[1])
    y64_j = df_to_numpy(*spmv_gsell_df(gsell_df_to_device(ja), jprec.df_from_f64(x)))
    y32_j = np.asarray(spmv_gsell(gsell_to_device(ja, "fp32"), x.astype(np.float32)),
                       np.float64)
    y64, t64 = solve.spmv_timed(a, x, "fp64", device="cpu", reps=2)
    y32, t32 = solve.spmv_timed(a, x, "fp32", device="cpu", reps=2)
    y64, y32 = solve._to_host_f64(y64), solve._to_host_f64(y32)
    assert np.abs(y64 - y64_j).max() / np.abs(y64_j).max() <= 1e-12
    assert np.abs(y32 - y32_j).max() / np.abs(y32_j).max() <= 2e-5
    assert port_err == pytest.approx(float(f"{np.abs(y64 - y32).mean():.3e}"))
    # the cross-precision error, port vs respatpu, within 10%
    assert port_err == pytest.approx(np.abs(y64_j - y32_j).mean(), rel=0.1)
    for t in (t64, t32):
        assert len(t.times) == 2 and 0 < t.floor_s <= t.min


def test_sweep_spmv_rows_and_header(tmp_path):
    path = str(tmp_path / "sweep.csv")
    rows = runner.sweep_spmv(["dc1", "2cubes_sphere"], csv_path=path,
                             policies=("fp64", "bf16"), reps=2,
                             max_synth_nnz=40_000, verbose=False, device="cpu")
    with open(path) as f:
        table = list(csv.reader(f))
    assert table[0] == runner.SPMV_HEADER == _respatpu_header()
    assert [r[3] for r in table[1:]] == ["dc1", "2cubes_sphere"]
    for row in rows:
        assert row["policy_hi"] == "fp64" and row["chips"] == 1 and row["synthetic"] == 1
        err = float(row["mean_abs_err"])
        assert np.isfinite(err) and err > 0
        assert float(row["t_lo_min_s"]) <= float(row["t_lo_s"])
        assert row["timing_lo"].floor_s > 0


def test_cli_device_rules(mtx, capsys, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(SystemExit, match="--device cpu"):
            cli.main(["spmv", mtx])  # the default device is cuda
    cli.main(["sweep", "spmv", "--group", "moderate", "--max-synth-nnz", "2000",
              "--device", "cpu", "--reps", "1"])
    assert capsys.readouterr().out.count("[spmv]") == 21
    for argv in (["lu", mtx], ["sweep", "ilu0", "--device", "cpu"]):
        with pytest.raises(SystemExit):
            cli.main(argv)


def test_timing_gate_raises_on_too_fast():
    nbytes = spmv_csr_sol_bytes(1000, 1000, 5000, 4, 4)
    assert nbytes == 1001 * 8 + 5000 * 4 + 5000 * 4 + 1000 * 4 + 1000 * 4
    with pytest.raises(ImplausibleTiming):
        check_plausible(OpTiming([1e-6, 1e-9]), nbytes, 3e12)
    t = check_plausible(OpTiming([1e-6, 2e-6]), nbytes, 3e12)
    assert t.floor_s == pytest.approx(nbytes / (1.05 * 3e12)) and t.median == 1.5e-6


def test_spmv_timed_probes_bandwidth_once_per_device(monkeypatch):
    calls = []
    probe = timing.stream_bandwidth

    def counting(device, reps=5):
        calls.append(torch.device(device))
        return probe(device, reps)

    monkeypatch.setattr(timing, "stream_bandwidth", counting)
    monkeypatch.setattr(timing, "_bandwidth", {})
    a = synth.mesh_fem_3d(1500, seed=4)
    x = np.random.default_rng(0).standard_normal(a.shape[1])
    t = [solve.spmv_timed(a, x, policy, device="cpu", reps=2)[1] for policy in ("fp64", "fp32")]
    assert calls == [torch.device("cpu")]
    assert all(0 < ti.floor_s <= ti.min for ti in t)
    # the gate is the same one: both floors come from the one measured bandwidth
    bw = timing._bandwidth[torch.device("cpu")]
    assert timing.device_bandwidth("cpu") == bw and len(calls) == 1
    nbytes = spmv_csr_sol_bytes(a.shape[0], a.shape[1], a.nnz, 8, 8)
    assert t[0].floor_s == pytest.approx(nbytes / (1.05 * bw))
