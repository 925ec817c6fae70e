"""The harness at a tiny size on the CPU, the contract's shape of its result
line and of ``BENCHMARK.json``, and metrics found by their names."""
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from spbench import run

ROOT = Path(run.__file__).resolve().parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def small_spec(cell: str, n: int = 1500, nnz: int = 15000):
    spec = run.cell_spec(cell)
    spec.config["matrix"].update(target_n=n, target_nnz=nnz)
    spec.config["matrix"].pop("n"), spec.config["matrix"].pop("nnz")
    return spec


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def result_of(out: dict) -> dict:
    return json.loads(run.result_line(out))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_end_to_end_on_the_cpu(cell):
    spec = small_spec(cell)
    out = result_of(run.run_cell(spec, seed=2 ** 31 + 99, seconds=0.5, trace=False,
                                 device="cpu", t_start=time.perf_counter()))
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {m["name"] for m in spec.end_to_end}
    for m in out["metrics"].values():
        assert m["value"] > 0 and set(m) == {"value", "unit"}
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("cell", ["2cubes_sphere.rhs", "dc1.rhs"])
def test_traced_run_on_the_cpu_reports_per_layer_metrics(cell):
    spec = small_spec(cell)
    out = result_of(run.run_cell(spec, seed=5, seconds=0.3, trace=True, device="cpu",
                                 t_start=time.perf_counter()))
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "checks"]
    wanted = {m["name"] for m in spec.per_layer}
    assert set(out["metrics"]) <= wanted
    # host-clock and program readings exist without a card; device shares do not
    assert "analyze_s" in out["metrics"]
    assert not any("roofline" in k or "idle" in k or "mfu" in k for k in out["metrics"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_every_metric_is_found_by_name():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(run.metric_reader(m["name"])), m["name"]


def test_a_metric_without_a_file_of_its_own_reads_its_stem():
    """``device_idle.rhs`` is read by ``device_idle.py``; a file of the whole
    name comes first."""
    from types import SimpleNamespace
    ctx = SimpleNamespace(steps=[SimpleNamespace(iterations=3), SimpleNamespace(iterations=5)])
    assert run.metric_reader("refine_iters.rhs")(ctx) == 4.0
    assert run.metric_reader("refine_iters.anything")(ctx) == 4.0
    assert not (run.HERE / "metrics" / "refine_iters.rhs.py").exists()


@pytest.mark.parametrize("listed", [True, False])
def test_a_new_metric_file_is_found_by_name(tmp_path, listed):
    """A later change adds a per-layer metric as a file and an entry only;
    without a list of cells it is reported in every cell that reports the
    end-to-end metric it moves."""
    shutil.copytree(ROOT / "spbench", tmp_path / "spbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = {"name": "answers.rhs", "unit": "count", "better": "higher",
             "source": "program_counter", "layer": "IR and Krylov", "moves": "solve_ms"}
    if listed:
        entry["workloads"] = ["2cubes_sphere.rhs"]
    bench["per_layer"].append(entry)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "spbench" / "metrics" / "answers.rhs.py").write_text(
        "def read(ctx):\n    return len(ctx.steps)\n")
    import importlib.util
    spec = importlib.util.spec_from_file_location("spbench_copy_run",
                                                  tmp_path / "spbench" / "run.py")
    copy = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(copy)
    cell = copy.cell_spec("2cubes_sphere.rhs")
    names = [m["name"] for m in cell.per_layer]
    assert "answers.rhs" in names and "solve_roofline.snlu" not in names
    from types import SimpleNamespace
    assert copy.metric_reader("answers.rhs")(SimpleNamespace(steps=[1, 2, 3])) == 3
    in_dc1 = "answers.rhs" in [m["name"] for m in copy.cell_spec("dc1.rhs").per_layer]
    assert in_dc1 is not listed


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["spbench"] and 1 <= BENCH["run_seconds"] <= 51
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("spbench/") and (ROOT / c["file"]).exists()
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"] == []
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "spbench" / "traffic" / f"{w['traffic']}.json").exists()
        names.append(w["name"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        for w in m.get("workloads", []):
            reports = [e["name"] for e in BENCH["end_to_end"]
                       if "workloads" not in e or w in e["workloads"]]
            assert m["moves"] in reports, (m["name"], w)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        names.append(m["name"])
        assert m["better"] in ("lower", "higher")
        assert re.fullmatch(r"[A-Za-z0-9_/%.-]{1,16}", m["unit"])
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for cell in CELLS:   # every cell reports setup_s, another end-to-end metric, a layer
        spec = run.cell_spec(cell)
        got = {m["name"] for m in spec.end_to_end}
        assert "setup_s" in got and len(got) >= 2 and spec.per_layer
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_without_a_card_the_command_fails_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    proc = subprocess.run([sys.executable, "-m", "spbench.run", "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card(cuda):
    proc = subprocess.run([sys.executable, "-m", "spbench.run", "--workload",
                           "2cubes_sphere.rhs", "--seed", str(2 ** 31 + 5), "--seconds", "2",
                           "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
    assert proc.stderr.strip().splitlines()[-1].startswith("check ")
