"""Run one cell of the benchmark of ``respatpu_torch`` once.

    python -m spbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

One process, one card. The cell is found by name in ``BENCHMARK.json`` at
the checkout's root; its configuration (``spbench/configs/``), traffic mix
(``spbench/traffic/``) and metrics (``spbench/metrics/<name>.py``, each a
``read(ctx)`` that returns a number or None) are files found by their names.

Set-up builds the configuration's matrix (the frozen stand-in, values scaled
from the seed where the configuration says so), factors it with
``respatpu_torch.solve.factorize`` and makes the mix's warm-up requests. The
window then makes requests for ``--seconds`` (closed loop, one client). After
it: the device's memory peak is read, the factor is probed, the program's
state is freed, and the plain reference (``spbench/reference.py``) judges the
probes and a sample of the window's answers drawn from the seed.
Every number compared is printed beside its limit as the last lines of
standard error and under ``checks``, the last key of the result, which is the
last line of standard output. ``--trace 1`` profiles the window and reports
the cell's per-layer metrics instead of its end-to-end ones.

Exits non-zero without a result when there is no card (or too few), or when
JAX or the JAX package is loaded once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up runs from here to the first request

import argparse  # noqa: E402
import ctypes  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "respatpu")
# the port builds its own kernels under build/respatpu_torch/; these hold what a Triton kernel, a
# torch extension or CUDA's PTX compiler would build, so that only a checkout's first run compiles
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "CUDA_CACHE_PATH": "cuda_cache"}
THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
M_TRIM_THRESHOLD, M_MMAP_MAX = -1, -4     # mallopt's parameters (glibc's malloc.h)

if __package__ in (None, ""):  # run as a file: make ``spbench`` importable
    sys.path.insert(0, str(ROOT))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, cell: str, e2e_names) -> bool:
    """Whether a metric is reported in a cell: the cells it lists, or (a
    per-layer metric without a list) every cell that reports its ``moves``."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in e2e_names
    return True


def cell_spec(name: str, bench: Optional[dict] = None) -> SimpleNamespace:
    """Everything one cell needs, found by name from ``BENCHMARK.json``."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    e2e = [m for m in bench["end_to_end"] if applies(m, name, ())]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if applies(m, name, e2e_names)]
    return SimpleNamespace(
        name=name, cell=cell, config=load_json(ROOT / conf["file"]),
        traffic=load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
        end_to_end=e2e, per_layer=layer, chips=int(cell["chips"]))


def metric_reader(name: str):
    """The ``read`` function of ``spbench/metrics/<name>.py``, or, where there
    is no such file, of the one named by the part before the first dot
    (``device_idle.rhs`` falls back on ``device_idle.py``)."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"spbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_peaks(kind: str) -> Optional[dict]:
    """The table's peaks for a device by its name, or None."""
    table = load_json(HERE / "peaks.json")
    for key, row in table.items():
        if key in kind:
            return row
    return None


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def matrix(cfg: dict, seed: int):
    """The run's matrix (frozen stand-in, values from the seed), on the host
    for the reference and as the program takes it."""
    from respatpu_torch import CSRMatrix

    from . import standin
    m = standin.build_matrix(cfg["matrix"], seed)
    return m, CSRMatrix(m.shape, m.indptr, m.indices, m.data)


def factorize(cfg: dict, a, device: str):
    """The program's set-up: ``solve.factorize`` as the configuration states."""
    from respatpu_torch import solve as S
    return S.factorize(a, policy=cfg["policy"], method=cfg["method"],
                       matching=cfg["matching"], device=device)


def build(cfg: dict, seed: int, device: str):
    m, a = matrix(cfg, seed)
    return m, a, factorize(cfg, a, device)


def probe_factor(fac, n: int, seed: int, count: int, device) -> list:
    """``(r, y)`` of ``count`` solves through the factor's correction solve
    (``solve_original_device``, fp64 in the original coordinates), r drawn
    from the seed: the factor as the window left it, judged by its solves."""
    import numpy as np
    import torch

    from . import standin
    out = []
    for k in range(count):
        r = standin.rhs(n, seed, 3, k)
        try:
            y = fac.solve_original_device(torch.from_numpy(r).to(device)).double().cpu().numpy()
        except Exception:          # a solve that raises gives no answer: judged as NaN
            traceback.print_exc(file=sys.stderr)
            y = np.full(n, np.nan)
        out.append((r, y))
    return out


def judge(m, probes: list, answers: list, limits: dict):
    """The plain reference's numbers beside their limits, and ``correct``:
    the probes' componentwise backward errors (the largest row of any probe,
    and the larger of the probes' median rows), and the largest residual of
    the answers ``(x, b)`` (infinite where there is none)."""
    import numpy as np

    from . import reference
    ref = reference.PlainCsr(m.shape, m.indptr, m.indices, m.data)
    errs = [reference.backward_errors(ref, y, r) for r, y in probes]
    values = {"factor_berr_max": max(e[0] for e in errs),
              "factor_berr_med": max(e[1] for e in errs),
              "refined_resid": max((reference.residual(ref, x, b) for x, b in answers),
                                   default=float("inf"))}
    checks = {k: {"value": v, "limit": limits[k]} for k, v in values.items()}
    correct = all(bool(np.isfinite(c["value"])) and c["value"] <= c["limit"]
                  for c in checks.values())
    return checks, correct


def run_cell(spec: SimpleNamespace, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None) -> dict:
    """Set-up, the window, the checks and the metrics of one run. Returns the
    result's fields; the caller prints them."""
    import torch

    from .loadgen import Mix
    from .trace import Tracer

    t_start = T_START if t_start is None else t_start
    cfg, mix_spec = spec.config, spec.traffic
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from respatpu_torch import solve as S

    cuda = torch.device(device).type == "cuda"
    m, a = matrix(cfg, seed)
    mix = Mix(mix_spec, S, m, a, seed, device)      # right-hand sides made on the device
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()           # the peak is the program's
    fac = mix.fac = factorize(cfg, a, device)
    analyze_s = float(fac.report.t_analyze)
    mix.warm_up()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    tracer = Tracer(cuda) if trace else None
    if tracer is not None:
        mix.spans = tracer.spans
        with tracer:
            steps, window_s = mix.window(seconds)
        mix.spans = None
    else:
        steps, window_s = mix.window(seconds)

    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    probes = probe_factor(fac, m.n, seed, int(cfg.get("probes", 2)), device)
    answers = mix.answers()
    del mix, fac
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks, correct = judge(m, probes, answers, cfg["limits"])

    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    ctx = SimpleNamespace(cell=spec.cell, config=cfg, traffic=mix_spec, steps=steps,
                          window_s=window_s, setup_s=setup_s, analyze_s=analyze_s,
                          trace=tracer.trace if tracer is not None else None,
                          peaks=load_peaks(kind) if cuda else None, work=cfg.get("work", {}))
    wanted = spec.per_layer if trace else spec.end_to_end
    metrics = {}
    for mt in wanted:
        value = metric_reader(mt["name"])(ctx)
        if value is not None:
            metrics[mt["name"]] = {"value": float(value), "unit": mt["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": spec.chips,
           "memory_peak_bytes": peak}
    out = {"correct": bool(correct), "attempted": len(steps),
           "failed": sum(not s.converged for s in steps), "metrics": metrics, "device": dev}
    if tracer is not None:
        tr = tracer.trace
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
        inside = sum(tr.busy_in(k) or 0.0 for k in tr.spans)
        out["_note"] = (f"trace busy {tr.busy_s!r} s of a {tr.window_s!r} s window, "
                        f"{inside!r} s of it inside the spans")
    out["checks"] = checks
    return out


def result_line(out: dict) -> str:
    """Print every number compared beside its limit as the last lines of
    standard error; return the result as one JSON line."""
    if "_note" in out:
        print(out.pop("_note"), file=sys.stderr)
    for c in out["checks"].values():
        if not math.isfinite(c["value"]):
            c["value"] = 1e300             # a number JSON can carry; fails every limit
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    return json.dumps(out, allow_nan=False)


def steady_host() -> None:
    """One thread for torch's and the BLAS libraries' pools, and a heap that
    keeps what it frees (glibc: no mmap'd blocks, no trimming), so that the
    program's host loop runs alone on a core and does not fault its large
    temporaries in again at every request. Called before numpy and torch
    are imported."""
    for var in THREAD_VARS:
        os.environ[var] = "1"
    try:
        libc = ctypes.CDLL("libc.so.6")
    except OSError:
        return                      # not glibc: its defaults stand
    libc.mallopt(M_MMAP_MAX, 0)
    libc.mallopt(M_TRIM_THRESHOLD, 2 ** 31 - 1)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m spbench.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    spec = cell_spec(args.workload)
    for var, sub in CACHES.items():    # kernel caches at fixed paths inside the checkout
        os.environ.setdefault(var, str(ROOT / "build" / sub))
    steady_host()

    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"spbench: {args.workload} needs {spec.chips} CUDA device(s); found {have}",
              file=sys.stderr)
        return 2
    out = run_cell(spec, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"spbench: the run loaded {bad}; the port must run without JAX or respatpu",
              file=sys.stderr)
        return 3
    print(f"card {card_line()}", file=sys.stderr)

    line = result_line(out)
    sys.stdout.flush()
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
