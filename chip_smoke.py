#!/usr/bin/env python3
"""Smoke run of respatpu_torch's main path on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. device: requires CUDA, prints the card's name and power limit, keeps TF32 off;
2. build: compiles the CSR SpMV kernel and the Matrix Market parser from the
   checkout's sources, and reads a file through the parser;
3. kernel vs plain: every kernel instance against its plain PyTorch version
   on the card, on small matrices with empty rows, rows wider than 32, one
   50,000-entry row, a rectangular shape and subnormal inputs, on shapes at
   the edges of the kernel's row blocks (a row of exactly ``CAP`` entries and
   one of ``CAP + 1``, a run of empty rows longer than a block's row maximum,
   a one-row matrix, rows and no entries, a short last block), and at the
   main path's shapes; fp64 twice, bitwise. At the main path's shapes each
   instance is timed in turns with its plain version and with the one
   PyTorch call that computes the same function (a sparse CSR tensor times a
   vector; fp32 and fp64 only), by CUDA events and once more from the
   profiler's trace, and held to its byte bound;
4. main path: ``runner.sweep_spmv`` over the 2cubes_sphere, dc1 and offshore
   stand-ins with fp64 and each low precision, with the launch counts, the
   fp64 result against the host oracle and the rows' cross-precision error;
   then one sweep row under the profiler, for where its time goes;
5. result: a JSON line of the kernels, then the device line last.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from respatpu_torch import io as rio  # noqa: E402
from respatpu_torch.bench import corpus, runner  # noqa: E402
from respatpu_torch.bench.synth import mesh_fem_3d, row_block_edges  # noqa: E402
from respatpu_torch.formats import COOMatrix, CSRMatrix, coo_to_csr  # noqa: E402
from respatpu_torch.io import native  # noqa: E402
from respatpu_torch.kernels import _build  # noqa: E402
from respatpu_torch.kernels import spmv as K  # noqa: E402
from respatpu_torch.solve import WARMUP  # noqa: E402
from respatpu_torch.timing import (OpTiming, ProfilerUnavailable, check_plausible,  # noqa: E402
                                   device_bandwidth, device_events, kernel_times,
                                   spmv_csr_sol_bytes, time_op)

MAIN = ("2cubes_sphere", "dc1", "offshore")
LOW = ("fp32", "fp32_ftz", "bf16")
REPS = 5
# max|kernel - plain| / max|plain|; fp64 is held to the host oracle instead.
# fp32 and bf16 differ from the plain version only in summation order.
TOL = {"fp32": 2e-5, "fp32_ftz": 2e-5, "bf16": 2e-5, "fp64": 1e-14}
REPLACES = {"fp32": "respatpu/kernels/gsell.py:608", "fp32_ftz": "respatpu/kernels/gsell.py:608",
            "bf16": "respatpu/kernels/gsell.py:608", "fp64": "respatpu/kernels/gsell_df.py:195"}
SOURCE = "respatpu_torch/kernels/csrc/spmv_csr.cu"
KERNEL = "spmv_csr_stream"  # the __global__ function's name, as the profiler shows it
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
# PyTorch has a sparse CSR product for fp32 and fp64 only: none that flushes
# subnormals, none with bf16 values against an fp32 vector.
HAS_LIBRARY = ("fp32", "fp64")


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def x_for(dev, x64: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x64).to(dev.policy.accum_dtype).cuda()


def rel_err(y: torch.Tensor, ref: torch.Tensor) -> float:
    y, ref = y.double().cpu(), ref.double().cpu()
    return float((y - ref).abs().max() / max(float(ref.abs().max()), 1e-300))


def small_matrices():
    """A rectangular 30000 x 70000 matrix with empty rows, rows of 0-80
    entries and one 50,000-entry row, and a 3-D mesh matrix."""
    rng = np.random.default_rng(2024)
    m, n = 30000, 70000
    lens = rng.integers(0, 81, m)
    lens[::9] = 0
    lens[123] = 0
    rows = np.repeat(np.arange(m), lens)
    cols = rng.integers(0, n, rows.size)
    hub = rng.choice(n, 50000, replace=False)
    r = np.concatenate([rows, np.full(hub.size, 123)])
    c = np.concatenate([cols, hub])
    # the hub row's values are positive and x has mean 1 (see main), so its
    # |y| grows with its length and fp32 rounding, which differs between the
    # kernel's and the plain version's order, stays ~1e-6 of it
    v = np.concatenate([rng.standard_normal(rows.size), rng.uniform(0.5, 1.5, hub.size)])
    rect = coo_to_csr(COOMatrix((m, n), r.astype(np.int32), c.astype(np.int32), v))
    assert np.diff(rect.indptr).max() == 50000 and (np.diff(rect.indptr) == 0).any()
    return {"rect_hub50k": rect, "mesh_fem_3d": mesh_fem_3d(20000, seed=1)}


def edge_matrices():
    """Shapes at the edges of the kernel's row blocks (``K.row_blocks``)."""
    cap, rmax = K.CAP, K.MAX_ROWS
    out = row_block_edges(cap, rmax)
    b = K.row_blocks(out["row_cap_and_cap+1"].indptr)
    ents = np.diff(out["row_cap_and_cap+1"].indptr[b])
    assert cap in ents and cap + 1 in ents  # each of the two rows is a block of its own
    assert (np.diff(K.row_blocks(out["empty_run"].indptr)) == rmax).sum() >= 2
    assert np.diff(K.row_blocks(out["short_last_block"].indptr))[-1] == 1
    return out


def check_kernel(name, a, policy, x64, errs):
    dev = K.to_device(a, policy, "cuda")
    x = x_for(dev, x64)
    y = K.spmv(dev, x)
    torch.cuda.synchronize()
    plain = K.spmv_plain(dev, x)
    err = rel_err(y, plain)
    if policy == "fp64":
        err = rel_err(y, torch.from_numpy(K.spmv_csr_reference(a, x64)))
        again = K.spmv(dev, x)
        if not torch.equal(y, again):
            raise AssertionError(f"{name}: fp64 kernel not bitwise reproducible")
    if not np.isfinite(err) or err > TOL[policy]:
        raise AssertionError(f"{name} {policy}: error {err:.3e} > {TOL[policy]:.0e}")
    if not bool((y[torch.diff(dev.indptr) == 0] == 0).all()):
        raise AssertionError(f"{name} {policy}: an empty row is not 0")
    errs[policy] = max(errs[policy], float((y.double() - plain.double()).abs().max()))
    print(f"[kernel] {name:18s} {policy:8s} shape={a.shape} nnz={a.nnz} "
          f"blocks={dev.row_blocks.numel() - 1} rel_err={err:.3e} (tol {TOL[policy]:.0e})",
          flush=True)
    return dev, x


def check_ftz():
    """fp32_ftz on subnormal inputs: integer values and x with subnormal
    entries (sums exact in any order, so kernel == plain bitwise), and
    normal inputs whose products are subnormal (flushed to exact zeros)."""
    rng = np.random.default_rng(5)
    a = small_matrices()["rect_hub50k"]
    v = rng.integers(-4, 5, a.nnz).astype(np.float64)
    v[::5] = 1e-40
    x64 = rng.integers(-3, 4, a.shape[1]).astype(np.float64)
    x64[::7] = -1e-40
    s = CSRMatrix(a.shape, a.indptr, a.indices, v)
    dev = K.to_device(s, "fp32_ftz", "cuda")
    x = x_for(dev, x64)
    y, plain = K.spmv(dev, x), K.spmv_plain(dev, x)
    if not torch.equal(y, plain):
        raise AssertionError("fp32_ftz: kernel != plain on subnormal inputs")
    # every product here is 1e-20 * 1e-20 (subnormal in fp32): all rows flush
    tiny = CSRMatrix(a.shape, a.indptr, a.indices, np.full(a.nnz, 1e-20))
    xt = np.full(a.shape[1], 1e-20)
    dt = K.to_device(tiny, "fp32_ftz", "cuda")
    yt, pt = K.spmv(dt, x_for(dt, xt)), K.spmv_plain(dt, x_for(dt, xt))
    d32 = K.to_device(tiny, "fp32", "cuda")
    y32 = K.spmv(d32, x_for(d32, xt))
    if not (torch.equal(yt, pt) and bool((pt == 0).all()) and bool((y32 != 0).any())):
        raise AssertionError("fp32_ftz: subnormal products not flushed to exact zeros")
    print(f"[kernel] fp32_ftz subnormal inputs: kernel == plain bitwise; "
          f"{int((y32 != 0).sum())} rows nonzero under fp32 are exact zeros under fp32_ftz",
          flush=True)


def check_parser():
    """The native Matrix Market parser, built here, against the numpy one."""
    if not native.available():
        raise AssertionError("the Matrix Market parser (io/csrc/mtx_parse.cpp) did not build")
    a = mesh_fem_3d(4000, seed=6)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "a.mtx")
        rio.write_mtx(path, a)
        fast, slow = rio.load_csr(path, native=True), rio.load_csr(path, native=False)
    for got in (fast, slow):
        if not (np.array_equal(got.indptr, a.indptr) and np.array_equal(got.indices, a.indices)
                and got.data.tobytes() == a.data.tobytes()):
            raise AssertionError("Matrix Market round trip changed the matrix")
    print(f"[build] {native._load()._name} parses {a.nnz} entries like the numpy parser",
          flush=True)


def timed_in_turns(dev, x):
    """Median seconds of the kernel, its plain version and the library call
    (None where PyTorch has none), timed in turns: plain, kernel, library,
    library, kernel, plain. The sparse tensor is built outside the windows."""
    fns = {"kernel": lambda: K.spmv(dev, x), "plain": lambda: K.spmv_plain(dev, x)}
    order = ["plain", "kernel", "kernel", "plain"]
    if dev.policy.name in HAS_LIBRARY:
        a_csr = torch.sparse_csr_tensor(dev.indptr.to(torch.int32), dev.indices, dev.vals,
                                        size=dev.shape)
        if rel_err(a_csr @ x, K.spmv(dev, x)) > 2e-5:
            raise AssertionError("the library's product disagrees with the kernel")
        fns["library"] = lambda: a_csr @ x
        order[2:2] = ["library", "library"]
    out = {name: [] for name in fns}
    for name in order:
        out[name] += time_op(fns[name], "cuda", warmup=2, reps=10).times
    return out, {name: float(np.median(t)) for name, t in out.items()}


def profile_sweep_row(name_limit):
    """One warm sweep row under the profiler: wall time and the card's time
    by kind of work."""
    wall = [0.0]

    def row():
        t0 = time.perf_counter()
        runner.sweep_spmv([MAIN[0]], policies=("fp64", "fp32"), reps=REPS, device="cuda",
                          verbose=False)
        torch.cuda.synchronize()
        wall[0] = time.perf_counter() - t0

    def spmv_kernels(events):
        return [t for name, t in events if KERNEL in name]

    try:  # complete when it shows every launch that the row's two spmv_timed calls count
        events = device_events(row, lambda ev: len(spmv_kernels(ev)) == 2 * (1 + WARMUP + REPS))
    except ProfilerUnavailable as e:
        print(f"[profile] sweep row not profiled ({e})", flush=True)
        return
    kinds = {"spmv kernel": [], "copy device to device": [], "copy host to device": [],
             "copy device to host": [], "L2 flush fill": [], "other": []}
    for name, t in events:
        kind = ("spmv kernel" if KERNEL in name else
                "copy device to device" if "DtoD" in name else
                "copy host to device" if "HtoD" in name else
                "copy device to host" if "DtoH" in name else
                "L2 flush fill" if "fill" in name.lower() or "Memset" in name else "other")
        kinds[kind].append(t)
    busy = sum(sum(v) for v in kinds.values())
    print(f"[profile] {name_limit} | sweep row {MAIN[0]} fp64+fp32 reps={REPS} under the "
          f"profiler: wall {wall[0] * 1e3:.1f} ms, device busy {busy * 1e3:.3f} ms "
          f"({100 * busy / wall[0]:.1f}%)", flush=True)
    for kind, v in kinds.items():
        print(f"[profile]   {kind}: {len(v)} events, {sum(v) * 1e3:.3f} ms", flush=True)


def main():
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    name_limit = card()
    print(name_limit, flush=True)
    if torch.backends.cuda.matmul.allow_tf32 is not False:
        raise AssertionError("TF32 matmul is on; the port expects full fp32")
    torch.backends.cudnn.allow_tf32 = False
    print(f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} torch={torch.__version__} "
          f"cuda={torch.version.cuda}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    lib = _build.load()
    print(f"[build] {lib._name} ready in {time.perf_counter() - t0:.2f} s "
          f"(cap {lib.respa_spmv_csr_cap()}, max rows {lib.respa_spmv_csr_max_rows()})", flush=True)
    check_parser()

    # 3. kernel vs plain
    errs = {p: 0.0 for p in TOL}
    for mname, a in {**small_matrices(), **edge_matrices()}.items():
        x64 = np.random.default_rng(3).standard_normal(a.shape[1]) + 1.0
        for policy in TOL:
            check_kernel(mname, a, policy, x64, errs)
    check_ftz()
    mats = {m: corpus.load_matrix(m)[0] for m in MAIN}
    bw = device_bandwidth("cuda")
    print(f"[stream] device-to-device copy {bw / 1e9:.1f} GB/s on {name_limit}", flush=True)
    times = {}
    for mname, a in mats.items():
        x64 = np.random.default_rng(42).standard_normal(a.shape[1])
        for policy in TOL:
            dev, x = check_kernel(mname, a, policy, x64, errs)
            samples, med = timed_in_turns(dev, x)
            nbytes = spmv_csr_sol_bytes(a.shape[0], a.shape[1], a.nnz,
                                        dev.vals.element_size(), x.element_size())
            check_plausible(OpTiming(samples["kernel"]), nbytes, bw)
            try:  # a measurement beside the events' own; the profiler may trace nothing
                prof = kernel_times([lambda: K.spmv(dev, x)], KERNEL, reps=10)[0]
            except ProfilerUnavailable as e:
                print(f"[time] {mname} {policy}: profiler time not measured ({e})", flush=True)
                prof = None
            t = {"ms": med["kernel"] * 1e3, "plain_ms": med["plain"] * 1e3,
                 "library_ms": med["library"] * 1e3 if "library" in med else None,
                 "profiler_ms": float(np.median(prof)) * 1e3 if prof else None,
                 "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
            if min(prof or samples["kernel"]) * 1e3 < t["bound_ms"]:
                raise AssertionError(f"{mname} {policy}: a launch ran below its byte bound")
            times[mname, policy] = t

            def us(ms):
                return "not measured" if ms is None else f"{ms * 1e3:.2f} us"

            def share(ms):
                return "not measured" if ms is None else f"{100 * t['bound_ms'] / ms:.1f}%"

            print(f"[time] {name_limit} | {mname} {policy}: kernel {us(t['ms'])} by events, "
                  f"{us(t['profiler_ms'])} by the profiler; bound {us(t['bound_ms'])} "
                  f"({nbytes} bytes at 3.35 TB/s; share {share(t['profiler_ms'])} "
                  f"by the profiler, {share(t['ms'])} by events); "
                  f"library {us(t['library_ms']).replace('not measured', 'none')}; "
                  f"plain {us(t['plain_ms'])}", flush=True)

    # 4. main path
    for p in K.LAUNCHES:
        K.LAUNCHES[p] = 0
    rows = {p: runner.sweep_spmv(list(MAIN), policies=("fp64", p), reps=REPS, device="cuda")
            for p in LOW}
    launches = dict(K.LAUNCHES)
    per_call = 1 + WARMUP + REPS
    want = {"fp64": per_call * len(MAIN) * len(LOW), **{p: per_call * len(MAIN) for p in LOW}}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    print(f"[main] launches {launches}", flush=True)
    y64s = {}
    for mname, a in mats.items():
        x64 = np.random.default_rng(42).standard_normal(a.shape[1])
        d64 = K.to_device(a, "fp64", "cuda")
        y64s[mname] = K.spmv(d64, x_for(d64, x64))
        e64 = rel_err(y64s[mname], torch.from_numpy(K.spmv_csr_reference(a, x64)))
        if e64 > 1e-13:
            raise AssertionError(f"{mname}: fp64 error {e64:.3e} > 1e-13")
        print(f"[main] {mname}: fp64 y vs host oracle rel_err={e64:.3e} (tol 1e-13)", flush=True)
    for p in LOW:
        for row in rows[p]:
            a = mats[row["matrix"]]
            x64 = np.random.default_rng(42).standard_normal(a.shape[1])
            dlo = K.to_device(a, p, "cuda")
            y64 = y64s[row["matrix"]]
            ylo = K.spmv(dlo, x_for(dlo, x64))
            err = float((y64.cpu() - ylo.double().cpu()).abs().mean())
            got = float(row["mean_abs_err"])
            if not (np.isfinite(got) and got > 0 and abs(got - err) <= 1e-3 * err):
                raise AssertionError(f"{row['matrix']} {p}: mean_abs_err {got} vs {err}")
            for t in (row["timing_hi"], row["timing_lo"]):
                if not (t.floor_s > 0 and t.min >= t.floor_s):
                    raise AssertionError(f"{row['matrix']} {p}: timing not gated")
            nnz = a.nnz
            print(f"[row] {name_limit} | {row['matrix']} n={row['n']} nnz={nnz} "
                  f"fp64 {float(row['t_hi_s']) * 1e6:.2f} us ({nnz / float(row['t_hi_s']) / 1e9:.2f} Gnnz/s) "
                  f"{p} {float(row['t_lo_s']) * 1e6:.2f} us ({nnz / float(row['t_lo_s']) / 1e9:.2f} Gnnz/s) "
                  f"mean_abs_err={row['mean_abs_err']} "
                  f"gate_floor_lo={row['timing_lo'].floor_s * 1e6:.2f} us", flush=True)
    profile_sweep_row(name_limit)

    # 5. result
    kernels = []
    for p in TOL:
        inst = {"fp32": "f32", "fp32_ftz": "f32_ftz", "bf16": "bf16", "fp64": "f64"}[p]
        kernels.append({"name": f"respa_spmv_csr_{inst}", "route": "cuda", "source": SOURCE,
                        "replaces": REPLACES[p], "launches": launches[p],
                        "max_abs_err": errs[p], **times[MAIN[0], p], "bound_by": "bytes",
                        "shape": MAIN[0],
                        "by_matrix": {m: times[m, p] for m in MAIN}})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
