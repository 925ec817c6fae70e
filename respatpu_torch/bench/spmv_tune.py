"""Compare compile-time sizes of the CSR SpMV kernel on the card.

    python -m respatpu_torch.bench.spmv_tune [--matrices 2cubes_sphere dc1 offshore]

Builds ``kernels/csrc/spmv_csr.cu`` once per variant (threads a block and
entries a thread, which fix the block capacity and its row maximum, and the
loads an fp64 thread keeps in flight), cuts each stand-in's rows for that
variant, checks the result against the plain version, and prints the median
kernel time from the profiler's trace with a cold L2, in rounds over the
variants so that drift hits all alike. Two more builds measure by
difference: one stops after the stream phase (``-DRESPA_SPMV_STREAM_ONLY``:
what the reduce phase costs), one sends every gather of x to x[0] or x[1]
(``-DRESPA_SPMV_PROBE_X01``: what the scattered gathers cost). Every
variant is timed twice: with the L2 flushed by writes, as ``timing.time_op``
flushes it, and flushed by reads, which leaves nothing to write back while
the kernel runs. The package itself always builds the source's defaults.
"""
from __future__ import annotations

import argparse
import shutil
import subprocess

import numpy as np
import torch

from ..kernels import _build
from ..kernels import spmv as K
from ..timing import kernel_times, spmv_csr_sol_bytes
from . import corpus

# (threads a block, entries a thread, further flags); the first is the source's default
VARIANTS = ((256, 8, ()), (256, 8, ("-DRESPA_SPMV_F64_BATCH=8",)), (256, 4, ()),
            (128, 8, ()), (128, 4, ()), (512, 8, ()),
            (256, 8, ("-DRESPA_SPMV_STREAM_ONLY",)), (256, 8, ("-DRESPA_SPMV_PROBE_X01",)))
POLICIES = ("fp32", "bf16", "fp64")
KERNEL = "spmv_csr_stream"


def _flags(threads: int, per_thread: int, extra=()):
    return (f"-DRESPA_SPMV_THREADS={threads}", f"-DRESPA_SPMV_PER_THREAD={per_thread}", *extra)


def _label(key) -> str:
    return f"threads={key[0]} per_thread={key[1]} {' '.join(f[2:] for f in key[2]) or '-'}"


def _resources(lib) -> str:
    """Registers and shared memory of each instance, if cuobjdump is there."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        out = subprocess.run([tool, "--dump-resource-usage", lib._name], capture_output=True,
                             text=True, timeout=120).stdout
    except OSError:
        return "cuobjdump not found"
    return " | ".join(ln.strip() for ln in out.splitlines() if "REG:" in ln)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--matrices", nargs="+", default=["2cubes_sphere", "dc1", "offshore"])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("spmv_tune needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    builds = {key: _build.build(_flags(*key)) for key in VARIANTS}
    for key, lib in builds.items():
        print(f"[build] {_label(key)}: {_resources(lib)}", flush=True)
    for mname in args.matrices:
        a = corpus.load_matrix(mname)[0]
        x64 = np.random.default_rng(42).standard_normal(a.shape[1])
        for policy in POLICIES:
            dev = K.to_device(a, policy, "cuda", fmt="csr")
            x = torch.from_numpy(x64).to(dev.policy.accum_dtype).cuda()
            plain = K.spmv_plain(dev, x)
            y = torch.empty_like(plain)
            stream = torch.cuda.current_stream().cuda_stream
            calls = {}
            for key, lib in builds.items():
                t, p = key[:2]
                measured_only = any("STREAM_ONLY" in f or "PROBE" in f for f in key[2])
                blocks = torch.from_numpy(K.row_blocks(a.indptr, t * p, t)).cuda()
                fn = getattr(lib, K._ENTRY[policy])

                def call(fn=fn, blocks=blocks):
                    rc = fn(0, blocks.numel() - 1, blocks.data_ptr(), dev.indptr.data_ptr(),
                            dev.indices.data_ptr(), dev.vals.data_ptr(), x.data_ptr(),
                            y.data_ptr(), stream)
                    if rc != 0:
                        raise RuntimeError(f"launch failed: cudaError {rc}")

                call()
                torch.cuda.synchronize()
                err = float((y.double() - plain.double()).abs().max() / plain.double().abs().max())
                if not measured_only and not err <= 2e-5:
                    raise AssertionError(f"{mname} {policy} {t}x{p}: error {err:.3e}")
                calls[key] = (call, blocks.numel() - 1)
            times = {(key, flush): [] for key in calls for flush in ("write", "read")}
            for _ in range(args.rounds):
                for flush in ("write", "read"):
                    got = kernel_times([call for call, _ in calls.values()], KERNEL, reps=10,
                                       flush=flush)
                    for key, t in zip(calls, got):
                        times[key, flush] += t
            nbytes = spmv_csr_sol_bytes(a.shape[0], a.shape[1], a.nnz, dev.vals.element_size(),
                                        x.element_size())
            bound = nbytes / 3.35e12
            for key, (_, nblocks) in calls.items():
                med, clean = (float(np.median(times[key, f])) for f in ("write", "read"))
                print(f"[tune] {card} | {mname} {policy} {_label(key)} "
                      f"blocks={nblocks} kernel {med * 1e6:.2f} us "
                      f"(min {min(times[key, 'write']) * 1e6:.2f}), bound {bound * 1e6:.2f} us, "
                      f"share {100 * bound / med:.1f}%; L2 flushed by reads: {clean * 1e6:.2f} us, "
                      f"share {100 * bound / clean:.1f}%", flush=True)


if __name__ == "__main__":
    main()
