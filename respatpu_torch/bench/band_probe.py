"""Build the band kernels, check each
against its plain version on a few shapes, and time them at the main path's
shape (P = 128, nb = 812, ml = mu = 18: the 2cubes_sphere stand-in's band).

    python -m respatpu_torch.bench.band_probe [--nb 812] [--m 18]

It ends with one factorization of a band of that shape under the profiler:
wall time, the card's busy time, and the busy time by kernel name.

Needs a CUDA card. A first, short run on the card for a new build of
``csrc/band_lu.cu``; ``chip_smoke.py`` holds the full checks.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..kernels import _build
from ..kernels import bandlu as B
from ..precision import get_policy
from ..timing import busy_by_name, card_line, device_events
from .synth import laplacian_2d, random_banded


def _events(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def synthetic_factor(nb, m, p, policy, seed=0) -> B.DeviceBand:
    """A band shaped like a factor: small off-diagonal entries, diagonal
    blocks close to the identity, so both sweeps are well conditioned."""
    policy = get_policy(policy)
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = (2 * m + 1) * p
    data = torch.randn((nb, p, w), generator=g, device="cuda", dtype=torch.float32) * (0.5 / w)
    data[:, :, m * p:(m + 1) * p] += torch.eye(p, device="cuda")
    return B.with_inverses(B.DeviceBand(n=nb * p, p=p, ml=m, mu=m, policy=policy,
                                        data=data.to(policy.dtype)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--nb", type=int, default=812)
    ap.add_argument("--m", type=int, default=18)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("band_probe needs a CUDA card")
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.load()
    print(f"[build] kernels ready in {time.perf_counter() - t0:.1f} s", flush=True)

    # block LU against its plain version
    rng = np.random.default_rng(0)
    for p in (16, 32, 128):
        for dt, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-5), (torch.float64, 1e-13)):
            blk = rng.standard_normal((3, p, p)) + 4 * np.sqrt(p) * np.eye(p)
            blk[1, 3, 3] = 0.0
            blk[2, 5, 5] = -1e-9
            x = torch.from_numpy(blk).to(dt).cuda()
            eps = 1e-4 if dt != torch.float64 else 1e-13
            lu, cnt = B.block_lu(x, eps)
            torch.cuda.synchronize()
            ref, rcnt = B.block_lu_plain(x, eps)
            err = float((lu - ref).abs().max() / ref.abs().max())
            same = torch.equal(lu, B.block_lu(x, eps)[0])
            print(f"[block_lu] P={p} {dt}: err {err:.2e} counts {cnt.tolist()} vs "
                  f"{rcnt.tolist()} bitwise twice {same}", flush=True)
            if err > tol or not torch.equal(cnt, rcnt) or not same:
                raise AssertionError("block_lu disagrees with its plain version")

    # sweeps against their plain version on real factors
    for a, p in ((random_banded(300, 40, 6, seed=1), 16), (laplacian_2d(40, 23), 32),
                 (random_banded(1000, 300, 9, seed=2), 128)):
        for policy, tol in (("fp32", 2e-5), ("fp32_ftz", 2e-5), ("bf16", 2e-5), ("fp64", 1e-12)):
            lu = B.band_lu(B.csr_to_device_band(a, policy, "cuda", p=p)).lu
            b = torch.from_numpy(rng.standard_normal(lu.nb * p)).to(lu.policy.accum_dtype).cuda()
            for fwd in (True, False):
                y = B.band_sweep(lu, b, fwd)
                torch.cuda.synchronize()
                ref = B.band_sweep_plain(lu, b, fwd)
                err = float((y - ref).abs().max() / ref.abs().max())
                same = torch.equal(y, B.band_sweep(lu, b, fwd))
                print(f"[sweep] n={a.nrows} P={p} nb={lu.nb} ml={lu.ml} mu={lu.mu} {policy} "
                      f"{'fwd' if fwd else 'bwd'}: err {err:.2e} bitwise twice {same}", flush=True)
                if not err <= tol or not same:
                    raise AssertionError("band_sweep disagrees with its plain version")

    # times at the main path's shape
    p = 128
    for dt in (torch.float32, torch.float64):
        blk = torch.from_numpy(rng.standard_normal((1, p, p)) + 50 * np.eye(p)).to(dt).cuda()
        ms = _events(lambda: B.block_lu(blk, 1e-6))
        pl = _events(lambda: B.block_lu_plain(blk, 1e-6), reps=3)
        lib = _events(lambda: torch.linalg.lu_factor(blk[0], pivot=False))
        print(f"[time] {card} | block_lu P=128 {dt}: kernel {ms * 1e3:.1f} us, plain "
              f"{pl * 1e3:.1f} us, lu_factor(pivot=False) {lib * 1e3:.1f} us", flush=True)
    for policy in ("fp32", "bf16", "fp64"):
        lu = synthetic_factor(args.nb, args.m, p, policy)
        b = torch.ones(lu.nb * p, dtype=lu.policy.accum_dtype, device="cuda")
        nbytes = lu.data.numel() * lu.data.element_size()
        for fwd in (True, False):
            ms = _events(lambda: B.band_sweep(lu, b, fwd), reps=10)
            print(f"[time] {card} | band_sweep {'fwd' if fwd else 'bwd'} {policy} nb={lu.nb} "
                  f"m={args.m}: kernel {ms:.3f} ms; the band is {nbytes / 1e9:.2f} GB", flush=True)
        t0 = time.perf_counter()
        ref = B.band_sweep_plain(lu, b, True)
        torch.cuda.synchronize()
        pl = time.perf_counter() - t0
        err = float((B.band_sweep(lu, b, True) - ref).abs().max() / ref.abs().max())
        print(f"[time] {card} | band_sweep fwd {policy} plain {pl * 1e3:.1f} ms (host clock), "
              f"kernel vs plain err {err:.2e}", flush=True)
        del lu

    # what the parts of a sweep cost: builds that leave one part out (their
    # results are wrong; only their times are read): NO_TRI the product with
    # the inverse block, NO_DIAG the inverse block's load, NEAR_ONLY every
    # panel but the nearest
    lu = synthetic_factor(args.nb, args.m, p, "fp32")
    b = torch.ones(lu.nb * p, device="cuda")
    out = torch.empty_like(b)
    for flags in ((), ("-DRESPA_SWEEP_NO_TRI",), ("-DRESPA_SWEEP_NEAR_ONLY",),
                  ("-DRESPA_SWEEP_NO_DIAG", "-DRESPA_SWEEP_NO_TRI"),
                  ("-DRESPA_SWEEP_NO_DIAG", "-DRESPA_SWEEP_NO_TRI", "-DRESPA_SWEEP_NEAR_ONLY")):
        lib = _build.build(flags)

        def call():
            mail = torch.zeros(2 * lu.nb * p, dtype=torch.int32, device="cuda")
            rc = lib.respa_band_sweep_fwd_f32(0, lu.nb, p, lu.ml, lu.mu, lu.data.data_ptr(),
                                              lu.inv.data_ptr(), b.data_ptr(), out.data_ptr(),
                                              mail.data_ptr(),
                                              torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"launch failed: cudaError {rc}")

        print(f"[parts] {card} | band_sweep fwd fp32 nb={lu.nb} m={args.m} built with "
              f"{' '.join(flags) or 'no flags'}: {_events(call, reps=10):.3f} ms", flush=True)
    del lu

    # where one factorization's time goes
    for policy in ("fp32", "fp64"):
        band = synthetic_factor(args.nb, args.m, p, policy)
        band.data[:, :, args.m * p:(args.m + 1) * p] += 3 * torch.eye(p, device="cuda")
        B.band_lu(band)
        torch.cuda.synchronize()
        wall = [0.0]

        def factor():
            t0 = time.perf_counter()
            B.band_lu(band)
            torch.cuda.synchronize()
            wall[0] = time.perf_counter() - t0

        factor()
        plain_wall = wall[0]
        events = device_events(factor)
        busy = sum(t for _, t in events)
        print(f"[factor] {card} | {policy} nb={args.nb} m={args.m}: wall {plain_wall * 1e3:.1f} ms "
              f"({wall[0] * 1e3:.1f} ms under the profiler), device busy {busy * 1e3:.1f} ms in "
              f"{len(events)} records", flush=True)
        for key, n, tot in busy_by_name(events):
            print(f"[factor]   {key}: {n} x {tot / n * 1e6:.1f} us = {tot * 1e3:.2f} ms", flush=True)
        del band


if __name__ == "__main__":
    main()
