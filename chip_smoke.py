#!/usr/bin/env python3
"""Smoke run of respatpu_torch's main path on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. device: requires CUDA, prints the card's name and power limit, keeps TF32 off;
2. build: compiles the CUDA kernels (one compiler process a source, started
   together) and the host library (Matrix Market parser, RCM ordering) from
   the checkout's sources, and reads a file through the parser;
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
5. band kernels vs plain: the block-LU kernel against ``block_lu_plain`` bit
   for bit on diagonally dominant blocks and blocks with planted zero, tiny
   and exactly-eps pivots, and blocks that send fp32's fast division back to
   ``__fdiv_rn`` (numerators of 2^-70 and 2^70, a pivot of 2^65) (P in 5,
   16, 32 (a warp a block), 100 and 128 (panels); 1 and 10 blocks; read in
   place from a band and contiguous; fp32, fp32_ftz, fp64 and bf16 input),
   and the sweep
   kernel against ``band_sweep_plain`` on factored bands (one block row,
   ml != mu, n not a multiple of P, ml = nb, all four instances), and on each
   with perturbed pivots planted in its diagonal blocks, each twice,
   bitwise equal; the same bands through K10 (several right-hand sides, 37
   of them, tiles of 32 columns, against ``band_sweep_plain``; from
   ``first_row`` bit for bit with the sweep from row 0) and K11 (the
   transposed sweeps, against ``band_sweep_t_plain``, on each band and with
   the perturbed pivots), each twice bit for bit;
6. direct path at full width: ``factorize(a, "fp32", method="auto")`` and
   ``solve_refined`` on the 2cubes_sphere stand-in at catalogue size, with
   the launch counts of the block-LU, sweep and fp64 SpMV kernels, the host
   oracle's residual and the error against the known solution; then the fp64
   factorization and direct solve of the same matrix, bf16 and fp32_ftz with
   refinement on a 300 x 300 grid Laplacian; then, on each of these four
   factors, a solve of 4 right-hand sides at once (K10) and ``condest``
   (its transposed solves on K11); the phase times; beside the path each
   estimate against the one the plain transposed solves give (within 2x),
   the band kernels timed at the full-width shapes beside bound, library and
   plain (K11 on the band of nb = 812 in every instance, held to plain and
   beside the torch-op loop it replaced; K10 at SPIKE's tips' shape, one
   partition of 2cubes_sphere with 2,304 right-hand sides (tiles of 128
   columns with row slots), beside ``solve_triangular`` on the dense
   partition, and in its few-column regime, a 4-column solve on the band of
   nb = 812 beside four one-column K2 solves in turns); the warm fp32
   factorization under the profiler (wall, busy, K1's share, busy by
   kernel); the
   block-LU kernel beside its first version in turns (``bench/csrc/
   smoke_probes.cu``, bit for bit with plain too) and beside its chain bound,
   128 pivots times one block barrier with a shared-memory hand-over (a probe
   there), and a block's arithmetic at one SM's share of the peak;
7. frontal kernels vs plain: extend-add, the forward and backward frontal
   sweep, its transposed form (K12) and the row reduction against their
   plain versions on synthetic
   groups in each of the sweep's regimes (one front; a parent with hundreds
   of children in one group; 2,000 fronts of pivot width 8 and 32; roots
   with no update rows; widths 24 and 128; a 6,144-row panel over many
   blocks; widths 192 to 2,048 with 0 to 384 update rows; fp32, fp32_ftz
   with subnormal inputs, fp64), each twice, bitwise equal, y's spare slot
   untouched; the extend-add (in both of its regimes, and on a hub parent of
   300 children) and the reduction bit for bit with plain;
8. multifrontal path at full width: the dc1 stand-in at catalogue size
   through ``factorize(a, "fp32", method="auto")`` (band refuses, the
   multifrontal LU serves with GESP matching) and ``solve_refined`` to a
   host-oracle residual <= 1e-10; 2cubes_sphere with ``method="snlu"`` in
   fp32 with refinement and in fp64 without; fp32_ftz on the grid Laplacian;
   offshore through ``auto``; ``condest`` of the dc1, 2cubes_sphere fp64 and
   Laplacian factors (their transposed solves on K12); with the launch counts
   of the block-LU, extend-add, sweep, transposed sweep, reduction and fp64
   SpMV kernels and twice-factored pools compared bit for bit; then, beside
   the path, each estimate against the plain transposed solves' (within 2x),
   every group of the dc1 fp32,
   2cubes_sphere fp64 and Laplacian fp32_ftz
   plans through each frontal kernel and its plain version on the same
   inputs (the factored pool bit for bit with the plain extend-add in the
   kernel's place, and with the extend-add's row regime in every group; a
   solve and a transposed solve walked group by group),
   and the frontal kernels timed at the full-width group
   shapes (the most populous group, the tallest panel, the widest front)
   beside bound, library (the library route for a sweep) and plain, the
   extend-add in its other regime too, the
   block LU at the populous group and the widest front beside its first
   version; and two
   solves of dc1's plan on two streams at once against the sequential ones;
   last the warm 2cubes_sphere fp64 and dc1 fp32 factorizations under the
   profiler (busy time, K1's and K3's shares);
9. ILU(0) path: the link probe (the card's one-way hand-over through L2,
   which times a triangle's levels gives its chain bound); the Chow-Patel
   sweep kernel and the one-launch triangular solve against their plain
   versions, each twice and bit for bit in every instance, on synthetic
   shapes (empty rows, a 50,000-entry hub row, a bidiagonal chain of 100,000
   levels, one level of 100,000 rows; lower and upper, unit and zero
   diagonal; subnormal inputs under fp32_ftz; y[n] untouched; the chain
   and the one level timed beside their chain bound (the hand-overs their
   schedule makes, times the link probe), and beside the solve's other way
   to wait, on ready values (checked too); the chain's schedule timed on the
   host; two solves on two streams at once); then ``runner.sweep_ilu0``
   on the 2cubes_sphere stand-in at catalogue size in fp32 with the default 8
   sweeps (reported), then with 30 in fp32 (Jacobi applies) and fp64 (exact
   applies), both refined to a host-oracle residual of 1e-10,
   the dc1 stand-in in fp32 (``stagnated`` is an outcome, not a failure),
   and CG and BiCGSTAB with ILU(0) on a 300 x 300 grid Laplacian (BiCGSTAB
   with the exact applies under fp32, fp32_ftz and bf16 too), with the launch
   counts of both kernels and the SpMV kernel; then, beside the path, both
   kernels bit for bit with plain at the path's shapes (one sweep of
   2cubes_sphere's factorization, its L and U solves) and timed there beside
   bound (bytes, and for K7 the chain bound too), library
   (``torch.triangular_solve`` on a sparse CSR tensor) and plain; K7 beside
   its other way to wait, with L's and U's schedule timed on the host; one
   Jacobi and one exact apply whole, and one GMRES solve under the profiler;
   the grid Laplacian's products there take the DIA kernel (phase 12);
10. exact ILU(0) by the scheduled LU (K8, ``kernels/csrc/splu.cu``): the
   2cubes_sphere ``sweep_ilu0`` rows with ``method="scheduled"`` (fp64 with
   the exact applies, fp32 with Jacobi applies), each GMRES(40) refined on
   the host to 1e-10, and BiCGSTAB with exact ILU(0) on the grid Laplacian
   under fp32_ftz and bf16, with the launch counts; beside the path, the
   plan's entry levels and tasks with their host time, K8 in every instance
   bit for bit with its plain version on 2cubes_sphere's ILU(0) and timed
   beside its byte and chain bounds and its value gathers against the L2
   read rate (a probe in ``bench/csrc/smoke_probes.cu``), K8 in fp32_ftz
   and bf16 bit for bit with plain on the grid Laplacian's ILU(0) (the
   BiCGSTAB rows' shape), and the exact factor against the 30-sweep
   Chow-Patel one;
11. the direct scheduled LU at full width: laplacian_2d(300, 300) by
   ``factorize(method="sparse")`` (313.9 M pairs) in fp32 refined to 1e-10
   and in fp64, its phase times, fill, pairs, levels, pivots and the ragged
   against the padded pair lists; ``auto`` reaching its third step on a grid
   that band and the multifrontal LU are made to refuse; beside the path,
   ``condest`` once and K8 bit for bit with plain on the filled pattern in
   every instance, timed beside its byte and chain bounds and in us a level;
12. the DIA path: ``sweep_spmv`` on the ecology2 and tmt_unsym stand-ins at
   catalogue size through ``fmt="auto"`` (DIA, K9 in ``kernels/csrc/dia.cu``)
   with fp64 and each low precision, past the DIA byte gate, with the launch
   counts; beside the path, K9 bit for bit with its plain version in every
   instance on both grids and on ecology2 with 2,000 stragglers (the
   remainder summed inside K9), timed beside its byte bound, K0 on the same
   matrix and ``torch.mv`` on a sparse CSR tensor; and on the stragglers
   case beside the remainder's other design (K0 on the remainder, then K9
   adding its product: ``bench/csrc/smoke_probes.cu``, built with the
   kernels), equal bit for bit;
13. persistence: dc1's multifrontal fp32 factor from phase 8 saved, loaded
   back onto K7 triangles that hold ``factor_values()`` bit for bit, and
   refined through GMRES-IR to 1e-10 by the host oracle; laplacian_2d(300,
   300)'s scheduled factors from phase 11 (fp32, fp64) and its band factor
   (fp32) saved and loaded, each loaded solve equal to the live one bit for
   bit and refined; an fp64 multifrontal factor forced onto its frontal pool
   (no device memory granted to its triangles), which stays fp64; each with its save and load
   seconds and file bytes, and the path's launch counts;
14. the precision study: ``attempt_fetch`` timed with the download refused
   at once (nothing in this script opens a connection), then
   ``study.run_study`` on 2cubes_sphere at catalogue size (the band path,
   five configurations) and on dc1 cut to 100,000 entries by the multifrontal
   LU, every row and ``summarize``'s JSON printed; any status but ``ok`` (or
   ``stagnated`` for dc1's bf16+ir), a 2cubes_sphere ``+ir`` row above 1e-12,
   or a kernel of the band or frontal path not launched fails the run;
15. the distributed stack, 4 shards on the card (``dist.make_mesh(4,
   "cuda:0")``): ``DistSpmv`` on offshore in fp32 and fp64 against the
   single-card K0 (1e-6 / 1e-14 in the inf-norm; bit-equality reported; two
   calls bit for bit; the bytes exchanged a call), ``dist_cg`` on ecology2's
   stand-in, ``runner.sweep_ilu0_dist`` on ecology2 (must be ``ok`` at
   1e-10) and 2cubes_sphere (reported), SPIKE (``dist_lu.DistBandLu``,
   natural order) on 2cubes_sphere factored twice bit for bit (its tips on
   K10, their seconds printed), solved for one and for 4 right-hand sides
   and refined to 1e-10, the subtree-sharded LU on 2cubes_sphere factored twice bit for bit,
   refined to 1e-10, saved, loaded and solved, its factor against the
   single-card pool of the same partition, and ``measure_scaling`` on
   offshore at 1, 2 and 4 shards (not a scaling: one card); any failed gate
   or a kernel of the path (K0 f32 and f64, K1, K2, K3, K4, K5, K6, K10) not
   launched fails the run; every result's SHA-256 is kept for phase 16;
16. the distributed stack over processes: two workers of this script
   (``--rank-worker``), ranks of a process group (``dist.init_distributed``,
   a store in a temporary file) on the card, 2 shards each, so 4 shards over
   2 ranks, through gloo and the host (NCCL with a card a rank, where there
   are as many): phase 15's path without the 2cubes_sphere sweep row,
   persistence and scaling, every result equal to phase 15's bit for bit
   on both ranks, and every kernel of the path launched in each; then one
   shard a rank: respatpu's psum check (1 + 2 = 3 on both ranks) and the
   offshore ``DistSpmv`` and ``dist_cg`` bit for bit with
   ``make_mesh(2, "cuda:0")``; the ranks' times beside phase 15's; a
   worker's failure, timeout or mismatch fails the run;
17. result: a JSON line of the kernels (with their launches on the study,
   persistence and distributed paths, and in each worker of phase 16), then
   the device line last.

Each phase prints its seconds on a line of its own (``[phase] k took``).
Every ``*_plain`` function of the port is wrapped in a call counter
(:func:`count_plain_calls`): the holds and comparisons beside a path may
call plain versions (:func:`held`), a path may not, and each path's end, and
each worker of phase 16, fails the run if one did.

Four measurements run alone, each in processes of its own:
``python3 chip_smoke.py --ilu-times`` takes phase 9's timings at the path's
shapes, with K6 beside its other designs (``bench/csrc/ilu0_designs.cu``:
evict-first or plain loads, the first version, warp-cooperative gathers;
each == plain bit for bit) in 3 rounds (:func:`time_ilu_alone`);
``python3 chip_smoke.py --splu-times`` times K8 at the path's two shapes
with its plan cut at several pair budgets (:func:`time_splu_alone`);
``python3 chip_smoke.py --ilu-rows TREE ...`` runs only the 2cubes_sphere
``sweep_ilu0`` rows at 30 sweeps of each tree in turn
(:func:`ilu_rows_in_turns`), to compare two commits on one card in one call;
``python3 chip_smoke.py --upload-times TREE ...`` times each tree's upload of
the offshore and ecology2 stand-ins the same way (:func:`upload_times_in_turns`);
``python3 chip_smoke.py --phase-times TREE ...`` times phases 6, 10 and 11 of
each tree the same way (:func:`phase_times_in_turns`).
``python3 chip_smoke.py --dist`` builds the kernels and runs phase 15 alone;
``python3 chip_smoke.py --band`` builds them (and the probes) and runs K1's,
K10's and K11's checks and phase 6 alone;
``python3 chip_smoke.py --ranks`` builds them, runs phase 15's shared path
on one process for the reference, and then phase 16;
``python3 chip_smoke.py --before`` builds them and the probes and times K8
beside its first version at the Laplacian's fill and 2cubes_sphere's ILU(0),
and K2, K11 and K3 beside their first versions, in turns (:func:`before_path`),
and traces each warm factorization with the first versions of K1 and K3 in
their place and with the package's.
"""
import contextlib
import ctypes
import dataclasses
import functools
import hashlib
import inspect
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from respatpu_torch import io as rio  # noqa: E402
from respatpu_torch._buildlib import build_shared  # noqa: E402
from respatpu_torch import persist  # noqa: E402
from respatpu_torch import timing  # noqa: E402
from respatpu_torch.bench import corpus, fetch, runner, study  # noqa: E402
from respatpu_torch import solve as slv  # noqa: E402
from respatpu_torch.bench.synth import (circuit_like, frontal_group, laplacian_2d,  # noqa: E402
                                        mesh_fem_3d, random_banded, row_block_edges,
                                        skew_banded)
from respatpu_torch.formats import COOMatrix, CSRMatrix, coo_to_csr, split_triangular  # noqa: E402
from respatpu_torch.io import native  # noqa: E402
from respatpu_torch.kernels import _build  # noqa: E402
from respatpu_torch import analysis  # noqa: E402
from respatpu_torch.kernels import bandlu as B  # noqa: E402
from respatpu_torch.kernels import dia as DI  # noqa: E402
from respatpu_torch.kernels import ilu0 as I  # noqa: E402
from respatpu_torch.kernels import splu as SP  # noqa: E402
from respatpu_torch.kernels import sptrsv as S  # noqa: E402
from respatpu_torch.kernels import snlu_device as F  # noqa: E402
from respatpu_torch.kernels import spmv as K  # noqa: E402
from respatpu_torch.precision import ftz, get_policy  # noqa: E402
from respatpu_torch.solve import WARMUP  # noqa: E402
from respatpu_torch.timing import (OpTiming, ProfilerUnavailable, busy_by_name,  # noqa: E402
                                   card_line, check_plausible, device_bandwidth,
                                   device_events, kernel_times, spmv_csr_sol_bytes, time_op)

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
# The band kernels (csrc/band_lu.cu): what each replaces, and the card's
# published peak for each type (NVIDIA's H100 SXM data sheet): fp32 outside
# the tensor cores (no TF32), fp64 on its tensor cores (DMMA).
BAND_SOURCE = "respatpu_torch/kernels/csrc/band_lu.cu"
LU_REPLACES = "respatpu/kernels/dflinalg.py:43"
SWEEP_REPLACES = "respatpu/kernels/bandlu.py:284"
FLOPS_PER_S = {torch.float32: 67e12, torch.float64: 67e12}
INST = {"fp32": "f32", "fp32_ftz": "f32_ftz", "bf16": "bf16", "fp64": "f64"}
# max|kernel - plain| / max|plain|: the block LU takes the plain version's
# operations in the plain version's order; the sweep sums in another order
LU_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-5, torch.float64: 1e-13}
SWEEP_TOL = {"fp32": 2e-5, "fp32_ftz": 2e-5, "bf16": 2e-5, "fp64": 1e-12}
# K10, several right-hand sides (csrc/band_multi.cu), and K11, the transposed
# sweeps (csrc/band_lu.cu): what each replaces. respatpu's transposed band
# solve is its band factor's CSR through two sptrsv triangles.
MULTI_SOURCE = "respatpu_torch/kernels/csrc/band_multi.cu"
T_REPLACES = "respatpu/solve.py:317"
NEW_BAND = tuple(n for n in B.LAUNCHES if "_multi_" in n or "_sweep_t_" in n)
NEW_FRONT = tuple(n for n in F.LAUNCHES if "_sweep_t_" in n)
TIPS_NRHS = 2_304  # SPIKE's tips on 2cubes_sphere: mu * p = ml * p columns
TIPS_NB = 203  # block rows a shard, 4 shards
# The frontal kernels (csrc/frontal.cu) and what each replaces. The extend-add
# and the reduction add in their plain versions' order; the sweeps' triangles
# and panel products are summed in another order than the library's.
FRONTAL_SOURCE = "respatpu_torch/kernels/csrc/frontal.cu"
FRONTAL_REPLACES = {"extend_add": "respatpu/kernels/snlu_device.py:373",
                    "front_sweep_fwd": "respatpu/kernels/snlu_device.py:467",
                    "front_sweep_bwd": "respatpu/kernels/snlu_device.py:490",
                    "rows_reduce": "respatpu/kernels/snlu_device.py:486",
                    "front_sweep_t_fwd": "respatpu/kernels/snlu_device.py:513",
                    "front_sweep_t_bwd": "respatpu/kernels/snlu_device.py:537"}
FRONT_TOL = {torch.float32: 2e-5, torch.float64: 1e-12}
# where a front amplifies rounding past FRONT_TOL: the kernel's distance from
# the fp64 result of the same inputs, in units of the plain version's
AMPLIFIED = 4.0
FRONT_INST = ((torch.float32, False, "f32"), (torch.float32, True, "f32_ftz"),
              (torch.float64, False, "f64"))
# The ILU(0) path's kernels and what each instance replaces: the Chow-Patel
# sweep (csrc/ilu0.cu) and the triangular solve (csrc/sptrsv.cu), whose
# single-word instances replace respatpu's blocklet solve and fp64 its
# double-float one. Both hold their plain versions bit for bit.
ILU_SOURCE = "respatpu_torch/kernels/csrc/ilu0.cu"
TRI_SOURCE = "respatpu_torch/kernels/csrc/sptrsv.cu"
ILU_POLICIES = {"f32": "fp32", "f32_ftz": "fp32_ftz", "bf16": "bf16", "f64": "fp64"}
ILU_REPLACES = {i: "respatpu/kernels/ilu0.py:123" if i == "f64" else "respatpu/kernels/ilu0.py:91"
                for i in ILU_POLICIES}
TRI_REPLACES = {i: "respatpu/kernels/sptrsv.py:280" if i == "f64"
                else "respatpu/kernels/sptrsv.py:315" for i in ILU_POLICIES}
# K6's other designs, timed beside it in rounds (bench/csrc/ilu0_designs.cu)
SPLU_SOURCE = "respatpu_torch/kernels/csrc/splu.cu"
DIA_SOURCE = "respatpu_torch/kernels/csrc/dia.cu"
SPLU_REPLACES = {i: "respatpu/kernels/splu.py:248" if i == "f64" else "respatpu/kernels/splu.py:205"
                 for i in ILU_POLICIES}
DIA_REPLACES = {i: "respatpu/kernels/dia.py:137" if i == "f64" else "respatpu/kernels/dia.py:126"
                for i in ILU_POLICIES}
GRIDS = ("ecology2", "tmt_unsym")  # the 5-point stencil stand-ins of the moderate group
ILU_DESIGNS_SOURCE = "respatpu_torch/bench/csrc/ilu0_designs.cu"
# K9's other remainder design and the L2 read probe (bench/csrc/smoke_probes.cu)
PROBES_SOURCE = "respatpu_torch/bench/csrc/smoke_probes.cu"
ILU_DESIGNS = ("body, evict-first", "body, plain loads", "first version",
               "warp-cooperative, 32 pairs a step", "warp-cooperative, 64 pairs a step")
# the sweeps' __global__ functions by (regime, forward, transposed), as the
# profiler names them: K4's, and K12's of its own
SWEEP_KERNELS = {("warp", True, False): "front_fwd_warp", ("warp", False, False): "front_bwd_warp",
                 ("block", True, False): "front_fwd_block",
                 ("block", False, False): "front_bwd_block",
                 ("wide", True, False): "front_wide_kernel",
                 ("wide", False, False): "front_wide_kernel",
                 ("warp", True, True): "front_fwd_warp_t", ("warp", False, True): "front_bwd_warp_t",
                 ("block", True, True): "front_fwd_block_t",
                 ("block", False, True): "front_bwd_block_t",
                 ("wide", True, True): "front_wide_t_kernel",
                 ("wide", False, True): "front_wide_t_kernel"}


# Calls of the port's plain versions outside the holds: none may happen. The
# paths run on the card and must reach only kernels; a hold compares a kernel
# with its plain version and is allowed to call it (``held``).
PLAIN_CALLS = {}
_HOLDING = [0]


def count_plain_calls():
    """Wrap every ``*_plain`` function of the port's kernel modules in a
    counter of the calls made outside a :func:`held` function. The wrappers
    reach their plain versions through their module, so the wrapped one is
    what a path would run."""
    for mod in (B, F, I, K, S, SP, DI):
        for name in dir(mod):
            fn = getattr(mod, name)
            if not name.endswith("_plain") or not callable(fn) or hasattr(fn, "_counted"):
                continue
            key = f"{mod.__name__.rsplit('.', 1)[-1]}.{name}"
            PLAIN_CALLS[key] = 0

            def counted(*args, _fn=fn, _key=key, **kwargs):
                if not _HOLDING[0]:
                    PLAIN_CALLS[_key] += 1
                return _fn(*args, **kwargs)

            counted._counted = True
            setattr(mod, name, functools.wraps(fn)(counted))


def held(fn):
    """A hold or comparison beside a path: its plain calls are not counted."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        _HOLDING[0] += 1
        try:
            return fn(*args, **kwargs)
        finally:
            _HOLDING[0] -= 1
    return run


def no_plain(where):
    """Fails if a plain version of the port ran outside a hold."""
    ran = {k: v for k, v in PLAIN_CALLS.items() if v}
    if ran:
        raise AssertionError(f"{where}: plain versions ran on the card: {ran}")
    print(f"[plain] {where}: no plain version ran outside the holds "
          f"({len(PLAIN_CALLS)} counted)", flush=True)


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


@held
def check_kernel(name, a, policy, x64, errs):
    dev = K.to_device(a, policy, "cuda", fmt="csr")
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


@held
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
    dev = K.to_device(s, "fp32_ftz", "cuda", fmt="csr")
    x = x_for(dev, x64)
    y, plain = K.spmv(dev, x), K.spmv_plain(dev, x)
    if not torch.equal(y, plain):
        raise AssertionError("fp32_ftz: kernel != plain on subnormal inputs")
    # every product here is 1e-20 * 1e-20 (subnormal in fp32): all rows flush
    tiny = CSRMatrix(a.shape, a.indptr, a.indices, np.full(a.nnz, 1e-20))
    xt = np.full(a.shape[1], 1e-20)
    dt = K.to_device(tiny, "fp32_ftz", "cuda", fmt="csr")
    yt, pt = K.spmv(dt, x_for(dt, xt)), K.spmv_plain(dt, x_for(dt, xt))
    d32 = K.to_device(tiny, "fp32", "cuda", fmt="csr")
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


@held
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
    elif dev.policy.name == "bf16":
        bf16_library(dev, x)
    out = {name: [] for name in fns}
    for name in order:
        out[name] += time_op(fns[name], "cuda", warmup=2, reps=10).times
    return out, {name: float(np.median(t)) for name, t in out.items()}


def bf16_library(dev, x):
    """Whether PyTorch's sparse CSR product takes bf16 values times the fp32
    x (the kernel's function); if not, why, and the time of bf16 values
    times x rounded to bf16 (another function: printed, not used as the
    library's time)."""
    a_csr = torch.sparse_csr_tensor(dev.indptr.to(torch.int32), dev.indices, dev.vals,
                                    size=dev.shape)
    try:
        a_csr @ x
    except RuntimeError as e:
        why = str(e).splitlines()[0][:120]
    else:
        raise AssertionError("bf16 CSR @ fp32 x ran: time it as the library call")
    try:
        ms = events_ms(lambda: a_csr @ x.bfloat16(), 10)
        other = f"bf16 values @ bf16 x runs in {ms:.4f} ms (x and y rounded to bf16)"
    except RuntimeError as e:
        other = f"bf16 @ bf16 refused too: {str(e).splitlines()[0][:120]}"
    print(f"[time] bf16 library: none, torch refuses bf16 CSR @ fp32 x ({why}); {other}",
          flush=True)


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


@held
def check_block_lu(errs):
    """The block-LU kernel against its plain version, bit for bit; see the
    docstring."""
    rng = np.random.default_rng(11)
    for dt, flush in ((torch.float32, False), (torch.float32, True), (torch.bfloat16, False),
                      (torch.float64, False)):
        eps = 1e-13 if dt == torch.float64 else 2.0 ** -13  # exact in bf16 and fp32
        plants = [0.0, eps, eps / 2, -eps / 2, -eps, 2 * eps, None]
        name = "respa_block_lu_" + ("f64" if dt == torch.float64 else "f32_ftz" if flush
                                    else "f32")
        for p in (5, 16, 32, 100, 128):
            for nblocks in (1, 10):
                blk = rng.standard_normal((nblocks, p, 3 * p)) + np.tile(4 * np.sqrt(p) * np.eye(p), 3)
                for i in range(min(nblocks, len(plants))):
                    plant = plants[i if nblocks > 1 else 0]
                    if plant is not None:
                        blk[i, 0, p] = plant
                if nblocks == 10:  # fp32's fast division refused: its retry by __fdiv_rn
                    blk[7, p - 1, p] = 2.0 ** -70
                    blk[8, p - 1, p] = 2.0 ** 70
                    blk[9, p // 2, p + p // 2] = 2.0 ** 65
                if flush:
                    blk[:, 1, p + 2] = 1e-40  # a subnormal entry, flushed on load
                band = torch.from_numpy(blk).to(dt).cuda()
                for x in (band[:, :, p:2 * p], band[:, :, p:2 * p].contiguous()):
                    lu, cnt = B.block_lu(x, eps, flush)
                    torch.cuda.synchronize()
                    ref, rcnt = B.block_lu_plain(x, eps, flush)
                    again = B.block_lu(x, eps, flush)
                    planted = sum(pl is not None and abs(pl) <= eps
                                  for pl in plants[:nblocks if nblocks > 1 else 1])
                    if (not torch.equal(bits(lu), bits(ref)) or not torch.equal(cnt, rcnt)
                            or int(cnt.sum()) < planted
                            or not (torch.equal(lu, again[0]) and torch.equal(cnt, again[1]))):
                        err = float((lu - ref).abs().max()) / float(ref.abs().max())
                        raise AssertionError(f"{name} P={p} B={nblocks}: not bit for bit with "
                                             f"plain (rel err {err:.3e}), counts {cnt.tolist()} "
                                             f"vs plain {rcnt.tolist()}")
                    errs[name] = max(errs.get(name, 0.0), float((lu - ref).abs().max()))
                print(f"[kernel] {name:24s} {str(dt):15s} P={p:3d} B={nblocks} in-band and "
                      f"contiguous: bit for bit with plain, perturbed={int(cnt.sum())}, "
                      f"bitwise twice", flush=True)


def sweep_cases():
    """(name, matrix, P): one block row, ml != mu, n not a multiple of P,
    ml = nb, a grid Laplacian, and P = 128."""
    return [("one_block_row", random_banded(100, 30, 6, seed=1), 128),
            ("ml_ne_mu", skew_banded(500, 70, 20, 7, seed=2), 16),
            ("ml_ne_mu_32", skew_banded(700, 40, 130, 7, seed=3), 32),
            ("ml_eq_nb", random_banded(100, 99, 10, seed=4), 16),
            ("laplacian_2d", laplacian_2d(40, 23), 32),
            ("banded_p128", random_banded(1000, 300, 9, seed=5), 128)]


def planted_pivots(lu):
    """``lu`` with three of its diagonal blocks' pivots set to +-eps (1e-4
    times the largest entry, 1e-13 in fp64), as ``band_lu`` leaves a pivot it
    perturbs, and the inverses made anew: K2 applies inverses with large
    entries."""
    data = lu.data.clone()
    p = lu.p
    eps = (1e-13 if lu.policy.name == "fp64" else 1e-4) * float(lu.data.abs().max())
    for k, (r, i) in enumerate(((0, 1), (lu.nb // 2, p // 2), (lu.nb - 1, p - 3))):
        data[r, i, lu.ml * p + i] = eps if k % 2 else -eps
    return B.with_inverses(dataclasses.replace(lu, data=data))


@held
def check_band_sweep(errs):
    """The sweep kernel against its plain version on factored bands, and on
    each with perturbed pivots planted in its diagonal blocks
    (``planted_pivots``)."""
    rng = np.random.default_rng(12)
    for cname, a, p in sweep_cases():
        for policy in SWEEP_TOL:
            lu = B.band_lu(B.csr_to_device_band(a, policy, "cuda", p=p)).lu
            if cname == "ml_ne_mu" and lu.ml == lu.mu or cname == "ml_eq_nb" and lu.ml != lu.nb:
                raise AssertionError(f"{cname}: shape ml={lu.ml} mu={lu.mu} nb={lu.nb}")
            b = torch.from_numpy(rng.standard_normal(lu.nb * p)).to(lu.policy.accum_dtype).cuda()
            if policy == "fp32_ftz":
                b[::7] = 1e-40  # subnormal right-hand-side entries, flushed on load
            worst = {}
            for what, band in (("factor", lu), ("perturbed pivots", planted_pivots(lu))):
                for fwd in (True, False):
                    name = f"respa_band_sweep_{'fwd' if fwd else 'bwd'}_{INST[policy]}"
                    y = B.band_sweep(band, b, fwd)
                    torch.cuda.synchronize()
                    ref = B.band_sweep_plain(band, b, fwd)
                    err = float((y - ref).abs().max() / ref.abs().max())
                    if not (err <= SWEEP_TOL[policy]) or \
                            not torch.equal(bits(y), bits(B.band_sweep(band, b, fwd))):
                        raise AssertionError(f"{name} {cname} {what}: err {err:.3e} or not "
                                             "reproducible")
                    if what == "factor":
                        errs[name] = max(errs.get(name, 0.0), float((y - ref).abs().max()))
                    worst[what] = max(worst.get(what, 0.0), err)
            print(f"[kernel] band_sweep {cname:14s} {policy:8s} n={a.nrows} P={p} nb={lu.nb} "
                  f"ml={lu.ml} mu={lu.mu}: rel_err={worst['factor']:.3e}, with perturbed pivots "
                  f"{worst['perturbed pivots']:.3e} (tol {SWEEP_TOL[policy]:.0e}), bitwise twice",
                  flush=True)


def events_ms(fn, reps, setup=None):
    """Median milliseconds of ``fn`` by CUDA events, after one warm call;
    ``setup`` runs before each call, outside its window."""
    return time_op(fn, "cuda", warmup=1, reps=reps, setup=setup).median * 1e3


def profiler_ms(fn, name_part, reps, flush="write"):
    try:
        return float(np.median(kernel_times([fn], name_part, reps=reps, flush=flush)[0])) * 1e3
    except ProfilerUnavailable as e:
        print(f"[time] {name_part}: profiler time not measured ({e})", flush=True)
        return None


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def block_lu_direct(lib, name, x, eps, flush, out, count):
    """One launch of a block-LU entry point of ``lib`` (the package's or the
    probes' first version) on ``x`` into preallocated ``out`` and ``count``:
    no allocation in the timed window."""
    fn = getattr(lib, name)
    stream = torch.cuda.current_stream().cuda_stream
    sb, ld, _ = x.stride()

    def call():
        rc = fn(x.device.index, x.shape[0], x.shape[1], x.data_ptr(),
                int(x.dtype == torch.bfloat16), ld, sb, float(eps), out.data_ptr(),
                count.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    return call


def time_block_lu_at(name_limit, name, x, eps, flush, probes, what, library=True):
    """K1 on ``x`` (a batch of blocks, read in place) beside its first
    version (``respa_block_lu_before_*`` of the probes library) in turns:
    both bit for bit with plain, each by direct calls into preallocated
    outputs (events, median of 20), the package's by its wrapper too and by
    the profiler; bounds: bytes and operations at the card's rates (the
    contract's), and the operations at one SM's share of the peak (a block
    is one thread block's work)."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    nb, p = x.shape[0], x.shape[1]
    out = torch.empty((nb, p, p), dtype=acc, device=x.device)
    count = torch.empty(nb, dtype=torch.int32, device=x.device)
    new = block_lu_direct(_build.load(), name, x, eps, flush, out, count)
    before = block_lu_direct(probes, name.replace("block_lu_", "block_lu_before_"), x, eps,
                             flush, out, count)
    ref, rcnt = B.block_lu_plain(x, eps, flush)
    for fn in (new, before):
        fn()
        if not (torch.equal(bits(out), bits(ref)) and torch.equal(count, rcnt)):
            raise AssertionError(f"{name} at {what}: not bit for bit with plain")
    nbytes = nb * p * p * (x.element_size() + torch.empty(0, dtype=acc).element_size()) + 4 * nb
    flops = nb * 2 * p ** 3 / 3
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FLOPS_PER_S[acc] * 1e3
    with uncounted():
        turns = [events_ms(fn, 20) for fn in (new, before, before, new)]
        t = {"ms": events_ms(lambda: B.block_lu(x, eps, flush), 20),
             "kernel_ms": min(turns[0], turns[3]), "before_ms": min(turns[1], turns[2]),
             "profiler_ms": profiler_ms(lambda: B.block_lu(x, eps, flush), "block_lu", 10),
             "bound_ms": max(by_bytes, by_ops),
             "bound_by": "bytes" if by_bytes >= by_ops else "operations",
             "sm_bound_ms": flops / nb / (FLOPS_PER_S[acc] / sms) * 1e3,
             "shape": f"{what}: {nb} block(s) of {p} x {p}, row stride {x.stride(1)}"}
        if library:
            dense = x.contiguous()
            t["library_ms"] = events_ms(lambda: torch.linalg.lu_factor(dense, pivot=False), 20)
            t["plain_ms"] = events_ms(lambda: B.block_lu_plain(x, eps, flush), 2)
    print(f"[time] {name_limit} | {name} {t['shape']}: kernel {fmt_ms(t['kernel_ms'])} by "
          f"events (direct calls; first version {fmt_ms(t['before_ms'])} in turns, "
          f"{t['before_ms'] / t['kernel_ms']:.2f}x), {fmt_ms(t['ms'])} through the wrapper, "
          f"{fmt_ms(t['profiler_ms'])} by the profiler; bound {t['bound_ms'] * 1e3:.3f} us at "
          f"the card's rates ({nbytes} bytes, {flops:.0f} flops), a block's operations at one "
          f"SM's share {t['sm_bound_ms'] * 1e3:.3f} us"
          + (f"; library lu_factor(pivot=False) {fmt_ms(t['library_ms'])}; plain "
             f"{fmt_ms(t['plain_ms'])}" if library else ""), flush=True)
    return t


@held
def time_block_lu(name_limit, fac32, fac64, times, probes):
    """The block-LU kernel at the main path's shape: one diagonal block of
    128 read in place from the uploaded band, beside its first version."""
    for name, fac, flush in (("respa_block_lu_f32", fac32, False),
                             ("respa_block_lu_f32_ftz", fac32, True),
                             ("respa_block_lu_f64", fac64, False)):
        band = fac._dev
        p, ml = band.p, band.ml
        x = band.data[band.nb // 2][None, :, ml * p:(ml + 1) * p]
        eps = 1e-6
        lib_lu = torch.linalg.lu_factor(x[0].contiguous(), pivot=False)[0]
        ours = B.block_lu(x, eps, flush)[0][0]
        if float((lib_lu - ours).abs().max() / ours.abs().max()) > LU_TOL[x.dtype] * 50:
            raise AssertionError(f"{name}: lu_factor(pivot=False) disagrees with the kernel")
        times[name] = time_block_lu_at(name_limit, name, x, eps, flush, probes,
                                       "the band's diagonal block")


@held
def time_band_sweep(name_limit, lu, policy, times):
    """Both sweeps of one factored band at the main path's shape."""
    lu = as_policy(lu, policy)
    acc = lu.policy.accum_dtype
    b = torch.ones(lu.nb * lu.p, dtype=acc, device="cuda")
    vec = torch.empty(0, dtype=acc).element_size()
    for fwd in (True, False):
        name = f"respa_band_sweep_{'fwd' if fwd else 'bwd'}_{INST[policy]}"
        m = lu.ml if fwd else lu.mu
        # the panels a sweep reads: min(m, q) of them in row q, and the diagonal block
        blocks = sum(min(m, q) + 1 for q in range(lu.nb))
        nbytes = blocks * lu.p * lu.p * lu.data.element_size() + 3 * lu.nb * lu.p * vec
        flops = 2 * blocks * lu.p * lu.p
        by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FLOPS_PER_S[acc] * 1e3
        y = B.band_sweep(lu, b, fwd)
        t0 = time.perf_counter()
        ref = B.band_sweep_plain(lu, b, fwd)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = float((y - ref).abs().max() / ref.abs().max())
        if not err <= SWEEP_TOL[policy]:
            raise AssertionError(f"{name} at full width: err {err:.3e}")
        t = {"ms": events_ms(lambda: B.band_sweep(lu, b, fwd), 5), "plain_ms": plain_ms,
             "library_ms": None,
             "profiler_ms": profiler_ms(lambda: B.band_sweep(lu, b, fwd), "band_sweep_kernel", 5),
             "bound_ms": max(by_bytes, by_ops),
             "bound_by": "bytes" if by_bytes >= by_ops else "operations",
             "shape": f"nb={lu.nb} P={lu.p} ml={lu.ml} mu={lu.mu}", "max_abs_err_full": err,
             "inverse_bytes": lu.inv.numel() * lu.inv.element_size(),
             "band_bytes": lu.data.numel() * lu.data.element_size()}
        times[name] = t
        print(f"[time] {name_limit} | {name} {t['shape']}: kernel {fmt_ms(t['ms'])} by events, "
              f"{fmt_ms(t['profiler_ms'])} by the profiler; bound {t['bound_ms']:.4f} ms "
              f"({nbytes} bytes at 3.35 TB/s, the function's: the diagonal blocks, not the "
              f"inverses K2 reads in their place, {t['inverse_bytes']} bytes of both directions "
              f"beside the band's {t['band_bytes']}; {flops} flops would take {by_ops:.4f} ms); "
              f"library none; plain {plain_ms:.1f} ms (one run, synchronised host clock); "
              f"rel_err vs plain {err:.2e}", flush=True)


def bits(t):
    """A float tensor's bits, so that +0 and -0 differ."""
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


def as_policy(lu, policy):
    """A factored band read under ``policy``: its values cast to the
    policy's type (fp32_ftz shares fp32's values), and the inverses of its
    diagonal triangles, which K2 applies, made anew in that type."""
    pol = get_policy(policy)
    return B.with_inverses(dataclasses.replace(lu, policy=pol, data=lu.data.to(pol.dtype)))


@held
def check_band_multi(errs):
    """K10 against ``band_sweep_plain`` on the sweep cases in every instance,
    37 right-hand sides (a tile and a ragged one), forward and backward, each
    twice bit for bit; a forward sweep from ``first_row`` equals the one from
    row 0 bit for bit."""
    for cname, a, p in sweep_cases():
        for policy in SWEEP_TOL:
            lu = B.band_lu(B.csr_to_device_band(a, policy, "cuda", p=p)).lu
            acc = lu.policy.accum_dtype
            rng = np.random.default_rng(13)
            b = torch.from_numpy(rng.standard_normal((lu.nb * p, 37))).to(acc).cuda()
            if policy == "fp32_ftz":
                b[::7] = 1e-40  # subnormal right-hand-side entries, flushed on load
            worst = 0.0
            for fwd in (True, False):
                name = f"respa_band_sweep_multi_{'fwd' if fwd else 'bwd'}_{INST[policy]}"
                y = B.band_sweep_multi(lu, b, fwd)
                torch.cuda.synchronize()
                ref = B.band_sweep_plain(lu, b, fwd)
                err = float((y - ref).abs().max() / ref.abs().max())
                if not (err <= SWEEP_TOL[policy]) or \
                        not torch.equal(bits(y), bits(B.band_sweep_multi(lu, b, fwd))):
                    raise AssertionError(f"{name} {cname}: err {err:.3e} or not reproducible")
                errs[name] = max(errs.get(name, 0.0), float((y - ref).abs().max()))
                worst = max(worst, err)
            r0 = lu.nb // 2
            bz = b.clone()
            bz[:r0 * p] = 0
            if not torch.equal(bits(B.band_sweep_multi(lu, bz, True, r0)),
                               bits(B.band_sweep_multi(lu, bz, True))):
                raise AssertionError(f"K10 {cname} {policy}: first_row {r0} != from row 0")
            print(f"[kernel] band_sweep_multi {cname:14s} {policy:8s} n={a.nrows} P={p} "
                  f"nb={lu.nb} ml={lu.ml} mu={lu.mu} nrhs=37: rel_err={worst:.3e} (tol "
                  f"{SWEEP_TOL[policy]:.0e}) bitwise twice; from first_row {r0} == from row 0 "
                  f"bit for bit", flush=True)


@held
def check_band_t(errs):
    """K11 against ``band_sweep_t_plain`` on the sweep cases in every
    instance, forward (U^T) and backward (L^T), each twice bit for bit, on
    each factored band and on it with perturbed pivots planted in its
    diagonal blocks (``planted_pivots``: K11 applies their inverses too)."""
    for cname, a, p in sweep_cases():
        for policy in SWEEP_TOL:
            lu = B.band_lu(B.csr_to_device_band(a, policy, "cuda", p=p)).lu
            b = torch.from_numpy(np.random.default_rng(14).standard_normal(lu.nb * p))
            b = b.to(lu.policy.accum_dtype).cuda()
            if policy == "fp32_ftz":
                b[::7] = 1e-40
            worst = {}
            for what, band in (("factor", lu), ("perturbed pivots", planted_pivots(lu))):
                for fwd in (True, False):
                    name = f"respa_band_sweep_t_{'fwd' if fwd else 'bwd'}_{INST[policy]}"
                    y = B.band_sweep_t(band, b, fwd)
                    torch.cuda.synchronize()
                    ref = B.band_sweep_t_plain(band, b, fwd)
                    err = float((y - ref).abs().max() / ref.abs().max())
                    if not (err <= SWEEP_TOL[policy]) or \
                            not torch.equal(bits(y), bits(B.band_sweep_t(band, b, fwd))):
                        raise AssertionError(f"{name} {cname} {what}: err {err:.3e} or not "
                                             "reproducible")
                    if what == "factor":
                        errs[name] = max(errs.get(name, 0.0), float((y - ref).abs().max()))
                    worst[what] = max(worst.get(what, 0.0), err)
            print(f"[kernel] band_sweep_t {cname:14s} {policy:8s} n={a.nrows} P={p} nb={lu.nb} "
                  f"ml={lu.ml} mu={lu.mu}: rel_err={worst['factor']:.3e}, with perturbed pivots "
                  f"{worst['perturbed pivots']:.3e} (tol {SWEEP_TOL[policy]:.0e}), bitwise twice",
                  flush=True)


@contextlib.contextmanager
def recorded_multi():
    """Every K10 sweep that runs inside the block, as the path ran it:
    (band, a copy of b, forward, first_row, a copy of out), the copies taken
    on the launch's stream just after it."""
    calls = []
    launch = B.band_sweep_multi

    def record(lu, b, forward, first_row=0):
        out = launch(lu, b, forward, first_row)
        calls.append((lu, b.clone(), forward, first_row, out.clone()))
        return out

    B.band_sweep_multi = record
    try:
        yield calls
    finally:
        B.band_sweep_multi = launch


@contextlib.contextmanager
def uncounted():
    """Launches inside the block are taken back out of the counts."""
    counters = (B.LAUNCHES, K.LAUNCHES, F.LAUNCHES, I.LAUNCHES, S.LAUNCHES, SP.LAUNCHES,
                DI.LAUNCHES)
    saved = [dict(c) for c in counters]
    try:
        yield
    finally:
        for c, v in zip(counters, saved):
            c.update(v)


@held
def hold_recorded_multi(tag, what, calls, errs=None):
    """K10's sweeps as a path ran them (:func:`recorded_multi`), on the
    padded right-hand sides the path built, both directions: each output
    against ``band_sweep_plain`` on the same inputs within ``SWEEP_TOL``, and
    the kernel run twice more on them, bit for bit the path's output both
    times. The launches of the hold are taken back out of the counts."""
    with uncounted():
        worst, shapes = 0.0, set()
        for lu, b, fwd, r0, out in calls:
            policy = lu.policy.name
            name = f"respa_band_sweep_multi_{'fwd' if fwd else 'bwd'}_{INST[policy]}"
            ref = B.band_sweep_plain(lu, b, fwd, r0)
            err = float((out - ref).abs().max() / max(float(ref.abs().max()), 1e-300))
            again = [B.band_sweep_multi(lu, b, fwd, r0) for _ in range(2)]
            if not err <= SWEEP_TOL[policy] or \
                    not all(torch.equal(bits(out), bits(y)) for y in again):
                raise AssertionError(f"{what}: {name} as the path ran it, err {err:.3e} or not "
                                     "reproducible")
            if errs is not None:
                errs[name] = max(errs.get(name, 0.0), float((out - ref).abs().max()))
            worst = max(worst, err)
            shapes.add(f"{'fwd' if fwd else 'bwd'} {policy} [{b.shape[0]}, {b.shape[1]}] "
                       f"nb={lu.nb} ml={lu.ml} mu={lu.mu}" + (f" from row {r0}" if r0 else ""))
    if not calls:
        raise AssertionError(f"{what}: the path ran no K10 sweep")
    print(f"{tag} | {what}: the path's {len(calls)} K10 sweeps ({'; '.join(sorted(shapes))}) "
          f"against band_sweep_plain on the right-hand sides the path built: rel_err "
          f"{worst:.3e} (tol {SWEEP_TOL[policy]:.0e}), twice more bit for bit the path's",
          flush=True)


def several_rhs(name_limit, what, fac, a, k=4):
    """A solve of ``k`` right-hand sides at once through the factor's
    ``solve_original_device`` (K10 on the band path): finite, and its first
    column, A's known-solution right-hand side, as close to it as the
    one-column solve (K2) is. Returns the K10 sweeps it ran
    (:func:`recorded_multi`)."""
    bm = np.random.default_rng(17).standard_normal((a.nrows, k))
    bm[:, 0] = slv.make_rhs_for_known_x(a)[0]
    with recorded_multi() as calls:
        xm, t_m = synced(lambda: fac.solve_original_device(torch.from_numpy(bm).cuda()))
    x1, t_1 = synced(lambda: fac.solve_original_device(torch.from_numpy(bm[:, 0]).cuda()))
    xm, x1 = xm.cpu().numpy(), x1.cpu().numpy()
    res = [slv.relative_residual(a, xm[:, j], bm[:, j]) for j in range(k)]
    one = slv.relative_residual(a, x1, bm[:, 0])
    if not (np.isfinite(xm).all() and xm.shape == (a.nrows, k) and res[0] <= 10 * one + 1e-15):
        raise AssertionError(f"{what}: {k} right-hand sides, residuals {res} against the "
                             f"one-column solve's {one:.3e}")
    print(f"[direct] {name_limit} | {what}: {k} right-hand sides in one solve {t_m * 1e3:.1f} ms "
          f"(one column {t_1 * 1e3:.1f} ms; host clock to a synchronize), residuals "
          f"{', '.join(f'{r:.3e}' for r in res)} (host oracle; the one-column solve {one:.3e})",
          flush=True)
    return calls


def on_path_condest(what, fac):
    """``condest`` on a path: (rcond, seconds); rcond must lie in (0, 1]."""
    rcond, t = synced(fac.condest)
    if not (np.isfinite(rcond) and 0 < rcond <= 1):
        raise AssertionError(f"{what}: condest {rcond}")
    return rcond, t


@held
def plain_rcond(fac):
    """The Hager estimate of ``fac`` as ``condest`` takes it, but with its
    transposed solves by the plain versions: two ``band_sweep_t_plain`` sweeps
    (K11's) for a band factor, ``front_sweep_t_plain`` (K12's) group by group
    for a frontal one."""
    if isinstance(fac, slv.BandLuFactorization):
        def plain_t(lu, v):
            pad = torch.zeros(lu.nb * lu.p, dtype=v.dtype, device=v.device)
            pad[:lu.n] = ftz(v, lu.policy.flush_to_zero)
            return B.band_sweep_t_plain(lu, B.band_sweep_t_plain(lu, pad, True), False)[:lu.n]

        inv = slv.condition_estimate(fac.a, fac.solve,
                                     solve_t_fn=lambda s: fac._solve_host(s, plain_t))
    else:
        solver = fac._frontal

        def sweep(gi, *args):
            return F.front_sweep_t_plain(solver.pool, *args, solver.flush)

        def t_permuted(sp):
            y = solver._start(sp.to(solver.pool.dtype))
            solver._run(y, sweep, True)
            solver._run(y, sweep, False)
            return y[:solver.n]

        fac._solve_t_permuted = t_permuted  # shadows the method for this estimate
        try:
            inv = slv.condition_estimate(fac.a, fac.solve, solve_t_fn=fac.solve_transpose)
        finally:
            del fac._solve_t_permuted
    return 1.0 / max(slv._norm1(fac.a) * inv, 1e-300)


def rcond_pairs(name_limit, tag, rconds):
    """Each factor's ``condest`` on the path beside the estimate its plain
    transposed solves give: within a factor of 2."""
    for what, (fac, rcond, t) in rconds.items():
        rp = plain_rcond(fac)
        ratio = max(rcond, rp) / min(rcond, rp)
        print(f"[{tag}] {name_limit} | {what} condest (Hager, the transposed solves on the "
              f"kernel): rcond {rcond:.6e} in {t:.3f} s; with the plain transposed solves "
              f"{rp:.6e} (ratio {ratio:.4f}, at most 2)", flush=True)
        if not ratio <= 2.0:
            raise AssertionError(f"{what}: condest {rcond:.3e} against {rp:.3e} with the plain "
                                 "transposed solves")


@held
def hold_band_t(name_limit, lu, policy, errs, times):
    """K11 on a full-width factored band (2cubes_sphere, nb = 812) read
    under ``policy``: each sweep against ``band_sweep_t_plain``, twice bit for
    bit, timed by events and the profiler beside its byte bound (the blocks
    it reads, each once, and b and out) and the plain version, a torch-op
    loop of a TRSM and a product each block row as the port ran before K11."""
    lu = as_policy(lu, policy)
    acc = lu.policy.accum_dtype
    vec = torch.empty(0, dtype=acc).element_size()
    b = torch.from_numpy(np.random.default_rng(23).standard_normal(lu.nb * lu.p)).to(acc).cuda()
    s = b[:lu.n].clone()
    both = events_ms(lambda: B.band_solve_transpose(lu, s), 5)
    for fwd in (True, False):
        name = f"respa_band_sweep_t_{'fwd' if fwd else 'bwd'}_{INST[policy]}"
        m = lu.mu if fwd else lu.ml
        blocks = sum(min(m, q) + 1 for q in range(lu.nb))
        nbytes = blocks * lu.p * lu.p * lu.data.element_size() + 2 * lu.nb * lu.p * vec
        flops = 2 * blocks * lu.p * lu.p
        by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FLOPS_PER_S[acc] * 1e3
        y = B.band_sweep_t(lu, b, fwd)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = B.band_sweep_t_plain(lu, b, fwd)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = float((y - ref).abs().max() / ref.abs().max())
        again = B.band_sweep_t(lu, b, fwd)
        if not err <= SWEEP_TOL[policy] or not torch.equal(bits(y), bits(again)):
            raise AssertionError(f"{name} at full width: err {err:.3e} or not reproducible")
        errs[name] = max(errs.get(name, 0.0), float((y - ref).abs().max()))
        t = {"ms": events_ms(lambda: B.band_sweep_t(lu, b, fwd), 5), "plain_ms": plain_ms,
             "library_ms": None,
             "profiler_ms": profiler_ms(lambda: B.band_sweep_t(lu, b, fwd), "band_sweep_t_kernel",
                                        5),
             "bound_ms": max(by_bytes, by_ops),
             "bound_by": "bytes" if by_bytes >= by_ops else "operations",
             "shape": f"nb={lu.nb} P={lu.p} ml={lu.ml} mu={lu.mu}", "max_abs_err_full": err,
             "transpose_solve_ms": both}
        times[name] = t
        print(f"[time] {name_limit} | {name} {t['shape']}: kernel {fmt_ms(t['ms'])} by events, "
              f"{fmt_ms(t['profiler_ms'])} by the profiler; bound {t['bound_ms']:.4f} ms "
              f"({nbytes} bytes at 3.35 TB/s; {flops} flops would take {by_ops:.4f} ms); "
              f"library none; plain {plain_ms:.1f} ms (one run, synchronised host clock); "
              f"rel_err vs plain {err:.2e}, bitwise twice; both sweeps by K11 {both:.4f} ms "
              f"(band_solve_transpose)", flush=True)


def leading_block(a, n):
    """The leading n x n block of ``a``: in the natural order, one SPIKE
    partition's band."""
    end = int(a.indptr[n])
    rows = np.repeat(np.arange(n, dtype=np.int32), np.diff(a.indptr[:n + 1]))
    cols, vals = a.indices[:end], a.data[:end]
    keep = cols < n
    return coo_to_csr(COOMatrix((n, n), rows[keep], cols[keep].astype(np.int32), vals[keep]))


def band_dense(lu, lower):
    """The unit lower L (``lower``) or the upper U of a factored band as a
    dense matrix on its device, in the accumulator type."""
    p, ml, nb, w = lu.p, lu.ml, lu.nb, lu.width
    n = nb * p
    dense = torch.zeros(n, n, dtype=lu.policy.accum_dtype, device=lu.device)
    for r in range(nb):
        c0 = (r - ml) * p
        lo, hi = max(c0, 0), min(c0 + w, n)
        dense[r * p:(r + 1) * p, lo:hi] = lu.data[r][:, lo - c0:hi - c0]
    if lower:
        dense.tril_(-1)
        dense.diagonal().fill_(1)
    else:
        dense.triu_()
    return dense


def multi_work(lu, nrhs, fwd, first_row=0):
    """(flops, bytes) that one K10 sweep needs on these inputs: the panel
    blocks it multiplies and the triangles it solves, each block read once,
    the rows of b it reads and of out it writes."""
    p, nb = lu.p, lu.nb
    rows = range(first_row, nb)
    m = [min(lu.ml, r - first_row) if fwd else min(lu.mu, nb - 1 - r) for r in rows]
    tri = p * (p - 1) if fwd else p * p  # multiply-adds and, backward, the divisions
    flops = sum(2 * p * p * k + tri for k in m) * nrhs
    acc = torch.empty(0, dtype=lu.policy.accum_dtype).element_size()
    nbytes = (sum(k + 1 for k in m) * p * p * lu.data.element_size()
              + 2 * len(m) * p * nrhs * acc)
    return flops, nbytes


@held
def hold_band_multi(name_limit, a, errs, times):
    """K10 at SPIKE's tips' shapes: one partition of 2cubes_sphere in the
    natural order (its leading ``TIPS_NB`` block rows, ml = mu = 18),
    factored in fp32 (read as fp32, fp32_ftz and bf16) and in fp64, with
    ``TIPS_NRHS`` right-hand sides: W's (the first ml block rows), forward
    from row 0 and then backward, and V's (the last mu block rows), forward
    from its first row. Each against ``band_sweep_plain``, twice bit for bit,
    V's from ``first_row`` bit for bit with the sweep from row 0; timed by
    events and the profiler beside the bound (flops at the card's rate for
    the type), the plain version (the torch-op loop that ran before) and,
    but for fp32_ftz (no library call flushes subnormals),
    ``torch.linalg.solve_triangular`` on the dense partition's triangle in
    the accumulator type (bf16's band widened to fp32, K10's function)."""
    sub = leading_block(a, TIPS_NB * 128)
    for fpol, policies in (("fp32", ("fp32", "fp32_ftz", "bf16")), ("fp64", ("fp64",))):
        base = B.band_lu(B.csr_to_device_band(sub, fpol, "cuda")).lu
        for policy in policies:
            lu = as_policy(base, policy)
            acc = lu.policy.accum_dtype
            p, nb, ml, mu = lu.p, lu.nb, lu.ml, lu.mu
            rng = np.random.default_rng(29)
            w_rhs = torch.zeros((nb * p, TIPS_NRHS), dtype=acc, device="cuda")
            w_rhs[:ml * p] = torch.from_numpy(rng.standard_normal((ml * p, TIPS_NRHS))).to(acc)
            v_rhs = torch.zeros_like(w_rhs)
            v_rhs[-mu * p:] = torch.from_numpy(rng.standard_normal((mu * p, TIPS_NRHS))).to(acc)
            r0 = nb - mu
            y = B.band_sweep_multi(lu, w_rhs, True)
            dense = {}
            for fwd, b in ((True, w_rhs), (False, y)):
                name = f"respa_band_sweep_multi_{'fwd' if fwd else 'bwd'}_{INST[policy]}"
                got = B.band_sweep_multi(lu, b, fwd)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ref = B.band_sweep_plain(lu, b, fwd)
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t0) * 1e3
                err = float((got - ref).abs().max() / ref.abs().max())
                if not err <= SWEEP_TOL[policy] or \
                        not torch.equal(bits(got), bits(B.band_sweep_multi(lu, b, fwd))):
                    raise AssertionError(f"{name} at the tips' shape: err {err:.3e} or not "
                                         "reproducible")
                errs[name] = max(errs.get(name, 0.0), float((got - ref).abs().max()))
                del got, ref
                flops, nbytes = multi_work(lu, TIPS_NRHS, fwd)
                by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FLOPS_PER_S[acc] * 1e3
                lib = None
                if policy != "fp32_ftz":
                    dense[fwd] = band_dense(lu, fwd)
                    lib = events_ms(lambda: torch.linalg.solve_triangular(
                        dense[fwd], b, upper=not fwd, unitriangular=fwd), 3)
                    dense.pop(fwd)
                t = {"ms": events_ms(lambda: B.band_sweep_multi(lu, b, fwd), 5),
                     "plain_ms": plain_ms, "library_ms": lib,
                     "profiler_ms": profiler_ms(lambda: B.band_sweep_multi(lu, b, fwd),
                                                "band_multi_kernel", 3),
                     "bound_ms": max(by_bytes, by_ops),
                     "bound_by": "bytes" if by_bytes >= by_ops else "operations",
                     "shape": f"nb={nb} P={p} ml={ml} mu={mu} nrhs={TIPS_NRHS}",
                     "max_abs_err_full": err}
                if fwd:  # V's forward sweep from its first nonzero block row
                    yv = B.band_sweep_multi(lu, v_rhs, True, r0)
                    if not torch.equal(bits(yv), bits(B.band_sweep_multi(lu, v_rhs, True))):
                        raise AssertionError(f"{name}: first_row {r0} != from row 0")
                    vflops, vbytes = multi_work(lu, TIPS_NRHS, True, r0)
                    t["first_row"] = {
                        "first_row": r0,
                        "ms": events_ms(lambda: B.band_sweep_multi(lu, v_rhs, True, r0), 5),
                        "bound_ms": max(vflops / FLOPS_PER_S[acc], vbytes / HBM_BYTES_PER_S) * 1e3}
                    del yv
                times[name] = {**times.get(name, {}), **t}
                v = t.get("first_row")
                print(f"[time] {name_limit} | {name} {t['shape']}: kernel {fmt_ms(t['ms'])} by "
                      f"events, {fmt_ms(t['profiler_ms'])} by the profiler; bound "
                      f"{t['bound_ms']:.4f} ms ({flops:.4e} flops at "
                      f"{FLOPS_PER_S[acc] / 1e12:.1f} TFLOP/s; {nbytes} bytes at 3.35 TB/s = "
                      f"{by_bytes:.4f} ms); library solve_triangular on the dense partition "
                      f"{fmt_ms(lib).replace('not measured', 'none')}; plain {plain_ms:.1f} ms "
                      f"(one run, synchronised host clock); rel_err vs plain {err:.2e}, bitwise "
                      f"twice" + (f"; V's sweep from block row {r0}: {v['ms']:.4f} ms (bound "
                                  f"{v['bound_ms']:.4f} ms), == from row 0 bit for bit"
                                  if v else ""), flush=True)
            del y, w_rhs, v_rhs, lu
        del base
    torch.cuda.empty_cache()


def factor_bound(band, acc):
    """Least milliseconds of one band factorization: its products' and
    TRSMs' flops at the card's rate for the type, or the band read and
    written once at the memory rate, whichever is more."""
    p, ml, mu, nb = band.p, band.ml, band.mu, band.nb
    flops = 0
    for r in range(nb):
        k = min(ml, nb - 1 - r)
        flops += 2 * p ** 3 / 3 + p * p * mu * p + k * p * p * p + 2 * k * p * p * mu * p
    nbytes = 2 * band.data.numel() * band.data.element_size()
    return flops, nbytes, max(flops / FLOPS_PER_S[acc], nbytes / HBM_BYTES_PER_S) * 1e3


@contextlib.contextmanager
def first_versions(probes):
    """K1's and K3's wrappers launch their first versions (the probes'
    ``respa_block_lu_before_*`` and ``respa_extend_add_before_*``; K3's
    takes no regime and no lists) in place of the package's inside the
    block; every other kernel is the package's. Both first versions give the
    package's bits, so a factorization leaves the same factor."""
    saved = B._library, F._library
    libs = (B._library(), F._library())

    def swapped(lib):
        class Swapped:
            def __getattr__(self, name):
                if name.startswith("respa_block_lu_"):
                    return getattr(probes, name.replace("respa_block_lu_",
                                                        "respa_block_lu_before_"))
                if name.startswith("respa_extend_add_"):
                    before = getattr(probes, name.replace("respa_extend_add_",
                                                          "respa_extend_add_before_"))
                    return lambda *args: before(*args[:12], args[-1])  # no regime, no lists
                return getattr(lib, name)
        return Swapped

    B._library, F._library = (swapped(lib) for lib in libs)
    try:
        yield
    finally:
        B._library, F._library = saved


def factor_busy(name_limit, tag, what, refactor, probes=None):
    """One warm factorization (``refactor``, timed on the host to a
    synchronize) under the profiler: its wall time, the card's busy time,
    K1's and K3's shares of it and the busy time by kernel name. With
    ``probes`` (``--before``) the same factorization first with the first
    versions of K1 and K3 swapped into their wrappers (``first_versions``),
    then with the package's, in one run."""
    wall = [0.0]

    def run():
        wall[0] = refactor()

    got = {}
    versions = ((("first versions", lambda: first_versions(probes)),) if probes else ()) + \
        (("the package's kernels", contextlib.nullcontext),)
    for version, ctx in versions:
        try:
            with ctx():
                events = device_events(run)
        except ProfilerUnavailable as e:
            print(f"{tag} {name_limit} | {what} warm factorization busy time not measured ({e})",
                  flush=True)
            return None
        busy = sum(t for _, t in events)
        k1 = [t for name, t in events if "block_lu" in name]
        k3 = [t for name, t in events if "extend_add" in name]
        got[version] = (busy, sum(k1), sum(k3))
        print(f"{tag} {name_limit} | {what} warm factorization under the profiler with "
              f"{version}: wall {wall[0] * 1e3:.1f} ms, device busy {busy * 1e3:.1f} ms in "
              f"{len(events)} records, K1 {sum(k1) * 1e3:.2f} ms ({len(k1)} x "
              f"{sum(k1) / max(len(k1), 1) * 1e6:.1f} us), K3 {sum(k3) * 1e3:.3f} ms ({len(k3)} "
              f"x {sum(k3) / max(len(k3), 1) * 1e6:.1f} us)", flush=True)
    for key, n, tot in busy_by_name(events, top=8):
        print(f"{tag}   {key}: {n} x {tot / n * 1e6:.1f} us = {tot * 1e3:.2f} ms", flush=True)
    if probes:
        (b1, k1, k3), (b0, k10, k30) = got["the package's kernels"], got["first versions"]
        print(f"{tag} {name_limit} | {what}: busy {b1 * 1e3:.1f} ms with the package's K1 and K3 "
              f"against {b0 * 1e3:.1f} ms with their first versions ({(b1 - b0) * 1e3:+.1f} ms); "
              f"K1 {k1 * 1e3:.2f} against {k10 * 1e3:.2f} ms, K3 {k3 * 1e3:.3f} against "
              f"{k30 * 1e3:.3f} ms", flush=True)
    return got


@held
def time_few_columns(name_limit, lu, times):
    """K10's few-column regime on the band of phase 6 (2cubes_sphere fp32,
    nb = 812): a solve of 4 right-hand sides (``band_solve``, both sweeps on
    K10) beside four one-column solves (K2) of the same run, in turns; the
    4-column sweeps held to ``band_sweep_plain`` within ``SWEEP_TOL`` and
    twice bit for bit."""
    acc = lu.policy.accum_dtype
    rng = np.random.default_rng(31)
    b4 = torch.from_numpy(rng.standard_normal((lu.n, 4))).to(acc).cuda()
    cols = [b4[:, j].contiguous() for j in range(4)]
    bp = torch.zeros((lu.nb * lu.p, 4), dtype=acc, device="cuda")
    bp[:lu.n] = b4
    with uncounted():
        worst = 0.0
        for fwd, b in ((True, bp), (False, B.band_sweep_multi(lu, bp, True))):
            y = B.band_sweep_multi(lu, b, fwd)
            ref = B.band_sweep_plain(lu, b, fwd)
            err = float((y - ref).abs().max() / ref.abs().max())
            if not err <= SWEEP_TOL[lu.policy.name] or \
                    not torch.equal(bits(y), bits(B.band_sweep_multi(lu, b, fwd))):
                raise AssertionError(f"K10 4 columns at nb={lu.nb}: err {err:.3e} or not "
                                     "reproducible")
            worst = max(worst, err)

        def four():
            return B.band_solve(lu, b4)

        def ones():
            return [B.band_solve(lu, c) for c in cols]

        turns = [events_ms(fn, 5) for fn in (four, ones, ones, four)]
    t = {"nrhs": 4, "ms": min(turns[0], turns[3]), "one_column_solves_ms": min(turns[1], turns[2]),
         "shape": f"nb={lu.nb} P={lu.p} ml={lu.ml} mu={lu.mu} {lu.policy.name}"}
    name = f"respa_band_sweep_multi_fwd_{INST[lu.policy.name]}"
    times.setdefault(name, {})["few_columns"] = t
    print(f"[time] {name_limit} | K10 few-column regime, {t['shape']}: a 4-column band_solve "
          f"(two K10 sweeps) {t['ms']:.3f} ms against four 1-column band_solves (K2) "
          f"{t['one_column_solves_ms']:.3f} ms, by events in turns; sweeps within {worst:.2e} of "
          f"plain, bitwise twice", flush=True)


def reset_counts():
    for counts in (B.LAUNCHES, K.LAUNCHES, F.LAUNCHES, I.LAUNCHES, S.LAUNCHES, SP.LAUNCHES,
                   DI.LAUNCHES):
        for name in counts:
            counts[name] = 0


def direct_path(name_limit, a, times, errs, probes):
    """Phase 6; returns the band kernels' launch counts on the direct path
    and the fp64 SpMV's. The path ends with a solve of several right-hand
    sides (K10) and ``condest`` (K11) on each of its four band factors; beside
    it, each estimate against the one the plain transposed solves give, the
    warm factorization's busy time, and the kernels held and timed at the
    full-width shapes."""
    b, x_true = slv.make_rhs_for_known_x(a)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()

    # fp32 factorization, a second (warm) one, and the refined solve
    fac = slv.factorize(a, "fp32", method="auto", device="cuda")
    t_warm = fac.refactorize_timed()
    x, rep = slv.solve_refined(a, b, fac=fac)
    peak = torch.cuda.max_memory_allocated()
    nb = fac._lu.nb
    err = slv.inf_norm_error(x, x_true)
    got = dict(B.LAUNCHES, spmv_fp64=K.LAUNCHES["fp64"])
    solves = rep.iterations - 1  # the last residual is followed by no solve
    want = {"respa_block_lu_f32": 2 * nb, "respa_band_sweep_fwd_f32": solves,
            "respa_band_sweep_bwd_f32": solves, "spmv_fp64": rep.iterations}
    if any(got[k] != want.get(k, 0) for k in got):
        raise AssertionError(f"direct path launches {got}, expected {want}")
    if not (rep.notes.startswith("method=band") and rep.converged and rep.residual <= 1e-10
            and err <= 1e-8 and np.isfinite(x).all() and x.shape == (a.nrows,)):
        raise AssertionError(f"direct path: {rep}, inf_norm_error {err:.3e}")
    flops, nbytes, bound = factor_bound(fac._dev, torch.float32)
    print(f"[direct] {name_limit} | 2cubes_sphere n={a.nrows} nnz={a.nnz} fp32 [{rep.notes}] "
          f"P={fac._lu.p} nb={nb} ml={fac._lu.ml} mu={fac._lu.mu} band "
          f"{fac.report.factor_bytes / 1e9:.2f} GB: analyze {rep.t_analyze:.3f} s, factor cold "
          f"{rep.t_factorize * 1e3:.1f} ms, factor warm {t_warm * 1e3:.1f} ms, refined solve "
          f"{rep.t_solve * 1e3:.1f} ms in {rep.iterations} iterations (host clock, each phase "
          f"ended by a device synchronize); residual {rep.residual:.3e} (host oracle), "
          f"inf_norm_error {err:.3e}, pivots perturbed {rep.n_pivot_perturbed}, pivot growth "
          f"{fac.report.pivot_growth:.3e}, peak device memory {peak / 1e9:.2f} GB", flush=True)
    print(f"[direct] {name_limit} | factorization bound {bound:.2f} ms ({flops:.3e} flops at 67 "
          f"TFLOP/s, fp32 outside the tensor cores, NVIDIA's data sheet; {nbytes} bytes at 3.35 "
          f"TB/s); warm factorization is {t_warm * 1e3 / bound:.1f}x its bound", flush=True)
    print(f"[direct] launches of the fp32 row {got}", flush=True)

    # fp64 factorization and direct solve of the same matrix
    fac64 = slv.factorize(a, "fp64", method="auto", device="cuda")
    x64 = fac64.solve(b)
    r64 = fac64.report
    if not (r64.residual <= 1e-12 and slv.inf_norm_error(x64, x_true) <= 1e-8
            and r64.notes.startswith("method=band")):
        raise AssertionError(f"fp64 direct: {r64}")
    flops, nbytes, bound64 = factor_bound(fac64._dev, torch.float64)
    print(f"[direct] {name_limit} | 2cubes_sphere fp64 [{r64.notes}] band "
          f"{r64.factor_bytes / 1e9:.2f} GB: analyze {r64.t_analyze:.3f} s, factor "
          f"{r64.t_factorize * 1e3:.1f} ms (bound {bound64:.2f} ms at "
          f"{FLOPS_PER_S[torch.float64] / 1e12:.0f} TFLOP/s), solve "
          f"{r64.t_solve * 1e3:.1f} ms, residual {r64.residual:.3e}, pivots perturbed "
          f"{r64.n_pivot_perturbed}", flush=True)

    # bf16 and fp32_ftz with refinement on a grid Laplacian
    lap = laplacian_2d(300, 300)
    bl, _ = slv.make_rhs_for_known_x(lap)
    lap_facs = {}
    for policy, tol in (("bf16", 1e-8), ("fp32_ftz", 1e-10)):
        lap_facs[policy] = slv.factorize(lap, policy, method="auto", device="cuda")
        _, rl = slv.solve_refined(lap, bl, fac=lap_facs[policy], max_iters=60)
        if not (rl.residual <= tol and rl.notes.startswith("method=band")):
            raise AssertionError(f"{policy} + IR on laplacian_2d(300, 300): {rl}")
        print(f"[direct] {name_limit} | laplacian_2d(300, 300) {rl.policy}: factor "
              f"{lap_facs[policy].report.t_factorize * 1e3:.1f} ms, refined solve "
              f"{rl.t_solve * 1e3:.1f} ms in {rl.iterations} iterations, residual "
              f"{rl.residual:.3e} (tol {tol:.0e})", flush=True)
    fp64_row = {"respa_block_lu_f64": nb, "respa_band_sweep_fwd_f64": 1,
                "respa_band_sweep_bwd_f64": 1}
    if any(B.LAUNCHES[k] != v for k, v in fp64_row.items()):
        raise AssertionError(f"direct path launches {dict(B.LAUNCHES)}")

    # several right-hand sides (K10) and the condition estimate (K11) of
    # every factor of the path
    facs = {"2cubes_sphere fp32": (fac, a), "2cubes_sphere fp64": (fac64, a),
            "laplacian_2d(300, 300) bf16": (lap_facs["bf16"], lap),
            "laplacian_2d(300, 300) fp32_ftz": (lap_facs["fp32_ftz"], lap)}
    recorded = {what: several_rhs(name_limit, what, f, m) for what, (f, m) in facs.items()}
    rconds = {what: (f, *on_path_condest(what, f)) for what, (f, _) in facs.items()}

    launches, spmv_direct = dict(B.LAUNCHES), K.LAUNCHES["fp64"]
    dia_direct = dict(DI.LAUNCHES)
    if min(launches.values()) < 1:
        raise AssertionError(f"direct path launches {launches}")
    no_plain("direct path")
    print(f"[direct] launches of the whole direct path {launches}, fp64 SpMV {spmv_direct} "
          f"(CSR kernel), DIA kernel (the Laplacian's residuals) {dia_direct}", flush=True)

    # beside the path, not counted: one unrefined solve, the condition
    # estimates against the plain transposed solves', and the kernels held
    # and timed at the full-width shapes
    t0 = time.perf_counter()
    x1 = fac.solve(b)
    t_one = time.perf_counter() - t0
    if not np.isfinite(x1).all():
        raise AssertionError("one fp32 solve: not finite")
    print(f"[direct] {name_limit} | one fp32 solve without refinement {t_one * 1e3:.1f} ms, "
          f"residual {fac.report.residual:.3e}", flush=True)
    rcond_pairs(name_limit, "direct", rconds)
    for what, calls in recorded.items():
        hold_recorded_multi(f"[held] {name_limit}", f"{what}, 4 right-hand sides", calls, errs)
    del lap_facs, rconds, facs, recorded
    time_block_lu(name_limit, fac, fac64, times, probes)
    time_few_columns(name_limit, fac._lu, times)
    for policy in ("fp32", "fp32_ftz", "bf16"):
        time_band_sweep(name_limit, fac._lu, policy, times)
        hold_band_t(name_limit, fac._lu, policy, errs, times)
    time_band_sweep(name_limit, fac64._lu, "fp64", times)
    hold_band_t(name_limit, fac64._lu, "fp64", errs, times)
    with uncounted():  # K1's first version beside it: --before
        factor_busy(name_limit, "[direct]", "2cubes_sphere fp32 band", fac.refactorize_timed)
    del fac, fac64
    torch.cuda.empty_cache()
    hold_band_multi(name_limit, a, errs, times)
    return launches, spmv_direct


def kernel_kind(name):
    """'respa_front_sweep_fwd_f32_ftz' -> 'front_sweep_fwd'."""
    for suffix in ("_f32_ftz", "_f32", "_f64"):
        if name.endswith(suffix):
            return name[len("respa_"):-len(suffix)]
    raise ValueError(name)


def group_on_card(g, dtype):
    """A synthetic group's arrays as tensors on the card, its pool and y in
    ``dtype``."""
    t = {k: torch.from_numpy(v).cuda() for k, v in g.items() if isinstance(v, np.ndarray)}
    t["pool"], t["y"] = t["pool"].to(dtype), t["y"].to(dtype)
    t["ga_base"] = g.get("ga_base", 0)
    return t


def no_subnormals(*tensors):
    return all(not bool(((t != 0) & (t.abs() < torch.finfo(t.dtype).tiny)).any())
               for t in tensors)


@held
def check_frontal_kernels(errs):
    """Extend-add, both frontal sweeps, both transposed ones (K12) and the row
    reduction against their plain versions on synthetic groups; see the
    docstring."""
    # (name, fronts, wp, rp, parents): a hub parent of 300 children for the
    # extend-add, the sweep's warp regime (up to 2,000
    # fronts of wp 8 and 32, a panel of two passes), its block regime (wp
    # 24-128, a 6,144-row panel over 96 tiles, 333 rows over 5 tiles of 67),
    # its wide regime (wp 192-2,048, rp 0-384, 1-3 fronts; odd widths)
    shapes = [("one_front", 1, 8, 8, 1), ("many_children", 700, 8, 16, 2), ("hub", 300, 8, 16, 1),
              ("warp_wp8", 2000, 8, 16, 40), ("warp_wp32", 2000, 32, 32, 40),
              ("warp_wp32_rp40", 300, 32, 40, 5), ("roots_rp0", 3, 24, 0, 0),
              ("wp24", 6, 24, 32, 4), ("wp128", 5, 128, 48, 3), ("tall_wp64", 1, 64, 6144, 1),
              ("tall_wp40_rp333", 1, 40, 333, 1), ("wide192", 2, 192, 96, 1),
              ("wide200", 3, 200, 64, 2), ("wide333_rp77", 2, 333, 77, 1),
              ("wide1000", 2, 1000, 384, 1), ("wide2048", 1, 2048, 256, 1),
              ("wide640_rp0", 1, 640, 0, 0), ("wide2048_rp0", 1, 2048, 0, 0)]
    for cname, nf, wp, rp, npar in shapes:
        host = frontal_group(nf, wp, rp, npar, seed=nf + wp)
        regime, tiles = F.sweep_regime(nf, wp, rp)
        for dtype, flush, inst in FRONT_INST:
            t = group_on_card(host, dtype)
            worst = check_frontal_group(errs, t, cname, nf, wp, rp, npar, dtype, flush, inst)
            print(f"[kernel] frontal {cname:14s} {inst:8s} B={nf} wp={wp} rp={rp} parents={npar} "
                  f"sweep regime {regime} x{tiles}: extend-add ({'both regimes' if 'add' in host else 'rows'}"
                  f"; the plan would pick {host.get('add', 'rows')}) and reduction == plain bitwise, "
                  f"sweeps rel_err={worst:.3e} (tol {FRONT_TOL[dtype]:.0e}), all bitwise twice, "
                  f"y[n] untouched", flush=True)
            del t


@held
def check_frontal_group(errs, t, cname, nf, wp, rp, npar, dtype, flush, inst):
    """One synthetic group through every frontal kernel of one instance;
    returns the sweeps' worst error relative to plain."""
    tol = FRONT_TOL[dtype]

    def held(name, got, ref, again):
        scale = max(float(ref.abs().max()), 1e-300)
        err = float((got - ref).abs().max())
        if not (np.isfinite(err) and err / scale <= tol and torch.equal(got, again)):
            raise AssertionError(f"{name} {cname}: rel_err {err / scale:.3e} (tol {tol:.0e}) "
                                 f"or not bitwise repeatable")
        errs[name] = max(errs.get(name, 0.0), err)
        return err / scale

    kids = nf * (wp + rp) ** 2
    if flush:  # subnormal entries in the fronts and the right-hand side, and
        # zeroed parents, so that the extend-add's sums are subnormal too
        t["pool"][:kids][wp * (wp + rp) + wp::97] = 1e-40
        t["pool"][:kids][3::101] = -1e-40
        t["pool"][kids:] = 0
        d = torch.arange(wp)
        t["pool"][:kids].view(nf, wp + rp, wp + rp)[:, d, d] = 2.5  # keep the pivots
        t["y"][:-1:5] = 1e-40
    rows = t["piv"][t["piv"] < t["y"].numel() - 1].long()
    idx = (t["lp"], t["poff"], t["pmp"], t["seg_ptr"])
    grp = (0, nf, wp, rp)
    worst = 0.0
    if npar:  # both regimes where the group has gather lists, else the rows
        name = f"respa_extend_add_{inst}"
        ref = t["pool"].clone()
        F.extend_add_plain(ref, *grp, *idx, flush)
        regimes = [("rows", None)]
        if "ga_dst" in t:  # corners of at most GATHER_RP rows
            regimes.insert(0, ("gather", (t["ga_base"], t["ga_dst"], t["ga_src"], t["ga_ptr"])))
        for regime, lists in regimes:
            out = [t["pool"].clone() for _ in range(2)]
            F.extend_add(out[0], *grp, *idx, flush, lists)
            F.extend_add(out[1], *grp, *idx, flush, lists)
            torch.cuda.synchronize()
            held(name, out[0], ref, out[1])
            if not torch.equal(out[0], ref):  # same operations in the same order
                raise AssertionError(f"{name} {cname} {regime}: kernel != plain bit for bit")
            if flush and not no_subnormals(out[0][kids:]):
                raise AssertionError(f"{name} {cname} {regime}: a subnormal sum was not flushed")
            del out
        del ref
    for trans, fwd in ((False, True), (False, False), (True, True), (True, False)):
        name = f"respa_front_sweep_{'t_' if trans else ''}{'fwd' if fwd else 'bwd'}_{inst}"
        sweep = F.front_sweep_t if trans else F.front_sweep
        ys = [t["y"].clone() for _ in range(3)]
        u0 = sweep(t["pool"], ys[0], *grp, t["piv"], t["rsx"], fwd, flush,
                   control=F.control_zeros(t["pool"], nf, wp, rp))
        u1 = sweep(t["pool"], ys[1], *grp, t["piv"], t["rsx"], fwd, flush,
                   control=F.control_zeros(t["pool"], nf, wp, rp))
        u2 = (F.front_sweep_t_plain if trans else F.front_sweep_plain)(
            t["pool"], ys[2], *grp, t["piv"], t["rsx"], fwd, flush)
        torch.cuda.synchronize()
        worst = max(worst, held(name, ys[0], ys[2], ys[1]))
        if float(ys[0][-1]) != 0.0:
            raise AssertionError(f"{name} {cname}: the padding's slot of y was written")
        if fwd and rp:
            worst = max(worst, held(name, u0, u2, u1))
            name = ("respa_rows_reduce_f64" if dtype == torch.float64
                    else "respa_rows_reduce_f32")
            red = (t["red_rows"], t["red_ptr"], t["red_src"])
            same = ys[0].clone()
            F.rows_reduce(ys[0], u0, *red, flush)
            F.rows_reduce(ys[1], u0, *red, flush)
            F.rows_reduce_plain(same, u0, *red, flush)
            torch.cuda.synchronize()
            if not (torch.equal(ys[0], ys[1]) and torch.equal(ys[0], same)):
                raise AssertionError(f"{name} {cname}: kernel != plain bit for bit, or twice")
            errs.setdefault(name, 0.0)
            if float(ys[0][-1]) != 0.0:
                raise AssertionError(f"{name} {cname}: the padding's slot of y was written")
        written = torch.cat([rows, t["red_rows"].long()]) if fwd and rp else rows
        if flush and not no_subnormals(ys[0][written], *([u0] if fwd and rp else [])):
            raise AssertionError(f"{name} {cname}: a subnormal result was not flushed")
    return worst


@held
def hold_frontal_full(name_limit, name, fac, errs, full):
    """Every group of ``fac``'s plan, at the shapes and on the data the main
    path gave the kernels, against the plain versions on the same inputs.

    The factorization is run again with ``extend_add_plain`` in the kernel's
    place and its pool must equal ``fac``'s bit for bit (same operations in
    the same order). Then one solve, and one solve of the transposed system
    (K12), are walked group by group: each sweep and each reduction runs on
    the state the kernels before it left and on a clone of that state
    through the plain version. What they wrote must agree
    within ``FRONT_TOL`` of the largest entry written, with nothing else in
    y touched. A front whose triangle or panel amplifies rounding past that
    (a circuit's factor can be that ill-conditioned) is settled by a third
    run: the plain version in fp64 on the same inputs, which the kernel's
    result must come as close to as ``AMPLIFIED`` times the plain fp32
    version's distance. Raises at the end, with every kernel that failed."""
    plan, pool, flush = fac._plan, fac._frontal.pool, fac._frontal.flush
    tol = FRONT_TOL[pool.dtype]
    inst = F._INST[pool.dtype, flush]
    dgs = plan.on_device(pool.device)
    names = {"add": f"respa_extend_add_{inst}", True: f"respa_front_sweep_fwd_{inst}",
             False: f"respa_front_sweep_bwd_{inst}",
             "red": "respa_rows_reduce_f64" if pool.dtype == torch.float64
             else "respa_rows_reduce_f32"}
    worst, amplified, failed = {}, {}, []

    def dist(got, ref):
        d = float((got.double() - ref.double()).abs().max())
        return d if np.isfinite(d) else float("inf")

    def held(kname, got, ref, written, g, in64=None):
        """``got`` against ``ref`` everywhere, on the scale of what was
        written; ``in64()`` gives the fp64 result where that is not enough."""
        if ref.numel() == 0:
            return
        where = f"B={g.nfronts} wp={g.wp} rp={g.rp} level={g.level}"
        err = dist(got, ref)
        rel = err / max(float(written.abs().max()), 1e-300)
        if rel <= tol:
            if rel >= worst.get(kname, (-1.0,))[0]:
                worst[kname] = (rel, err, where)
            return
        if in64 is None or pool.dtype == torch.float64:
            failed.append(f"{kname}: rel_err {rel:.3e} (abs {err:.3e}) > {tol:.0e} at {where}")
            return
        r64 = in64()
        ek, ep = dist(got, r64), dist(ref, r64)
        if ek / max(ep, 1e-300) >= amplified.get(kname, (-1.0,))[0]:
            amplified[kname] = (ek / max(ep, 1e-300), rel, err, ek, ep, where)
        if not ek <= AMPLIFIED * ep:
            failed.append(f"{kname}: rel_err {rel:.3e} against plain at {where}, and {ek:.3e} "
                          f"from the fp64 result where plain is {ep:.3e} away")

    t0 = time.perf_counter()
    ref = F.assemble_pool(plan, pool.dtype, pool.device, fac._pivot_eps, flush)
    for g, d in zip(plan.groups, dgs):
        grp = (g.g0, g.nfronts, g.wp, g.rp)
        F.factor_group(ref, *grp, fac._pivot_eps, flush)
        F.extend_add_plain(ref, *grp, d["lp"], d["poff"], d["pmp"], d["seg_ptr"], flush)
    add_err = dist(ref, pool)
    if not torch.equal(ref, pool):
        failed.append(f"{names['add']}: the pool factored with the plain extend-add differs "
                      f"(max abs {add_err:.3e})")
    del ref
    # the other regime: every group through the row kernel, the gather groups too
    rows = F.assemble_pool(plan, pool.dtype, pool.device, fac._pivot_eps, flush)
    for g, d in zip(plan.groups, dgs):
        grp = (g.g0, g.nfronts, g.wp, g.rp)
        F.factor_group(rows, *grp, fac._pivot_eps, flush)
        F.extend_add(rows, *grp, d["lp"], d["poff"], d["pmp"], d["seg_ptr"], flush)
    rows_equal = torch.equal(rows, pool)
    if not rows_equal:
        failed.append(f"{names['add']}: the pool factored with the row regime in every group "
                      f"differs (max abs {dist(rows, pool):.3e})")
    del rows
    t_add = time.perf_counter() - t0
    n_gather = sum(g.add == "gather" for g in plan.groups)

    t0 = time.perf_counter()
    walks = ((F.front_sweep, F.front_sweep_plain, names, 7),
             (F.front_sweep_t, F.front_sweep_t_plain,
              {True: f"respa_front_sweep_t_fwd_{inst}", False: f"respa_front_sweep_t_bwd_{inst}",
               "red": names["red"]}, 8))
    for sweep, plain, knames, seed in walks:
        y = torch.randn(plan.part.n + 1, dtype=pool.dtype, device=pool.device,
                        generator=torch.Generator(device=pool.device).manual_seed(seed))
        y[-1] = 0
        idx = range(len(plan.groups))
        for fwd in (True, False):
            for gi in (idx if fwd else reversed(idx)):
                g, d = plan.groups[gi], dgs[gi]
                grp = (g.g0, g.nfronts, g.wp, g.rp)
                y_in = y.clone()
                yp = y.clone()
                upd = sweep(pool, y, *grp, d["piv"], d["rsx"], fwd, flush,
                            control=F.control_zeros(pool, *grp[1:]))
                updp = plain(pool, yp, *grp, d["piv"], d["rsx"], fwd, flush)
                run64 = {}

                def in64(key, g=g, d=d, y_in=y_in, fwd=fwd, run64=run64, plain=plain):
                    if not run64:  # the same inputs through the plain version in fp64
                        fronts = pool[g.g0:g.g0 + g.nfronts * g.mp * g.mp].double()
                        run64["y"] = y_in.double()
                        run64["upd"] = plain(fronts, run64["y"], 0, g.nfronts, g.wp, g.rp,
                                             d["piv"], d["rsx"], fwd, False)
                    return run64[key]

                held(knames[fwd], y, yp, yp[d["piv"].long().reshape(-1)], g, lambda: in64("y"))
                if fwd and g.rp:
                    held(knames[fwd], upd, updp, updp, g, lambda: in64("upd"))
                    yp = y.clone()
                    red = (d["red_rows"], d["red_ptr"], d["red_src"])
                    F.rows_reduce(y, upd, *red, flush)
                    F.rows_reduce_plain(yp, upd, *red, flush)
                    held(knames["red"], y, yp, yp[d["red_rows"].long()], g)
                    if not torch.equal(y, yp):  # it sums in its plain version's order
                        failed.append(f"{knames['red']}: != plain bit for bit at B={g.nfronts} "
                                      f"wp={g.wp} rp={g.rp} level={g.level}")
        if float(y[-1]) != 0.0 or not bool(torch.isfinite(y).all()):
            failed.append(f"{name}: the walked solve left y[n] != 0 or a non-finite entry")
    t_solve = time.perf_counter() - t0

    print(f"[kernel] {name_limit} | {name} at full width, {names['add']}: pool == the pool "
          f"factored with the plain extend-add, bit for bit over {len(plan.groups)} groups "
          f"({n_gather} in the gather regime): {add_err == 0.0}; == the pool factored with the "
          f"row regime in every group: {rows_equal}", flush=True)
    errs[names["add"]] = max(errs.get(names["add"], 0.0), add_err)
    full.setdefault(names["add"], {"max_rel_err_full": 0.0, "max_abs_err_full": add_err,
                                   "worst_group": f"all {len(plan.groups)} groups",
                                   "held_on": name})
    for kname, (rel, err, where) in worst.items():
        errs[kname] = max(errs.get(kname, 0.0), err)
        if rel >= full.get(kname, {}).get("max_rel_err_full", -1.0):  # a kernel two rows share
            full[kname] = {"max_rel_err_full": rel, "max_abs_err_full": err,
                           "worst_group": where, "held_on": name}
        print(f"[kernel] {name_limit} | {name} at full width, {kname}: rel_err {rel:.3e} (abs "
              f"{err:.3e}, tol {tol:.0e}), worst at {where}", flush=True)
    for kname, (ratio, rel, err, ek, ep, where) in amplified.items():
        errs[kname] = max(errs.get(kname, 0.0), err)
        full.setdefault(kname, {})["amplified"] = {
            "rel_err_vs_plain": rel, "abs_err_vs_plain": err, "kernel_from_fp64": ek, "plain_from_fp64": ep,
            "worst_group": where, "held_on": name}
        print(f"[kernel] {name_limit} | {name} at full width, {kname}: past {tol:.0e} of plain on "
              f"ill-conditioned fronts, worst at {where}: rel_err {rel:.3e} against plain; from "
              f"the fp64 result of the same inputs the kernel is {ek:.3e} away, plain {ep:.3e} "
              f"(ratio {ratio:.2f}, at most {AMPLIFIED:.0f})", flush=True)
    print(f"[kernel] {name}: all {len(plan.groups)} groups held against the plain versions in "
          f"{t_add:.1f} s (factorization) + {t_solve:.1f} s (a solve and a transposed solve "
          f"walked group by group)", flush=True)
    if failed:
        raise AssertionError(f"{name} at full width: " + "; ".join(failed))


def frontal_picks(groups):
    """Three groups of a frontal plan by index: the one with the most fronts
    among those with parents (populous), the one with the most update rows
    among those a warp or a thread block solves (tallest), and the widest
    front."""
    with_parents = [i for i, g in enumerate(groups) if g.seg_ptr.size > 1]
    narrow = [i for i, g in enumerate(groups) if g.wp <= F.MAX_TRI]
    return {"populous": max(with_parents, key=lambda i: groups[i].nfronts),
            "tallest": max(narrow, key=lambda i: (groups[i].rp, groups[i].nfronts)),
            "widest": max(range(len(groups)), key=lambda i: groups[i].wp)}


def sweep_chain(g, latency, barrier):
    """A sweep's chain bound for group ``g`` (ms and what it counts): the
    wide regime's row blocks of 64, one after the other, each handed over
    through L2 (``latency``, the link probe); the block regime's pivots,
    each handed over through shared memory past a barrier (``barrier``, the
    barrier probe); none for the warp regime, whose pivots go by shuffles
    that no probe measures."""
    if g.regime == "wide":
        links = -(-g.wp // 64) - 1
        return links * latency * 1e3, f"{links} row-block hand-overs x the link probe"
    if g.regime == "block":
        return (g.wp - 1) * barrier * 1e3, f"{g.wp - 1} pivot hand-overs x the barrier probe"
    return None, "none: a pivot goes by a shuffle, which no probe measures"


@held
def time_frontal(name_limit, fac, times, probes, latency, barrier):
    """The frontal kernels of ``fac``'s instance at the three groups of
    :func:`frontal_picks`. ``ms`` is the
    wrapper's window by events with a cold L2 (y is reset before each window,
    outside it), ``profiler_ms`` the kernel alone from a trace. The bound is
    the bytes the function needs (a sweep: the triangle, not the square it
    lies in, the panel, y's entries, the indices) at 3.35 TB/s; a sweep's
    chain bound (:func:`sweep_chain`) is printed beside it. Beside them
    the plain version; for the extend-add and the reduction the one PyTorch
    call with the same function (``index_add_`` on materialised indices, on
    ``rsx``; for the extend-add also under deterministic algorithms, the
    call that sums in a fixed order as K3 does); for a sweep the library
    route (``solve_triangular`` on the triangle read in place, the panel by
    ``matmul``). K1 at two of the groups beside its first version, from
    ``probes``."""
    plan, pool, flush = fac._plan, fac._frontal.pool, fac._frontal.flush
    inst = F._INST[pool.dtype, flush]
    item = pool.element_size()
    dgs = plan.on_device(pool.device)
    groups = plan.groups
    picks = frontal_picks(groups)
    y0 = torch.randn(plan.part.n + 1, dtype=pool.dtype, device=pool.device)
    y0[-1] = 0
    y = y0.clone()
    # K1 (the block LU, one launch for each 128 pivots of a group) at the
    # populous group and the widest front: their first diagonal blocks, read
    # in place from the factored pool, beside K1's first version
    for tag in ("populous", "widest"):
        g = groups[picks[tag]]
        w = min(g.wp, B.MAX_P)
        d = F._fronts(pool, g.g0, g.nfronts, g.mp)[:, :w, :w]
        name = f"respa_block_lu_{inst}"
        times.setdefault("block_lu_groups", {})[f"{name} {tag}"] = time_block_lu_at(
            name_limit, name, d, 1e-6, flush, probes,
            f"{tag} group (B={g.nfronts} wp={g.wp} rp={g.rp}, {-(-g.wp // B.MAX_P)} launches "
            "a factorization)", library=False)

    def reset():
        y.copy_(y0)

    def record(name, tag, shape, fn, plain_fn, lib_fn, kernel_name, nbytes, setup=None,
               extra=None, reps=10, regime=None, chain=None):
        setup = setup or (lambda: None)
        torch.cuda.synchronize()
        setup()
        t0 = time.perf_counter()
        plain_fn()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3

        def traced():
            setup()
            fn()

        t = {"ms": events_ms(fn, reps, setup), "plain_ms": plain_ms,
             "library_ms": events_ms(lib_fn, reps, setup) if lib_fn else None,
             "profiler_ms": profiler_ms(traced, kernel_name, 5),
             "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "shape": shape}
        t.update({k: f() for k, f in (extra or {}).items()})
        if regime:
            t["regime"] = regime
        more = "".join(f"; {k.replace('_', ' ')} {t[k]:.4f} ms" for k in (extra or {}))
        if chain:
            t["chain_bound"] = {"bound_ms": chain[0], "bound_by": "chain", "counts": chain[1]}
            more += (f"; chain bound {'none' if chain[0] is None else f'{chain[0]:.4f} ms'} "
                     f"({chain[1]})")
        print(f"[time] {name_limit} | {name} {tag} {shape}: {fmt_ms(t['ms'])} by events, "
              f"{fmt_ms(t['profiler_ms'])} the kernel alone by the profiler; bound "
              f"{t['bound_ms'] * 1e3:.3f} us ({nbytes} bytes at 3.35 TB/s); library "
              f"{fmt_ms(t['library_ms']).replace('not measured', 'none')}; plain "
              f"{t['plain_ms']:.2f} ms (one run, synchronised host clock){more}", flush=True)
        if tag == "populous":
            times.setdefault(name, t)
        elif name in times:
            times[name].setdefault(tag, t)

    for tag, gi in picks.items():
        g, d = groups[gi], dgs[gi]
        grp = (g.g0, g.nfronts, g.wp, g.rp)
        shape = f"B={g.nfronts} wp={g.wp} rp={g.rp} level={g.level}"
        nf, wp, rp, mp = g.nfronts, g.wp, g.rp, g.mp
        if g.seg_ptr.size > 1 and rp:
            # materialised indices: what index_add_ needs, and the distinct
            # parent entries for the bound
            l = d["lp"].long()
            ok = l >= 0
            dst = (d["poff"][:, None, None] + l[:, :, None] * d["pmp"].long()[:, None, None]
                   + l[:, None, :])[ok[:, :, None] & ok[:, None, :]]
            corner = pool[g.g0:g.g0 + nf * mp * mp].view(nf, mp, mp)[:, wp:, wp:]
            src = corner[ok[:, :, None] & ok[:, None, :]]
            touched = int(torch.unique(dst).numel())
            nbytes = (src.numel() + 2 * touched) * item + nf * (rp * 4 + 12)
            scratch = pool.clone()  # the extend-add accumulates: time it on a copy
            idx = (d["lp"], d["poff"], d["pmp"], d["seg_ptr"])
            # beside the plan's regime, the other one: the rows, or lists made
            # here (up to 8 GATHER_RP rows: a wider corner's lists take seconds)
            other = None
            if d["gather"] is None and rp <= 8 * F.GATHER_RP:
                lists = F.gather_lists(g.lp, g.poff, g.pmp, g.seg_ptr, wp, rp)
                other = lists and (lists[0], *(torch.from_numpy(x).cuda() for x in lists[1:]))
            words = sum(int(x.numel()) for x in (d["gather"] or other)[1:]) if (
                d["gather"] or other) else 0
            record(f"respa_extend_add_{inst}", tag,
                   f"{shape}, {g.seg_ptr.size - 1} parents, most children "
                   f"{int(np.diff(g.seg_ptr).max())}, {g.add} regime (gather lists "
                   f"{4 * words} bytes)",
                   lambda: F.extend_add(scratch, *grp, *idx, flush, d["gather"]),
                   lambda: F.extend_add_plain(scratch, *grp, *idx, flush),
                   lambda: scratch.index_add_(0, dst, src), "extend_add", nbytes,
                   extra={"library_deterministic_ms": lambda: deterministic_ms(
                       lambda: scratch.index_add_(0, dst, src)),
                       **({"other_regime_ms": lambda: events_ms(
                           lambda: F.extend_add(scratch, *grp, *idx, flush, other), 10)}
                          if d["gather"] is not None or other is not None else {})},
                   regime=g.add)
            del scratch, dst, src, other
        tri = wp * (wp + 1) // 2
        f3 = pool[g.g0:g.g0 + nf * mp * mp].view(nf, mp, mp)
        pv, rs = d["piv"].long(), d["rsx"].long()
        for trans, fwd in ((False, True), (False, False), (True, True), (True, False)):
            name = f"respa_front_sweep_{'t_' if trans else ''}{'fwd' if fwd else 'bwd'}_{inst}"
            kernel_name = SWEEP_KERNELS[g.regime, fwd, trans]
            # the function: the triangle and the panel once, y[piv] read and
            # written, y[rsx] read (backward) or upd written (forward), indices
            need = nf * ((tri + rp * wp + 2 * wp + rp) * item + (wp if fwd else wp + rp) * 4)

            def sweep(fwd=fwd, trans=trans):
                return (F.front_sweep_t if trans else F.front_sweep)(
                    pool, y, *grp, d["piv"], d["rsx"], fwd, flush,
                    control=F.control_zeros(pool, *grp[1:]))

            def plain(fwd=fwd, trans=trans):
                return (F.front_sweep_t_plain if trans else F.front_sweep_plain)(
                    pool, y, *grp, d["piv"], d["rsx"], fwd, flush)

            def library_route(fwd=fwd, trans=trans):
                """The same function by the library: the triangle in place
                (transposed as a view for K12)."""
                t11 = f3[:, :wp, :wp].mT if trans else f3[:, :wp, :wp]
                lower = fwd  # L11 and U11^T forward, U11 and L11^T backward
                unit = fwd != trans
                if fwd:
                    z = ftz(torch.linalg.solve_triangular(
                        t11, ftz(y[pv], flush)[..., None], upper=not lower,
                        unitriangular=unit), flush)
                    y[pv.reshape(-1)] = z.reshape(-1)
                    panel = f3[:, :wp, wp:].mT if trans else f3[:, wp:, :wp]
                    return ftz(-(panel @ z), flush)
                rhs = ftz(y[pv], flush)[..., None]
                if rp:
                    panel = f3[:, wp:, :wp].mT if trans else f3[:, :wp, wp:]
                    rhs = ftz(rhs - ftz(panel @ ftz(y[rs], flush)[..., None], flush), flush)
                z = ftz(torch.linalg.solve_triangular(t11, rhs, upper=not lower,
                                                      unitriangular=unit), flush)
                y[pv.reshape(-1)] = z.reshape(-1)
                return None

            record(name, tag, f"{shape}, {g.regime} regime x{g.tiles}", sweep,
                   plain, None, kernel_name, need, setup=reset,
                   extra={"library_route_ms": lambda: events_ms(library_route, 10, reset)},
                   chain=sweep_chain(g, latency, barrier))
        if rp and not flush:
            upd = F.front_sweep(pool, y0.clone(), *grp, d["piv"], d["rsx"], True, flush,
                                control=F.control_zeros(pool, *grp[1:]))
            red = (d["red_rows"], d["red_ptr"], d["red_src"])
            nnz, nd = g.red_src.size, g.red_rows.size
            nbytes = nnz * (item + 4) + (nd + 1) * 8 + nd * 4 + 2 * nd * item
            record("respa_rows_reduce_f64" if item == 8 else "respa_rows_reduce_f32", tag,
                   f"{shape}, {nd} rows from {nnz} sources, longest "
                   f"{int(np.diff(g.red_ptr).max())}, rows a bin {g.red_bins.tolist()}",
                   lambda: F.rows_reduce(y, upd, *red, flush),
                   lambda: F.rows_reduce_plain(y, upd, *red, flush),
                   lambda: y.index_add_(0, rs.reshape(-1), upd.reshape(-1)),
                   "rows_reduce_kernel", nbytes, setup=reset)


@held
def k2_against_first(name_limit, lu, policy, probes):
    """``--before``: K2 beside its first version (the probes'
    ``respa_band_sweep_before_*``, substitution in place of the inverses) on
    one factored band, both sweeps, in turns: each call with its output
    allocated and its mailbox zeroed in its window, as the wrapper does, by
    events and by the profiler; both held within ``SWEEP_TOL`` of plain."""
    lu = as_policy(lu, policy)
    b = torch.ones(lu.nb * lu.p, dtype=lu.policy.accum_dtype, device="cuda")
    for fwd in (True, False):
        d = "fwd" if fwd else "bwd"
        first = getattr(probes, f"respa_band_sweep_before_{d}_{INST[policy]}")

        def old(first=first):
            out = torch.empty_like(b)
            mail = torch.zeros(2 * lu.nb * lu.p * (b.element_size() // 4), dtype=torch.int32,
                               device="cuda")
            rc = first(lu.device.index, lu.nb, lu.p, lu.ml, lu.mu, lu.data.data_ptr(),
                       b.data_ptr(), out.data_ptr(), mail.data_ptr(),
                       torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"K2's first version launch failed: cudaError {rc}")
            return out

        def new(fwd=fwd):
            return B.band_sweep(lu, b, fwd)

        ref = B.band_sweep_plain(lu, b, fwd)
        errs = {}
        with uncounted():
            for who, fn in (("K2", new), ("first version", old)):
                y = fn()
                errs[who] = float((y - ref).abs().max() / ref.abs().max())
                if not errs[who] <= SWEEP_TOL[policy] or not torch.equal(bits(y), bits(fn())):
                    raise AssertionError(f"{who} {d} {policy}: err {errs[who]:.3e} or not "
                                         "reproducible")
            turns = [events_ms(fn, 5) for fn in (new, old, old, new)]
            prof = (profiler_ms(new, "band_sweep_kernel", 5), profiler_ms(old, "first_k2", 5))
        print(f"[before] {name_limit} | respa_band_sweep_{d}_{INST[policy]} nb={lu.nb} P={lu.p} "
              f"ml={lu.ml} mu={lu.mu}: K2 {min(turns[0], turns[3]):.4f} ms by events "
              f"({fmt_ms(prof[0])} by the profiler) against its first version "
              f"{min(turns[1], turns[2]):.4f} ms ({fmt_ms(prof[1])}), in turns "
              f"{', '.join(f'{t:.4f}' for t in turns)}; rel_err vs plain {errs['K2']:.2e} "
              f"against {errs['first version']:.2e}", flush=True)


@held
def k11_against_first(name_limit, lu, policy, probes):
    """``--before``: K11 beside its first version (the probes'
    ``respa_band_sweep_t_before_*``, substitution in place of the inverses)
    on one factored band, both sweeps, in turns, as :func:`k2_against_first`
    times K2; both held within ``SWEEP_TOL`` of plain."""
    lu = as_policy(lu, policy)
    b = torch.ones(lu.nb * lu.p, dtype=lu.policy.accum_dtype, device="cuda")
    for fwd in (True, False):
        d = "fwd" if fwd else "bwd"
        first = getattr(probes, f"respa_band_sweep_t_before_{d}_{INST[policy]}")

        def old(first=first):
            out = torch.empty_like(b)
            mail = torch.zeros(2 * lu.nb * lu.p * (b.element_size() // 4), dtype=torch.int32,
                               device="cuda")
            rc = first(lu.device.index, lu.nb, lu.p, lu.ml, lu.mu, lu.data.data_ptr(),
                       b.data_ptr(), out.data_ptr(), mail.data_ptr(),
                       torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"K11's first version launch failed: cudaError {rc}")
            return out

        def new(fwd=fwd):
            return B.band_sweep_t(lu, b, fwd)

        ref = B.band_sweep_t_plain(lu, b, fwd)
        errs = {}
        with uncounted():
            for who, fn in (("K11", new), ("first version", old)):
                y = fn()
                errs[who] = float((y - ref).abs().max() / ref.abs().max())
                if not errs[who] <= SWEEP_TOL[policy] or not torch.equal(bits(y), bits(fn())):
                    raise AssertionError(f"{who} {d} {policy}: err {errs[who]:.3e} or not "
                                         "reproducible")
            turns = [events_ms(fn, 5) for fn in (new, old, old, new)]
            prof = (profiler_ms(new, "band_sweep_t_kernel", 5),
                    profiler_ms(old, "first_k2::band_sweep_t", 5))
        print(f"[before] {name_limit} | respa_band_sweep_t_{d}_{INST[policy]} nb={lu.nb} "
              f"P={lu.p} ml={lu.ml} mu={lu.mu}: K11 {min(turns[0], turns[3]):.4f} ms by events "
              f"({fmt_ms(prof[0])} by the profiler) against its first version "
              f"{min(turns[1], turns[2]):.4f} ms ({fmt_ms(prof[1])}), in turns "
              f"{', '.join(f'{t:.4f}' for t in turns)}; rel_err vs plain {errs['K11']:.2e} "
              f"against {errs['first version']:.2e}", flush=True)


def first_k8_tasks(plan):
    """K8's first plan of the same positions: up to TASK_ENTRIES short
    entries of a level from its start, and runs of a level's long entries cut
    where the pairs of the long entries before them pass a multiple of 256;
    its tasks (int32 [ntasks, 4]) and warps (LOOKAHEAD levels' worth)."""
    lens = np.diff(plan.sched.ptr)
    long = lens > SP.SHORT
    level, perm, level_ptr, nlev = plan.levels.astype(np.int64), plan.perm, plan.level_ptr, \
        plan.nlevels
    ns = np.bincount(level[~long], minlength=nlev)
    k = -(-ns // SP.TASK_ENTRIES)
    lev_s = np.repeat(np.arange(nlev), k)
    first = np.zeros(nlev + 1, np.int64)
    np.cumsum(k, out=first[1:])
    q0s = level_ptr[lev_s] + SP.TASK_ENTRIES * (np.arange(lev_s.size) - first[lev_s])
    q1s = np.minimum(q0s + SP.TASK_ENTRIES, level_ptr[lev_s] + ns[lev_s])
    q_long = np.flatnonzero(long[perm])
    lev_l = level[perm[q_long]]
    c = lens[perm[q_long]]
    before = np.cumsum(c) - c
    before -= before[np.searchsorted(lev_l, lev_l)]
    cut = before // 256
    starts = np.flatnonzero(np.r_[q_long.size > 0, (np.diff(lev_l) != 0) | (np.diff(cut) != 0)])
    ends = np.r_[starts[1:], q_long.size][:starts.size] - 1
    tasks = np.concatenate([np.stack([q0s, q1s, lev_s, lev_s], 1),
                            np.stack([q_long[starts], q_long[ends] + 1, lev_l[starts],
                                      np.full(starts.size, -1)], 1)])
    tasks = tasks[np.argsort(tasks[:, 0], kind="stable")].astype(np.int32)
    return tasks, max(32, -(-SP.LOOKAHEAD * len(tasks) // max(nlev, 1)))


@held
def k8_against_first(name_limit, what, plan, d, values, eps, insts, probes):
    """``--before``: K8 beside its first version (the probes'
    ``respa_splu_factor_before_*`` on its own plan, :func:`first_k8_tasks`),
    in turns, on one pattern's plan and values: both bit for bit with plain
    twice, by events (medians of 5) and the profiler, in ms and in us a
    level."""
    old_tasks, old_warps = first_k8_tasks(plan)
    old_t = torch.from_numpy(old_tasks).cuda()
    for inst in insts:
        p = get_policy(ILU_POLICIES[inst])
        av = p.cast_host(values).cuda()

        def first(fn=getattr(probes, f"respa_splu_factor_before_{inst}")):
            out = torch.empty_like(av)
            ctl = torch.zeros(d.levels + 1, dtype=torch.int32, device="cuda")
            rc = fn(d.device.index, old_t.shape[0], old_warps, old_t.data_ptr(),
                    d.level_ptr.data_ptr(), d.perm.data_ptr(), d.ptr.data_ptr(),
                    d.pairs_a.data_ptr(), d.pairs_b.data_ptr(), d.is_lower.data_ptr(),
                    d.diag_pos_col.data_ptr(), av.data_ptr(), out.data_ptr(), float(eps),
                    ctl.data_ptr(), ctl.numel(), torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"K8's first version: cudaError {rc}")
            return out

        fns = {"K8": lambda: SP.splu_factor(d, av, eps, p.flush_to_zero),
               "first version": first}
        want = SP.splu_factor_plain(d, av, eps, p.flush_to_zero)
        with uncounted():
            for who, fn in fns.items():
                if not (torch.equal(fn(), want) and torch.equal(fn(), want)):
                    raise AssertionError(f"K8 {inst} {what}: {who} != plain")
            order = (*fns, *reversed(fns))
            turns = [(who, events_ms(fns[who], 5)) for who in order]
            prof = {who: profiler_ms(fn, "splu_factor_kernel", 5) for who, fn in fns.items()}
        best = {who: min(t for w, t in turns if w == who) for who in fns}
        print(f"[before] {name_limit} | respa_splu_factor_{inst} {what} nnz={d.nnz} "
              f"pairs={d.pairs_a.numel()} levels={d.levels} tasks={d.tasks.shape[0]} (first "
              f"plan {len(old_tasks)}), budget {plan.budget}: "
              + "; ".join(f"{who} {best[who]:.4f} ms by events ({fmt_ms(prof[who])} by the "
                          f"profiler), {best[who] * 1e3 / max(d.levels, 1):.3f} us a level"
                          for who in fns)
              + f"; in turns {', '.join(f'{w} {t:.4f}' for w, t in turns)}; all == plain bit "
              f"for bit twice", flush=True)


@held
def k3_against_first(name_limit, what, fac, probes):
    """``--before``: K3 (each group in its plan's regime) beside its first
    version (the probes' ``respa_extend_add_before_*``) at the groups
    ``time_frontal`` times, in turns, by events (10 calls, on a copy of the
    factored pool) and by the profiler; both bit for bit with plain."""
    plan, pool, flush = fac._plan, fac._frontal.pool, fac._frontal.flush
    inst = F._INST[pool.dtype, flush]
    first = getattr(probes, f"respa_extend_add_before_{inst}")
    dgs = plan.on_device(pool.device)
    groups = plan.groups
    with_parents = [i for i, g in enumerate(groups) if g.seg_ptr.size > 1 and g.rp]
    narrow = [i for i in with_parents if groups[i].wp <= F.MAX_TRI]
    picks = {"populous": max(with_parents, key=lambda i: groups[i].nfronts),
             "tallest": max(narrow, key=lambda i: (groups[i].rp, groups[i].nfronts)),
             "widest": max(with_parents, key=lambda i: groups[i].wp)}
    for tag, gi in picks.items():
        g, d = groups[gi], dgs[gi]
        grp = (g.g0, g.nfronts, g.wp, g.rp)
        idx = (d["lp"], d["poff"], d["pmp"], d["seg_ptr"])
        scratch = pool.clone()

        def old(target=scratch):
            rc = first(pool.device.index, target.data_ptr(), g.g0, g.nfronts, g.wp, g.rp,
                       d["lp"].data_ptr(), d["poff"].data_ptr(), d["pmp"].data_ptr(),
                       d["seg_ptr"].data_ptr(), g.seg_ptr.size - 1, max(1, min(512, g.rp // 8)),
                       torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"K3's first version launch failed: cudaError {rc}")

        def new(target=scratch):
            F.extend_add(target, *grp, *idx, flush, d["gather"])

        ref = pool.clone()
        F.extend_add_plain(ref, *grp, *idx, flush)
        with uncounted():
            for fn in (new, old):
                got = pool.clone()
                fn(got)
                if not torch.equal(got, ref):
                    raise AssertionError(f"K3 {what} {tag}: not bit for bit with plain")
            del got, ref
            turns = [events_ms(fn, 10) for fn in (new, old, old, new)]
            prof = (profiler_ms(new, "extend_add", 5), profiler_ms(old, "first_k3", 5))
        lists = (f"{g.ga_dst.size} entries from {g.ga_src.size} sources, at most "
                 f"{g.ga_ptr.size - 1} an entry, {np.diff(g.ga_ptr)[:4].tolist()} entries with more "
                 f"than 0-3" if g.add == "gather" else "")
        print(f"[before] {name_limit} | respa_extend_add_{inst} {what} {tag} (B={g.nfronts} "
              f"wp={g.wp} rp={g.rp}, {g.seg_ptr.size - 1} parents, most children "
              f"{int(np.diff(g.seg_ptr).max())}, {g.add} regime{': ' if lists else ''}{lists}): K3 "
              f"{min(turns[0], turns[3]):.4f} ms by events ({fmt_ms(prof[0])} by the profiler) "
              f"against its first version {min(turns[1], turns[2]):.4f} ms ({fmt_ms(prof[1])}), "
              f"in turns {', '.join(f'{t:.4f}' for t in turns)}; both bit for bit with plain",
              flush=True)
        del scratch


@held
def k12_against_first(name_limit, what, fac, probes):
    """``--before``: K12 beside its first version (the probes'
    ``respa_front_sweep_t_before_*``: K4's kernels read transposed) at the
    groups of :func:`frontal_picks`, both directions, in turns, by events
    (10 calls of the entry through ctypes, ``launch_sweep`` for K12, y reset
    before each outside the window; control words zeroed inside it for both)
    and by the profiler. Both run twice bit for bit on
    the same inputs as the plain version; K12 stays within ``FRONT_TOL`` of
    plain, or within ``AMPLIFIED`` times the first version's distance where
    the front amplifies rounding past it."""
    plan, pool, flush = fac._plan, fac._frontal.pool, fac._frontal.flush
    inst = F._INST[pool.dtype, flush]
    tol = FRONT_TOL[pool.dtype]
    dgs = plan.on_device(pool.device)
    groups = plan.groups
    y0 = torch.randn(plan.part.n + 1, dtype=pool.dtype, device=pool.device,
                     generator=torch.Generator(device=pool.device).manual_seed(12))
    y0[-1] = 0
    y = y0.clone()

    def reset():
        y.copy_(y0)

    for tag, gi in frontal_picks(groups).items():
        g, d = groups[gi], dgs[gi]
        grp = (g.g0, g.nfronts, g.wp, g.rp)
        words = F.control_words(g.nfronts, g.wp, g.rp, pool.element_size())
        tickets = g.nfronts + (g.nfronts & 1)
        for fwd in (True, False):
            dname = "fwd" if fwd else "bwd"
            first = getattr(probes, f"respa_front_sweep_t_before_{dname}_{inst}")
            shape = (g.nfronts, g.rp) if fwd else (
                (g.nfronts, g.tiles, g.wp) if g.tiles > 1 else (1,))
            out = torch.empty(shape, dtype=pool.dtype, device=pool.device)

            def old(first=first, out=out, fwd=fwd):
                ctl = torch.zeros(words, dtype=torch.int32, device=pool.device)
                rc = first(pool.device.index, pool.data_ptr(), g.g0, g.nfronts, g.wp, g.rp,
                           d["piv"].data_ptr(), d["rsx"].data_ptr(), y.data_ptr(),
                           y.numel() - 1, out.data_ptr(), F._REGIMES[g.regime], g.tiles,
                           ctl.data_ptr(),
                           ctl[tickets:].data_ptr() if g.regime == "wide" else ctl.data_ptr(),
                           torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"K12's first version launch failed: cudaError {rc}")
                return out if fwd else None

            def new(out=out, fwd=fwd):  # the wrapper's kernel part, as old() is the entry's
                F.launch_sweep(pool, y, *grp, d["piv"], d["rsx"], fwd, flush, out,
                               F.control_zeros(pool, *grp[1:]), transposed=True)
                return out if fwd else None

            def result(fn):
                reset()
                u = fn()
                torch.cuda.synchronize()
                return torch.cat([y, u.reshape(-1)]) if fwd and g.rp else y.clone()

            reset()
            yp = y0.clone()
            up = F.front_sweep_t_plain(pool, yp, *grp, d["piv"], d["rsx"], fwd, flush)
            want = torch.cat([yp, up.reshape(-1)]) if fwd and g.rp else yp
            scale = max(float(want.abs().max()), 1e-300)
            errs = {}
            with uncounted():
                for who, fn in (("K12", new), ("first version", old)):
                    got = result(fn)
                    if not torch.equal(got, result(fn)):
                        raise AssertionError(f"K12 {what} {tag} {dname}: {who} not bit for bit "
                                             "twice")
                    errs[who] = float((got.double() - want.double()).abs().max()) / scale
                if not errs["K12"] <= max(tol, AMPLIFIED * errs["first version"]):
                    raise AssertionError(f"K12 {what} {tag} {dname}: rel_err {errs['K12']:.3e} "
                                         f"against plain, the first version "
                                         f"{errs['first version']:.3e} (tol {tol:.0e})")
                turns = [events_ms(fn, 10, reset) for fn in (new, old, old, new)]
                kname = SWEEP_KERNELS[g.regime, fwd, True]
                prof = (profiler_ms(lambda: (reset(), new()), kname, 5),
                        profiler_ms(lambda: (reset(), old()),
                                    "first_k12::" + SWEEP_KERNELS[g.regime, fwd, False], 5))
            print(f"[before] {name_limit} | respa_front_sweep_t_{dname}_{inst} {what} {tag} "
                  f"(B={g.nfronts} wp={g.wp} rp={g.rp}, {g.regime} regime x{g.tiles}): K12 "
                  f"{min(turns[0], turns[3]):.4f} ms by events ({fmt_ms(prof[0])} by the "
                  f"profiler) against its first version {min(turns[1], turns[2]):.4f} ms "
                  f"({fmt_ms(prof[1])}), in turns {', '.join(f'{t:.4f}' for t in turns)}; "
                  f"rel_err vs plain {errs['K12']:.2e} against {errs['first version']:.2e}; "
                  f"both bit for bit twice", flush=True)
        del out


def before_path(name_limit, probes):
    """``--before``: K8 beside its first version at the Laplacian's fill in every instance and at
    2cubes_sphere's ILU(0) in fp32; K2, K11, K3 and K12 beside their first
    versions, in turns, at the main paths' shapes (2cubes_sphere's band factor
    in every instance; dc1 fp32, 2cubes_sphere fp64 and the Laplacian
    fp32_ftz by snlu), and each warm factorization traced with the first
    versions of K1 and K3 and with the package's, in one run."""
    cubes = corpus.load_matrix("2cubes_sphere")[0]
    # the frontal kernels first: the profiler drops records after many traces
    for what, a, policy, method in (
            ("dc1 fp32", corpus.load_matrix("dc1")[0], "fp32", "auto"),
            ("2cubes_sphere fp64", cubes, "fp64", "snlu"),
            ("laplacian_2d(300, 300) fp32_ftz", laplacian_2d(300, 300), "fp32_ftz", "snlu")):
        f = slv.factorize(a, policy, method=method, device="cuda")
        k12_against_first(name_limit, what, f, probes)
        k3_against_first(name_limit, what, f, probes)
        with uncounted():
            factor_busy(name_limit, "[before]", f"{what} multifrontal", f.refactorize_timed,
                        probes)
        del f
        torch.cuda.empty_cache()
    lap = laplacian_2d(300, 300)
    fill = analysis.symbolic_fill_lu(analysis.permute_csr(lap, analysis.ordering(lap, "fillauto")))
    for what, f, insts in (("laplacian_2d(300, 300) fill", fill, tuple(ILU_POLICIES)),
                           ("2cubes_sphere ILU(0)", cubes, ("f32",))):
        plan = SP.build_scheduled_lu(f)
        d = SP.splu_to_device(plan, "cuda")
        k8_against_first(name_limit, what, plan, d, f.data,
                         1e-4 * float(np.abs(f.data).max()), insts, probes)
        del plan, d
    del fill
    torch.cuda.empty_cache()
    fac = slv.factorize(cubes, "fp32", method="auto", device="cuda")
    fac64 = slv.factorize(cubes, "fp64", method="auto", device="cuda")
    for policy in ("fp32", "fp32_ftz", "bf16"):
        k2_against_first(name_limit, fac._lu, policy, probes)
        k11_against_first(name_limit, fac._lu, policy, probes)
    k2_against_first(name_limit, fac64._lu, "fp64", probes)
    k11_against_first(name_limit, fac64._lu, "fp64", probes)
    with uncounted():
        factor_busy(name_limit, "[before]", "2cubes_sphere fp32 band", fac.refactorize_timed,
                    probes)
    del fac, fac64
    torch.cuda.empty_cache()


def deterministic_ms(fn, reps=10):
    """``fn`` by events under ``torch.use_deterministic_algorithms(True)``:
    ``index_add_`` on the card then sums in a fixed order, as K3 does."""
    torch.use_deterministic_algorithms(True)
    try:
        return events_ms(fn, reps)
    except RuntimeError as e:  # no deterministic implementation: not measured
        print(f"[time] deterministic index_add_: not measured ({e})", flush=True)
        return float("nan")
    finally:
        torch.use_deterministic_algorithms(False)


def frontal_counts(fac):
    """Launches one factorization and one solve of ``fac`` make, from its
    plan: (block-LU, extend-add, forward sweeps, backward sweeps, reductions)."""
    groups = fac._plan.groups
    return (sum(-(-g.wp // B.MAX_P) for g in groups),
            sum(g.seg_ptr.size > 1 and g.rp > 0 for g in groups),
            len(groups), len(groups), sum(g.rp > 0 for g in groups))


def frontal_row(name_limit, name, a, policy, method, refine, inst, want_matching=None):
    """One matrix through ``factorize`` and a (refined) solve on the
    multifrontal path, with its launches held to the plan's and its
    factorization run twice and compared bit for bit."""
    b, x_true = slv.make_rhs_for_known_x(a)
    before = dict(F.LAUNCHES, **B.LAUNCHES)
    held = torch.cuda.memory_allocated()  # earlier rows' factors
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fac = slv.factorize(a, policy, method=method, device="cuda")
    t_all = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - held
    notes = fac.report.notes
    if not notes.startswith("method=snlu") or (want_matching is not None and
                                               ("matching+ruiz" in notes) != want_matching):
        raise AssertionError(f"{name}: served by [{notes}]")
    first = fac._frontal.pool.clone()
    t_warm = fac.refactorize_timed()
    if not torch.equal(first, fac._frontal.pool):
        raise AssertionError(f"{name}: two factorizations differ bit for bit")
    del first
    if refine:
        x, rep = slv.solve_refined(a, b, fac=fac)
        solves = rep.iterations - 1  # the last residual is followed by no solve
    else:
        x, rep, solves = fac.solve(b), fac.report, 1
    n_lu, n_add, n_fwd, n_bwd, n_red = frontal_counts(fac)
    now = dict(F.LAUNCHES, **B.LAUNCHES)
    got = {k: now[k] - before[k] for k in now if now[k] != before[k]}
    red = "respa_rows_reduce_f64" if inst == "f64" else "respa_rows_reduce_f32"
    want = {f"respa_block_lu_{inst}": 2 * n_lu, f"respa_extend_add_{inst}": 2 * n_add,
            f"respa_front_sweep_fwd_{inst}": solves * n_fwd,
            f"respa_front_sweep_bwd_{inst}": solves * n_bwd, red: solves * n_red}
    want = {k: v for k, v in want.items() if v}
    if got != want:
        raise AssertionError(f"{name}: launches {got}, the plan gives {want}")
    err = slv.inf_norm_error(x, x_true)
    if not (rep.residual <= 1e-10 and np.isfinite(x).all() and x.shape == (a.nrows,)):
        raise AssertionError(f"{name}: {rep}")
    ph = fac.phases
    plan = fac._plan
    print(f"[frontal] {name_limit} | {name} n={a.nrows} nnz={a.nnz} {rep.policy} [{rep.notes}] "
          f"fronts {fac.part.nsn}, groups {len(plan.groups)}, widest front "
          f"{int((plan.wp + plan.rp).max())}, fill {fac.part.fill_nnz}, pool "
          f"{fac.report.factor_bytes} bytes, peak device memory of factorize() {peak / 1e9:.2f} GB: analyze "
          f"{fac.report.t_analyze:.2f} s (matching {ph['matching']:.2f}, ordering and symbolic "
          f"{ph['symbolic']:.2f}, plan {ph['plan']:.2f}), factor cold "
          f"{fac.report.t_factorize * 1e3:.1f} ms, warm {t_warm * 1e3:.1f} ms, "
          f"{'refined ' if refine else ''}solve {rep.t_solve * 1e3:.1f} ms in {rep.iterations} "
          f"iterations, {fac._frontal.launches_per_solve} launches a solve (host clock, each "
          f"phase ended by a device synchronize; factorize() as a whole {t_all:.2f} s); residual "
          f"{rep.residual:.3e} (host oracle), inf_norm_error {err:.3e}, pivots perturbed "
          f"{rep.n_pivot_perturbed}, pivot growth {fac.report.pivot_growth:.3e}, both "
          f"factorizations bitwise equal", flush=True)
    print(f"[frontal] launches of this row {got}", flush=True)
    adds = [g for g in plan.groups if g.seg_ptr.size > 1 and g.rp > 0]
    gat = [g for g in adds if g.add == "gather"]
    words = sum(g.ga_dst.size + g.ga_src.size + g.ga_ptr.size for g in gat)
    item = fac._frontal.pool.element_size()
    print(f"[frontal] {name_limit} | {name} K3's plan: {len(gat)} of {len(adds)} groups with "
          f"parents in the gather regime (rp {sorted({g.rp for g in gat})}), their lists "
          f"{4 * words} bytes against their padded corners' {item * sum(g.nfronts * g.rp ** 2 for g in gat)} "
          f"bytes and the pool's {fac.report.factor_bytes}; {len(adds) - len(gat)} in the row "
          f"regime (rp {sorted({g.rp for g in adds if g.add == 'rows'})})", flush=True)
    return fac, x, rep


def on_two_streams(first, second):
    """Run ``first`` and ``second`` on two new streams at once; their results."""
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    out = []
    for stream, fn in zip(streams, (first, second)):
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            out.append(fn())
    torch.cuda.synchronize()
    return out


def two_streams_frontal(name_limit, fac, bd):
    """Two solves of dc1's plan on two streams at once equal the sequential
    ones bit for bit: every solve zeroes its own control words (P3). And what
    that zeroing costs beside one solve's busy time."""
    solver = fac._frontal
    b1 = bd.to(solver.pool.dtype)
    b2 = b1.flip(0).contiguous()
    x1, x2 = solver.solve_device(b1), solver.solve_device(b2)
    got = on_two_streams(lambda: solver.solve_device(b1), lambda: solver.solve_device(b2))
    if not (torch.equal(got[0], x1) and torch.equal(got[1], x2)):
        raise AssertionError("dc1: solves on two streams differ from the sequential ones")
    words = 2 * solver._ctl_off[-1]
    zero_ms = events_ms(lambda: torch.zeros(words, dtype=torch.int32, device="cuda"), 10)
    try:
        busy = sum(t for _, t in device_events(lambda: solver.solve_device(b1))) * 1e3
    except ProfilerUnavailable as e:
        print(f"[frontal] one solve's busy time not measured ({e})", flush=True)
        busy = None
    share = "not measured" if busy is None else f"{100 * zero_ms / busy:.2f}% of"
    print(f"[frontal] {name_limit} | dc1: two solves on two streams at once == the sequential "
          f"solves bit for bit; the solve's control words ({words} int32, zeroed once a solve) "
          f"take {zero_ms:.4f} ms by events, {share} one solve's busy time "
          f"{fmt_ms(busy)}", flush=True)


def graphed_frontal(name_limit, fac, bd, a, b):
    """dc1's solves through the solver's CUDA graph equal the eager loop
    (``FrontalSolver._eager``) bit for bit, K4 and K12; the graphs' hit rate
    over one refined solve (GMRES-IR's applies); and one solve's wall time
    (host clock to a synchronize, median of 10) against its busy time (the
    profiler), launch by launch and replayed."""
    solver = fac._frontal
    bp = bd.to(solver.pool.dtype)
    for sweep, solve in ((F.front_sweep, solver.solve_device),
                         (F.front_sweep_t, solver.solve_t_device)):
        eager, graphed = solver._eager(bp, sweep).clone(), solve(bp)
        if not torch.equal(eager, graphed):
            raise AssertionError(f"dc1: the graphed {sweep.__name__} solve differs from the "
                                 "eager loop")
    with timing.recording() as rec:
        _, rep = slv.solve_refined(a, b, fac=fac)
    c = {k: rec.counts.get(f"frontal_{k}", 0) for k in ("capture", "replay", "eager")}
    hit = c["replay"] / max(sum(c.values()), 1)

    def wall_busy(fn):
        walls = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        try:
            busy = sum(t for _, t in device_events(fn)) * 1e3
        except ProfilerUnavailable as e:
            print(f"[frontal] a solve's busy time not measured ({e})", flush=True)
            busy = None
        return float(np.median(walls)) * 1e3, busy

    eager_ms, eager_busy = wall_busy(lambda: solver._eager(bp, F.front_sweep))
    graph_ms, graph_busy = wall_busy(lambda: solver.solve_device(bp))
    print(f"[frontal] {name_limit} | dc1: the graphed K4 and K12 solves == the eager loop bit for "
          f"bit; one refined solve ({rep.iterations} iterations, {rep.notes}): captures "
          f"{c['capture']}, replays {c['replay']}, eager {c['eager']}, hit rate {hit:.4f}; one "
          f"solve launch by launch {eager_ms:.3f} ms wall, busy {fmt_ms(eager_busy)} "
          f"({solver.launches_per_solve} launches); replayed {graph_ms:.3f} ms wall, busy "
          f"{fmt_ms(graph_busy)}", flush=True)


def multifrontal_path(name_limit, mats, errs, full, times, probes, latency):
    """Phase 8; returns the launch counts of the frontal, block-LU and fp64
    SpMV kernels on the multifrontal path, and dc1's fp32 factorization
    (phase 13 saves it). ``latency``: the link probe's hand-over, for the
    sweeps' chain bounds."""
    reset_counts()
    a = mats["dc1"]
    if slv.structural_symmetry(a) >= 0.9:
        raise AssertionError("the dc1 stand-in should be structurally unsymmetric")
    # the circuit stand-in: band refuses, the multifrontal LU serves, matched
    fac, x, rep = frontal_row(name_limit, "dc1", a, "fp32", "auto", True, "f32", True)
    # the FEM stand-in the band path serves, by the other method, and in fp64
    cubes = mats["2cubes_sphere"]
    fac_c, _, rep_c = frontal_row(name_limit, "2cubes_sphere", cubes, "fp32", "snlu", True, "f32",
                                  False)
    del fac_c
    fac64, _, _ = frontal_row(name_limit, "2cubes_sphere", cubes, "fp64", "snlu", False, "f64")
    lap = laplacian_2d(300, 300)
    fac_z, _, _ = frontal_row(name_limit, "laplacian_2d(300, 300)", lap, "fp32_ftz", "snlu", True,
                              "f32_ftz")
    # offshore through the chain: served, or refused with each method's reason
    t0 = time.perf_counter()
    try:
        fac_o = slv.factorize(mats["offshore"], "fp32", method="auto", device="cuda")
    except MemoryError as e:
        text = str(e)
        if not ("band: band storage would need" in text and "snlu: front pool would need" in text
                and "; sparse: " in text):
            raise AssertionError(f"offshore: refusal text {text!r}") from e
        print(f"[frontal] offshore refused in {time.perf_counter() - t0:.1f} s: {text}", flush=True)
    else:
        bo, _ = slv.make_rhs_for_known_x(mats["offshore"])
        _, ro = slv.solve_refined(mats["offshore"], bo, fac=fac_o)
        if not (ro.notes.startswith("method=snlu") and ro.residual <= 1e-10):
            raise AssertionError(f"offshore: {ro}")
        print(f"[frontal] {name_limit} | offshore n={mats['offshore'].nrows} [{ro.notes}] fronts "
              f"{fac_o.part.nsn}, groups {len(fac_o._plan.groups)}, fill {fac_o.part.fill_nnz}, "
              f"pool {fac_o.report.factor_bytes} bytes: analyze {ro.t_analyze:.2f} s, factor "
              f"{ro.t_factorize * 1e3:.1f} ms, refined solve {ro.t_solve * 1e3:.1f} ms in "
              f"{ro.iterations} iterations, residual {ro.residual:.3e}, pivots perturbed "
              f"{ro.n_pivot_perturbed}", flush=True)
        del fac_o
    # the condition estimate of three factors: the transposed solves on K12
    rconds = {what: (f, *on_path_condest(what, f))
              for what, f in (("dc1 fp32", fac), ("2cubes_sphere fp64", fac64),
                              ("laplacian_2d(300, 300) fp32_ftz", fac_z))}
    launches = dict(F.LAUNCHES, **B.LAUNCHES, spmv_fp64=K.LAUNCHES["fp64"])
    no_plain("multifrontal path")
    print(f"[frontal] launches of the whole multifrontal path {launches}", flush=True)

    # beside the path, not counted: one unrefined solve, the condition
    # estimates against the plain transposed solves', every group of three
    # plans through the kernels and their plain versions, and the kernels'
    # times
    rcond_pairs(name_limit, "frontal", rconds)
    del rconds
    b, _ = slv.make_rhs_for_known_x(a)
    t0 = time.perf_counter()
    fac.solve(b)
    t_one, r_one = time.perf_counter() - t0, fac.report.residual
    bd = torch.from_numpy(b).cuda()
    x1 = fac.solve_original_device(bd)
    again = fac.solve_original_device(bd)
    if not torch.equal(x1, again):
        raise AssertionError("dc1: two solves differ bit for bit")
    two_streams_frontal(name_limit, fac, bd)
    graphed_frontal(name_limit, fac, bd, a, b)
    print(f"[frontal] {name_limit} | dc1 one fp32 solve without refinement {t_one * 1e3:.1f} ms, "
          f"residual {r_one:.3e}, bitwise equal twice", flush=True)
    for name, f in (("dc1 fp32", fac), ("2cubes_sphere fp64", fac64),
                    ("laplacian_2d(300, 300) fp32_ftz", fac_z)):
        hold_frontal_full(name_limit, name, f, errs, full)
    barrier = block_barrier(name_limit, probes)
    time_frontal(name_limit, fac, times, probes, latency, barrier)
    time_frontal(name_limit, fac64, times, probes, latency, barrier)
    with uncounted():  # K1's and K3's shares; their first versions beside them: --before
        factor_busy(name_limit, "[frontal]", "2cubes_sphere fp64 multifrontal",
                    fac64.refactorize_timed)
    del fac64
    time_frontal(name_limit, fac_z, times, probes, latency, barrier)
    with uncounted():
        factor_busy(name_limit, "[frontal]", "dc1 fp32 multifrontal", fac.refactorize_timed)
    return launches, fac


# ---------------------------------------------------------------------------
# 9. the ILU(0) path: K6 (csrc/ilu0.cu) and K7 (csrc/sptrsv.cu)
# ---------------------------------------------------------------------------


def ilu_synthetic(n=100_000, hub=50_000, seed=21):
    """A square matrix with every 7th row empty (no entry at all, no
    diagonal), about 5 entries a row on both sides of a dominant diagonal,
    and one hub row of ``hub`` entries."""
    rng = np.random.default_rng(seed)
    rows = np.r_[np.repeat(np.arange(n), 4), np.full(hub, n // 2), np.arange(n)]
    cols = np.r_[np.clip(np.repeat(np.arange(n), 4) + rng.integers(-300, 301, 4 * n), 0, n - 1),
                 rng.choice(n, hub, replace=False), np.arange(n)]
    vals = rng.uniform(-1.0, 1.0, rows.size)
    vals[rows == cols] = 8.0
    keep = rows % 7 != 3
    a = coo_to_csr(COOMatrix((n, n), rows[keep].astype(np.int32), cols[keep].astype(np.int32),
                             vals[keep]))
    a.data[a.indices == np.repeat(np.arange(n), a.row_lengths())] += np.abs(a.data).max()
    return a


def tri_synthetic(kind, n=100_000, hub=50_000, seed=22):
    """Lower triangles: random (rows with no off-diagonal entry, a hub row of
    ``hub`` entries, a zero diagonal entry); a bidiagonal chain of n levels;
    one level of n rows."""
    rng = np.random.default_rng(seed)
    if kind == "chain":
        rows, cols = np.r_[np.arange(n), np.arange(1, n)], np.r_[np.arange(n), np.arange(n - 1)]
    elif kind == "one_level":
        rows, cols = np.arange(n), np.arange(n)
    else:
        r = np.repeat(np.arange(n), 3)
        c = np.maximum(r - rng.integers(1, 2000, r.size), 0)
        rows = np.r_[r, np.full(hub, n - 1), np.arange(n)]
        cols = np.r_[c, rng.choice(n - 1, hub, replace=False), np.arange(n)]
        keep = ((rows % 7 != 3) | (rows == cols)) & ((rows > cols) | (rows == cols))
        rows, cols = rows[keep], cols[keep]
    vals = rng.uniform(0.5, 1.5, rows.size) * rng.choice((-1.0, 1.0), rows.size)
    vals[rows == cols] = 4.0
    t = coo_to_csr(COOMatrix((n, n), rows.astype(np.int32), cols.astype(np.int32), vals))
    if kind == "random":
        t.data[t.indptr[5]:t.indptr[6]][t.indices[t.indptr[5]:t.indptr[6]] == 5] = 0.0
    return t


@held
def check_ilu_synthetic(errs):
    """K6 against ``ilu0_sweep_plain`` on the synthetic matrix, every
    instance, twice, bit for bit, the slot past the output untouched, with
    the pivot fix and the residual; under fp32_ftz with subnormal old values
    too, and a subnormal partial flushed to 0."""
    a = ilu_synthetic()
    sched = analysis.chow_patel_schedule(a)
    s = I.ilu_schedule_to_device(sched, "cuda")
    rng = np.random.default_rng(23)
    for inst, policy in ILU_POLICIES.items():
        p = get_policy(policy)
        av = p.cast_host(a.data).cuda()
        old = p.cast_host(a.data * rng.uniform(0.9, 1.1, a.nnz)).cuda()
        if p.flush_to_zero:  # subnormal values off the diagonal, read by the products
            idx = torch.arange(0, a.nnz, 11, device="cuda")
            old[idx[s.kind[idx] != I.DIAG]] = 1e-40
        eps = 1e-3 * float(np.abs(a.data).max())
        outs = []
        for _ in range(2):
            out = torch.full((a.nnz + 1,), 7.0, dtype=p.dtype, device="cuda")
            _, res = I.ilu0_sweep(s, av, old, eps, True, p.flush_to_zero, True, out=out)
            outs.append((out, res))
        want, wres = I.ilu0_sweep_plain(s, av, old, eps, True, p.flush_to_zero, True)
        torch.cuda.synchronize()
        for out, res in outs:
            same = torch.equal(out[:-1], want) and torch.equal(res, wres)
            if not (same and float(out[-1]) == 7.0):
                raise AssertionError(f"K6 {inst}: kernel != plain on the synthetic matrix")
        errs[f"respa_ilu0_sweep_{inst}"] = 0.0
    # u11 = 0 - l10 u01 = -1e-39: kept by fp32, flushed by fp32_ftz
    a2 = CSRMatrix((2, 2), np.array([0, 2, 4]), np.array([0, 1, 0, 1], np.int32),
                   np.array([1.0, 1e-20, 1e-19, 0.0]))
    s2 = I.ilu_schedule_to_device(analysis.chow_patel_schedule(a2), "cuda")
    v2 = torch.tensor([1.0, 1e-20, 1e-19, 0.0], device="cuda")
    u32 = float(I.ilu0_sweep(s2, v2, v2, 1e-30, False, False)[0][3])
    uftz = float(I.ilu0_sweep(s2, v2, v2, 1e-30, False, True)[0][3])
    if not (0 < -u32 < 1.2e-38 and uftz == 0.0):
        raise AssertionError(f"K6: subnormal partial {u32} (fp32), {uftz} (fp32_ftz)")
    print(f"[kernel] K6 ilu0_sweep on n={a.nrows} nnz={a.nnz} (every 7th row empty, a hub row "
          f"of 50,000 entries; t_max {sched.t_max}, {sched.npairs} pairs): every instance twice, "
          f"== plain bit for bit with the pivot fix and the residual, out[nnz] untouched; "
          f"fp32_ftz with subnormal values; a subnormal partial flushed", flush=True)


def turned(t):
    """A lower triangle turned by 180 degrees: an upper one with the same
    rows (its hub row kept)."""
    n = t.nrows
    coo = t.tocoo()
    return coo_to_csr(COOMatrix((n, n), (n - 1 - coo.row).astype(np.int32),
                                (n - 1 - coo.col).astype(np.int32), coo.val))


@held
def check_tri_synthetic(name_limit, errs, latency):
    """K7 against ``tri_solve_plain`` (run on the host copy of the same
    inputs) on the synthetic triangles, lower and upper, with and without a
    unit diagonal on the random one, every instance, twice, bit for bit,
    y[n] untouched; the chain and the one level timed in fp64 and fp32
    beside their chain bound, and waiting on ready values instead (checked
    and timed); the chain's schedule timed on the host; two streams at once;
    a subnormal partial flushed."""
    b64 = np.random.default_rng(24).standard_normal(100_000)
    b64[::13] = 1e-40  # subnormal right-hand side entries (flushed under fp32_ftz)
    for kind in ("random", "chain", "one_level"):
        low = tri_synthetic(kind)
        if kind == "chain":
            schedule_time(name_limit, "the 100,000-level chain", low, True)
        t0 = time.perf_counter()
        for lower in (True, False):
            tri = low if lower else turned(low)
            for unit in ((False, True) if kind == "random" else (False,)):
                for inst, policy in ILU_POLICIES.items():
                    d = S.tri_to_device(tri, lower, unit, policy, device="cuda")
                    dh = S.tri_to_device(tri, lower, unit, policy, device="cpu")
                    b = torch.from_numpy(b64).to(d.policy.accum_dtype)
                    bc = b.cuda()
                    ys = []
                    for _ in range(2):
                        y = torch.full((tri.nrows + 1,), 7.0, dtype=b.dtype, device="cuda")
                        S.tri_solve(d, bc, out=y)
                        ys.append(y.cpu())
                    want = S.tri_solve_plain(dh, b)
                    for y in ys:
                        if not (torch.equal(y[:-1], want) and float(y[-1]) == 7.0):
                            raise AssertionError(f"K7 {kind} lower={lower} unit={unit} {inst}: "
                                                 "kernel != plain")
                    errs[f"respa_tri_solve_{'lower' if lower else 'upper'}_{inst}"] = 0.0
                    if kind != "random" and lower and policy in ("fp32", "fp64"):
                        if not torch.equal(S._tri_solve_flags(d, bc).cpu(), want):
                            raise AssertionError(f"K7 {kind} {inst} waiting on ready values: "
                                                 "kernel != plain")
                        ms = events_ms(lambda: S.tri_solve(d, bc), 5)
                        flags = events_ms(lambda: S._tri_solve_flags(d, bc), 5)
                        links, runs, in_runs = chain_links(d)
                        print(f"[time] K7 {policy} {kind} n={d.n} levels {d.levels} tasks "
                              f"{d.tasks.shape[0]} ({runs} runs holding {in_runs} levels): "
                              f"level counters {fmt_ms(ms)} ({ms * 1e3 / d.levels:.3f} us a "
                              f"level), ready values {fmt_ms(flags)} (== plain) by events; "
                              f"chain bound {links * latency * 1e3:.4f} ms ({links} hand-overs "
                              f"x {latency * 1e6:.4f} us)", flush=True)
        print(f"[kernel] K7 tri_solve {kind:9s} n={low.nrows} strict entries "
              f"{low.nnz - low.nrows} levels {int(analysis.level_schedule(low).max()) + 1}: "
              f"lower and upper{', unit and not' if kind == 'random' else ''}, every instance "
              f"twice, == plain bit for bit, y[n] untouched "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    d = S.tri_to_device(tri_synthetic("random"), True, False, "fp32", device="cuda")
    b = torch.from_numpy(b64).float().cuda()
    b2 = b.flip(0).contiguous()
    y1, y2 = S.tri_solve(d, b), S.tri_solve(d, b2)
    got = on_two_streams(lambda: S.tri_solve(d, b), lambda: S.tri_solve(d, b2))
    if not (torch.equal(got[0], y1) and torch.equal(got[1], y2)):
        raise AssertionError("K7: solves on two streams differ from the sequential ones")
    l2 = CSRMatrix((2, 2), np.array([0, 1, 3]), np.array([0, 0, 1], np.int32),
                   np.array([1.0, 1e-20, 1.0]))
    y32, yftz = (float(S.tri_solve(S.tri_to_device(l2, policy=p, device="cuda"),
                                   torch.tensor([1e-19, 0.0], device="cuda"))[1])
                 for p in ("fp32", "fp32_ftz"))
    if not (0 < -y32 < 1.2e-38 and yftz == 0.0):
        raise AssertionError(f"K7: subnormal partial {y32} (fp32), {yftz} (fp32_ftz)")
    print("[kernel] K7: two solves on two streams at once == sequential bit for bit; a "
          "subnormal partial kept by fp32, flushed by fp32_ftz", flush=True)


def link_probe(name_limit):
    """The card's one-way hand-over through L2 (``sptrsv.link_latency``),
    the median of 5 probes of 20,000 round trips each."""
    runs = [S.link_latency("cuda") for _ in range(5)]
    lat = float(np.median([r[0] for r in runs]))
    print(f"[time] {name_limit} | link probe: one-way hand-over through L2 {lat * 1e6:.4f} us "
          f"(median of 5: {', '.join(f'{r[0] * 1e6:.4f}' for r in runs)}; SMs "
          f"{sorted({(r[1], r[2]) for r in runs})})", flush=True)
    return lat


def ilu_counts():
    """K6's and K7's launches, and the products': the CSR kernel's by policy
    (``spmv_*``) and, for the grid Laplacian's products, the DIA kernel's."""
    return dict(I.LAUNCHES, **S.LAUNCHES, spmv_fp32=K.LAUNCHES["fp32"],
                spmv_fp32_ftz=K.LAUNCHES["fp32_ftz"], spmv_bf16=K.LAUNCHES["bf16"],
                spmv_fp64=K.LAUNCHES["fp64"], **DI.LAUNCHES)


def ilu_row(name_limit, name, policy, sweeps, must_converge):
    """One ``sweep_ilu0`` row; its launches."""
    before = ilu_counts()
    t0 = time.perf_counter()
    row = runner.sweep_ilu0([name], policy=policy, sweeps=sweeps, device="cuda",
                            verbose=False)[0]
    wall = time.perf_counter() - t0
    now = ilu_counts()
    got = {k: now[k] - before[k] for k in now if now[k] != before[k]}
    if row["status"] not in ("ok", "stagnated") or (must_converge and row["status"] != "ok"):
        raise AssertionError(f"{name} {policy}: {row}")
    if must_converge and not float(row["krylov_residual"]) <= 1e-10:
        raise AssertionError(f"{name} {policy}: residual {row['krylov_residual']}")
    print(f"[ilu] {name_limit} | {name} n={row['n']} nnz={row['nnz']} {policy}, {sweeps} "
          f"sweeps: [{row['cp_residual']}] pivots perturbed {row['pivots_perturbed']}; analyze "
          f"{float(row['t_analyze_s']) * 1e3:.1f} ms, factor {float(row['t_factor_s']) * 1e3:.1f} "
          f"ms, one apply {float(row['t_apply_s']) * 1e3:.3f} ms, GMRES(40) with host "
          f"refinement {float(row['t_krylov_s']) * 1e3:.1f} ms in {row['krylov_iters']} "
          f"iterations to {row['krylov_residual']} (host oracle): {row['status']} (host clock, "
          f"each phase ended by a device synchronize; row {wall:.2f} s)", flush=True)
    print(f"[ilu] launches of this row {got}", flush=True)
    return row


def in_turns(trees, code, timeout, tag=None):
    """Run ``code`` (``python -c``) in each tree, a process each, in the
    order given (e.g. parent, this tree, this tree, parent), so that two
    commits are compared on one card in one call. With ``tag``, a process's
    output goes to ``output/<tag>_<k>.txt`` and only its lines that
    start with ``[tag]`` are printed."""
    for k, tree in enumerate(trees):
        print(f"[turn] {os.path.abspath(tree)}", flush=True)
        run = functools.partial(subprocess.run, [sys.executable, "-c", code], cwd=tree,
                                check=True, timeout=timeout)
        if tag is None:
            run()
            continue
        os.makedirs("output", exist_ok=True)
        log = os.path.abspath(os.path.join("output", f"{tag}_{k}.txt"))
        with open(log, "w") as f:
            run(stdout=f, stderr=subprocess.STDOUT)
        with open(log) as f:
            print("".join(line for line in f if line.startswith(f"[{tag}]")), end="", flush=True)


def ilu_rows_in_turns(trees):
    """``python3 chip_smoke.py --ilu-rows TREE ...``: the sweep_ilu0 rows of
    2cubes_sphere at 30 sweeps (fp64 with exact applies, fp32 with Jacobi
    applies) by each tree's own ``ilu_row``, :func:`in_turns`, each after
    that tree's kernels and host library are built and one preconditioner
    of each policy has been made (first launches and first allocations out
    of the rows)."""
    in_turns(trees, "import chip_smoke as c, torch; name = c.card_line(); c._build.load(); "
             "c.check_parser(); a = c.corpus.load_matrix('2cubes_sphere')[0]; "
             "[c.slv.Ilu0Preconditioner(a, p, sweeps=1, device='cuda') for p in ('fp64', 'fp32')]; "
             "torch.cuda.synchronize(); "
             "[c.ilu_row(name, '2cubes_sphere', p, 30, True) for p in ('fp64', 'fp32')]", 900)


# phases 6, 10 and 11 in a tree: this file's band_phase and splu_phases,
# defined on the tree's own chip_smoke module (its paths, holds and probes)
PHASE_TIMES = """
import time, chip_smoke as c
exec(SOURCE, vars(c))
c.count_plain_calls()
name = c.card_line()
probes = c.build_probes()
c._build.load()
a = c.corpus.load_matrix('2cubes_sphere')[0]
latency = c.link_probe(name)
took, mark = {}, [time.perf_counter()]


def done(k):
    took[k], mark[0] = time.perf_counter() - mark[0], time.perf_counter()


c.band_phase(name, a, {}, {}, probes)
done(6)
c.splu_phases(name, a, latency, probes, done)
print('[phases] ' + ', '.join(f'phase {k} {v:.1f} s' for k, v in took.items()), flush=True)
"""


def phase_times_in_turns(trees):
    """``python3 chip_smoke.py --phase-times TREE ...``: phases 6, 10 and 11
    as :func:`main` runs them (:func:`band_phase`, :func:`splu_phases`) on
    each tree's own functions, :func:`in_turns`, with their seconds on one
    line; the other lines go to ``output/phases_<k>.txt``. A tree
    builds its kernels in its first process."""
    source = "\n\n".join(inspect.getsource(f) for f in (band_phase, splu_phases))
    in_turns(trees, f"SOURCE = {source!r}\n{PHASE_TIMES}", 1500, "phases")


def upload_times_in_turns(trees):
    """``python3 chip_smoke.py --upload-times TREE ...``: one upload of the
    offshore (CSR) and ecology2 (DIA, where the tree has it) stand-ins by
    each tree's own ``to_device(a, "fp32", "cuda")`` with its default
    format, :func:`in_turns`: host clock to a device synchronize, after one
    warm upload, 5 times; one JSON line a tree."""
    in_turns(trees, "import json, time, torch; from respatpu_torch.bench import corpus; "
             "from respatpu_torch.kernels.spmv import to_device; out = {}\n"
             "for m in ('offshore', 'ecology2'):\n"
             "    a = corpus.load_matrix(m)[0]; to_device(a, 'fp32', 'cuda'); "
             "torch.cuda.synchronize(); ts = []\n"
             "    for _ in range(5):\n"
             "        t0 = time.perf_counter(); d = to_device(a, 'fp32', 'cuda'); "
             "torch.cuda.synchronize(); ts.append((time.perf_counter() - t0) * 1e3)\n"
             "    out[m] = {'format': type(d).__name__, 'nnz': a.nnz, 'ms': ts}\n"
             "print('[upload] ' + json.dumps(out), flush=True)", 600)


@held
def time_ilu_alone(name_limit):
    """``python3 chip_smoke.py --ilu-times``: phase 9's measurements at the
    path's shapes alone, in a fresh process (the profiler drops records after
    the many traces of a whole run): the kernels and K6's other designs
    built in parallel, the link probe, then :func:`hold_and_time_ilu` with
    the designs; the times as one JSON line."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        designs = pool.submit(build_ilu_designs)
        _build.load()
        designs = designs.result()
    print(f"[build] kernels and K6's designs in {time.perf_counter() - t0:.1f} s", flush=True)
    check_parser()
    latency = link_probe(name_limit)
    times = {}
    hold_and_time_ilu(name_limit, corpus.load_matrix("2cubes_sphere")[0], {}, times, latency,
                      designs)
    print(json.dumps(times))


def ilu_path(name_limit, mats):
    """Phase 9: the ILU(0) path; returns its launch counts."""
    reset_counts()
    # respatpu's default of 8 sweeps, from A's own values as the first iterate,
    # leaves the FEM stand-in's factor in its transient (both packages, bit for
    # bit); by 30 sweeps the iteration has converged
    ilu_row(name_limit, "2cubes_sphere", "fp32", 8, False)
    ilu_row(name_limit, "2cubes_sphere", "fp32", 30, True)
    ilu_row(name_limit, "2cubes_sphere", "fp64", 8, False)
    ilu_row(name_limit, "2cubes_sphere", "fp64", 30, True)
    ilu_row(name_limit, "dc1", "fp32", 8, False)
    lap = laplacian_2d(300, 300)
    b, _ = slv.make_rhs_for_known_x(lap)
    # CG and BiCGSTAB in fp32; BiCGSTAB with the exact applies under every
    # single-word policy, so that each instance runs on the path
    for solver, policy, mode, tol in (("cg", "fp32", "auto", 1e-6),
                                      ("bicgstab", "fp32", "auto", 1e-6),
                                      ("bicgstab", "fp32", "scheduled", 1e-6),
                                      ("bicgstab", "fp32_ftz", "scheduled", 1e-6),
                                      ("bicgstab", "bf16", "scheduled", 1e-2)):
        pre = slv.Ilu0Preconditioner(lap, policy, apply_mode=mode, device="cuda")
        x, rep = getattr(slv, solver)(lap, b, precond=pre, policy=policy, tol=tol)
        if not (rep.converged and np.isfinite(x).all() and x.shape == (lap.nrows,)):
            raise AssertionError(f"laplacian {solver} {policy} {mode}: {rep}")
        print(f"[ilu] {name_limit} | laplacian_2d(300, 300) {solver} {policy} apply={mode}: "
              f"{rep.iterations} iterations in {rep.t_solve * 1e3:.1f} ms, residual "
              f"{rep.residual:.3e} (host oracle; tol {tol:.0e}, gate tol*100)", flush=True)
    launches = ilu_counts()
    print(f"[ilu] launches of the whole ILU path {launches}", flush=True)
    return launches


def ilu_bytes(s, itemsize):
    """Bytes one sweep must move: a, old and out once each, the offsets, the
    pairs, the kinds and the diagonal positions."""
    return s.nnz * (3 * itemsize + 8 + 1 + 4) + 8 + 8 * s.pairs_a.numel()


def tri_bytes(d):
    """Bytes one solve must move: the strict triangle (offsets, columns,
    values), dinv and b read once each, y written once."""
    return ((d.n + 1) * 8 + d.nnz * (4 + d.vals.element_size())
            + d.n * (d.dinv.element_size() + 2 * torch.finfo(d.policy.accum_dtype).bits // 8))


def chain_links(d):
    """The hand-overs on a solve's chain as its schedule makes them: a level
    outside a run is one stage, a run of thin levels one stage, and every
    stage but the first waits once. Returns (hand-overs, runs, levels in
    runs)."""
    tasks = d.tasks.cpu().numpy()
    runs = tasks[tasks[:, 3] > tasks[:, 2]]
    in_runs = int((runs[:, 3] - runs[:, 2] + 1).sum())
    return max(d.levels - in_runs + len(runs) - 1, 0), len(runs), in_runs


def schedule_time(name_limit, what, tri, lower):
    """Host seconds of K7's schedule of a triangle (``tri_schedule``, made
    once a factor inside ``tri_to_device``) and of its level sets alone
    (``level_schedule``), the median of 3."""
    strict, _ = S._strict_and_diag(tri, lower, False)
    lev, sch = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        analysis.level_schedule(strict, upper=not lower)
        t1 = time.perf_counter()
        S.tri_schedule(strict, lower)
        lev.append(t1 - t0)
        sch.append(time.perf_counter() - t1)
    print(f"[time] {name_limit} | K7 schedule of {what} (n={tri.nrows}, strict entries "
          f"{strict.nnz}) on the host: tri_schedule {np.median(sch) * 1e3:.1f} ms, of which "
          f"level_schedule {np.median(lev) * 1e3:.1f} ms (median of 3)", flush=True)


def schedule_sizes(name_limit, name, a):
    """The Chow-Patel pair lists of a matrix: t_max, pairs, and the bytes of
    the lists on the card ragged (as the port keeps them) and padded to t_max
    (as respatpu does)."""
    t0 = time.perf_counter()
    sched = analysis.chow_patel_schedule(a)
    lay = sched.layout_bytes()
    print(f"[ilu] {name} n={a.nrows} nnz={a.nnz}: Chow-Patel t_max {sched.t_max}, "
          f"{sched.npairs} pairs; pair lists on the card {lay['ragged']} bytes ragged, "
          f"{lay['padded']} padded to t_max (host {time.perf_counter() - t0:.2f} s)", flush=True)


def build_ilu_designs():
    """K6's other designs (``bench/csrc/ilu0_designs.cu``, which includes the
    package's kernel source) in a library of their own, bound by ctypes."""
    path = build_shared("librespa_ilu0_designs.so",
                        [os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                      ILU_DESIGNS_SOURCE)],
                        [_build._nvcc(), *_build.NVCC_FLAGS])
    lib = ctypes.CDLL(path)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # design, inst, device, nnz, a, old, out, ptr, pairs_a, pairs_b, kind, diag_col, eps, fix,
    # resid, stream
    lib.respa_ilu0_design_sweep.argtypes = [i32, i32, i32, ctypes.c_int64, *[ptr] * 8,
                                            ctypes.c_double, i32, ptr, ptr]
    lib.respa_ilu0_design_sweep.restype = i32
    return lib


def design_sweep(lib, design, inst, s, av, old, eps, resid=None):
    """One sweep (with the pivot fix) by one of ``ILU_DESIGNS``; not counted."""
    out = torch.empty_like(av)
    rc = lib.respa_ilu0_design_sweep(
        design, list(ILU_POLICIES).index(inst), s.device.index, s.nnz, av.data_ptr(),
        old.data_ptr(), out.data_ptr(), s.ptr.data_ptr(), s.pairs_a.data_ptr(),
        s.pairs_b.data_ptr(), s.kind.data_ptr(), s.diag_pos_col.data_ptr(), float(eps), 1,
        None if resid is None else resid.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K6 design {design} {inst}: cudaError {rc}")
    return out


@held
def compare_ilu_designs(name_limit, lib, inst, s, av, old, eps, want, wres):
    """K6's designs at the path's input, each == plain bit for bit (with the
    residual too), then timed by the profiler in 3 rounds (the order turned
    each round; a trace of the designs without the residual, then one with
    it, 5 sweeps a design, so that no trace holds many records): {design:
    {"profiler_ms": [a round's median], "residual_profiler_ms": [...]}}; a
    round the profiler could not trace is left out and said so."""
    acc = I._acc(av.dtype)
    for d, label in enumerate(ILU_DESIGNS):
        r = torch.zeros(1, dtype=acc, device="cuda")
        if not (torch.equal(design_sweep(lib, d, inst, s, av, old, eps), want)
                and torch.equal(design_sweep(lib, d, inst, s, av, old, eps, r), want)
                and torch.equal(r, wres)):
            raise AssertionError(f"K6 {inst} {label}: != plain on 2cubes_sphere")
    resid = torch.zeros(1, dtype=acc, device="cuda")
    fns = [lambda d=d, r=r: design_sweep(lib, d, inst, s, av, old, eps, r)
           for r in (None, resid) for d in range(len(ILU_DESIGNS))]
    nd = len(ILU_DESIGNS)
    got = {i: [] for i in range(len(fns))}
    for k in range(3):
        for group in (range(nd), range(nd, 2 * nd)):
            order = list(group)[::1 if k % 2 == 0 else -1]
            try:
                ts = kernel_times([fns[i] for i in order], "sweep_kernel", reps=5)
            except ProfilerUnavailable as e:
                print(f"[time] K6 {inst} designs, round {k + 1}: not measured ({e})", flush=True)
                continue
            for i, t in zip(order, ts):
                got[i].append(float(np.median(t)) * 1e3)
    out = {label: {"profiler_ms": got[d], "residual_profiler_ms": got[nd + d]}
           for d, label in enumerate(ILU_DESIGNS)}
    for label, t in out.items():
        print(f"[time] {name_limit} | K6 {inst} design '{label}': profiler "
              f"{', '.join(f'{x:.4f}' for x in t['profiler_ms'])} ms (rounds); with the "
              f"residual {', '.join(f'{x:.4f}' for x in t['residual_profiler_ms'])} ms; == "
              f"plain bit for bit", flush=True)
    return out


@held
def hold_and_time_ilu(name_limit, a, errs, times, latency, designs):
    """Beside the path, not counted: K6 and K7 against their plain versions
    at the main path's shapes (one sweep of 2cubes_sphere's factorization in
    every instance; the L and U solves of its fp64 factor, and in every
    instance on the same triangles), bit for bit, each timed beside its
    bound, the library and plain, and K6 beside its other designs if
    ``designs`` (the library of :func:`build_ilu_designs`) is given; one
    Jacobi and one exact apply whole."""
    pre64 = slv.Ilu0Preconditioner(a, "fp64", sweeps=30, device="cuda")
    pre32 = slv.Ilu0Preconditioner(a, "fp32", sweeps=30, device="cuda")
    sched = pre64.schedule
    s = I.ilu_schedule_to_device(sched, "cuda")
    lev = {t.lower: t.levels for t in (pre64._l, pre64._u)}
    lay = sched.layout_bytes()
    print(f"[ilu] {name_limit} | 2cubes_sphere n={a.nrows} nnz={a.nnz}: Chow-Patel t_max "
          f"{sched.t_max}, {sched.npairs} pairs; pair lists on the card {lay['ragged']} bytes "
          f"ragged, {lay['padded']} padded to t_max; levels of L {lev[True]}, of U "
          f"{lev[False]}", flush=True)
    eps = 1e-4 * float(np.abs(a.data).max())
    for inst, policy in ILU_POLICIES.items():
        p = get_policy(policy)
        av = p.cast_host(a.data).cuda()
        # the factorization's second sweep: A's values, and the first sweep's
        # result as the iterate, a tensor of its own as on the path
        old, _ = I.ilu0_sweep(s, av, av.clone(), eps, True, p.flush_to_zero)
        out, _ = I.ilu0_sweep(s, av, old, eps, True, p.flush_to_zero)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want, _ = I.ilu0_sweep_plain(s, av, old, eps, True, p.flush_to_zero)
        torch.cuda.synchronize()
        plain = (time.perf_counter() - t0) * 1e3
        if not torch.equal(out, want):
            raise AssertionError(f"K6 {inst}: kernel != plain on 2cubes_sphere")
        _, wres = I.ilu0_sweep_plain(s, av, old, eps, True, p.flush_to_zero, True)
        name = f"respa_ilu0_sweep_{inst}"
        nbytes = ilu_bytes(s, p.dtype.itemsize)
        ops = 2 * sched.npairs + a.nnz
        bound = max(nbytes / HBM_BYTES_PER_S, ops / FLOPS_PER_S[p.accum_dtype]) * 1e3
        t = {"ms": events_ms(lambda: I.ilu0_sweep(s, av, old, eps, True, p.flush_to_zero), 10),
             "profiler_ms": profiler_ms(lambda: I.ilu0_sweep(s, av, old, eps, True,
                                                             p.flush_to_zero),
                                        "ilu0_sweep_kernel", 10),
             "profiler_read_flush_ms": profiler_ms(
                 lambda: I.ilu0_sweep(s, av, old, eps, True, p.flush_to_zero),
                 "ilu0_sweep_kernel", 10, flush="read"),
             "plain_ms": plain, "bound_ms": bound, "bound_by": "bytes", "library_ms": None,
             "library": "none: no PyTorch call computes a Chow-Patel sweep",
             "shape": f"2cubes_sphere nnz={a.nnz} pairs={sched.npairs}",
             }
        if designs is not None:
            t["designs"] = compare_ilu_designs(name_limit, designs, inst, s, av, old, eps, want,
                                               wres)
        times[name] = t
        errs[name] = 0.0
        print(f"[time] {name_limit} | K6 {inst} one sweep of 2cubes_sphere: events "
              f"{fmt_ms(t['ms'])}, profiler {fmt_ms(t['profiler_ms'])} (after a read flush "
              f"{fmt_ms(t['profiler_read_flush_ms'])}, no dirty lines to write back); bound "
              f"{bound:.4f} ms ({nbytes} bytes at 3.35 TB/s); library none; plain "
              f"{plain:.2f} ms; == plain bit for bit", flush=True)
    b = torch.from_numpy(np.random.default_rng(25).standard_normal(a.nrows)).cuda()
    for tri64 in (pre64._l, pre64._u):
        lower = tri64.lower
        full = _with_diagonal(tri64.strict_csr(), 1.0 / tri64.dinv.cpu().double().numpy())
        schedule_time(name_limit, f"2cubes_sphere's {'L' if lower else 'U'}", full, lower)
        links, runs, in_runs = chain_links(tri64)
        print(f"[ilu] {name_limit} | 2cubes_sphere's {'L' if lower else 'U'}: {lev[lower]} "
              f"levels, {tri64.tasks.shape[0]} tasks, of which {runs} runs of thin levels "
              f"holding {in_runs} levels: {links} hand-overs on the chain", flush=True)
        for inst, policy in ILU_POLICIES.items():
            d = tri64 if policy == "fp64" else S.tri_to_device(full, lower, lower, policy,
                                                               device="cuda")
            bb = b.to(d.policy.accum_dtype)
            ys = [S.tri_solve(d, bb) for _ in range(2)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = S.tri_solve_plain(d, bb)
            torch.cuda.synchronize()
            plain = (time.perf_counter() - t0) * 1e3
            if not all(torch.equal(y, want) for y in ys):
                raise AssertionError(f"K7 {inst} lower={lower}: kernel != plain on 2cubes_sphere")
            y = ys[0]
            if not torch.equal(S._tri_solve_flags(d, bb), want):
                raise AssertionError(f"K7 {inst} lower={lower} waiting on ready values: kernel "
                                     "!= plain on 2cubes_sphere")
            name = f"respa_tri_solve_{'lower' if lower else 'upper'}_{inst}"
            nbytes = tri_bytes(d)
            ops = 2 * d.nnz + 2 * d.n
            bound = max(nbytes / HBM_BYTES_PER_S, ops / FLOPS_PER_S[d.policy.accum_dtype]) * 1e3
            lib_ms, lib = None, "none: PyTorch has no sparse triangular solve that flushes " \
                                "subnormals or takes bf16 values"
            if policy in ("fp32", "fp64"):
                lib_ms, lib = library_tri(full, lower, d.policy, bb, y)
            chain = links * latency * 1e3
            t = {"ms": events_ms(lambda: S.tri_solve(d, bb), 10),
                 "profiler_ms": profiler_ms(lambda: S.tri_solve(d, bb), "tri_solve_kernel", 10),
                 "plain_ms": plain, "bound_ms": bound, "bound_by": "bytes", "library_ms": lib_ms,
                 "library": lib, "shape": f"2cubes_sphere {'L' if lower else 'U'} n={d.n} "
                                          f"strict={d.nnz} levels={lev[lower]}",
                 "chain_bound": {"bound_ms": chain, "bound_by": "chain", "levels": lev[lower],
                                 "runs": runs, "levels_in_runs": in_runs, "hand_overs": links,
                                 "link_us": latency * 1e6},
                 "signal": "level",
                 "other_signal": {
                     "signal": "flags",
                     "ms": events_ms(lambda: S._tri_solve_flags(d, bb), 10),
                     "profiler_ms": profiler_ms(lambda: S._tri_solve_flags(d, bb),
                                                "tri_solve_kernel", 10)}}
            times[name] = t
            errs[name] = 0.0
            print(f"[time] {name_limit} | K7 {inst} {'L' if lower else 'U'} solve of "
                  f"2cubes_sphere ({lev[lower]} levels), waiting on level counters: events "
                  f"{fmt_ms(t['ms'])}, profiler {fmt_ms(t['profiler_ms'])}; on ready values: "
                  f"events {fmt_ms(t['other_signal']['ms'])}, profiler "
                  f"{fmt_ms(t['other_signal']['profiler_ms'])}; chain bound {chain:.4f} ms "
                  f"({links} hand-overs x {latency * 1e6:.4f} us); byte bound {bound:.4f} ms "
                  f"({nbytes} bytes at 3.35 TB/s); library "
                  f"{fmt_ms(lib_ms) if lib_ms else lib}; plain {plain:.2f} ms; == plain bit for "
                  f"bit both ways", flush=True)
    t0 = time.perf_counter()
    isai = slv.Ilu0Preconditioner(a, "fp32", sweeps=30, apply_mode="isai", device="cuda")
    print(f"[ilu] {name_limit} | 2cubes_sphere ISAI of both triangles built on the host in "
          f"{isai.report.t_analyze:.2f} s (preconditioner {time.perf_counter() - t0:.2f} s)",
          flush=True)
    for what, pre, bb in (("Jacobi (6 sweeps a triangle, fp32)", pre32, b.float()),
                          ("ISAI (one SpMV a triangle, fp32)", isai, b.float()),
                          ("exact (K7, fp64)", pre64, b)):
        windows = [events_ms(lambda: pre.apply(bb), 10) for _ in range(5)]
        busy = "not measured"
        try:  # the card's own time for the same work, launches and host left out
            ev = device_events(lambda: [pre.apply(bb) for _ in range(10)])
            busy = f"{sum(t for _, t in ev) * 1e3 / 10:.4f} ms in {len(ev) / 10:.0f} records"
        except ProfilerUnavailable as e:
            busy += f" ({e})"
        print(f"[time] {name_limit} | one {what} apply of 2cubes_sphere's ILU(0), whole: "
              f"{float(np.median(windows)):.4f} ms by events (median of 5 windows, each the "
              f"median of 10: {', '.join(f'{w:.4f}' for w in windows)}); device busy an apply "
              f"{busy}", flush=True)
    krylov_profile(name_limit, a, pre32)


def _with_diagonal(strict, diag):
    n = strict.nrows
    rows = np.r_[np.repeat(np.arange(n), strict.row_lengths()), np.arange(n)]
    cols = np.r_[strict.indices, np.arange(n)]
    return coo_to_csr(COOMatrix((n, n), rows.astype(np.int32), cols.astype(np.int32),
                                np.r_[strict.data, diag]))


def library_tri(full, lower, policy, b, y):
    """ms of ``torch.triangular_solve`` with the triangle as a sparse CSR
    tensor (cuSPARSE; timed here, never called by the package), or None and
    why it did not run."""
    a_csr = torch.sparse_csr_tensor(torch.from_numpy(full.indptr).cuda(),
                                    torch.from_numpy(full.indices.astype(np.int64)).cuda(),
                                    torch.from_numpy(full.data).to(policy.dtype).cuda(),
                                    size=full.shape)
    unit = bool(lower)  # L is unit lower; U has its diagonal
    try:
        got = torch.triangular_solve(b[:, None], a_csr, upper=not lower,
                                     unitriangular=unit).solution[:, 0]
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, TypeError) as e:
        return None, f"refused by the installed torch: {str(e)[:120]}"
    err = rel_err(got, y)
    if not err <= (1e-10 if policy.dtype == torch.float64 else 1e-3):
        return None, f"disagrees with the kernel (rel_err {err:.3e})"
    return events_ms(lambda: torch.triangular_solve(b[:, None], a_csr, upper=not lower,
                                                    unitriangular=unit), 10), \
        f"torch.triangular_solve on a sparse CSR tensor (rel_err {err:.2e} to the kernel)"


def krylov_profile(name_limit, a, pre):
    """One GMRES(40) solve of 2cubes_sphere with the fp32 ILU(0) under the
    profiler: wall against busy, and the busiest kernels."""
    b, _ = slv.make_rhs_for_known_x(a)
    wall = [0.0]

    def run():
        t0 = time.perf_counter()
        slv.gmres(a, b, precond=pre, tol=1e-7)
        wall[0] = time.perf_counter() - t0

    try:
        events = device_events(run)
    except ProfilerUnavailable as e:
        print(f"[profile] GMRES not profiled ({e})", flush=True)
        return
    busy = sum(t for _, t in events)
    print(f"[profile] {name_limit} | 2cubes_sphere GMRES(40) fp32, ILU(0) Jacobi applies, tol "
          f"1e-7: wall {wall[0] * 1e3:.1f} ms, device busy {busy * 1e3:.2f} ms "
          f"({100 * busy / wall[0]:.1f}%) in {len(events)} records", flush=True)
    for key, n, tot in busy_by_name(events, top=8):
        print(f"[profile]   {key}: {n} records, {tot * 1e3:.3f} ms", flush=True)



# ---------------------------------------------------------------------------
# 10-12. the scheduled LU (K8, csrc/splu.cu) and the DIA SpMV (K9, csrc/dia.cu)
# ---------------------------------------------------------------------------


def splu_counts():
    """The launch counts the scheduled-LU and DIA paths read."""
    return dict(SP.LAUNCHES, **DI.LAUNCHES, **S.LAUNCHES,
                **{f"spmv_{p}": n for p, n in K.LAUNCHES.items()})


def splu_bytes(d, itemsize):
    """Bytes one factorization must move through device memory: the pair
    positions once (two int32 a pair) and each entry's own words (A's value
    read, its value written, its first pair and count, kind, diagonal
    position and place in the plan), the tasks and level offsets. The values a pair gathers are
    the factor's own, written by this launch and read back through L2, which
    holds them (at most 40 MB on the path, of 50): each is counted once, in
    its write; the gathers are set against L2 on their own
    (:func:`splu_gather_bytes`)."""
    return (d.pairs_a.numel() * 8 + d.nnz * (2 * itemsize + 8 + 4 + 1 + 4 + 4)
            + d.tasks.numel() * 4 + d.level_ptr.numel() * 4)


def splu_gather_bytes(d, itemsize):
    """Bytes of the value gathers through L2: two values a pair."""
    return d.pairs_a.numel() * 2 * itemsize


def block_barrier(name_limit, probes, rounds=(1 << 14, 1 << 17)):
    """Seconds of one barrier with a shared-memory hand-over in a block of
    256 threads (``respa_barrier_probe``), K1's least step a pivot: the
    difference of two launches' times over the difference of their rounds
    (the launch itself cancels), each the median of 10 by events."""
    out = torch.zeros(1, dtype=torch.float32, device="cuda")

    def launch(r):
        rc = probes.respa_barrier_probe(out.device.index, r, out.data_ptr(),
                                        torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"respa_barrier_probe: cudaError {rc}")
    ms = [events_ms(lambda r=r: launch(r), 10) for r in rounds]
    step = (ms[1] - ms[0]) * 1e-3 / (rounds[1] - rounds[0])
    print(f"[time] {name_limit} | block barrier probe: {rounds[0]} and {rounds[1]} hand-overs "
          f"through shared memory past a barrier of 256 threads in {ms[0]:.4f} and {ms[1]:.4f} "
          f"ms (medians of 10 by events): {step * 1e9:.2f} ns a hand-over", flush=True)
    return step


def l2_read_rate(name_limit, probes, mib=16, rounds=64):
    """The card's L2 read rate: bytes/s of one probe launch
    (``respa_l2_read_probe``) that reads a ``mib`` MiB buffer, small enough to
    stay in L2, ``rounds`` times over through L2 alone, the median of 10 by
    events, each after the one before (no flush). K8's value gathers are set against it (a
    gather of a word takes a whole 32-byte sector, so gathers go slower)."""
    buf = torch.ones((mib << 20) // 4, dtype=torch.float32, device="cuda")
    out = torch.zeros(1, dtype=torch.float32, device="cuda")

    def probe():
        rc = probes.respa_l2_read_probe(buf.device.index, buf.data_ptr(), buf.numel() // 4,
                                        rounds, out.data_ptr(),
                                        torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"respa_l2_read_probe: cudaError {rc}")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    probe()
    times = []
    for _ in range(10):  # the buffer stays warm in L2: no flush between launches
        start.record()
        probe()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    ms = float(np.median(times))
    rate = rounds * (mib << 20) / (ms * 1e-3)
    print(f"[time] {name_limit} | L2 read probe: {mib} MiB read {rounds} times through L2 in "
          f"{ms:.4f} ms, {rate / 1e12:.3f} TB/s (median of 10 by events, warm)", flush=True)
    return rate


@held
def hold_splu(what, d, values, eps, insts, errs, plain=True):
    """K8 against its plain version on a plan and values (A's values on the
    pattern, fp64 on the host), twice, bit for bit, in each instance of
    ``insts``, the slot past the output untouched; returns {instance: (A's
    values on the card, plain ms)}. Without ``plain`` the two runs are held
    to each other alone (plain ms None): for instances that phase 10 holds
    against plain on other plans."""
    out = {}
    for inst in insts:
        p = get_policy(ILU_POLICIES[inst])
        av = p.cast_host(values).cuda()
        runs = []
        for _ in range(2):
            o = torch.full((d.nnz + 1,), 7.0, dtype=p.dtype, device="cuda")
            SP.splu_factor(d, av, eps, p.flush_to_zero, out=o)
            runs.append(o)
        torch.cuda.synchronize()
        ms = None
        if plain:
            t0 = time.perf_counter()
            want = SP.splu_factor_plain(d, av, eps, p.flush_to_zero)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            errs[f"respa_splu_factor_{inst}"] = 0.0
        else:
            want = runs[1][:-1]
        if not all(torch.equal(o[:-1], want) and float(o[-1]) == 7.0 for o in runs):
            raise AssertionError(f"K8 {inst} on {what}: kernel != plain, or not twice the same")
        held = "== plain bit for bit twice" if plain else "bit for bit twice (phase 10 holds it)"
        print(f"[kernel] K8 {inst} {what} nnz={d.nnz} pairs={d.pairs_a.numel()}: {held}",
              flush=True)
        out[inst] = (av, ms)
    return out


@held
def hold_and_time_splu(name_limit, what, d, values, eps, insts, errs, latency, l2, reps=10,
                       hold=True):
    """K8 held against its plain version (:func:`hold_splu`) on the path's
    own plan and values (with ``hold=False`` only repeated bit for bit), then
    timed by events and the profiler beside its
    byte and chain bounds, its value gathers against the L2 read rate ``l2``
    (bytes/s, :func:`l2_read_rate`), and the plain version (one run, host
    clock to a synchronize; None without the hold). Returns {kernel name:
    times}."""
    out = {}
    for inst, (av, plain) in hold_splu(what, d, values, eps, insts, errs, hold).items():
        p = get_policy(ILU_POLICIES[inst])
        name = f"respa_splu_factor_{inst}"
        nbytes = splu_bytes(d, p.dtype.itemsize)
        gather = splu_gather_bytes(d, p.dtype.itemsize)
        ops = 2 * d.pairs_a.numel() + 2 * d.nnz
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = ops / FLOPS_PER_S[p.accum_dtype] * 1e3
        chain = max(d.levels - 1, 0) * latency * 1e3
        t = {"ms": events_ms(lambda: SP.splu_factor(d, av, eps, p.flush_to_zero), reps),
             "profiler_ms": profiler_ms(lambda: SP.splu_factor(d, av, eps, p.flush_to_zero),
                                        "splu_factor_kernel", reps),
             "plain_ms": plain, "bound_ms": max(by_bytes, by_ops),
             "bound_by": "bytes" if by_bytes >= by_ops else "operations",
             "library_ms": None,
             "library": "none: PyTorch has no sparse LU on the card",
             "shape": f"{what} nnz={d.nnz} pairs={d.pairs_a.numel()} levels={d.levels} "
                      f"tasks={d.tasks.shape[0]} budget={SP.PAIR_BUDGET}",
             "l2_gather_ms": gather / l2 * 1e3, "l2_read_bytes_per_s": l2,
             "chain_bound": {"bound_ms": chain, "bound_by": "chain", "levels": d.levels,
                             "hand_overs": max(d.levels - 1, 0), "link_us": latency * 1e6}}
        out[name] = t
        t["us_a_level"] = t["ms"] * 1e3 / max(d.levels, 1)
        print(f"[time] {name_limit} | K8 {inst} {t['shape']}: events {fmt_ms(t['ms'])} "
              f"({t['us_a_level']:.3f} us a level), profiler {fmt_ms(t['profiler_ms'])}; byte "
              f"bound {by_bytes:.4f} ms ({nbytes} "
              f"bytes at 3.35 TB/s; {ops} operations {by_ops:.4f} ms); value gathers "
              f"{t['l2_gather_ms']:.4f} ms ({gather} bytes at the L2 read rate {l2 / 1e12:.3f} "
              f"TB/s); chain bound {chain:.4f} ms ({d.levels - 1} hand-overs x "
              f"{latency * 1e6:.4f} us); library none; plain "
              f"{'not run' if plain is None else f'{plain:.1f} ms'}", flush=True)
    return out


def splu_ilu_path(name_limit):
    """Phase 10: exact ILU(0) by the scheduled LU on the path: the
    2cubes_sphere ``sweep_ilu0`` rows with ``method="scheduled"`` (fp64 with
    the exact applies, fp32 with Jacobi applies), each GMRES(40) refined on
    the host to the oracle's 1e-10, and BiCGSTAB with exact ILU(0) and exact
    applies on the grid Laplacian under fp32_ftz and bf16; returns the
    launch counts."""
    reset_counts()
    if not native.available():
        raise AssertionError("the host library (entry levels of the scheduled LU) did not build")
    for policy in ("fp64", "fp32"):
        t0 = time.perf_counter()
        row = runner.sweep_ilu0(["2cubes_sphere"], policy=policy, method="scheduled",
                                device="cuda", verbose=False)[0]
        if row["status"] != "ok" or not float(row["krylov_residual"]) <= 1e-10 \
                or not row["cp_residual"].startswith("exact_scheduled"):
            raise AssertionError(f"2cubes_sphere {policy} exact ILU(0): {row}")
        print(f"[splu] {name_limit} | 2cubes_sphere n={row['n']} nnz={row['nnz']} {policy} exact "
              f"ILU(0) [{row['cp_residual']}] pivots perturbed {row['pivots_perturbed']}; analyze "
              f"{float(row['t_analyze_s']) * 1e3:.1f} ms, factor (plan on the host and one K8 "
              f"launch) {float(row['t_factor_s']) * 1e3:.1f} ms, one apply "
              f"{float(row['t_apply_s']) * 1e3:.3f} ms, GMRES(40) with host refinement "
              f"{float(row['t_krylov_s']) * 1e3:.1f} ms in {row['krylov_iters']} iterations to "
              f"{row['krylov_residual']} (host oracle): {row['status']} (host clock, each phase "
              f"ended by a device synchronize; row {time.perf_counter() - t0:.2f} s)", flush=True)
    lap = laplacian_2d(300, 300)
    b, _ = slv.make_rhs_for_known_x(lap)
    for policy, tol in (("fp32_ftz", 1e-6), ("bf16", 1e-2)):
        pre = slv.Ilu0Preconditioner(lap, policy, method="scheduled", apply_mode="scheduled",
                                     device="cuda")
        x, rep = slv.bicgstab(lap, b, precond=pre, policy=policy, tol=tol)
        if not (rep.converged and np.isfinite(x).all() and pre.report.notes == "exact_scheduled"):
            raise AssertionError(f"laplacian bicgstab {policy} exact ILU(0): {rep}")
        print(f"[splu] {name_limit} | laplacian_2d(300, 300) bicgstab {policy}, exact ILU(0) and "
              f"exact applies: {rep.iterations} iterations in {rep.t_solve * 1e3:.1f} ms, residual "
              f"{rep.residual:.3e} (host oracle; tol {tol:.0e}, gate tol*100)", flush=True)
    launches = splu_counts()
    print(f"[splu] launches of the exact ILU(0) path {launches}", flush=True)
    return launches


@held
def hold_splu_ilu(name_limit, a, errs, times, latency, l2):
    """Beside phase 10, not counted: 2cubes_sphere's ILU(0) plan (entry
    levels and tasks, with their host time), K8 in every instance against
    its plain version on it and timed; K8 in fp32_ftz and bf16 against its
    plain version on the grid Laplacian's ILU(0), the BiCGSTAB rows' shape;
    and the exact factor against the 30-sweep Chow-Patel one."""
    sched = analysis.chow_patel_schedule(a)
    t0 = time.perf_counter()
    lev = SP.entry_levels(sched)
    t1 = time.perf_counter()
    plan = SP.build_scheduled_lu(a, sched)
    t2 = time.perf_counter()
    d = SP.splu_to_device(plan, "cuda")
    long = int((np.diff(sched.ptr) > SP.SHORT).sum())
    print(f"[splu] {name_limit} | 2cubes_sphere ILU(0) plan: nnz {a.nnz}, {sched.npairs} pairs, "
          f"t_max {sched.t_max}, {plan.nlevels} entry levels (max {int(lev.max())}), "
          f"{len(plan.tasks)} tasks ({long} long entries), {plan.warps} warps; host: entry "
          f"levels {(t1 - t0) * 1e3:.1f} ms, whole plan {(t2 - t0) * 1e3:.1f} ms", flush=True)
    eps = 1e-4 * float(np.abs(a.data).max())
    times.update(hold_and_time_splu(name_limit, "2cubes_sphere ILU(0)", d, a.data, eps,
                                    tuple(ILU_POLICIES), errs, latency, l2))
    # the BiCGSTAB rows' instances at their own shape: the grid Laplacian's ILU(0)
    lap = laplacian_2d(300, 300)
    dl = SP.splu_to_device(SP.build_scheduled_lu(lap), "cuda")
    hold_splu("laplacian_2d(300, 300) ILU(0)", dl, lap.data, 1e-4 * float(np.abs(lap.data).max()),
              ("f32_ftz", "bf16"), errs)
    del dl
    for policy in ("fp64", "fp32"):
        p = get_policy(policy)
        e = (1e-13 if policy == "fp64" else 1e-4) * float(np.abs(a.data).max())
        exact = SP.splu_factor(d, p.cast_host(a.data).cuda(), e).double()
        cp, _ = I.ilu0_factor(a, sched=sched, policy=policy, sweeps=30, device="cuda")
        diff = float((cp.values.double() - exact).abs().max() / exact.abs().max())
        oracle = I.ilu0_host_reference(a) if policy == "fp64" else None
        extra = ""
        if oracle is not None:
            extra = (f"; exact vs the host IKJ oracle "
                     f"{float(np.abs(exact.cpu().numpy() - oracle).max() / np.abs(oracle).max()):.3e}")
        print(f"[splu] {name_limit} | 2cubes_sphere {policy}: exact ILU(0) against the 30-sweep "
              f"Chow-Patel factor, max |diff| / max |exact| = {diff:.3e} (cp_residual "
              f"{cp.residual:.2e}){extra}", flush=True)


def splu_direct_path(name_limit):
    """Phase 11: the direct scheduled LU at full width: laplacian_2d(300,
    300) by ``factorize(method="sparse")`` in fp32 refined to the oracle's
    1e-10 and in fp64 with one solve; then ``auto`` on a grid that band and
    the multifrontal LU are made to refuse. Returns (launch counts, the fp32
    factorization, the fp64 one)."""
    lap = laplacian_2d(300, 300)
    b, x_true = slv.make_rhs_for_known_x(lap)
    reset_counts()
    t0 = time.perf_counter()
    fac = slv.factorize(lap, "fp32", method="sparse", device="cuda")
    t_all = time.perf_counter() - t0
    t_warm = fac.refactorize_timed()
    x, rep = slv.solve_refined(lap, b, fac=fac)
    if not (rep.converged and rep.residual <= 1e-10 and rep.notes.startswith("method=sparse")
            and np.isfinite(x).all()):
        raise AssertionError(f"laplacian_2d(300, 300) sparse fp32 + IR: {rep}")
    fac64 = slv.factorize(lap, "fp64", method="sparse", device="cuda")
    x64 = fac64.solve(b)
    r64 = fac64.report
    if not (r64.residual <= 1e-12 and slv.inf_norm_error(x64, x_true) <= 1e-8):
        raise AssertionError(f"laplacian_2d(300, 300) sparse fp64: {r64}")
    launches = splu_counts()
    solves = rep.iterations - 1
    want = {"respa_splu_factor_f32": 2, "respa_splu_factor_f64": 1,
            "respa_tri_solve_lower_f32": solves, "respa_tri_solve_upper_f32": solves,
            "respa_tri_solve_lower_f64": 1, "respa_tri_solve_upper_f64": 1}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"sparse LU launches {launches}, expected {want}")
    sched = fac.plan.sched
    lay = sched.layout_bytes()
    for what, f, r in (("fp32", fac, rep), ("fp64", fac64, r64)):
        print(f"[splu] {name_limit} | laplacian_2d(300, 300) n={lap.nrows} nnz={lap.nnz} {what} "
              f"[{f.report.notes}]: fill {f._filled.nnz}, {sched.npairs} pairs, t_max "
              f"{sched.t_max}, {f.plan.nlevels} entry levels, {len(f.plan.tasks)} tasks; analyze "
              f"{f.report.t_analyze:.2f} s (ordering, fill, pair lists, plan, upload, the two "
              f"triangles' schedules), factor {f.report.t_factorize * 1e3:.1f} ms"
              f"{f', warm {t_warm * 1e3:.1f} ms' if f is fac else ''}, "
              f"{'refined ' if f is fac else ''}solve {r.t_solve * 1e3:.1f} ms in "
              f"{r.iterations if f is fac else 1} iterations (host clock, each phase ended by a "
              f"device synchronize; factorize() as a whole {t_all:.1f} s for fp32); residual "
              f"{r.residual:.3e} (host oracle), pivots perturbed {f.report.n_pivot_perturbed}, "
              f"pivot growth {f.report.pivot_growth:.3e}", flush=True)
    print(f"[splu] laplacian_2d(300, 300) pair lists on the card: {lay['ragged']} bytes ragged "
          f"(under the 4 GiB guard: {lay['ragged'] <= 4 << 30}), {lay['padded']} bytes padded "
          f"to t_max as respatpu stores and guards them (D4)", flush=True)
    print(f"[splu] launches of the direct sparse path {launches}", flush=True)
    # the chain's third step: band and the multifrontal LU refuse, sparse serves
    g = laplacian_2d(120, 120)
    gb, _ = slv.make_rhs_for_known_x(g)
    fa = slv.factorize(g, "fp32", method="auto", max_band_bytes=1 << 20, max_pool_bytes=1 << 20,
                       device="cuda")
    xa, ra = slv.solve_refined(g, gb, fac=fa)
    if not (ra.notes.startswith("method=sparse") and ra.residual <= 1e-10):
        raise AssertionError(f"auto's third step: {ra}")
    print(f"[splu] {name_limit} | laplacian_2d(120, 120) through auto with band and the "
          f"multifrontal LU refused (forced: band 1 MiB, pool 1 MiB): [{ra.notes}], residual "
          f"{ra.residual:.3e}", flush=True)
    return launches, fac, fac64


@held
def hold_splu_direct(name_limit, fac, fac64, errs, latency, l2):
    """Beside phase 11, not counted: the condition estimate once, and K8 on
    the Laplacian's filled pattern in every instance, timed: fp32 and fp64,
    the path's, against their plain versions; fp32_ftz and bf16 on the fp32
    factor's plan repeated bit for bit (phase 10 holds them against plain on
    2cubes_sphere's and the Laplacian's ILU(0) plans)."""
    t0 = time.perf_counter()
    rcond = fac.condest()
    if not (np.isfinite(rcond) and 0 < rcond <= 1):
        raise AssertionError(f"condest {rcond}")
    print(f"[splu] {name_limit} | laplacian_2d(300, 300) condest (Hager, transpose solves of the "
          f"scheduled factor): rcond {rcond:.3e} in {time.perf_counter() - t0:.2f} s", flush=True)
    out = {}
    for f, insts, hold in ((fac, ("f32",), True), (fac, ("f32_ftz", "bf16"), False),
                           (fac64, ("f64",), True)):
        out.update(hold_and_time_splu(name_limit, "laplacian_2d(300, 300) fill", f._dev,
                                      f._filled.data, f._pivot_eps, insts, errs, latency, l2,
                                      reps=5, hold=hold))
    return out


def stragglers(a, k, seed):
    """``a`` and k entries at random places: a remainder for the DIA path."""
    rng = np.random.default_rng(seed)
    coo = a.tocoo()
    n = a.nrows
    return coo_to_csr(COOMatrix(a.shape, np.r_[coo.row, rng.integers(0, n, k)].astype(np.int32),
                                np.r_[coo.col, rng.integers(0, n, k)].astype(np.int32),
                                np.r_[coo.val, rng.uniform(-0.5, 0.5, k)]))


def dia_path(name_limit):
    """Phase 12: ``sweep_spmv`` on the ecology2 and tmt_unsym stand-ins at
    catalogue size through ``fmt="auto"`` (DIA by respatpu's rule), fp64
    and every low precision, each timing past the byte gate of the DIA
    format; returns the launch counts."""
    mats = {m: corpus.load_matrix(m)[0] for m in GRIDS}
    for m, a in mats.items():
        if not isinstance(K.to_device(a, "fp32", "cpu"), K.DeviceDia):
            raise AssertionError(f"{m}: fmt='auto' did not pick DIA")
    reset_counts()
    for p in LOW:
        for row in runner.sweep_spmv(list(GRIDS), policies=("fp64", p), reps=REPS, device="cuda",
                                     verbose=False):
            for t in (row["timing_hi"], row["timing_lo"]):
                if not (t.floor_s > 0 and t.min >= t.floor_s):
                    raise AssertionError(f"{row['matrix']} {p}: timing not gated")
            nnz = int(row["nnz"])
            print(f"[dia] {name_limit} | {row['matrix']} n={row['n']} nnz={nnz} fmt=auto (DIA) "
                  f"fp64 {float(row['t_hi_s']) * 1e6:.2f} us {p} {float(row['t_lo_s']) * 1e6:.2f} "
                  f"us mean_abs_err={row['mean_abs_err']} gate floors "
                  f"{row['timing_hi'].floor_s * 1e6:.2f} / {row['timing_lo'].floor_s * 1e6:.2f} us "
                  f"(the DIA byte model)", flush=True)
    launches = splu_counts()
    per = (1 + WARMUP + REPS) * len(GRIDS)
    want = {"respa_dia_spmv_f64": per * len(LOW), **{f"respa_dia_spmv_{INST[p]}": per for p in LOW}}
    if any(launches[k] != v for k, v in want.items()) or any(launches[f"spmv_{p}"] for p in TOL):
        raise AssertionError(f"DIA path launches {launches}, expected {want} and no CSR product")
    print(f"[dia] launches of the DIA path {launches}", flush=True)
    return launches, mats


def build_probes():
    """``bench/csrc/smoke_probes.cu`` (K9's other remainder design, which
    includes the package's kernel source, the L2 read and barrier probes, and
    the first versions of K1, K2, K3, K8, K11 and K12) in a library of its
    own, bound by ctypes."""
    here = os.path.dirname(os.path.abspath(__file__))
    csrc = os.path.join(here, "respatpu_torch", "kernels", "csrc")
    path = build_shared("librespa_smoke_probes.so", [os.path.join(here, PROBES_SOURCE)],
                        [_build._nvcc(), *_build.NVCC_FLAGS],
                        depends=[os.path.join(csrc, f) for f in ("dia.cu", *_build.HEADERS)])
    lib = ctypes.CDLL(path)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    # device, n, ncols, ndiag, offsets, diags, x, addend, y, stream
    lib.respa_dia_design_addend_f32.argtypes = [i32, i64, i64, i32, *[ptr] * 6]
    lib.respa_dia_design_addend_f32.restype = i32
    # device, buf, words, rounds, out, stream
    lib.respa_l2_read_probe.argtypes = [i32, ptr, i64, i32, ptr, ptr]
    lib.respa_l2_read_probe.restype = i32
    # device, rounds, out, stream
    lib.respa_barrier_probe.argtypes = [i32, i32, ptr, ptr]
    lib.respa_barrier_probe.restype = i32
    for inst in ("f32", "f32_ftz", "f64"):
        # K1's first version: device, nblocks, p, in, in_is_bf16, ld, batch_stride, eps, lu,
        # n_perturbed, stream
        fn = getattr(lib, f"respa_block_lu_before_{inst}")
        fn.argtypes = [i32, i32, i32, ptr, i32, i64, i64, ctypes.c_double, ptr, ptr, ptr]
        fn.restype = i32
        # K3's first version: device, pool, g0, nfronts, wp, rp, lp, poff, pmp, seg_ptr, nseg,
        # tiles, stream
        fn = getattr(lib, f"respa_extend_add_before_{inst}")
        fn.argtypes = [i32, ptr, i64, i32, i32, i32, ptr, ptr, ptr, ptr, i32, i32, ptr]
        fn.restype = i32
    for d in ("fwd", "bwd"):
        for inst in ("f32", "f32_ftz", "bf16", "f64"):
            # K2's and K11's first versions: device, nb, p, ml, mu, band, b, out, mail, stream
            for kind in ("sweep", "sweep_t"):
                fn = getattr(lib, f"respa_band_{kind}_before_{d}_{inst}")
                fn.argtypes = [i32] * 5 + [ptr] * 5
                fn.restype = i32
    for inst in ("f32", "f32_ftz", "bf16", "f64"):
        # K8's first version: as respa_splu_factor_*
        fn = getattr(lib, f"respa_splu_factor_before_{inst}")
        fn.argtypes = [i32, i32, i32, *[ptr] * 10, ctypes.c_double, ptr, i32, ptr]
        fn.restype = i32
    for d in ("fwd", "bwd"):
        for inst in ("f32", "f32_ftz", "f64"):
            # K12's first version: device, pool, g0, nfronts, wp, rp, piv, rsx, y, n, out,
            # regime, tiles, ctl, mail, stream
            fn = getattr(lib, f"respa_front_sweep_t_before_{d}_{inst}")
            fn.argtypes = [i32, ptr, i64, i32, i32, i32, ptr, ptr, ptr, i32, ptr, i32, i32, ptr,
                           ptr, ptr]
            fn.restype = i32
    return lib


def dia_by_addend(lib, dev, rem_csr, x):
    """K9's other remainder design, fp32: the remainder's product by K0 over
    all n rows, then the diagonals with it as an addend; not counted."""
    addend = K.spmv(rem_csr, x)
    y = torch.empty(dev.n, dtype=torch.float32, device="cuda")
    rc = lib.respa_dia_design_addend_f32(dev.device.index, dev.n, dev.ncols, dev.ndiag,
                                         dev.offsets.data_ptr(), dev.diags.data_ptr(),
                                         x.data_ptr(), addend.data_ptr(), y.data_ptr(),
                                         torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K9 addend design: cudaError {rc}")
    return y


@held
def compare_dia_remainders(name_limit, designs, a):
    """ecology2 with 2,000 stragglers, fp32: the kept design (the remainder
    summed inside K9) against the other (K0 on the remainder, then K9 adding
    its product), equal bit for bit, each timed by events over its whole
    product in 3 rounds, the order turned each round; the kept one by the
    profiler too. Returns the times."""
    dev = K.to_device(a, "fp32", "cuda", fmt="dia")
    rem_csr = K.to_device(DI.build_dia(a).remainder, "fp32", "cuda", fmt="csr")
    x = x_for(dev, np.random.default_rng(42).standard_normal(a.shape[1]))
    kept, other = DI.dia_spmv(dev, x), dia_by_addend(designs, dev, rem_csr, x)
    if not torch.equal(kept, other):
        raise AssertionError("K9's two remainder designs disagree on ecology2 with stragglers")
    fns = {"remainder summed inside K9 (kept)": lambda: DI.dia_spmv(dev, x),
           "K0 on the remainder, then K9 adding it": lambda: dia_by_addend(designs, dev, rem_csr,
                                                                            x)}
    out = {k: [] for k in fns}
    for rnd in range(3):
        for k in (list(fns) if rnd % 2 == 0 else list(fns)[::-1]):
            out[k].append(events_ms(fns[k], 10))
    prof = profiler_ms(fns["remainder summed inside K9 (kept)"], "dia_spmv_kernel", 10)
    for k, v in out.items():
        print(f"[time] {name_limit} | K9 ecology2 with 2,000 stragglers fp32 (remainder "
              f"{dev.rem.nnz} entries on {dev.rem.nrows} rows), {k}: events "
              f"{', '.join(f'{t:.4f}' for t in v)} ms (rounds); equal bit for bit", flush=True)
    print(f"[time] {name_limit} | K9 with the remainder inside, profiler {fmt_ms(prof)}",
          flush=True)
    return {"events_ms": out, "kept_profiler_ms": prof}


@held
def hold_and_time_dia(name_limit, mats, errs, times, designs):
    """Beside phase 12, not counted: K9 against its plain version in every
    instance on both grids and on ecology2 with 2,000 stragglers (the
    remainder summed inside), twice, bit for bit; the fp64 result against
    the host oracle; then timed on ecology2 by events and the profiler
    beside its byte bound, K0 on the same matrix and
    ``torch.sparse_csr_tensor @ x`` (cuSPARSE), and the plain version; and
    the two remainder designs timed on the stragglers case."""
    cases = {**mats, "ecology2+stragglers": stragglers(mats["ecology2"], 2000, 31)}
    for cname, a in cases.items():
        x64 = np.random.default_rng(42).standard_normal(a.shape[1])
        for inst, policy in ILU_POLICIES.items():
            dev = K.to_device(a, policy, "cuda", fmt="dia")
            x = x_for(dev, x64)
            ys = [DI.dia_spmv(dev, x) for _ in range(2)]
            want = DI.dia_spmv_plain(dev, x)
            if not all(torch.equal(y, want) for y in ys):
                raise AssertionError(f"K9 {inst} on {cname}: kernel != plain")
            name = f"respa_dia_spmv_{inst}"
            errs[name] = 0.0
            ref = K.spmv_csr_reference(a, x64) if policy == "fp64" else None
            e = "" if ref is None else f", fp64 vs host oracle {rel_err(ys[0], torch.from_numpy(ref)):.3e}"
            print(f"[kernel] K9 {inst} {cname} ndiag={dev.ndiag} remainder "
                  f"{0 if dev.rem is None else dev.rem.nnz}: == plain bit for bit twice{e}",
                  flush=True)
            if ref is not None and rel_err(ys[0], torch.from_numpy(ref)) > 1e-14:
                raise AssertionError(f"K9 f64 {cname}: off the host oracle")
            if cname != "ecology2":
                continue
            csr = K.to_device(a, policy, "cuda", fmt="csr")
            nbytes = K.spmv_sol_bytes(dev, x.element_size())
            lib_ms, lib = None, ("none: torch has no product of a flushing or a bf16-valued "
                                 "sparse matrix with an fp32 vector")
            if policy in HAS_LIBRARY:
                sp = torch.sparse_csr_tensor(csr.indptr, csr.indices.long(), csr.vals,
                                             size=a.shape)
                got = torch.mv(sp, x)
                if rel_err(got, ys[0]) > TOL[policy] * 10:
                    raise AssertionError(f"cuSPARSE disagrees with K9 on {cname} {policy}")
                lib_ms, lib = events_ms(lambda: torch.mv(sp, x), 10), "torch.mv on a sparse CSR tensor"
            t0 = time.perf_counter()
            DI.dia_spmv_plain(dev, x)
            torch.cuda.synchronize()
            t = {"ms": events_ms(lambda: DI.dia_spmv(dev, x), 10),
                 "profiler_ms": profiler_ms(lambda: DI.dia_spmv(dev, x), "dia_spmv_kernel", 10),
                 "plain_ms": (time.perf_counter() - t0) * 1e3,
                 "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                 "library_ms": lib_ms, "library": lib,
                 "k0_ms": events_ms(lambda: K.spmv(csr, x), 10),
                 "k0_profiler_ms": profiler_ms(lambda: K.spmv(csr, x), KERNEL, 10),
                 "k0_bound_ms": spmv_csr_sol_bytes(a.shape[0], a.shape[1], a.nnz,
                                                   csr.vals.element_size(),
                                                   x.element_size()) / HBM_BYTES_PER_S * 1e3,
                 "shape": f"ecology2 n={a.nrows} ndiag={dev.ndiag}"}
            times[name] = t
            print(f"[time] {name_limit} | K9 {inst} ecology2 (n={a.nrows}, {dev.ndiag} "
                  f"diagonals): events {fmt_ms(t['ms'])}, profiler {fmt_ms(t['profiler_ms'])}; "
                  f"bound {t['bound_ms']:.4f} ms ({nbytes} bytes at 3.35 TB/s); K0 on the same "
                  f"matrix events {fmt_ms(t['k0_ms'])}, profiler {fmt_ms(t['k0_profiler_ms'])} "
                  f"(its bound {t['k0_bound_ms']:.4f} ms); library "
                  f"{fmt_ms(lib_ms) if lib_ms else lib}; plain {t['plain_ms']:.2f} ms", flush=True)
    times["respa_dia_spmv_f32"]["remainder_designs"] = compare_dia_remainders(
        name_limit, designs, cases["ecology2+stragglers"])


# ---------------------------------------------------------------------------
# 13. persistence and 14. the precision study
# ---------------------------------------------------------------------------


def all_counts():
    """Every kernel's launch count, by the name in the ``kernels`` line."""
    out = {f"respa_spmv_csr_{INST[p]}": n for p, n in K.LAUNCHES.items()}
    for counts in (B.LAUNCHES, F.LAUNCHES, I.LAUNCHES, S.LAUNCHES, SP.LAUNCHES, DI.LAUNCHES):
        out.update(counts)
    return out


def synced(fn):
    """(fn(), seconds on the host clock to a device synchronize)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def no_triangle_room():
    """Loaded triangles get no device memory: a multifrontal factor's load
    takes its frontal branch."""
    budget = persist._tri_budget
    persist._tri_budget = lambda device: 0
    try:
        yield
    finally:
        persist._tri_budget = budget


def persist_row(name_limit, what, live, a, tmp, bitwise, no_room=False, compressed=True):
    """Save ``live`` (a sparse factor without zlib where not ``compressed``),
    load it back bound to ``a`` (with no room for the triangles where
    ``no_room``), one solve and a refined solve; the loaded solve equal to
    the live one bit for bit where ``bitwise``. Returns the loaded
    factorization."""
    band = isinstance(live, slv.BandLuFactorization)
    path = os.path.join(tmp, "_".join(re.findall(r"\w+", what)) + ".npz")
    _, t_save = synced(lambda: persist.save_band_factorization(path, live) if band else
                       persist.save_sparse_factorization(path, live, compressed=compressed))
    nbytes = os.path.getsize(path)
    with no_triangle_room() if no_room else contextlib.nullcontext():
        fac, t_load = synced(lambda: persist.load_band_factorization(path, a) if band else
                             persist.load_sparse_factorization(path, a))
    b, _ = slv.make_rhs_for_known_x(a)
    x = fac.solve(b)
    t_one, r_one = fac.report.t_solve, fac.report.residual
    if bitwise and not np.array_equal(x, live.solve(b)):
        raise AssertionError(f"{what}: the loaded solve differs from the live one")
    xr, rep = slv.solve_refined(a, b, fac=fac)
    if not (rep.converged and rep.residual <= 1e-10 and np.isfinite(xr).all()
            and xr.shape == (a.nrows,)):
        raise AssertionError(f"{what}, loaded and refined: {rep}")
    print(f"[persist] {name_limit} | {what} [{fac.report.notes}, {type(fac).__name__}]: save "
          f"{t_save:.2f} s{'' if compressed else ' (uncompressed)'}, file {nbytes} bytes, load {t_load:.2f} s (the triangles' schedules "
          f"or the pool included), one solve {t_one * 1e3:.1f} ms (residual {r_one:.3e}), refined "
          f"solve {rep.t_solve * 1e3:.1f} ms in {rep.iterations} iterations to {rep.residual:.3e} "
          f"(host oracle) [{rep.notes}]{'; loaded solve == live solve bit for bit' if bitwise else ''} "
          f"(host clock, each step ended by a device synchronize)", flush=True)
    return fac


def hold_loaded_triangles(fac, live):
    """dc1's loaded triangles hold ``factor_values()`` bit for bit: L's and
    U's strict entries and U's reciprocal diagonal in the policy's type."""
    vals = live.factor_values()
    if not np.array_equal(fac.factor_values(), vals):
        raise AssertionError("dc1: the loaded values differ from factor_values()")
    f = live.part.filled
    L, _, U = split_triangular(CSRMatrix(f.shape, f.indptr, f.indices, vals))
    u_strict, u_diag = S._strict_and_diag(U, lower=False, unit_diag=False)
    for tri, strict in ((fac._l, L), (fac._u, u_strict)):
        got = tri.strict_csr()
        if not (np.array_equal(got.indptr, strict.indptr)
                and np.array_equal(got.indices, strict.indices)
                and np.array_equal(got.data, fac.policy.cast_host(strict.data).double().numpy())):
            raise AssertionError("dc1: a loaded triangle differs from factor_values()")
    dinv = fac.policy.cast_host(1.0 / np.where(u_diag == 0.0, 1.0, u_diag))
    if not torch.equal(fac._u.dinv.cpu(), dinv):
        raise AssertionError("dc1: the loaded U's diagonal differs from factor_values()")
    print(f"[persist] dc1: the loaded triangles hold factor_values() bit for bit "
          f"(L {fac._l.nnz} and U {fac._u.nnz} strict entries, {fac._l.levels} and "
          f"{fac._u.levels} levels, {fac._l.tasks.shape[0]} and {fac._u.tasks.shape[0]} tasks)",
          flush=True)


PERSIST_KERNELS = ("respa_tri_solve_lower_f32", "respa_tri_solve_upper_f32",
                   "respa_tri_solve_lower_f64", "respa_tri_solve_upper_f64",
                   "respa_band_sweep_fwd_f32", "respa_band_sweep_bwd_f32",
                   "respa_front_sweep_fwd_f64", "respa_front_sweep_bwd_f64",
                   "respa_rows_reduce_f64", "respa_spmv_csr_f64")


def persistence_path(name_limit, fac_dc1, fac_s, fac_s64):
    """Phase 13: factors saved, loaded back and solved: dc1's multifrontal
    fp32 factor from phase 8 (saved without zlib, loaded onto K7 triangles,
    refined through GMRES-IR to 1e-10), laplacian_2d(300, 300)'s scheduled factors from
    phase 11 (fp32, fp64) and its band factor (fp32), both solving bit for
    bit like the live ones, and an fp64 multifrontal factor forced onto its
    frontal pool, which stays fp64. The live band and fp64 factors are made
    before the counts are zeroed. Returns the launch counts of the path."""
    lap = fac_s.a
    band = slv.factorize(lap, "fp32", method="band", device="cuda")
    circ = circuit_like(20_000, 5, seed=4)
    snlu64 = slv.SupernodalLuFactorization(circ, policy="fp64", matching=True, device="cuda")
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        # uncompressed: zlib took 39-46 s of the phase here; the other sparse rows keep it
        dc1 = persist_row(name_limit, "dc1 multifrontal fp32, matched", fac_dc1, fac_dc1.a, tmp,
                          False, compressed=False)
        if not isinstance(dc1, persist.LoadedSparseLu):
            raise AssertionError(f"dc1 loaded as {type(dc1).__name__}, not onto K7")
        hold_loaded_triangles(dc1, fac_dc1)
        del dc1
        for live in (fac_s, fac_s64):
            persist_row(name_limit, f"laplacian_2d(300, 300) scheduled {live.policy.name}", live,
                        lap, tmp, True)
        persist_row(name_limit, "laplacian_2d(300, 300) band fp32", band, lap, tmp, True)
        forced = persist_row(name_limit, "circuit_like(20000) multifrontal fp64, matched",
                             snlu64, circ, tmp, True, no_room=True)
        if not (isinstance(forced, persist.LoadedFrontalLu)
                and forced._frontal.pool.dtype == torch.float64):
            raise AssertionError(f"the forced frontal branch: {type(forced).__name__}, "
                                 f"{forced._frontal.pool.dtype}")
        print(f"[persist] the forced branch (no room for the triangles) solves from an fp64 pool of "
              f"{forced.report.factor_bytes} bytes, rebuilt with no factorization", flush=True)
    launches = all_counts()
    for name in PERSIST_KERNELS:
        if launches[name] < 1:
            raise AssertionError(f"{name} was not launched on the persistence path")
    print(f"[persist] launches of the persistence path "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    return launches


@contextlib.contextmanager
def offline():
    """``urllib.request.urlretrieve`` refuses at once: no call in this run
    opens a connection, and ``attempt_fetch`` takes its first-failure path,
    as it does on a machine with no network."""
    import urllib.error
    import urllib.request
    old = urllib.request.urlretrieve

    def refuse(url, *args, **kwargs):
        raise urllib.error.URLError(f"not fetched: {url}")

    urllib.request.urlretrieve = refuse
    try:
        yield
    finally:
        urllib.request.urlretrieve = old


STUDY_KERNELS = (*(n for n in B.LAUNCHES if n not in NEW_BAND),
                 *(n for n in F.LAUNCHES if n not in NEW_FRONT), "respa_spmv_csr_f64")
# dc1 in phase 14: cut to this many entries (its analysis at catalogue size takes 38 s a row),
# and by the multifrontal LU, which ``auto`` reaches at catalogue size (the band refuses: 72.8
# GiB), while the cut matrix's band would fit
STUDY_CUT = 100_000


def study_path(name_limit):
    """Phase 14: ``run_study`` on 2cubes_sphere at catalogue size (the band
    path, five configurations, fp64 band 3.94 GB) and on dc1 cut to
    ``STUDY_CUT`` entries by ``method="snlu"`` (the multifrontal path with
    matching, which ``auto`` takes at catalogue size), each row
    printed with ``summarize``'s JSON. Fails unless 2cubes_sphere's rows are
    all ``ok`` with its ``+ir`` rows at 1e-12 and dc1's are ``ok`` (its
    ``bf16+ir`` may stagnate). Returns the launch counts of the path."""
    with offline():
        got, t_fetch = synced(lambda: fetch.attempt_fetch(["2cubes_sphere", "dc1"]))
        print(f"[study] attempt_fetch: {got} matrices on disk after {t_fetch:.3f} s (the download "
              "refused at once, as with no network; the stand-ins serve)", flush=True)
        reset_counts()
        rows, t_cubes = synced(lambda: study.run_study(["2cubes_sphere"], device="cuda"))
        more, t_dc1 = synced(lambda: study.run_study(["dc1"], max_synth_nnz=STUDY_CUT,
                                                     method="snlu", device="cuda"))
    launches = all_counts()
    rows += more
    for r in rows:
        print(f"[study] {name_limit} | {json.dumps(r)}", flush=True)
    summary = study.summarize(rows)
    print(f"[study] {name_limit} | 2cubes_sphere {t_cubes:.1f} s, dc1 (cut to {STUDY_CUT} "
          f"entries) {t_dc1:.1f} s; summary {json.dumps(summary)}", flush=True)
    allowed = {(r["matrix"], r["config"]): {"ok"} for r in rows}
    allowed["dc1", "bf16+ir"] = {"ok", "stagnated"}
    for r in rows:
        if r["status"] not in allowed[r["matrix"], r["config"]]:
            raise AssertionError(f"study row {r['matrix']}/{r['config']}: {r['status']} "
                                 f"[{r['method']}]")
        if r["matrix"] == "2cubes_sphere" and r["config"].endswith("+ir") and \
                not float(r["rel_residual"]) <= 1e-12:
            raise AssertionError(f"study row 2cubes_sphere/{r['config']}: {r['rel_residual']}")
    if summary["n_matrices"] != 2 or summary["fp32_ir_reaches_1e-10_frac"] != 1.0:
        raise AssertionError(f"study summary {summary}")
    for name in STUDY_KERNELS:
        if launches[name] < 1:
            raise AssertionError(f"{name} was not launched on the study path")
    print(f"[study] launches of the study path "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    return launches


# ---------------------------------------------------------------------------
# 15. the distributed stack, 4 shards on the card
# ---------------------------------------------------------------------------

DIST_SHARDS = 4
DIST_DEVICE = "cuda:0"  # all the shards on the first card
# the kernels the distributed path must launch
DIST_KERNELS = ("respa_spmv_csr_f32", "respa_spmv_csr_f64", "respa_block_lu_f32",
                "respa_band_sweep_fwd_f32", "respa_band_sweep_bwd_f32",
                "respa_band_sweep_multi_fwd_f32", "respa_band_sweep_multi_bwd_f32",
                "respa_extend_add_f32",
                "respa_front_sweep_fwd_f32", "respa_front_sweep_bwd_f32", "respa_rows_reduce_f32",
                "respa_ilu0_sweep_f32")
DIST_SPMV_TOL = {"fp32": 1e-6, "fp64": 1e-14}
# 2cubes_sphere's band in the natural order, ml = mu = 18 blocks of 128, on 4 shards: the
# reduced system's order is 4 x 36 x 128 = 18,432, past respatpu's default cap of 16,384
SPIKE_MAX_REDUCED = 18_432


def digest(*arrays) -> str:
    """SHA-256 of arrays' bytes: results held bit for bit across processes."""
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def dist_spmv_rows(tag, mesh, a, refs, digests):
    """The distributed SpMV on ``a``, two calls bit for bit, against the
    single-card products ``refs`` (by policy) where given; its rows, and each
    product's digest in ``digests``."""
    from respatpu_torch import dist
    x = np.random.default_rng(42).standard_normal(a.shape[1])
    out = {}
    for policy in DIST_SPMV_TOL:
        op, t_up = synced(lambda: dist.DistSpmv(a, mesh, policy=policy))
        xs = op.shard_vector(x)
        moved = mesh.bytes_moved + mesh.bytes_sent
        y1, t1 = synced(lambda: op(xs))
        per_call = mesh.bytes_moved + mesh.bytes_sent - moved
        times = [synced(lambda: op(xs))[1] for _ in range(REPS)]
        y2 = op(xs)
        torch.cuda.synchronize()
        if not all(torch.equal(u, v) for u, v in zip(y1, y2) if u is not None):
            raise AssertionError(f"distributed SpMV {policy}: two calls differ")
        got = op.unshard(y1)
        digests[f"spmv_{policy}"] = digest(got)
        row = dict(upload_s=t_up, first_s=t1, median_s=float(np.median(times)),
                   exchange_bytes=per_call)
        against = ""
        if refs is not None:
            ref = refs[policy]
            err = float((torch.from_numpy(got) - ref).abs().max() / ref.abs().max())
            row.update(rel_err_inf=err, bit_equal=bool(torch.equal(torch.from_numpy(got), ref)))
            if err > DIST_SPMV_TOL[policy]:
                raise AssertionError(f"distributed SpMV {policy}: {err:.3e} from the "
                                     "single-card K0")
            against = (f"; against the single-card K0 {err:.3e} (tol {DIST_SPMV_TOL[policy]}), "
                       f"bit-equal {row['bit_equal']}")
        out[policy] = row
        print(f"{tag} | DistSpmv {policy} offshore ({mesh.describe()}): {per_call} bytes this "
              f"rank moved a call ({op.plan.exchange_entries} entries, halo {op.plan.halo}); "
              f"upload {t_up:.3f} s; a call {float(np.median(times)) * 1e3:.3f} ms (median of "
              f"{REPS}, host clock to a synchronize){against}; two calls equal bit for bit",
              flush=True)
    return out


def dist_cg_row(tag, mesh, eco, digests, failed):
    from respatpu_torch import dist
    # b = A x for a random x: A times ones is zero off the boundary, and its small b puts the
    # fp32 iteration's attainable residual near 1e-5
    b_eco = slv.make_rhs_for_known_x(eco, np.random.default_rng(7).standard_normal(eco.nrows))[0]
    (xc, it), t_cg = synced(lambda: dist.dist_cg(eco, b_eco, mesh=mesh, tol=1e-6,
                                                 max_iters=20_000))
    res = slv.relative_residual(eco, xc, b_eco)
    digests["cg"] = [digest(xc), it]
    print(f"{tag} | dist_cg ecology2 (n {eco.nrows}, {mesh.describe()}): {it} iterations, "
          f"{t_cg:.2f} s, {t_cg / max(it, 1) * 1e3:.3f} ms an iteration (host clock to a "
          f"synchronize), host-oracle residual {res:.3e} (tol 1e-6)", flush=True)
    if it >= 20_000 or not res <= 1e-5:
        failed.append(f"dist_cg on ecology2: {it} iterations, residual {res:.3e}")
    return dict(iterations=it, seconds=t_cg, ms_per_iteration=t_cg / max(it, 1) * 1e3,
                residual=res)


def pool_digests(sub, mesh):
    return {f"pool_{d}": digest(sub.pools[d].cpu().numpy()) for d in mesh.local_shards}


ALLOC_KEYS = ("num_device_alloc", "num_device_free", "num_alloc_retries")


def alloc_counts():
    """The caching allocator's cudaMalloc and cudaFree calls and its retries
    (a retry frees the cache, and a cudaFree waits for the whole card)."""
    stats = torch.cuda.memory_stats()
    return {k: stats.get(k) for k in ALLOC_KEYS}


def alloc_delta(before):
    after = alloc_counts()
    return {k: None if before[k] is None else after[k] - before[k] for k in ALLOC_KEYS}


def tips_trace(tag, mesh, build, tmp):
    """One SPIKE construction (``build``) under the profiler, its tips phase
    read from the trace: the card's records between the first shard's tips
    and the reduced system's gather, by stream (K10's and the rest), K10's
    busy time summed against the union of its records (the shards' sweeps
    overlapping, or one after another), and the host's runtime calls in the
    window (allocations, frees, launches, waits). Its launches are not
    counted. Returns the host seconds of the phase as the construction
    measured it."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from respatpu_torch import dist_lu
    tips_fn = dist_lu.DistBandLu._tips

    def tips(self, j):
        with record_function(f"spike tips shard {j}"):
            return tips_fn(self, j)

    def gathered(*args, _gather=mesh.all_gather, **kwargs):
        with record_function("spike reduced"):
            return _gather(*args, **kwargs)

    dist_lu.DistBandLu._tips = tips
    mesh.all_gather = gathered
    try:
        torch.cuda.synchronize()
        with uncounted(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
            fac = build()
            torch.cuda.synchronize()
    finally:
        dist_lu.DistBandLu._tips = tips_fn
        del mesh.all_gather
    path = os.path.join(tmp, "spike_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    os.remove(path)
    ann = [e for e in events if e.get("cat") == "user_annotation"]
    starts = [e["ts"] for e in ann if e["name"].startswith("spike tips")]
    if not starts:
        print(f"{tag} | SPIKE tips under the profiler: no annotation in the trace", flush=True)
        return fac.phases["tips"]
    t0 = min(starts)
    t1 = min([e["ts"] for e in ann if e["name"] == "spike reduced" and e["ts"] > t0]
             or [max(e["ts"] + e["dur"] for e in events)])
    gpu = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
           and t0 <= e["ts"] < t1]
    k10 = sorted((e["ts"], e["ts"] + e["dur"]) for e in gpu if "band_multi_kernel" in e["name"])
    union, end = 0.0, None
    for a, b in k10:
        if end is None or a > end:
            union += b - a
            end = b
        elif b > end:
            union += b - end
            end = b
    by_stream = {}
    for e in gpu:
        st = by_stream.setdefault(e.get("args", {}).get("stream"), [0, 0.0, 0, 0.0, 1e30, 0.0])
        i = 0 if "band_multi_kernel" in e["name"] else 2
        st[i] += 1
        st[i + 1] += e["dur"]
        st[4], st[5] = min(st[4], e["ts"]), max(st[5], e["ts"] + e["dur"])
    host = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and t0 <= e["ts"] < t1:
            n, d = host.get(e["name"], (0, 0.0))
            host[e["name"]] = (n + 1, d + e["dur"])
    busy = sum(b - a for a, b in k10)
    streams = "; ".join(
        f"stream {s}: K10 {v[0]} x {v[1] / 1e3:.2f} ms, other {v[2]} x {v[3] / 1e3:.2f} ms, "
        f"from {(v[4] - t0) / 1e3:.2f} to {(v[5] - t0) / 1e3:.2f} ms"
        for s, v in sorted(by_stream.items(), key=lambda kv: str(kv[0])))
    calls = ", ".join(f"{k} {n} x {d / 1e3:.3f} ms" for k, (n, d) in
                      sorted(host.items(), key=lambda kv: -kv[1][1])[:8])
    print(f"{tag} | SPIKE tips under the profiler (a third factorization): host "
          f"{fac.phases['tips']:.3f} s; trace window {(t1 - t0) / 1e3:.2f} ms; {streams}; K10 "
          f"busy {busy / 1e3:.2f} ms over a union of {union / 1e3:.2f} ms (overlap "
          f"{busy / max(union, 1e-9):.2f}x); host runtime calls in the window: {calls}",
          flush=True)
    return fac.phases["tips"]


def dist_core(tag, mesh, device, off, eco, cubes, refs=None, tmp=None):
    """The distributed path that phases 15 and 16 share, on ``mesh`` (this
    rank's part of it): ``DistSpmv`` on offshore (fp32, fp64); ``dist_cg`` on
    ecology2's stand-in; ``runner.sweep_ilu0_dist`` on ecology2 (``ok`` at
    1e-10), its mesh made on ``device`` (None: the rank's); SPIKE on 2cubes_sphere in the natural order, factored twice bit
    for bit, solved and refined to 1e-10; the subtree LU on 2cubes_sphere,
    factored twice bit for bit, solved and refined to 1e-10. With ``tmp``
    (phase 15), SPIKE's tips are traced in a third factorization
    (:func:`tips_trace`). Returns (rows, digests of every result, failed
    gates, the subtree factor)."""
    from respatpu_torch import dist_lu, dist_snlu_sub
    digests, failed = {}, []
    rows = {"spmv": dist_spmv_rows(tag, mesh, off, refs, digests)}
    rows["cg"] = dist_cg_row(tag, mesh, eco, digests, failed)

    (row,), t_sweep = synced(lambda: runner.sweep_ilu0_dist(["ecology2"], ndev=mesh.size,
                                                            device=device, verbose=False))
    print(f"{tag} | sweep_ilu0_dist {json.dumps(row)}", flush=True)
    rows["ilu0dist"] = [row]
    digests["ilu0dist"] = [row["krylov_iters"], row["krylov_residual"]]
    if row["status"] != "ok" or not float(row["krylov_residual"]) <= 1e-10:
        failed.append(f"sweep_ilu0_dist ecology2: {row}")

    b2 = slv.make_rhs_for_known_x(cubes)[0]

    def build():
        return dist_lu.DistBandLu(cubes, mesh=mesh, order="natural",
                                  max_reduced=SPIKE_MAX_REDUCED)

    before = alloc_counts()
    spike, t_f = synced(build)
    allocs = alloc_delta(before)
    before = alloc_counts()
    again = build()
    torch.cuda.synchronize()
    allocs_again = alloc_delta(before)
    print(f"{tag} | SPIKE tips on K10: {spike.phases['tips']:.3f} s in the first factorization "
          f"(allocator {allocs}), {again.phases['tips']:.3f} s in the second "
          f"({allocs_again}); host clock to a synchronize", flush=True)
    same = (all(torch.equal(spike._parts[j].lu.data, again._parts[j].lu.data)
                for j in mesh.local_shards)
            and all(torch.equal(spike._rlu.values[pl][0], again._rlu.values[pl][0])
                    for pl in mesh.local_places))
    del again
    if not same:
        failed.append("SPIKE: two factorizations differ")
    if tmp is not None:
        tips_trace(tag, mesh, build, tmp)
    x, t_s = synced(lambda: spike.solve(b2))
    # four right-hand sides at once: the shards' solves on K10
    bm = np.random.default_rng(31).standard_normal((cubes.nrows, 4))
    bm[:, 0] = b2
    with recorded_multi() as calls:
        xm, t_m = synced(lambda: spike.solve(bm))
    hold_recorded_multi(tag, "SPIKE's solve of 4 right-hand sides, every shard's", calls)
    del calls
    res_m = [slv.relative_residual(cubes, xm[:, j], bm[:, j]) for j in range(4)]
    res_1 = slv.relative_residual(cubes, x, b2)
    if not (np.isfinite(xm).all() and res_m[0] <= 10 * res_1 + 1e-15):
        failed.append(f"SPIKE, 4 right-hand sides: residuals {res_m}, one column {res_1:.3e}")
    (xr, rep), t_r = synced(lambda: dist_lu.dist_solve_refined(cubes, b2, fac=spike))
    res = slv.relative_residual(cubes, xr, b2)
    digests.update(spike_x=digest(x), spike_multi=digest(xm),
                   spike_refined=[digest(xr), rep.iterations])
    rows["spike"] = dict(reduced_order=spike.reduced_order, reduced_bytes=spike.reduced_bytes,
                         ml=spike.ml, mu=spike.mu, nb_loc=spike.nb_loc,
                         analyze_s=spike.report.t_analyze, factor_s=t_f, phases=spike.phases,
                         solve_s=t_s, refined_s=t_r, iterations=rep.iterations, residual=res,
                         pivots=spike.report.n_pivot_perturbed, solve4_s=t_m,
                         solve4_residuals=res_m)
    print(f"{tag} | SPIKE 2cubes_sphere fp32 ({mesh.describe()}): ml = mu = {spike.mu} "
          f"blocks of {spike.p}, {spike.nb_loc} block rows a shard; reduced system order "
          f"{spike.reduced_order}, {spike.reduced_bytes} bytes once a place; analyze "
          f"{spike.report.t_analyze:.3f} s, construction {t_f:.3f} s (factor "
          f"{spike.report.t_factorize:.3f}: band LU {spike.phases['band_lu']:.3f}, tips on K10 "
          f"{spike.phases['tips']:.3f}, reduced {spike.phases['reduced']:.3f}; the tips were "
          f"0.33 s as a torch-op loop on 4 shards in one process, the factor 0.75 s, and over 2 "
          f"ranks the factor 1.55-1.56 s), two factorizations bit for bit {same}; one solve "
          f"{t_s * 1e3:.1f} ms; 4 right-hand sides at once {t_m * 1e3:.1f} ms, residuals "
          f"{', '.join(f'{r:.3e}' for r in res_m)}; refined {t_r:.3f} s "
          f"in {rep.iterations} iterations to {res:.3e} (host oracle; tol 1e-10); pivots "
          f"perturbed {spike.report.n_pivot_perturbed} (host clock to a synchronize)", flush=True)
    if not res <= 1e-10:
        failed.append(f"SPIKE refined residual {res:.3e}")
    del spike

    sub, t_sub = synced(lambda: dist_snlu_sub.DistSubtreeLu(cubes, mesh=mesh))
    pools = pool_digests(sub, mesh)
    t_warm = sub.refactorize_timed()
    if pool_digests(sub, mesh) != pools:
        failed.append("subtree LU: two factorizations differ")
    digests.update(pools)
    x, t_s = synced(lambda: sub.solve(b2))
    xs, t_r = synced(lambda: sub.solve_refined(b2))
    res = slv.relative_residual(cubes, xs, b2)
    digests.update(subtree_x=digest(x), subtree_refined=[digest(xs), sub.report.iterations])
    if not res <= 1e-10:
        failed.append(f"subtree LU refined residual {res:.3e}")
    plan = sub.plan
    rows["subtree"] = dict(
        analyze_s=sub.report.t_analyze, construction_s=t_sub, factor_s=sub.report.t_factorize,
        factor_warm_s=t_warm, solve_s=t_s, refined_s=t_r, iterations=sub.report.iterations,
        residual=res, local_pool_bytes=[int(v) * 4 for v in plan.local_sizes],
        stage_bytes=[int(v) * 4 for v in plan.stage_sizes],
        replicated_pool_bytes=sub.replicated_pool_bytes,
        corner_bytes_exchanged=sub.bytes_exchanged, groups=len(plan.groups),
        fronts_per_shard=np.bincount(plan.owner, minlength=mesh.size).tolist(),
        pivots=sub.report.n_pivot_perturbed)
    r = rows["subtree"]
    print(f"{tag} | subtree LU 2cubes_sphere fp32 ({mesh.describe()}): {r['groups']} groups, "
          f"fronts a shard {r['fronts_per_shard']}; pool bytes a shard {r['local_pool_bytes']} "
          f"(+ staging {r['stage_bytes']}) against {r['replicated_pool_bytes']} unsharded; "
          f"corners this rank moved {r['corner_bytes_exchanged']} bytes; analyze "
          f"{r['analyze_s']:.2f} s, factor {r['factor_s']:.3f} s (again {t_warm:.3f}; bit for "
          f"bit); one solve {t_s * 1e3:.1f} ms; refined {t_r:.3f} s in {r['iterations']} "
          f"iterations to {res:.3e} (host oracle, tol 1e-10) (host clock to a synchronize)",
          flush=True)
    return rows, digests, failed, sub


def dist_path(name_limit, mats, tmp):
    """Phase 15: the distributed stack with ``DIST_SHARDS`` shards on the
    card, through its entry points: :func:`dist_core` (with ``DistSpmv``
    held to the single-card K0), then ``runner.sweep_ilu0_dist`` on
    2cubes_sphere (reported), the subtree factor saved, loaded and solved,
    and ``measure_scaling`` on offshore. Returns the path's launch counts,
    counted from just before it to just after it (the single-card references
    come before and after), and the digests phase 16 holds the ranks to. A
    failed gate is raised at the end of the phase, after every row has run
    and printed."""
    from respatpu_torch import dist
    from respatpu_torch.bench import scaling
    mesh = dist.make_mesh(DIST_SHARDS, DIST_DEVICE)
    tag = f"[dist] {name_limit}"
    print(f"{tag} | mesh: {mesh.describe()}", flush=True)
    off, cubes = mats["offshore"], mats["2cubes_sphere"]
    eco = corpus.load_matrix("ecology2")[0]
    x = np.random.default_rng(42).standard_normal(off.shape[1])
    refs = {}
    for policy in DIST_SPMV_TOL:
        one = K.to_device(off, policy, DIST_DEVICE, fmt="csr")
        xd = torch.from_numpy(x).to(one.policy.accum_dtype).to(one.device)
        refs[policy] = K.spmv(one, xd).cpu().double()
    reset_counts()
    t_path = time.perf_counter()
    rows, digests, failed, sub = dist_core(tag, mesh, DIST_DEVICE, off, eco, cubes, refs, tmp)
    more = runner.sweep_ilu0_dist(["2cubes_sphere"], ndev=DIST_SHARDS, device=DIST_DEVICE,
                                  verbose=False)
    print(f"{tag} | sweep_ilu0_dist {json.dumps(more[0])}", flush=True)
    rows["ilu0dist"] += more

    b2 = slv.make_rhs_for_known_x(cubes)[0]
    vals = sub.factor_values()
    path = os.path.join(tmp, "subtree.npz")
    _, t_save = synced(lambda: persist.save_sparse_factorization(path, sub, compressed=False))
    loaded, t_load = synced(lambda: persist.load_sparse_factorization(path, cubes,
                                                                      device=DIST_DEVICE))
    xl, t_ls = synced(lambda: loaded.solve(b2))
    xd = sub.solve(b2)
    lerr = float(np.abs(xl - xd).max() / np.abs(xd).max())
    if not lerr <= 1e-4:
        failed.append(f"subtree LU loaded: its solve is {lerr:.3e} from the live one")
    rows["subtree"].update(save_s=t_save, file_bytes=os.path.getsize(path), load_s=t_load,
                           loaded_solve_s=t_ls, loaded_vs_live=lerr)
    os.remove(path)
    del loaded

    srows, t_scale = synced(lambda: scaling.measure_scaling("offshore", (1, 2, DIST_SHARDS),
                                                            max_synth_nnz=None, device=DIST_DEVICE))
    for r in srows:
        print(f"{tag} | scaling {json.dumps(r)}", flush=True)
    rows["scaling"] = srows
    t_path = time.perf_counter() - t_path
    launches = all_counts()
    no_plain("distributed path")

    # after the count: the single-card pool of the same partition
    plan1 = F.build_frontal_plan(sub.part)
    pool1, _ = F.frontal_factor_pool(plan1, torch.float32, DIST_DEVICE,
                                     pivot_eps=sub.pivot_eps)
    single = F.values_from_pool(plan1, pool1)
    del pool1, sub
    diff = float(np.abs(vals - single).max())
    rows["subtree"].update(max_abs_diff_single=diff, scale=float(np.abs(single).max()),
                           bit_equal_single=bool(np.array_equal(vals, single)))
    r = rows["subtree"]
    print(f"{tag} | subtree LU: factor_values() against the single-card pool of the same "
          f"partition: largest difference {diff:.3e} (of {r['scale']:.3e}), bit-equal "
          f"{r['bit_equal_single']}; saved uncompressed in {t_save:.2f} s ({r['file_bytes']} "
          f"bytes), loaded in {t_load:.2f} s, its solve {t_ls * 1e3:.1f} ms, {lerr:.3e} from the "
          f"live one (host clock to a synchronize)", flush=True)
    print(f"{tag} | the path {t_path:.1f} s; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    print(f"{tag} | rows {json.dumps(rows, default=str)}", flush=True)
    failed += [f"{name} was not launched on the distributed path"
               for name in DIST_KERNELS if launches[name] < 1]
    if failed:
        raise AssertionError("phase 15: " + "; ".join(failed))
    return launches, digests, rows


# ---------------------------------------------------------------------------
# 16. the distributed stack over processes
# ---------------------------------------------------------------------------

RANKS = 2
RANK_TIMEOUT_S = 400  # a worker's wall time before phase 16 fails


def rank_worker(name_limit, argv):
    """``chip_smoke.py --rank-worker MODE RANK WORLD STORE OUT``: one rank of
    phase 16, joined to the others through a store in the file STORE. Mode
    ``2x2``: :func:`dist_core` on a mesh of 2 shards a rank, with the
    launch counts of its path; ``2x1``: respatpu's psum check and the
    offshore ``DistSpmv`` and ``dist_cg`` on one shard a rank. Writes its
    rows, digests and counts to OUT as JSON."""
    from respatpu_torch import dist
    mode, rank, world, store, out = argv
    dist.init_distributed(num_processes=int(world), process_id=int(rank), device="cuda",
                          init_method=f"file://{store}", timeout_s=RANK_TIMEOUT_S)
    tag = f"[rank {rank}] {name_limit}"
    try:
        _build.load()  # the parent built the kernels; this only loads them
        t0 = time.perf_counter()
        off = corpus.load_matrix("offshore")[0]
        eco = corpus.load_matrix("ecology2")[0]
        digests, failed = {}, []
        if mode == "2x2":
            cubes = corpus.load_matrix("2cubes_sphere")[0]
            mesh = dist.make_mesh(2 * int(world))
            reset_counts()
            t_path = time.perf_counter()
            rows, digests, failed, sub = dist_core(tag, mesh, None, off, eco, cubes)
            t_path = time.perf_counter() - t_path
            launches = all_counts()
            del sub
        else:
            mesh = dist.make_mesh(int(world))
            one = mesh.map(lambda d: torch.tensor(float(dist.process_index() + 1),
                                                  device=mesh.shards[d].device))
            rows = {"psum": float(mesh.psum(one).first)}
            t_path = time.perf_counter()
            rows["spmv"] = dist_spmv_rows(tag, mesh, off, None, digests)
            rows["cg"] = dist_cg_row(tag, mesh, eco, digests, failed)
            t_path = time.perf_counter() - t_path
            launches = all_counts()
        failed += [f"{k} ran {v} times on the path" for k, v in PLAIN_CALLS.items() if v]
        result = dict(rows=rows, digests=digests, failed=failed, launches=launches,
                      mesh=mesh.describe(), path_s=t_path, seconds=time.perf_counter() - t0)
    finally:
        dist.shutdown_distributed()
    with open(out, "w") as f:
        json.dump(result, f, default=str)


def run_ranks(tmp, mode):
    """Start ``RANKS`` workers of ``mode`` and wait for them, each at most
    ``RANK_TIMEOUT_S``; kills any left. Returns each rank's exit code,
    result (None without one) and log."""
    env = dict(os.environ)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")  # the ranks share this host
    outs = [os.path.join(tmp, f"{mode}_rank{r}.json") for r in range(RANKS)]
    logs = [os.path.join(tmp, f"{mode}_rank{r}.log") for r in range(RANKS)]
    procs = []
    try:
        for r in range(RANKS):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--rank-worker", mode, str(r),
                     str(RANKS), os.path.join(tmp, f"store_{mode}"), outs[r]],
                    stdout=log, stderr=subprocess.STDOUT, env=env))
        deadline = time.monotonic() + RANK_TIMEOUT_S
        rcs = []
        for p in procs:
            try:
                rcs.append(p.wait(timeout=max(1.0, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                rcs.append("timeout")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for o in outs:
        if os.path.exists(o):
            with open(o) as f:
                results.append(json.load(f))
        else:
            results.append(None)
    texts = []
    for path in logs:
        with open(path) as f:
            texts.append(f.read())
    return rcs, results, texts


def rank_times(rows):
    """The times of a :func:`dist_core` run that phase 16 sets beside phase
    15's."""
    sp, sub = rows["spike"], rows["subtree"]
    return {"DistSpmv fp32 ms": rows["spmv"]["fp32"]["median_s"] * 1e3,
            "DistSpmv fp64 ms": rows["spmv"]["fp64"]["median_s"] * 1e3,
            "dist_cg ms an iteration": rows["cg"]["ms_per_iteration"],
            "sweep_ilu0_dist ecology2 setup s": float(rows["ilu0dist"][0]["t_setup_s"]),
            "sweep_ilu0_dist ecology2 Krylov s": float(rows["ilu0dist"][0]["t_krylov_s"]),
            "SPIKE factor s": sp["factor_s"], "SPIKE tips s": sp["phases"]["tips"],
            "SPIKE solve ms": sp["solve_s"] * 1e3, "SPIKE 4-column solve ms": sp["solve4_s"] * 1e3,
            "SPIKE refined s": sp["refined_s"], "subtree analyze s": sub["analyze_s"],
            "subtree factor s": sub["factor_s"], "subtree factor again s": sub["factor_warm_s"],
            "subtree solve ms": sub["solve_s"] * 1e3, "subtree refined s": sub["refined_s"]}


def ranks_path(name_limit, ref, ref_rows):
    """Phase 16: the distributed stack over processes, ``RANKS`` workers of
    this script on the card (gloo through the host when they share it; NCCL
    with a card a rank), each holding 2 shards: their ``dist_core`` results
    equal ``ref``, the one-process mesh of 4 shards (phase 15), bit for bit
    on every rank, and every kernel of the path launches in every worker.
    Then one shard a rank: respatpu's psum (1 + 2 = 3 on both) and the
    offshore ``DistSpmv`` and ``dist_cg``, bit for bit with
    ``make_mesh(2, DIST_DEVICE)``; the ranks' times beside phase 15's.
    Returns each 2 x 2 worker's launch counts."""
    from respatpu_torch import dist
    tag = f"[ranks] {name_limit}"
    failed = []
    mesh2 = dist.make_mesh(RANKS, DIST_DEVICE)  # the one-shard-a-rank reference
    ref2 = {}
    dist_spmv_rows(f"{tag} | reference", mesh2, corpus.load_matrix("offshore")[0], None, ref2)
    dist_cg_row(f"{tag} | reference", mesh2, corpus.load_matrix("ecology2")[0], ref2, failed)
    del mesh2
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        runs = {}
        for mode in ("2x2", "2x1"):
            t0 = time.perf_counter()
            runs[mode] = run_ranks(tmp, mode)
            print(f"{tag} | {RANKS} ranks, mode {mode}: {time.perf_counter() - t0:.1f} s, exit "
                  f"codes {runs[mode][0]}", flush=True)
    for mode, want in (("2x2", ref), ("2x1", ref2)):
        rcs, results, texts = runs[mode]
        for r, (rc, res, text) in enumerate(zip(rcs, results, texts)):
            lines = [ln for ln in text.splitlines() if ln.startswith(f"[rank {r}]")]
            print("\n".join(lines), flush=True)
            if rc != 0 or res is None:
                print(f"{tag} | rank {r} of {mode} failed ({rc}); its log's end:\n"
                      f"{text[-4000:]}", flush=True)
                failed.append(f"rank {r} of {mode}: exit {rc}")
                continue
            failed += [f"rank {r} of {mode}: {f}" for f in res["failed"]]
            for key, value in want.items():
                if key.startswith("pool_") and key not in res["digests"]:
                    continue  # another rank's shard
                if res["digests"].get(key) != value:
                    failed.append(f"rank {r} of {mode}: {key} differs from the one-process mesh")
            if mode == "2x1" and res["rows"]["psum"] != 3.0:
                failed.append(f"rank {r}: psum {res['rows']['psum']}, not 1 + 2 = 3")
            if mode == "2x2":
                failed += [f"{name} was not launched in rank {r}" for name in DIST_KERNELS
                           if res["launches"][name] < 1]
                pools = [k for k in res["digests"] if k.startswith("pool_")]
                if len(pools) != 2:
                    failed.append(f"rank {r} holds the pools {pools}")
    one = rank_times(ref_rows)
    for r, res in enumerate(runs["2x2"][1]):
        if res is not None:
            print(f"{tag} | rank {r} launches "
                  f"{ {k: v for k, v in res['launches'].items() if v} }", flush=True)
            mine = rank_times(res["rows"])
            print(f"{tag} | rank {r} ({res['mesh']}), beside one process of 4 shards in "
                  f"brackets: " + "; ".join(f"{k} {v:.3f} ({one[k]:.3f})" for k, v in mine.items())
                  + f"; its path {res['path_s']:.1f} s, its process {res['seconds']:.1f} s (host "
                  "clock to a synchronize)", flush=True)
    for r, res in enumerate(runs["2x1"][1]):
        if res is not None:
            rr = res["rows"]
            print(f"{tag} | rank {r} ({res['mesh']}): psum {rr['psum']}; DistSpmv offshore "
                  f"{rr['spmv']['fp32']['median_s'] * 1e3:.3f} / "
                  f"{rr['spmv']['fp64']['median_s'] * 1e3:.3f} ms a call; dist_cg "
                  f"{rr['cg']['ms_per_iteration']:.3f} ms an iteration", flush=True)
    rows = {m: [res and res["rows"] for res in runs[m][1]] for m in runs}
    print(f"{tag} | rows {json.dumps(rows, default=str)}", flush=True)
    if failed:
        raise AssertionError("phase 16: " + "; ".join(failed))
    return [res["launches"] for res in runs["2x2"][1]]


_PHASE = [0.0]


def phase_done(k):
    """Print phase k's seconds on a line of its own."""
    now = time.perf_counter()
    print(f"[phase] {k} took {now - _PHASE[0]:.1f} s", flush=True)
    _PHASE[0] = now


SPLU_BUDGETS = (SP.SHORT, 128, 256, SP.MAX_BUDGET)


@held
def time_splu_alone(name_limit):
    """``python3 chip_smoke.py --splu-times``: K8 at the path's two shapes
    (2cubes_sphere's ILU(0), laplacian_2d(300, 300)'s fill) in a fresh
    process, the plan cut at each pair budget of ``SPLU_BUDGETS`` (the
    smallest: every long entry a task of its own), fp32 and fp64: each
    plan's factor bit for bit with the first plan's (and that one with the
    plain version), timed by events and the profiler in 3 rounds; the times
    as one JSON line."""
    _build.load()
    check_parser()
    latency = link_probe(name_limit)
    a = corpus.load_matrix("2cubes_sphere")[0]
    lap = laplacian_2d(300, 300)
    fill = analysis.symbolic_fill_lu(analysis.permute_csr(lap, analysis.ordering(lap, "fillauto")))
    out = {}
    for what, f in (("2cubes_sphere ILU(0)", a), ("laplacian_2d(300, 300) fill", fill)):
        sched = analysis.chow_patel_schedule(f)
        # the levels' census: a level costs its longest entry's chain at least
        lev, lens = SP.entry_levels(sched), np.diff(sched.ptr)
        longest = np.zeros(int(lev.max()) + 1, np.int64)
        np.maximum.at(longest, lev, lens)
        print(f"[splu] {name_limit} | {what}: {longest.size} levels; the longest entry of a level "
              f"at the 10th / 50th / 90th percentile and the most: "
              f"{np.percentile(longest, [10, 50, 90]).tolist()} / {int(longest.max())} pairs; "
              f"levels whose longest entry passes {SP.MAX_BUDGET} pairs: "
              f"{int((longest > SP.MAX_BUDGET).sum())}", flush=True)
        first = {}
        for lp in SPLU_BUDGETS:
            plan = SP._plan_cut(f.nrows, sched, lp)
            d = SP.splu_to_device(plan, "cuda")
            for policy in ("fp32", "fp64"):
                p = get_policy(policy)
                eps = (1e-13 if policy == "fp64" else 1e-4) * float(np.abs(f.data).max())
                av = p.cast_host(f.data).cuda()
                got = SP.splu_factor(d, av, eps)
                if policy not in first:
                    if not torch.equal(got, SP.splu_factor_plain(d, av, eps)):
                        raise AssertionError(f"K8 {policy} on {what}: kernel != plain")
                    first[policy] = got
                elif not torch.equal(got, first[policy]):
                    raise AssertionError(f"K8 {policy} on {what}, budget {lp}: another result")
                ev, prof = [], []
                for _ in range(3):
                    ev.append(events_ms(lambda: SP.splu_factor(d, av, eps), 5))
                    prof.append(profiler_ms(lambda: SP.splu_factor(d, av, eps),
                                            "splu_factor_kernel", 5))
                key = f"{what} {policy} budget={lp}"
                out[key] = {"events_ms": ev, "profiler_ms": prof, "tasks": len(plan.tasks),
                            "levels": plan.nlevels}
                print(f"[time] {name_limit} | K8 {key}: {len(plan.tasks)} tasks, {plan.nlevels} "
                      f"levels; events {', '.join(f'{x:.4f}' for x in ev)} ms, profiler "
                      f"{', '.join(fmt_ms(x) for x in prof)} (rounds); chain bound "
                      f"{(plan.nlevels - 1) * latency * 1e3:.4f} ms; == the first plan's bit for "
                      f"bit", flush=True)
            del d
    print(json.dumps(out))


def band_phase(name_limit, a, band_times, band_errs, probes):
    """Phase 6: the direct path at full width (:func:`direct_path`) on
    ``a``, and K1's chain bound; returns the path's launches and its
    products'. ``--phase-times`` runs this source in another tree."""
    band_launches, spmv_direct = direct_path(name_limit, a, band_times, band_errs, probes)
    for name, n in band_launches.items():
        if n < 1:
            raise AssertionError(f"{name} was not launched on the direct path")
    barrier = block_barrier(name_limit, probes)
    for name in ("respa_block_lu_f32", "respa_block_lu_f32_ftz", "respa_block_lu_f64"):
        t = band_times[name]
        # the chain: 128 pivots, each handed on at least once through shared
        # memory past a barrier (the first version's step) or a shuffle
        t["chain_bound_ms"] = B.MAX_P * barrier * 1e3
        print(f"[time] {name_limit} | {name}: chain bound {t['chain_bound_ms'] * 1e3:.3f} us "
              f"({B.MAX_P} pivots x the barrier-and-broadcast probe), a block's arithmetic on "
              f"one SM {t['sm_bound_ms'] * 1e3:.3f} us; the kernel "
              f"{fmt_ms(t['profiler_ms'] or t['kernel_ms'])} is "
              f"{(t['profiler_ms'] or t['kernel_ms']) / t['chain_bound_ms']:.1f}x the chain "
              f"(first version {fmt_ms(t['before_ms'])})", flush=True)
    return band_launches, spmv_direct


def splu_phases(name_limit, a, latency, probes, done):
    """Phases 10 (exact ILU(0) of ``a`` by K8, :func:`splu_ilu_path`) and 11
    (the direct scheduled LU, :func:`splu_direct_path`), each with its
    holds; ``done(k)`` ends phase k. Returns their launches, K8's errors,
    its times on each, and phase 11's fp32 and fp64 factorizations.
    ``--phase-times`` runs this source in another tree."""
    errs, times = {}, {}
    ilu_launches = splu_ilu_path(name_limit)
    no_plain("exact ILU(0) path")
    for name in ("respa_splu_factor_f32", "respa_splu_factor_f64", "respa_splu_factor_f32_ftz",
                 "respa_splu_factor_bf16", "respa_tri_solve_lower_f64"):
        if ilu_launches[name] < 1:
            raise AssertionError(f"{name} was not launched on the exact ILU(0) path")
    l2 = l2_read_rate(name_limit, probes)
    hold_splu_ilu(name_limit, a, errs, times, latency, l2)
    done(10)
    direct_launches, fac, fac64 = splu_direct_path(name_limit)
    no_plain("direct sparse path")
    lu_times = hold_splu_direct(name_limit, fac, fac64, errs, latency, l2)
    done(11)
    return ilu_launches, direct_launches, errs, times, lu_times, fac, fac64


def main():
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    name_limit = card_line()
    print(name_limit, flush=True)
    if torch.backends.cuda.matmul.allow_tf32 is not False:
        raise AssertionError("TF32 matmul is on; the port expects full fp32")
    torch.backends.cudnn.allow_tf32 = False
    print(f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} torch={torch.__version__} "
          f"cuda={torch.version.cuda}", flush=True)
    count_plain_calls()

    if sys.argv[1:2] == ["--ilu-rows"]:
        ilu_rows_in_turns(sys.argv[2:])
        return
    if sys.argv[1:2] == ["--ilu-times"]:
        time_ilu_alone(name_limit)
        return
    if sys.argv[1:2] == ["--upload-times"]:
        upload_times_in_turns(sys.argv[2:])
        return
    if sys.argv[1:2] == ["--phase-times"]:
        phase_times_in_turns(sys.argv[2:])
        return
    if sys.argv[1:2] == ["--splu-times"]:
        time_splu_alone(name_limit)
        return
    if sys.argv[1:2] == ["--dist"]:
        _build.load()
        with tempfile.TemporaryDirectory() as tmp:
            dist_path(name_limit, {m: corpus.load_matrix(m)[0] for m in MAIN}, tmp)
        return
    if sys.argv[1:2] == ["--band"]:
        with ThreadPoolExecutor(1) as builder:
            probes = builder.submit(build_probes)
            _build.load()
            probes = probes.result()
        band_errs, band_times = {}, {}
        check_block_lu(band_errs)
        check_band_multi(band_errs)
        check_band_t(band_errs)
        direct_path(name_limit, corpus.load_matrix(MAIN[0])[0], band_times, band_errs, probes)
        return
    if sys.argv[1:2] == ["--before"]:
        with ThreadPoolExecutor(1) as builder:
            probes = builder.submit(build_probes)
            _build.load()
            probes = probes.result()
        before_path(name_limit, probes)
        return
    if sys.argv[1:2] == ["--rank-worker"]:
        rank_worker(name_limit, sys.argv[2:])
        return
    if sys.argv[1:2] == ["--ranks"]:
        from respatpu_torch import dist
        _build.load()
        off, cubes, eco = (corpus.load_matrix(m)[0] for m in ("offshore", "2cubes_sphere",
                                                                "ecology2"))
        t0 = time.perf_counter()
        rows, digests, failed, sub = dist_core(f"[dist] {name_limit}",
                                               dist.make_mesh(DIST_SHARDS, DIST_DEVICE),
                                               DIST_DEVICE, off, eco, cubes)
        del sub
        if failed:
            raise AssertionError("the one-process reference: " + "; ".join(failed))
        print(f"[ranks] the one-process reference took {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        ranks_path(name_limit, digests, rows)
        print(f"[ranks] phase 16 took {time.perf_counter() - t0:.1f} s", flush=True)
        return

    # 2. build
    t0 = time.perf_counter()
    _PHASE[0] = t0
    builder = ThreadPoolExecutor(1)  # the probes of phases 10 and 12, beside the kernels
    probes = builder.submit(build_probes)
    lib = _build.load()
    print(f"[build] {lib._name} ready in {time.perf_counter() - t0:.2f} s "
          f"(cap {lib.respa_spmv_csr_cap()}, max rows {lib.respa_spmv_csr_max_rows()}, "
          f"largest band block {lib.respa_band_max_p()})", flush=True)
    check_parser()
    phase_done(2)

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

    phase_done(3)

    # 4. main path
    reset_counts()
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
        d64 = K.to_device(a, "fp64", "cuda", fmt="csr")
        y64s[mname] = K.spmv(d64, x_for(d64, x64))
        e64 = rel_err(y64s[mname], torch.from_numpy(K.spmv_csr_reference(a, x64)))
        if e64 > 1e-13:
            raise AssertionError(f"{mname}: fp64 error {e64:.3e} > 1e-13")
        print(f"[main] {mname}: fp64 y vs host oracle rel_err={e64:.3e} (tol 1e-13)", flush=True)
    for p in LOW:
        for row in rows[p]:
            a = mats[row["matrix"]]
            x64 = np.random.default_rng(42).standard_normal(a.shape[1])
            dlo = K.to_device(a, p, "cuda", fmt="csr")
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
    no_plain("SpMV path")
    profile_sweep_row(name_limit)
    phase_done(4)

    # 5. band kernels vs plain
    band_errs, band_times = {}, {}
    check_block_lu(band_errs)
    check_band_sweep(band_errs)
    check_band_multi(band_errs)
    check_band_t(band_errs)
    phase_done(5)

    # 6. direct path at full width
    band_launches, spmv_direct = band_phase(name_limit, mats[MAIN[0]], band_times, band_errs,
                                            probes.result())
    phase_done(6)

    # 7. frontal kernels vs plain
    front_errs, front_full, front_times = {}, {}, {}
    check_frontal_kernels(front_errs)
    phase_done(7)

    # 8. multifrontal path at full width (the link probe first: the wide
    # sweeps' chain bounds, and phase 9's)
    latency = link_probe(name_limit)
    front_launches, fac_dc1 = multifrontal_path(name_limit, mats, front_errs, front_full,
                                                front_times, probes.result(), latency)
    for name in (*F.LAUNCHES, "respa_block_lu_f32", "respa_block_lu_f32_ftz",
                 "respa_block_lu_f64", "spmv_fp64"):
        if front_launches[name] < 1:
            raise AssertionError(f"{name} was not launched on the multifrontal path")
    phase_done(8)

    # 9. the ILU(0) path
    ilu_errs, ilu_times = {}, {}
    check_ilu_synthetic(ilu_errs)
    check_tri_synthetic(name_limit, ilu_errs, latency)
    ilu_launches = ilu_path(name_limit, mats)
    no_plain("ILU(0) path")
    # the grid Laplacian's products take the DIA kernel, 2cubes_sphere's the CSR one
    for name in (*I.LAUNCHES, *S.LAUNCHES, "spmv_fp32", "respa_dia_spmv_f32",
                 "respa_dia_spmv_f32_ftz", "respa_dia_spmv_bf16"):
        if ilu_launches[name] < 1:
            raise AssertionError(f"{name} was not launched on the ILU path")
    schedule_sizes(name_limit, "dc1", mats["dc1"])
    hold_and_time_ilu(name_limit, mats["2cubes_sphere"], ilu_errs, ilu_times, latency, None)
    phase_done(9)

    # 10. exact ILU(0) by the scheduled LU (K8); 11. the direct scheduled LU
    (splu_ilu_launches, splu_direct_launches, splu_errs, splu_times, splu_lu_times, fac_s,
     fac_s64) = splu_phases(name_limit, mats["2cubes_sphere"], latency, probes.result(),
                            phase_done)

    # 12. the DIA path
    dia_errs, dia_times = {}, {}
    dia_launches, grids = dia_path(name_limit)
    no_plain("DIA path")
    hold_and_time_dia(name_limit, grids, dia_errs, dia_times, probes.result())
    builder.shutdown()
    phase_done(12)

    # 13. persistence
    persist_launches = persistence_path(name_limit, fac_dc1, fac_s, fac_s64)
    no_plain("persistence path")
    del fac_dc1, fac_s, fac_s64
    phase_done(13)

    # 14. the precision study
    study_launches = study_path(name_limit)
    no_plain("study path")
    phase_done(14)

    # 15. the distributed stack
    with tempfile.TemporaryDirectory() as tmp:
        dist_launches, dist_digests, dist_rows = dist_path(name_limit, mats, tmp)
    phase_done(15)

    # 16. the distributed stack over processes
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    rank_launches = ranks_path(name_limit, dist_digests, dist_rows)
    phase_done(16)

    # 17. result
    kernels = []
    for p in TOL:
        kernels.append({"name": f"respa_spmv_csr_{INST[p]}", "route": "cuda", "source": SOURCE,
                        "replaces": REPLACES[p], "launches": launches[p],
                        "max_abs_err": errs[p], **times[MAIN[0], p], "bound_by": "bytes",
                        "shape": MAIN[0],
                        "by_matrix": {m: times[m, p] for m in MAIN},
                        "launches_ilu_path": ilu_launches[f"spmv_{p}"],
                        **({"launches_direct_path": spmv_direct,
                            "launches_frontal_path": front_launches["spmv_fp64"]}
                           if p == "fp64" else {})})
    for name in B.LAUNCHES:
        kernels.append({"name": name, "route": "cuda",
                        "source": MULTI_SOURCE if "_multi_" in name else BAND_SOURCE,
                        "replaces": (LU_REPLACES if "block_lu" in name else
                                     T_REPLACES if "_sweep_t_" in name else SWEEP_REPLACES),
                        "launches": band_launches[name], "max_abs_err": band_errs[name],
                        **band_times[name],
                        **({"launches_frontal_path": front_launches[name],
                            "frontal_groups": {k.split()[-1]: v for k, v in
                                               front_times.get("block_lu_groups", {}).items()
                                               if k.split()[0] == name}}
                           if "block_lu" in name else {})})
    for name in F.LAUNCHES:
        kernels.append({"name": name, "route": "cuda", "source": FRONTAL_SOURCE,
                        "replaces": FRONTAL_REPLACES[kernel_kind(name)],
                        "launches": front_launches[name], "max_abs_err": front_errs[name],
                        **front_full.get(name, {}), **front_times[name]})
    for name in (*I.LAUNCHES, *S.LAUNCHES):
        inst = "f32_ftz" if name.endswith("_ftz") else name.rsplit("_", 1)[-1]
        sweep = name in I.LAUNCHES
        kernels.append({"name": name, "route": "cuda",
                        "source": ILU_SOURCE if sweep else TRI_SOURCE,
                        "replaces": (ILU_REPLACES if sweep else TRI_REPLACES)[inst],
                        "launches": ilu_launches[name], "max_abs_err": ilu_errs[name],
                        **ilu_times[name]})
    for name in SP.LAUNCHES:
        inst = "f32_ftz" if name.endswith("_ftz") else name.rsplit("_", 1)[-1]
        kernels.append({"name": name, "route": "cuda", "source": SPLU_SOURCE,
                        "replaces": SPLU_REPLACES[inst], "launches": splu_ilu_launches[name],
                        "launches_direct_sparse_path": splu_direct_launches[name],
                        "max_abs_err": splu_errs[name], **splu_times[name],
                        **({"lu_laplacian": splu_lu_times[name]} if name in splu_lu_times
                           else {})})
    for name in DI.LAUNCHES:
        inst = "f32_ftz" if name.endswith("_ftz") else name.rsplit("_", 1)[-1]
        kernels.append({"name": name, "route": "cuda", "source": DIA_SOURCE,
                        "replaces": DIA_REPLACES[inst], "launches": dia_launches[name],
                        "launches_ilu_path": ilu_launches[name],
                        "launches_exact_ilu_path": splu_ilu_launches[name],
                        "max_abs_err": dia_errs[name], **dia_times[name]})
    for k in kernels:
        k["launches_study_path"] = study_launches[k["name"]]
        k["launches_persist_path"] = persist_launches[k["name"]]
        k["launches_dist_path"] = dist_launches[k["name"]]
        k["launches_rank_path"] = [w[k["name"]] for w in rank_launches]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
