#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pisces_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero without printing
its result lines:

  1. build  — compile every CUDA kernel from the sources in this checkout
     (one nvcc per source, in parallel, sm_90a) and, beside them, the native
     host module (g++ from pisces_tpu_torch/io/_native/*.cpp), and print the
     build times, the ptxas report and the zlib the host module links;
  2. kernels — hold each kernel against its plain PyTorch version on the
     card on seeded inputs (integer outputs exact, floats within the stated
     tolerance): the tuple kernel and the counts kernel at L = 1, 7, 511,
     513, 6,119, 50,176, 200,000 and 200,192 (the tile edges, and sizes
     ragged against a 32-locus tile), in the k ~ lambda band, on deep loci
     (coverage up to 5,000) and at lambda up to 1e5; the counts kernel also
     on reference-N rows;
  3. main path — write a synthetic messy workload (one 200 kb chromosome,
     1.5M 100 bp reads: 750x, an enrichment-panel depth) and run the
     port's CLI entry point on the card with -gVCF true, which takes the
     native flow (C++ decode and pileup pass): the launch and native-pileup
     counts are set to 0 just before and read just after; the native pileup
     must have run and the tuple kernel must have launched. The same run
     with -backend numpy (all-host f64, native flow) must give the same VCF
     body, the reference-line strand bias within 1e-3 dB (5% below -40 dB).
     Then one run of the Python flow (open_bam(prefer_native=False),
     -backend torch) must hand the tuple kernel as many unique tuples and
     give a byte-equal VCF body; its read events, reference sequence and
     single-device reference-locus outputs are recorded;
  4. mesh — the Python flow's events through the mesh-sharded scoring path
     (parallel/sharding.sharded_score_reference_positions, the function
     -MeshDevices calls) on meshes of 1 and 4 shards on the one card, at
     the main path's full width: the counts are set to 0 just before each
     mesh's run and read just after, the counts kernel must launch once per
     shard, and the per-position outputs must equal the single-device ones
     (integers exact, strand bias within the phase-2 tolerance). The counts
     kernel is then held against its plain version on the tile each mesh
     handed it, with the phase-2 tolerance;
  5. entry points — entry() on the card against the plain version, and
     dryrun_multichip over every card;
  A. windowed panel — phase 3's workload (written with its .bai) through
     the CLI with -WindowSize 100000 (serial windows), then through
     call_chromosome_windowed with two pipeline threads, each window on
     its own lazy reader: counts set to 0 before each run and read after;
     the native pileup must run once a window and the tuple kernel launch
     once a window, and each VCF body must be byte-equal to phase 3's
     whole-chromosome body;
  B. schedulers — a 4 x 100 kb, 3M-read workload (750x) through the CLI
     serially, with -MaxThreads 4, with -MaxThreads 4 -ThreadByChr true
     and with -MultiProcess true -MaxThreads 4 (spawned children, which
     fail rather than fall back): each in-process run must launch the
     tuple kernel once a chromosome from the pool's threads, counted
     exactly, and every body must be byte-equal to the serial one;
  C. WGS streaming — the reference bench's WGS workload
     (generate_wgs_workload) cut to one 11 Mb chromosome and 3.3M messy
     reads (30x, six windows; the bench's is 33 Mb and 10M reads),
     generated in a child process, then the CLI as a child process
     with -gVCF true -WindowSize 2000000 on the card and again with
     -backend numpy: the native pileup must run once a window, and the two
     bodies must agree (reference-line SB within the phase-2 tolerance);
     each run's wall, reads/s, windows, peak RSS (the child's rusage,
     beside that of a child that only opens the CUDA context), stages,
     counters and device watermark (-metricsjson) are logged;
  D. multi-host — phase B's workload through run_local_multihost: two
     worker processes joined by torch.distributed (gloo on 127.0.0.1),
     both on the one card, each with its own CUDA context; then the SIGKILL
     arm (worker 1 killed after its first shard, host 0 steals the rest).
     Each merged body must be byte-equal to phase B's serial body, and every
     surviving worker must report its own tuple-kernel launches;
  E. ploidies — phase 3's workload through the CLI with -ploidy diploid
     (the whole chromosome) and -ploidy adaptive (20 kb of it, inside
     -IntervalPaths: the adaptive object path genotypes every reference
     locus in Python), each with -backend torch and -backend numpy, which
     must give byte-equal bodies; the candidate batches that reached the
     device are counted; then apps/accuracy.run_germline (thresholding
     and adaptive) on the card, whose recall, precision and genotype
     concordance must each be at least 0.95;
  F. the EM at genome scale — 4M (AD, DP) observations of a seeded
     3-component binomial mixture: fit_mixture_model_torch on the card,
     timed; on the first 1M (the CPU takes about a minute for 4M) the
     card's fit is held against the same function on the CPU within 1e-4,
     and on the first 100k against the f64 numpy EM within 5e-3; then
     satellites/adaptive_gt.recalibrate on a 10,000-locus germline VCF of
     that mixture with backend torch (on the card) and numpy, whose bodies
     must be equal;
  G. caller options — phase 3's workload through the CLI with a
     forced-allele VCF (300 sites: called SNVs and reference loci without
     support), a priors VCF with padded MNVs (-TrimMnvPriors true) and
     -OutputBiasFiles true, -backend torch and numpy: score_tuples must
     launch once in the torch run, every forced allele must be in the body,
     the bodies must agree (reference-line SB within the phase-2 tolerance)
     and both bias tables must be byte-equal;
  H. tagged input — (a) stitched pairs with XD tags under a Stitcher @PG
     line over phase 3's 200 kb (40,000 fragments, about 30x: tagged input
     finds its candidates with the per-read state machine, as in the
     reference) with -UseStitchedXD true, then again with -CoverageMethod
     exact: the native pass counts with the XD directions and score_tuples
     must launch once on tuples with non-zero stitched columns; (b) an
     amplicon panel with XN tags (100 amplicons at 1000x) with -abfilter
     0.01: score_tuples once, AB-filtered calls, byte-equal amplicon-bias
     tables; (c) read-collapsed reads (XV/XW/XR, 5 kb at 300x) with
     -ReportRcCounts true on the object gVCF path; torch and numpy bodies
     agree in each;
  I. MNV calling — apps/accuracy.run_mnv_accuracy (the reference bench's
     mnv stage, direct arm: 40 haplotypes, 300x over 30 kb, seed 13) on the
     card must give recall = precision = 1.00; then its BAM with -CallMNVs
     and -gVCF true in 10 kb of it, torch and numpy bodies byte-equal;
     Phase E runs right after phase A, on its workload, then phase G; phase
     D right after phase B, then phases H and I; phase F runs last;
  6. timing — each kernel on the main path's tuples, 200,000 random tuples
     and each mesh's first tile: the wrapper's time (CUDA events over 50
     back-to-back calls), the kernel's device-only time (torch.profiler's
     kernel time over 50 wrapper calls; CUDA events around the bound C
     launcher alone where the trace shows no kernel; the kernels line says
     which, and how many of the launches the trace showed), the C
     launcher's time alone, the plain version's, and the bound (the bytes
     each call must move and the f32 operations its data needs, each series
     counted to its exact exit);
  7. report — the kernels line (JSON; each kernel's launches on every path
     in "launches_by_path"), end-to-end rates and stages of both flows, the
     mesh phase's wall and stages, peak device memory (main path), the
     card's name and power limit, and the contract line
     {"ok": true, "device": {...}} last.

It needs the pisces_tpu_torch package beside it and a CUDA card; it fails
without either.
"""
from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# one chromosome at 750x of 100 bp reads, an enrichment-panel depth: deep
# enough that the gVCF path's unique (support, coverage) tuples pass the
# 4096-row device threshold (about 1,300 unique tuples per 20 kb at 300x,
# 2,500 at 600x, 3,700 at 1000x on this generator; about twice that over
# 200 kb)
CHROM_LEN = 200_000
N_READS = 1_500_000
SEED = 0
# the tile edges, the main path's tuple count and mesh tiles (ragged
# against a 32-locus tile), and a large random batch
SIZES = (1, 7, 511, 513, 6_119, 50_176, 200_000, 200_192)
TIMING_ITERS = 50
# phase A: two 100 kb windows of the main path's chromosome, each above
# the 4096-tuple device threshold (about 5,000 unique tuples a window)
WINDOW = 100_000
# phase B: four chromosomes at the main path's depth, one a worker thread
SCHED_CHROMS = 4
SCHED_CHROM_LEN = 100_000
SCHED_READS = 3_000_000
SCHED_RUNS = ((), ("-MaxThreads", "4"),
              ("-MaxThreads", "4", "-ThreadByChr", "true"),
              ("-MultiProcess", "true", "-MaxThreads", "4"))
# phase C: the reference bench's WGS stage (bench.py "wgs", 10M reads over
# 33 Mb in 2 Mb windows) cut to a third of its length and reads, so the
# script fits its time: 30x and six windows kept
WGS_READS = 3_300_000
WGS_LEN = 11_000_000
WGS_WINDOW = 2_000_000
# phase D: the SIGKILL arm's pause before each chromosome (so the kill lands
# between a worker's two) and host 0's wait without shard progress
MH_DELAY_S = 2.0
MH_STALL_S = 3.0
# phase E: the adaptive runs' 20 kb of phase 3's chromosome (the object path
# genotypes each reference locus in Python, about half a millisecond each)
ADAPTIVE_REGION = (50_001, 70_000)
# phase F: a germline WGS VCF holds about 4-5M sites
EM_OBS = 4_000_000
EM_CPU_OBS = 1_000_000
EM_NUMPY_OBS = 100_000
EM_MEANS = (0.01, 0.45, 0.95)
EM_WEIGHTS = (0.6, 0.3, 0.1)
RECAL_LOCI = 10_000
# phase G: forced-allele sites on phase 3's chromosome (half of them called
# SNVs, half reference loci without support)
FORCED_SITES = 300
# phase H: (a) stitched pairs over phase 3's 200 kb, cut to 40,000
# fragments (about 30x): tagged input finds its candidates with the
# per-read state machine; (b) an amplicon panel of 100 amplicons at 1000x
# (about 100,000 reads); (c) read-collapsed reads, 5 kb at 300x, whose
# -ReportRcCounts gVCF takes the object path (a reference locus each)
XD_FRAGMENTS = 40_000
AMPLICONS = 100
AMPLICON_DEPTH = 1_000
RC_LEN = 5_000
RC_READS = 15_000
# phase I: the -gVCF run on the MNV accuracy BAM (30 kb, object path),
# cut to 10 kb of it
MNV_GVCF_REGION = (10_001, 20_000)

# published peaks of one H100 SXM at its full 700 W limit (NVIDIA data
# sheet): f32 outside the tensor cores, and HBM3 bandwidth
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12


def log(msg: str) -> None:
    print(f"chip_smoke: {msg}", flush=True)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = TIMING_ITERS) -> float:
    """Mean time of fn() over `iters` back-to-back calls (CUDA events): the
    device time, or the host's when fn() enqueues slower than the card
    runs it."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernel: str, direct):
    """(device-only ms, its source, profiler events seen of TIMING_ITERS):
    the profiler's kernel time over fn()'s launches (a second trace where
    the first missed launches, the fuller one kept); where no trace shows
    the kernel, CUDA events around `direct` (the bound C launcher called
    alone, outputs made once), which on a small launch also holds the
    host's launch time."""
    from pisces_tpu_torch.utils.metrics import kernel_device_ms
    ms, seen = kernel_device_ms(fn, kernel, TIMING_ITERS)
    if seen != TIMING_ITERS:
        log(f"profiler: {seen} device events of {kernel} for "
            f"{TIMING_ITERS} calls")
    if ms is not None:
        return ms, "profiler", seen
    return cuda_ms(direct), "cuda_events_c_launcher", 0


# ---------------------------------------------------------------------------
# The kernels: comparison with their plain versions, and their bounds
# ---------------------------------------------------------------------------

INT_KEYS = ("total_coverage", "support", "variant_qscore", "genotype", "gq",
            "filter_bits", "num_no_calls")
DIR_KEYS = ("coverage_by_dir", "support_by_dir")


def compare_scores(name, out, ref) -> float:
    """Integers (and the by-direction tuples) exact; frequency within 1e-6;
    sb_gatk (clipped to the [-100, 0] dB the gVCF writer emits) within
    1e-3 above -40 dB, 5% below. Returns the largest absolute float
    difference."""
    import torch
    for k in INT_KEYS + DIR_KEYS:
        if not torch.equal(out[k], ref[k]):
            bad = int((out[k] != ref[k]).sum())
            raise AssertionError(f"{name}: {k} differs at {bad} loci")
    err = float((out["frequency"] - ref["frequency"]).abs().max()) \
        if out["frequency"].numel() else 0.0
    if err > 1e-6:
        raise AssertionError(f"{name}: frequency differs by {err}")
    got = out["sb_gatk"].clamp(-100.0, 0.0)
    want = ref["sb_gatk"].clamp(-100.0, 0.0)
    diff = (got - want).abs()
    tol = torch.where(want > -40.0, torch.full_like(want, 1e-3),
                      0.05 * want.abs())
    if bool((diff > tol).any()):
        raise AssertionError(f"{name}: sb_gatk differs by "
                             f"{float(diff.max())} dB")
    return max(err, float(diff.max()) if diff.numel() else 0.0)


def _lgamma_ops(k):
    import numpy as np
    shifts = np.clip(7.0 - np.floor(k), 0.0, 8.0)   # z = k+1 < 8 steps
    return 8 + 3 * shifts + 14                      # compares, shifts, Stirling


def _log_pmf_ops(k):
    return _lgamma_ops(k) + 5


def series_terms(k, lam, lower: bool):
    """Terms each Poisson series of csrc/score_locus.cuh runs on these
    inputs, in f32 as the kernel computes them: it stops at the first term
    that is no larger than the one before and leaves the sum unchanged, or
    after 64 (upper_series: term * lam / (k + j); lower_series:
    term * max(k - (j - 1), 0) / max(lam, 1e-30))."""
    import numpy as np
    f32 = np.float32
    k = np.asarray(k, f32)
    lam = np.asarray(lam, f32)
    if lower:
        lam = np.maximum(lam, f32(1e-30))
    term = np.ones_like(k)
    acc = np.ones_like(k)
    terms = np.full(k.shape, 64, np.int64)
    live = np.ones(k.shape, bool)
    with np.errstate(all="ignore"):
        for j in range(1, 65):
            if lower:
                nxt = term * np.maximum(k - f32(j - 1), f32(0)) / lam
            else:
                nxt = term * lam / (k + f32(j))
            s = acc + nxt
            stop = live & (nxt <= term) & (s == acc)
            terms[stop] = j
            live &= ~stop
            if not live.any():
                break
            term = np.where(live, nxt, term)
            acc = np.where(live, s, acc)
    return terms


# per term: add, multiply, divide, accumulate, two compares (the exit)
_UPPER_TERM = 6
# per term: subtract, max, multiply, divide, accumulate, two compares
_LOWER_TERM = 7


def _tail_ops(k, lam):
    """poisson_tail on the branch each locus takes, its series to the
    exit."""
    import numpy as np
    m = np.maximum(k - np.float32(1), np.float32(0))
    up = _log_pmf_ops(k) + _UPPER_TERM * series_terms(k, lam, False) + 6
    low = 2 + _log_pmf_ops(m) + 1 + _LOWER_TERM * series_terms(m, lam, True) \
        + 6
    return np.where(k <= 0, 1, np.where(k > lam, up, low))


def _lower_cdf_ops(m, lam):
    import numpy as np
    mt = np.trunc(np.maximum(m, np.float32(0)))
    up = _log_pmf_ops(mt + 1) + _UPPER_TERM * series_terms(mt + 1, lam, False)
    low = _log_pmf_ops(mt) + 1 + _LOWER_TERM * series_terms(mt, lam, True)
    return 3 + np.where(mt + 1 > lam, up + 4, low + 3)


def tuple_kernel_ops(tuples, out, params) -> float:
    """f32 operations the scoring math needs on these tuples, following the
    branches this data takes, each series to its exact exit and the overall
    tail once per locus (each add, multiply, divide, compare and
    transcendental counted as one: a lower bound on the work)."""
    import numpy as np
    from pisces_tpu_torch.domain.types import Genotype
    from pisces_tpu_torch.ops.scoring_kernels import noise_constants
    f32 = np.float32
    t = tuples.cpu().numpy().astype(f32)
    nf, _ = noise_constants(params)
    nf = f32(nf)
    sup = t[:, :3]
    cov = t[:, 3:]
    total = cov[:, 0] + cov[:, 1] + cov[:, 2]
    support = sup[:, 0] + sup[:, 1] + sup[:, 2]
    half_s = np.floor(t[:, 2] / 2)
    half_c = np.floor(t[:, 5] / 2)
    # Q and the overall strand-bias side share one tail; a locus without
    # support takes the closed form
    ops = 4 + 1 + np.where(support <= 0, 3, _tail_ops(support, nf * total)
                           + 3) + 4 + 3 + 2 + 2
    for s, c in ((sup[:, 0] + half_s, cov[:, 0] + half_c),
                 (sup[:, 1] + half_s, cov[:, 1] + half_c)):
        ops = ops + 2 + np.where(s <= 0, 3, _tail_ops(s, c * nf) + 3)
    ops = ops + 5 + 3 + 6
    freq = out["frequency"].cpu().numpy().astype(f32)
    gt = out["genotype"].cpu().numpy()
    non_allele = (f32(1) - freq) * total
    expected = f32(params.target_lod) * total
    gated = (gt == int(Genotype.HOMOZYGOUS_REF)) & (non_allele < expected)
    ops = ops + 3 + np.where(gated, 5 + _lower_cdf_ops(non_allele, expected)
                             + 4, 2) + 3 + 4
    return float(ops.sum())


# the counts kernel's prologue per locus: 15 conversions and 12 adds for
# coverage, 2 compares and 3 conversions for support, 2 adds for the N
# count, 2 conversions back for the stitched counts
LOCI_PROLOGUE_OPS = 36
# bytes per locus: counts (72) and reference code (4) read once; seven int32
# and two f32 outputs (36) and six by-direction int32 (24) written once
LOCI_BYTES = 72 + 4 + 36 + 24


def loci_kernel_ops(out, params) -> float:
    """f32 operations the counts kernel does on these loci: its prologue
    plus the tuple math on the tuples the prologue derives."""
    import torch
    tuples = torch.cat([out["support_by_dir"], out["coverage_by_dir"]], 1)
    n = tuples.shape[0]
    return tuple_kernel_ops(tuples, out, params) + LOCI_PROLOGUE_OPS * n


def bound(ops: float, nbytes: float):
    """(bound ms, what bounds it) on one H100 at its published peaks."""
    ops_ms = ops / PEAK_F32_OPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations"
    return bytes_ms, "bytes"


def random_tuples(n: int, seed: int = SEED):
    """int32 [n, 6] (support, coverage)-by-direction tuples, support within
    coverage."""
    import numpy as np
    rng = np.random.default_rng(seed)
    cov = rng.integers(0, 500, size=(n, 3))
    sup = (cov * rng.random((n, 3))).astype(np.int64)
    return np.concatenate([sup, cov], 1).astype(np.int32)


def deep_tuples(n: int, seed: int = SEED):
    """Deep reference loci: coverage up to 5,000, support the coverage less
    a few non-reference reads (lambda = 0.01 x coverage, the upper series'
    short exits)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    cov = rng.integers(0, 1_667, size=(n, 3))
    sup = np.maximum(cov - rng.integers(0, 4, size=(n, 3)), 0)
    return np.concatenate([sup, cov], 1).astype(np.int32)


def large_lambda_tuples(n: int, seed: int = SEED):
    """Coverage up to 10 million (lambda up to 1e5), support 0-3% of it:
    both series branches near k ~ lambda, where they run longest."""
    import numpy as np
    rng = np.random.default_rng(seed)
    cov = rng.integers(0, 3_333_333, size=(n, 3))
    sup = (cov * 0.03 * rng.random((n, 3))).astype(np.int64)
    return np.concatenate([sup, cov], 1).astype(np.int32)


def check_tuple_kernel(device):
    """Phase 2: the tuple kernel against its plain version at the edge and
    ragged sizes, in the k ~ lambda band, on deep loci and at large lambda.
    Returns the largest float difference."""
    import numpy as np
    import torch
    from pisces_tpu_torch.ops import scoring_kernels as K
    from pisces_tpu_torch.ops.scoring_params import ScoringParams
    rng = np.random.default_rng(SEED)
    cases = [(f"L={L}", random_tuples(L, SEED + L)) for L in SIZES]
    band = np.zeros((1024, 6), np.int64)
    band[:, 0] = rng.integers(0, 12, 1024)     # support near the noise floor
    band[:, 3] = band[:, 0]
    band[:, 4] = rng.integers(0, 500, 1024)
    cases.append(("k~lambda band", band))
    cases.append(("deep (coverage up to 5,000)", deep_tuples(4099, SEED + 3)))
    cases.append(("large lambda (up to 1e5)",
                  large_lambda_tuples(4099, SEED + 4)))
    worst = 0.0
    for name, tup in cases:
        t = torch.from_numpy(tup.astype(np.int32)).to(device)
        nc = torch.from_numpy(rng.integers(0, 8, len(tup)).astype(np.int32)
                              ).to(device)
        out = K.score_reference_tuples(t, ScoringParams(), num_no_calls=nc)
        torch.cuda.synchronize()
        ref = K.score_reference_tuples_plain(t, ScoringParams(),
                                             num_no_calls=nc)
        worst = max(worst, compare_scores("score_tuples", out, ref))
        log(f"score_tuples {name}: matches its plain version (integers "
            "exact, sb_gatk within 1e-3 dB above -40 dB and 5% below)")
    return worst


def random_loci(n: int, seed: int = SEED, codes: int = 4):
    """(int32 [n, 6, 3] counts, int32 [n] reference codes in 0..codes-1)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 60, size=(n, 6, 3)).astype(np.int32)
    counts[: n // 50] = 0                      # uncovered loci
    return counts, rng.integers(0, codes, n).astype(np.int32)


def tuple_loci(tuples, seed: int = SEED):
    """Counts whose derived tuples are `tuples` (int [n, 6]): the support
    on the reference row, the rest of the coverage on another base."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n = len(tuples)
    ref = rng.integers(0, 4, n)
    other = (ref + 1 + rng.integers(0, 3, n)) % 4
    counts = np.zeros((n, 6, 3), np.int64)
    rows = np.arange(n)
    counts[rows, ref, :] = tuples[:, :3]
    counts[rows, other, :] = tuples[:, 3:] - tuples[:, :3]
    return counts.astype(np.int32), ref.astype(np.int32)


def check_loci_kernel(device):
    """Phase 2: the counts kernel against its plain version at the edge and
    ragged sizes, in the k ~ lambda band, on reference-N rows, on deep loci
    and at large lambda. Returns the largest float difference."""
    import numpy as np
    import torch
    from pisces_tpu_torch.ops import scoring_kernels as K
    from pisces_tpu_torch.ops.scoring_params import ScoringParams
    rng = np.random.default_rng(SEED + 1)
    cases = [(f"L={L}", *random_loci(L, SEED + L)) for L in SIZES]
    band = np.zeros((1024, 6, 3), np.int32)
    band[:, 0, 0] = rng.integers(0, 12, 1024)   # A reference support ~ noise
    band[:, 2, 1] = rng.integers(0, 500, 1024)  # under a deep C pileup
    cases.append(("k~lambda band", band, np.zeros(1024, np.int32)))
    counts, ref = random_loci(3000, SEED + 2, codes=6)
    ref[::3] = 4                                # reference N: N-row support
    cases.append(("reference-N rows", counts, ref))
    cases.append(("deep (coverage up to 5,000)",
                  *tuple_loci(deep_tuples(4099, SEED + 5), SEED + 5)))
    cases.append(("large lambda (up to 1e5)",
                  *tuple_loci(large_lambda_tuples(4099, SEED + 6), SEED + 6)))
    worst = 0.0
    for name, counts, ref in cases:
        c = torch.from_numpy(counts).to(device)
        r = torch.from_numpy(ref).to(device)
        out = K.score_reference_loci(c, r, ScoringParams())
        torch.cuda.synchronize()
        plain = K.score_reference_loci_plain(c, r, ScoringParams())
        worst = max(worst, compare_scores("score_loci", out, plain))
        log(f"score_loci {name}: matches its plain version (integers and "
            "by-direction tuples exact, sb_gatk within 1e-3 dB above -40 dB "
            "and 5% below)")
    return worst


# ---------------------------------------------------------------------------
# The main path
# ---------------------------------------------------------------------------

def _run_cli(app, bam, genome, out, backend, extra=(), gvcf=True):
    """One CLI run; returns (wall seconds, stage snapshot, VCF body)."""
    import torch
    from pisces_tpu_torch.entry import vcf_body
    from pisces_tpu_torch.utils.metrics import metrics
    metrics.reset()
    t0 = time.perf_counter()
    rc = app.main(["-bam", bam, "-g", genome, "-o", out,
                   "-gVCF", "true" if gvcf else "false",
                   "-backend", backend, "-device", "cuda", *extra])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"-backend {backend} run into {out} exited {rc}")
    stem = os.path.basename(bam)[:-len(".bam")]
    name = f"{stem}.genome.vcf" if gvcf else f"{stem}.vcf"
    return (wall, metrics.snapshot()["stages"],
            vcf_body(os.path.join(out, name)))


def run_main_path(work: str, device):
    """Phase 3. Returns (launch counts, the tuples handed to the tuple
    kernel, the Python flow's recorded gVCF scoring inputs and outputs,
    timings and counts for the report)."""
    import torch
    import pisces_tpu_torch.apps.pisces as app
    import pisces_tpu_torch.calling.fast_gvcf as fast_gvcf
    from pisces_tpu_torch.entry import compare_vcf_bodies
    from pisces_tpu_torch.io import native
    from pisces_tpu_torch.ops import scoring_kernels as K
    from pisces_tpu_torch.synthetic import write_synthetic_workload
    from pisces_tpu_torch.utils.metrics import metrics

    t0 = time.perf_counter()
    bam, genome = write_synthetic_workload(work, 1, CHROM_LEN, N_READS,
                                           seed=SEED, messy=True, index=True)
    log(f"workload: 1 x {CHROM_LEN:,} bp, {N_READS:,} reads "
        f"({N_READS * 100 / CHROM_LEN:.0f}x), written in "
        f"{time.perf_counter() - t0:.1f} s")

    # record what each run hands the kernel (its tuples, to time the kernel
    # there and to count them) and, in the Python flow, the read events, the
    # reference and the single-device outputs, for the mesh phase
    seen, rec = [], {}
    launch = K.score_reference_tuples
    events = app.build_base_events
    score_positions = fast_gvcf.score_reference_positions
    open_bam = app.open_bam

    def recording(tuples, params, num_no_calls=None):
        seen.append((tuples, params))
        return launch(tuples, params, num_no_calls)

    def recording_events(*args, **kw):
        rec["events"] = events(*args, **kw)
        return rec["events"]

    def recording_positions(pc, refseq, params, **kw):
        rec["refseq"], rec["params"] = refseq, params
        rec["single"] = score_positions(pc, refseq, params, **kw)
        return rec["single"]

    # the main path: the default run, native flow, on the card
    K.score_reference_tuples = recording
    torch.cuda.reset_peak_memory_stats(device)
    native.reset_pileup_calls()
    K.reset_launch_counts()
    try:
        wall, stages, port = _run_cli(app, bam, genome,
                                      os.path.join(work, "gpu"), "torch")
    finally:
        K.score_reference_tuples = launch
    launches = dict(K.launch_counts)
    pileups = native.pileup_calls
    counters = metrics.snapshot()["counters"]
    peak = torch.cuda.max_memory_allocated(device)
    if pileups != 1:
        raise AssertionError(f"the main path ran the native pileup {pileups} "
                             "times for one chromosome")
    if launches["score_tuples"] < 1:
        raise AssertionError("kernel score_tuples was not launched on the "
                             "main path")
    main_tuples = sum(t.shape[0] for t, _ in seen)
    log(f"main path (native flow): native_pileup ran {pileups} time(s), "
        f"score_tuples launched {launches['score_tuples']} time(s) on "
        f"{main_tuples:,} unique tuples; "
        f"{counters.get('candidate_batches_on_device', 0):.0f} candidate "
        f"batch(es) of {counters.get('candidates_scored', 0):,.0f} "
        f"candidates reached the device threshold "
        f"({counters.get('candidates_on_device', 0):,.0f} candidates)")

    native.reset_pileup_calls()
    host_wall, host_stages, host = _run_cli(app, bam, genome,
                                            os.path.join(work, "host"),
                                            "numpy")
    if native.pileup_calls != 1:
        raise AssertionError("the -backend numpy run did not take the "
                             "native flow")
    n_lines = compare_vcf_bodies(port, host)
    n_var = sum(1 for ln in port if ln.split("\t")[4] != "."
                and ln.split("\t")[6] == "PASS")
    if n_var == 0:
        raise AssertionError("no PASS variant calls on planted SNVs")
    log(f"main path: {n_lines:,} gVCF lines, {n_var} PASS variants; "
        f"matches -backend numpy")

    # the Python flow (pure-Python reader, read events, torch count build)
    n_seen = len(seen)
    K.score_reference_tuples = recording
    app.build_base_events = recording_events
    fast_gvcf.score_reference_positions = recording_positions
    app.open_bam = lambda path: native.open_bam(path, prefer_native=False)
    native.reset_pileup_calls()
    try:
        py_wall, py_stages, py = _run_cli(app, bam, genome,
                                          os.path.join(work, "python"),
                                          "torch")
    finally:
        K.score_reference_tuples = launch
        app.build_base_events = events
        fast_gvcf.score_reference_positions = score_positions
        app.open_bam = open_bam
    if native.pileup_calls != 0 or "events" not in rec:
        raise AssertionError("the Python-flow run did not take the Python "
                             "flow")
    py_tuples = sum(t.shape[0] for t, _ in seen[n_seen:])
    if py_tuples != main_tuples:
        raise AssertionError(f"the native flow scored {main_tuples:,} unique "
                             f"tuples, the Python flow {py_tuples:,}")
    if py != port:
        raise AssertionError("the Python flow's VCF body differs from the "
                             "native flow's")
    log(f"Python flow: the same {py_tuples:,} unique tuples and a VCF body "
        "byte-equal to the native flow's")
    return launches, seen[:n_seen], rec, {
        "wall_s": wall, "host_wall_s": host_wall, "py_wall_s": py_wall,
        "lines": n_lines, "peak_bytes": peak, "stages": stages,
        "host_stages": host_stages, "py_stages": py_stages,
        "pileups": pileups, "tuples": main_tuples, "body": port}


# ---------------------------------------------------------------------------
# The mesh path
# ---------------------------------------------------------------------------

MESH_SHARDS = (1, 4)


def _per_position(out):
    return {k: v[out["inv"]] for k, v in out.items()
            if k not in ("inv", "ref_base")}


def run_mesh_path(rec, device):
    """Phase 4. Returns (the counts kernel's launches in each mesh's run,
    the largest SB difference, the tile each mesh handed the kernel,
    per-mesh walls and stages)."""
    import numpy as np
    import torch
    from pisces_tpu_torch.ops import scoring_kernels as K
    from pisces_tpu_torch.parallel import sharding
    from pisces_tpu_torch.utils.metrics import metrics

    ev, refseq, params = rec["events"], rec["refseq"], rec["params"]
    pos1, out1 = rec["single"]
    want = _per_position(out1)
    log(f"mesh: {len(ev.gpos):,} recorded events, {len(pos1):,} "
        "single-device positions")
    tiles, runs = {}, []
    launch = sharding.score_reference_loci

    def recording(counts, ref_code, p):
        tiles.setdefault(n, []).append((counts, ref_code, p))
        return launch(counts, ref_code, p)

    worst = 0.0
    launches = {}
    sharding.score_reference_loci = recording
    try:
        for n in MESH_SHARDS:
            metrics.reset()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            pos, out, stats = sharding.sharded_score_reference_positions(
                ev, refseq, params, sharding.Mesh([device] * n))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = launches[n] = K.launch_counts["score_loci"]
            if got != n:
                raise AssertionError(f"{n}-shard mesh launched score_loci "
                                     f"{got} times")
            if not np.array_equal(pos, pos1):
                raise AssertionError(f"{n}-shard mesh: positions differ")
            have = _per_position(out)
            for k in ("total_coverage", "support", "variant_qscore",
                      "genotype", "gq"):
                if not np.array_equal(have[k], want[k]):
                    raise AssertionError(f"{n}-shard mesh: {k} differs")
            sb = np.clip(have["sb_gatk"], -100.0, 0.0)
            sb1 = np.clip(want["sb_gatk"], -100.0, 0.0)
            diff = np.abs(sb - sb1)
            if (diff > np.where(sb1 > -40.0, 1e-3, 0.05 * np.abs(sb1))).any():
                raise AssertionError(f"{n}-shard mesh: sb_gatk differs by "
                                     f"{diff.max()} dB")
            worst = max(worst, float(diff.max(initial=0.0)))
            tile = tiles[n][0][0].shape[0]
            runs.append({"shards": n, "wall_s": wall, "loci_per_launch": tile,
                         "stats": stats,
                         "stages": metrics.snapshot()["stages"]})
            log(f"mesh {n} shard(s) on {device}: {len(pos):,} positions, "
                f"{n} x {tile:,} loci per launch, {wall:.2f} s; equals the "
                "single-device outputs (integers exact, sb_gatk within "
                "1e-3 dB above -40 dB and 5% below)")
    finally:
        sharding.score_reference_loci = launch
    return launches, worst, tiles, runs


# ---------------------------------------------------------------------------
# The entry points
# ---------------------------------------------------------------------------

def run_entry_points(device) -> float:
    """Phase 5: entry() on the card against the plain version, then
    dryrun_multichip over every card; each must launch the counts kernel.
    Returns the largest float difference."""
    import torch
    from pisces_tpu_torch.entry import dryrun_multichip, entry
    from pisces_tpu_torch.ops import scoring_kernels as K
    from pisces_tpu_torch.ops.scoring_params import ScoringParams

    K.reset_launch_counts()
    fn, (counts, ref_code) = entry(device)
    out = fn(counts, ref_code)
    torch.cuda.synchronize()
    if K.launch_counts["score_loci"] != 1:
        raise AssertionError("entry() did not launch score_loci")
    plain = K.score_reference_loci_plain(
        counts.sum(dim=-1, dtype=torch.int32), ref_code, ScoringParams())
    err = compare_scores("entry()", out, plain)
    log(f"entry(): {counts.shape[0]:,}-locus tile matches the plain version")
    n = torch.cuda.device_count()
    K.reset_launch_counts()
    dryrun_multichip(n)
    if K.launch_counts["score_loci"] < 1:
        raise AssertionError("dryrun_multichip did not launch score_loci")
    log(f"dryrun_multichip({n}) completed")
    return err


# ---------------------------------------------------------------------------
# Phases A-C: windows, schedulers, WGS streaming
# ---------------------------------------------------------------------------

def _counted(what: str, pileups: int, launches: int, want: int) -> None:
    """Raise unless a run ran the native pileup and launched score_tuples
    `want` times each."""
    if pileups != want or launches != want:
        raise AssertionError(f"{what}: native_pileup ran {pileups} and "
                             f"score_tuples launched {launches} times; "
                             f"want {want} each")


def run_windowed_path(work: str, device, whole_body):
    """Phase A on phase 3's indexed workload. Returns each run's record."""
    import torch
    import pisces_tpu_torch.apps.pisces as app
    from pisces_tpu_torch.entry import vcf_body
    from pisces_tpu_torch.io import native
    from pisces_tpu_torch.io.fasta import Genome
    from pisces_tpu_torch.io.vcf_write import VcfWriter, VcfWriterConfig
    from pisces_tpu_torch.ops import scoring_kernels as K
    from pisces_tpu_torch.options import PiscesApplicationOptions

    bam = os.path.join(work, "b.bam")
    genome = os.path.join(work, "genome")
    windows = -(-CHROM_LEN // WINDOW)
    runs = []

    # serial windows, through the CLI
    native.reset_pileup_calls()
    K.reset_launch_counts()
    wall, stages, body = _run_cli(app, bam, genome,
                                  os.path.join(work, "windowed"), "torch",
                                  ("-WindowSize", str(WINDOW)))
    runs.append({"run": "windowed serial", "wall_s": wall, "stages": stages,
                 "pileups": native.pileup_calls,
                 "launches": K.launch_counts["score_tuples"]})

    # pipelined windows, two threads with a lazy reader each
    o = PiscesApplicationOptions()
    o.window_size = WINDOW
    o.validate()
    g = Genome(genome)
    out = os.path.join(work, "pipelined.genome.vcf")
    native.reset_pileup_calls()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    reader = native.open_bam(bam, lazy=True)
    with VcfWriter(out, VcfWriterConfig(o), g.directory, "b.bam",
                   g.chromosome_lengths, "") as writer:
        writer.write_header()
        for (alleles, ref_lines), _w0, _w1 in app.call_chromosome_windowed(
                o, g.get_chr_reference("chr1"), reader, 0, None, device,
                reader_factory=lambda: native.open_bam(bam, lazy=True),
                pipeline_threads=2):
            app.write_spliced(writer, alleles, ref_lines)
    torch.cuda.synchronize()
    runs.append({"run": "windowed pipelined (2 threads)",
                 "wall_s": time.perf_counter() - t0,
                 "pileups": native.pileup_calls,
                 "launches": K.launch_counts["score_tuples"]})

    for r, got in zip(runs, (body, vcf_body(out))):
        _counted(r["run"], r["pileups"], r["launches"], windows)
        if got != whole_body:
            raise AssertionError(f"{r['run']}: VCF body differs from the "
                                 "whole-chromosome body")
        log(f"{r['run']}: {windows} windows of {WINDOW:,} bp, "
            f"native_pileup {r['pileups']} and score_tuples "
            f"{r['launches']} time(s), {r['wall_s']:.2f} s "
            f"({N_READS / r['wall_s']:,.0f} reads/s); VCF body byte-equal "
            "to the whole-chromosome body")
    return runs


def run_scheduler_paths(work: str):
    """Phase B. Returns (each run's record, the BAM, the genome directory,
    the serial VCF body)."""
    import pisces_tpu_torch.apps.pisces as app
    from pisces_tpu_torch.io import native
    from pisces_tpu_torch.ops import scoring_kernels as K
    from pisces_tpu_torch.synthetic import write_synthetic_workload

    t0 = time.perf_counter()
    bam, genome = write_synthetic_workload(work, SCHED_CHROMS,
                                           SCHED_CHROM_LEN, SCHED_READS,
                                           seed=SEED, messy=True)
    log(f"scheduler workload: {SCHED_CHROMS} x {SCHED_CHROM_LEN:,} bp, "
        f"{SCHED_READS:,} reads "
        f"({SCHED_READS * 100 / SCHED_CHROMS / SCHED_CHROM_LEN:.0f}x), "
        f"written in {time.perf_counter() - t0:.1f} s")
    runs, serial = [], None
    for i, flags in enumerate(SCHED_RUNS):
        name = "scheduler " + (" ".join(flags) or "serial")
        native.reset_pileup_calls()
        K.reset_launch_counts()
        wall, stages, body = _run_cli(app, bam, genome,
                                      os.path.join(work, f"run{i}"),
                                      "torch", flags)
        r = {"run": name, "wall_s": wall, "stages": stages,
             "pileups": native.pileup_calls,
             "launches": K.launch_counts["score_tuples"]}
        if "-MultiProcess" in flags:
            # the children's pileups and launches are their own
            if r["pileups"] or r["launches"]:
                raise AssertionError("-MultiProcess: the parent ran the "
                                     "chromosomes itself")
        else:
            _counted(name, r["pileups"], r["launches"], SCHED_CHROMS)
        if serial is None:
            serial = body
        elif body != serial:
            raise AssertionError(f"{name}: VCF body differs from the "
                                 "serial run's")
        runs.append(r)
        log(f"{name}: {wall:.2f} s "
            f"({SCHED_READS / wall:,.0f} reads/s), native_pileup "
            f"{r['pileups']} and score_tuples {r['launches']} time(s) in "
            f"this process; {len(body):,} lines"
            + ("" if i == 0 else ", byte-equal to the serial run"))
    return runs, bam, genome, serial


# runs argv[1:] and prints its peak RSS from its rusage (wait4). A child's
# ru_maxrss starts from the RSS of the process it was forked from, so the
# work runs under this small launcher, never straight under chip_smoke
_LAUNCHER = ("import os, subprocess, sys\n"
             "p = subprocess.Popen(sys.argv[1:])\n"
             "_, status, usage = os.wait4(p.pid, 0)\n"
             "print(f'peak RSS KiB {usage.ru_maxrss}', flush=True)\n"
             "sys.exit(os.waitstatus_to_exitcode(status))\n")


def _child(code: str, args, log_path: str):
    """Run the Python `code` (with sys.argv[1:] = args and the checkout on
    sys.path) as a child process under _LAUNCHER, its output to log_path;
    returns (wall seconds, the child's peak RSS in bytes). Raises with the
    log's end if it fails; never leaves it running."""
    prog = f"import sys\nsys.path.insert(0, {REPO!r})\n{code}\n"
    t0 = time.perf_counter()
    with open(log_path, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-c", _LAUNCHER, sys.executable, "-c", prog,
             *args], cwd=REPO, stdout=out, stderr=subprocess.STDOUT,
            start_new_session=True)
        try:
            proc.wait()
        finally:
            if proc.returncode is None:
                os.killpg(proc.pid, 9)
                proc.wait()
    wall = time.perf_counter() - t0
    with open(log_path) as f:
        text = f.read()
    if proc.returncode != 0:
        raise RuntimeError(f"child exited {proc.returncode}:\n"
                           f"{text[-4000:]}")
    rss = [ln.split()[-1] for ln in text.splitlines()
           if ln.startswith("peak RSS KiB")]
    return wall, int(rss[-1]) * 1024


def run_wgs_path(work: str):
    """Phase C; logs each run."""
    from pisces_tpu_torch.entry import compare_vcf_files

    os.makedirs(work, exist_ok=True)
    free = shutil.disk_usage(work).free
    gen_s, gen_rss = _child(
        "from pisces_tpu_torch.synthetic import generate_wgs_workload\n"
        "generate_wgs_workload(sys.argv[1], int(sys.argv[2]), "
        "int(sys.argv[3]))",
        [os.path.join(work, "wl"), str(WGS_READS), str(WGS_LEN)],
        os.path.join(work, "gen.log"))
    bam = os.path.join(work, "wl", "wgs.bam")
    log(f"WGS workload: 1 x {WGS_LEN:,} bp, {WGS_READS:,} messy reads "
        f"({WGS_READS * 100 / WGS_LEN:.0f}x), generated in a child in "
        f"{gen_s:.1f} s (peak RSS {gen_rss / 2**30:.2f} GiB); BAM "
        f"{os.path.getsize(bam) / 2**20:.0f} MiB; "
        f"{free / 2**30:.0f} GiB free before")
    _, base_rss = _child("import torch\ntorch.zeros(1, device='cuda')", [],
                         os.path.join(work, "base.log"))
    log(f"a child that imports torch and opens the CUDA context: peak RSS "
        f"{base_rss / 2**30:.2f} GiB")
    windows = -(-WGS_LEN // WGS_WINDOW)
    vcfs = []
    for backend in ("torch", "numpy"):
        out = os.path.join(work, backend)
        mj = os.path.join(work, f"{backend}.metrics.json")
        wall, rss = _child(
            "from pisces_tpu_torch.apps.pisces import main\n"
            "rc = main(sys.argv[1:])\n"
            "if rc:\n"
            "    sys.exit(rc)",
            ["-bam", bam, "-g", os.path.join(work, "wl", "genome"),
             "-o", out, "-gVCF", "true", "-WindowSize", str(WGS_WINDOW),
             "-backend", backend, "-metricsjson", mj],
            os.path.join(work, f"{backend}.log"))
        with open(mj) as f:
            m = json.load(f)
        pileups = m["stages"]["pileup"]["calls"]
        if pileups != windows:
            raise AssertionError(f"WGS -backend {backend}: {pileups} native "
                                 f"pileups for {windows} windows")
        vcfs.append(os.path.join(out, "wgs.genome.vcf"))
        log(f"WGS -backend {backend} (child process): {wall:.2f} s "
            f"({WGS_READS / wall:,.0f} reads/s), {pileups} windows of "
            f"{WGS_WINDOW:,} bp, peak RSS {rss / 2**30:.2f} GiB, device "
            f"watermark {m['hbm_peak_bytes'] / 2**20:.1f} MiB; stages: "
            + ", ".join(f"{k} {v['seconds']:.2f} s ({v['calls']} calls)"
                        for k, v in m["stages"].items())
            + f"; counters: {m['counters']}")
    n = compare_vcf_files(*vcfs)
    log(f"WGS: {n:,} gVCF lines, -backend torch agrees with -backend "
        "numpy (reference-line SB within 1e-3 dB above -40 dB and 5% "
        "below)")


# ---------------------------------------------------------------------------
# Phases D-F: multi-host, ploidies, the EM
# ---------------------------------------------------------------------------

def _worker_launches(out_dir: str, worker: int):
    """The tuple-kernel launches a multi-host worker reported in its last
    line, or None when it printed none (it was killed)."""
    with open(os.path.join(out_dir, f"multihost_worker{worker}.log")) as f:
        found = [ln.rsplit("score_tuples_launches=", 1)[1]
                 for ln in f.read().splitlines()
                 if "score_tuples_launches=" in ln]
    return int(found[-1]) if found else None


def run_multihost_paths(work: str, bam: str, genome: str, serial_body):
    """Phase D on phase B's workload. Returns each run's record."""
    from pisces_tpu_torch.entry import vcf_body
    from pisces_tpu_torch.parallel.multihost import run_local_multihost

    runs = []
    for name, kw in (("multihost 2 processes", {}),
                     ("multihost SIGKILL arm",
                      {"kill_worker": 1, "recover_stall_s": MH_STALL_S,
                       "delay_per_chr": MH_DELAY_S})):
        out = os.path.join(work, name.split()[-1])
        t0 = time.perf_counter()
        merged = run_local_multihost(bam, genome, out, n_procs=2, gvcf=True,
                                     timeout_s=600, device="cuda", **kw)
        wall = time.perf_counter() - t0
        body = vcf_body(merged)
        if body != serial_body:
            raise AssertionError(f"{name}: merged VCF body differs from "
                                 "phase B's serial body")
        launches = [_worker_launches(out, i) for i in range(2)]
        survivors = [n for i, n in enumerate(launches)
                     if i != kw.get("kill_worker")]
        if any(n is None or n < 1 for n in survivors):
            raise AssertionError(f"{name}: a surviving worker launched "
                                 f"score_tuples {launches} times")
        runs.append({"run": name, "wall_s": wall,
                     "launches": sum(survivors), "by_worker": launches})
        log(f"{name}: {wall:.2f} s ({SCHED_READS / wall:,.0f} reads/s) for "
            "two workers on the one card (each importing torch and opening "
            f"its CUDA context); score_tuples launches by worker {launches}"
            + (" (worker 1 killed after its first shard, so its count is "
               "lost; host 0's includes the stolen chromosome)"
               if "kill_worker" in kw else "")
            + f"; merged body byte-equal to the serial run's "
            f"({len(body):,} lines)")
    return runs


def _germline_ok(name: str, res) -> None:
    for z, r in res.items():
        if min(r.recall, r.precision, r.gt_concordance) < 0.95:
            raise AssertionError(
                f"{name} {z}: recall {r.recall:.3f}, precision "
                f"{r.precision:.3f}, GT concordance {r.gt_concordance:.3f}; "
                "want each at least 0.95")
        log(f"{name} {z}: recall {r.recall:.3f}, precision "
            f"{r.precision:.3f}, GT concordance {r.gt_concordance:.3f} "
            f"(tp={r.tp} gt_err={r.gt_err} fn={r.fn} fp={r.fp})")


def run_ploidy_paths(work: str, device):
    """Phase E on phase 3's workload. Returns each run's record."""
    import pisces_tpu_torch.apps.pisces as app
    from pisces_tpu_torch.apps.accuracy import run_germline
    from pisces_tpu_torch.ops import scoring_kernels as K
    from pisces_tpu_torch.utils.metrics import metrics

    bam = os.path.join(work, "b.bam")
    genome = os.path.join(work, "genome")
    region = os.path.join(work, "adaptive.picard")
    with open(region, "w") as f:
        f.write("@HD\tVN:1.6\nchr1\t%d\t%d\n" % ADAPTIVE_REGION)
    runs = []
    for ploidy, extra in (("diploid", ()),
                          ("adaptive", ("-IntervalPaths", region))):
        bodies = {}
        for backend in ("torch", "numpy"):
            K.reset_launch_counts()
            wall, stages, bodies[backend] = _run_cli(
                app, bam, genome, os.path.join(work, f"{ploidy}_{backend}"),
                backend, ("-ploidy", ploidy, *extra))
            counters = metrics.snapshot()["counters"]
            r = {"run": f"ploidy {ploidy} -backend {backend}",
                 "wall_s": wall, "stages": stages,
                 "launches": K.launch_counts["score_tuples"],
                 "device_batches": counters.get(
                     "candidate_batches_on_device", 0),
                 "device_candidates": counters.get("candidates_on_device", 0),
                 "candidates": counters.get("candidates_scored", 0)}
            runs.append(r)
            log(f"{r['run']}{' in ' + region if extra else ''}: "
                f"{wall:.2f} s, {len(bodies[backend]):,} lines; "
                f"score_tuples launched {r['launches']} time(s) (reference "
                "lines: diploid on the f64 host twin, adaptive on the "
                f"object path); {r['device_batches']:.0f} candidate "
                f"batch(es) of {r['candidates']:,.0f} candidates reached the "
                f"device ({r['device_candidates']:,.0f} candidates)")
        if bodies["torch"] != bodies["numpy"]:
            raise AssertionError(f"-ploidy {ploidy}: -backend torch and "
                                 "-backend numpy bodies differ")
        gts = {ln.split("\t")[9].split(":")[0] for ln in bodies["torch"]}
        if not gts & {"0/1", "1/1"}:
            raise AssertionError(f"-ploidy {ploidy}: no diploid variant "
                                 "genotypes")
        log(f"-ploidy {ploidy}: -backend torch body byte-equal to -backend "
            "numpy")
    for is_adaptive in (False, True):
        name = "germline " + ("adaptive" if is_adaptive else "thresholding")
        t0 = time.perf_counter()
        res = run_germline(os.path.join(work, name.split()[-1]),
                           adaptive=is_adaptive, device=device)
        runs.append({"run": name, "wall_s": time.perf_counter() - t0})
        log(f"{name} (run_germline: generation and the call on the card): "
            f"{runs[-1]['wall_s']:.2f} s")
        _germline_ok(name, res)
    return runs


def _mixture(n: int):
    """(ad, dp): n draws of the 3-component binomial mixture, dp in
    20-300, from SEED."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    comps = rng.choice(3, size=n, p=list(EM_WEIGHTS))
    dp = rng.integers(20, 301, size=n)
    return rng.binomial(dp, np.asarray(EM_MEANS)[comps]), dp


def _germline_vcf(path: str, ad, dp) -> None:
    """A germline VCF of one locus per observation on chr1 (reference
    lines where ad < 2), the shape AdaptiveGT reads."""
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.1\n"
                "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1\n")
        for k, (a, d) in enumerate(zip(ad.tolist(), dp.tolist())):
            alt = "AT" if k % 7 == 0 else "T"
            if a < 2:
                alt, ad_s, gt = ".", str(d - a), "0/0"
            else:
                ad_s, gt = f"{d - a},{a}", ("1/1" if a > 0.75 * d else "0/1")
            f.write(f"chr1\t{100 + 3 * k}\t.\tA\t{alt}\t100\tPASS\tDP={d}\t"
                    f"GT:GQ:AD:DP:VF:NL:SB\t{gt}:100:{ad_s}:{d}:"
                    f"{a / d:.3f}:20:-100.0000\n")


def run_em_path(work: str, device):
    """Phase F. Returns the record of its times."""
    import numpy as np
    import torch
    from pisces_tpu_torch.entry import vcf_body
    from pisces_tpu_torch.genotype import adaptive
    from pisces_tpu_torch.satellites import adaptive_gt

    os.makedirs(work, exist_ok=True)
    ad, dp = _mixture(EM_OBS)
    # the first call pays torch's lazy CUDA set-up; the second is timed
    adaptive.fit_mixture_model_torch(ad[:1000], dp[:1000], device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    means, weights = adaptive.fit_mixture_model_torch(ad, dp, device=device)
    em_s = time.perf_counter() - t0
    m1, w1 = adaptive.fit_mixture_model_torch(
        ad[:EM_CPU_OBS], dp[:EM_CPU_OBS], device=device)
    t0 = time.perf_counter()
    mc, wc = adaptive.fit_mixture_model_torch(
        ad[:EM_CPU_OBS], dp[:EM_CPU_OBS], device="cpu")
    cpu_s = time.perf_counter() - t0
    err_cpu = max(np.abs(m1 - mc).max(), np.abs(w1 - wc).max())
    if err_cpu > 1e-4:
        raise AssertionError(f"EM on the card differs from the CPU by "
                             f"{err_cpu}")
    m2, w2 = adaptive.fit_mixture_model_torch(
        ad[:EM_NUMPY_OBS], dp[:EM_NUMPY_OBS], device=device)
    t0 = time.perf_counter()
    fit = adaptive.fit_mixture_model(ad[:EM_NUMPY_OBS], dp[:EM_NUMPY_OBS])
    np_s = time.perf_counter() - t0
    err_np = max(np.abs(m2 - fit.means).max(), np.abs(w2 - fit.weights).max())
    if err_np > 5e-3:
        raise AssertionError(f"EM on the card differs from the f64 numpy EM "
                             f"by {err_np}")
    log(f"EM: {EM_OBS:,} observations, 200 steps on the card in "
        f"{em_s * 1e3:.1f} ms (transfer and result included); means "
        f"{[round(float(x), 5) for x in means]}, weights "
        f"{[round(float(x), 5) for x in weights]}; on {EM_CPU_OBS:,}: card vs CPU "
        f"within {err_cpu:.2e} (CPU {cpu_s:.2f} s); on {EM_NUMPY_OBS:,}: card "
        f"vs f64 numpy EM ({np_s:.2f} s) within {err_np:.2e}")

    bodies, walls = {}, {}
    for backend in ("torch", "numpy"):
        d = os.path.join(work, backend)
        os.makedirs(d, exist_ok=True)
        vcf = os.path.join(d, "germline.vcf")
        _germline_vcf(vcf, ad[:RECAL_LOCI], dp[:RECAL_LOCI])
        t0 = time.perf_counter()
        out = adaptive_gt.recalibrate(vcf, d, backend=backend, device=device)
        walls[backend] = time.perf_counter() - t0
        bodies[backend] = vcf_body(out)
    if bodies["torch"] != bodies["numpy"] or not bodies["torch"]:
        raise AssertionError("adaptive_gt.recalibrate: -backend torch and "
                             "numpy bodies differ")
    log(f"adaptive_gt.recalibrate on {RECAL_LOCI:,} loci: torch (card) "
        f"{walls['torch']:.2f} s, numpy {walls['numpy']:.2f} s; "
        f"{len(bodies['torch']):,} recalibrated lines, byte-equal")
    return {"em_ms": em_s * 1e3, "cpu_s": cpu_s, "numpy_s": np_s,
            "err_cpu": float(err_cpu), "err_numpy": float(err_np),
            "recal_s": walls}


# ---------------------------------------------------------------------------
# Phases G-I: caller options, tagged input, MNV calling
# ---------------------------------------------------------------------------

def _option_runs(name, bam, genome, out, extra=(), gvcf=True,
                 tuples=None):
    """The CLI on the card (-backend torch) and on the host (-backend
    numpy), launch counts set to 0 just before each run and read just after;
    logs each run's wall, stages, launches and device batches. Returns
    ({backend: record}, {backend: VCF body}). `tuples`, a list, receives
    the tuples each launch of the torch run was handed."""
    import pisces_tpu_torch.apps.pisces as app
    from pisces_tpu_torch.io import native
    from pisces_tpu_torch.ops import scoring_kernels as K
    from pisces_tpu_torch.utils.metrics import metrics

    launch = K.score_reference_tuples

    def recording(t, params, num_no_calls=None):
        tuples.append(t)
        return launch(t, params, num_no_calls)

    runs, bodies = {}, {}
    for backend in ("torch", "numpy"):
        native.reset_pileup_calls()
        K.reset_launch_counts()
        if tuples is not None and backend == "torch":
            K.score_reference_tuples = recording
        try:
            wall, stages, bodies[backend] = _run_cli(
                app, bam, genome, f"{out}_{backend}", backend, extra, gvcf)
        finally:
            K.score_reference_tuples = launch
        counters = metrics.snapshot()["counters"]
        r = {"run": f"{name} -backend {backend}", "wall_s": wall,
             "stages": stages, "pileups": native.pileup_calls,
             "launches": K.launch_counts["score_tuples"],
             "device_batches": counters.get("candidate_batches_on_device", 0),
             "device_candidates": counters.get("candidates_on_device", 0),
             "candidates": counters.get("candidates_scored", 0),
             "reads": counters.get("reads", 0)}
        runs[backend] = r
        log(f"{r['run']}: {wall:.2f} s ({r['reads'] / wall:,.0f} reads/s), "
            f"{len(bodies[backend]):,} lines; native_pileup {r['pileups']} "
            f"and score_tuples {r['launches']} time(s); "
            f"{r['device_batches']:.0f} candidate batch(es) of "
            f"{r['candidates']:,.0f} candidates reached the device "
            f"({r['device_candidates']:,.0f} candidates); stages: "
            + ", ".join(f"{k} {v['seconds']:.2f} s ({v['calls']} calls)"
                        for k, v in stages.items()))
    return runs, bodies


def _launched_once(runs, what: str) -> None:
    if runs["torch"]["launches"] != 1 or runs["numpy"]["launches"] != 0:
        raise AssertionError(
            f"{what}: score_tuples launched {runs['torch']['launches']} "
            f"(torch) and {runs['numpy']['launches']} (numpy) times; want "
            "1 and 0")


def run_option_paths(work: str, main_body):
    """Phase G on phase 3's workload: forced alleles, priors with padded
    MNVs trimmed, and the bias tables in one run a backend. Returns each
    run's record."""
    import filecmp

    from pisces_tpu_torch.entry import compare_vcf_bodies
    from pisces_tpu_torch.io.fasta import Genome
    from pisces_tpu_torch.synthetic import (
        forced_and_prior_sites, write_sites_vcf,
    )

    bam = os.path.join(work, "b.bam")
    genome = os.path.join(work, "genome")
    seq = Genome(genome).get_chr_reference("chr1").sequence
    forced, priors = forced_and_prior_sites(main_body, seq, "chr1",
                                            FORCED_SITES, seed=SEED)
    flags = ("-ForcedAlleles",
             write_sites_vcf(os.path.join(work, "forced.vcf"), forced),
             "-PriorsPath",
             write_sites_vcf(os.path.join(work, "priors.vcf"), priors),
             "-TrimMnvPriors", "true", "-OutputBiasFiles", "true")
    out = os.path.join(work, "options")
    tuples = []
    runs, bodies = _option_runs("options (forced, priors, bias files)", bam,
                                genome, out, flags, tuples=tuples)
    _launched_once(runs, "phase G")
    n = compare_vcf_bodies(bodies["torch"], bodies["numpy"])
    lines = {(ln.split("\t")[1], ln.split("\t")[4]) for ln in bodies["torch"]}
    missing = [f for f in forced if (str(f[1]), f[3]) not in lines]
    if missing:
        raise AssertionError(f"phase G: {len(missing)} forced alleles "
                             f"missing from the body, e.g. {missing[:3]}")
    n_report = sum("ForcedReport" in ln for ln in bodies["torch"])
    for table in ("ReadStrandBias", "AmpliconBias"):
        a, b = (os.path.join(f"{out}_{k}", f"b.genome.{table}.txt")
                for k in ("torch", "numpy"))
        if not filecmp.cmp(a, b, shallow=False):
            raise AssertionError(f"phase G: {table} tables differ between "
                                 "the backends")
    with open(a.replace("AmpliconBias", "ReadStrandBias")) as f:
        n_sb = len(f.read().splitlines()) - 1
    log(f"phase G: score_tuples got {tuples[0].shape[0]:,} unique tuples; "
        f"{n:,} lines agree between the backends; all "
        f"{len(forced)} forced alleles ({len(forced) // 2} at called SNVs, "
        f"the rest at reference loci) in the body, {n_report} lines "
        f"filtered ForcedReport; {len(priors)} priors ({FORCED_SITES // 4} padded "
        f"MNVs); bias tables byte-equal ({n_sb:,} strand-bias rows)")
    return list(runs.values())


def run_tagged_paths(work: str):
    """Phase H: stitched (XD) pairs, also with -CoverageMethod exact; an
    amplicon panel (XN) with -abfilter; read-collapsed input (XV/XW/XR)
    with -ReportRcCounts. Returns each run's record and the stitched
    tuples' count."""
    import filecmp

    from pisces_tpu_torch.entry import compare_vcf_bodies
    from pisces_tpu_torch.synthetic import (
        write_amplicon_workload, write_collapsed_workload,
        write_stitched_workload,
    )

    records = []
    t0 = time.perf_counter()
    bam, genome = write_stitched_workload(os.path.join(work, "xd"),
                                          CHROM_LEN, XD_FRAGMENTS, seed=SEED)
    log(f"stitched workload: 1 x {CHROM_LEN:,} bp, {XD_FRAGMENTS:,} "
        f"fragments, written in {time.perf_counter() - t0:.1f} s")
    stitched = 0
    for name, extra in (("stitched XD", ()),
                        ("stitched XD, -CoverageMethod exact",
                         ("-CoverageMethod", "exact"))):
        tuples = []
        runs, bodies = _option_runs(
            name, bam, genome, os.path.join(work, "xd", name.split()[-1]),
            ("-UseStitchedXD", "true", *extra), tuples=tuples)
        _launched_once(runs, name)
        if runs["torch"]["pileups"] != 1:
            raise AssertionError(f"{name}: the native pass did not count "
                                 "the stitched reads")
        t = tuples[0]
        n_st = int(((t[:, 2] > 0) | (t[:, 5] > 0)).sum())
        if n_st == 0:
            raise AssertionError(f"{name}: no tuple with stitched counts")
        stitched = max(stitched, n_st)
        n = compare_vcf_bodies(bodies["torch"], bodies["numpy"])
        log(f"{name}: score_tuples got {t.shape[0]:,} unique tuples, "
            f"{n_st:,} with non-zero stitched columns; {n:,} lines agree "
            "between the backends")
        records += runs.values()

    t0 = time.perf_counter()
    bam, genome = write_amplicon_workload(os.path.join(work, "amp"),
                                          AMPLICONS, depth=AMPLICON_DEPTH,
                                          seed=SEED)
    log(f"amplicon workload: {AMPLICONS} amplicons at {AMPLICON_DEPTH}x, "
        f"written in {time.perf_counter() - t0:.1f} s")
    out = os.path.join(work, "amp", "run")
    tuples = []
    runs, bodies = _option_runs("amplicon panel -abfilter 0.01", bam, genome,
                                out, ("-abfilter", "0.01",
                                      "-OutputBiasFiles", "true"),
                                tuples=tuples)
    _launched_once(runs, "amplicon panel")
    n = compare_vcf_bodies(bodies["torch"], bodies["numpy"])
    n_ab = sum("AB" in ln.split("\t")[6].split(";") for ln in bodies["torch"])
    if n_ab == 0:
        raise AssertionError("amplicon panel: no call carries the AB filter")
    if not filecmp.cmp(*(os.path.join(f"{out}_{k}",
                                      "b.genome.AmpliconBias.txt")
                         for k in ("torch", "numpy")), shallow=False):
        raise AssertionError("amplicon panel: bias tables differ")
    log(f"amplicon panel: score_tuples got {tuples[0].shape[0]:,} unique "
        f"tuples; {n:,} lines agree between the backends, {n_ab} "
        "calls filtered AB; amplicon-bias tables byte-equal")
    records += runs.values()

    t0 = time.perf_counter()
    bam, genome = write_collapsed_workload(os.path.join(work, "rc"), RC_LEN,
                                           RC_READS, seed=SEED)
    log(f"read-collapsed workload: 1 x {RC_LEN:,} bp, {RC_READS:,} reads, "
        f"written in {time.perf_counter() - t0:.1f} s")
    runs, bodies = _option_runs("read-collapsed -ReportRcCounts", bam,
                                genome, os.path.join(work, "rc", "run"),
                                ("-ReportRcCounts", "true"))
    if bodies["torch"] != bodies["numpy"]:
        raise AssertionError("read-collapsed: bodies differ between the "
                             "backends")
    n_us = sum(ln.split("\t")[8].endswith(":US") for ln in bodies["torch"])
    if n_us == 0 or runs["torch"]["launches"] != 0:
        raise AssertionError(f"read-collapsed: {n_us} lines with US counts, "
                             f"{runs['torch']['launches']} tuple launches")
    log(f"read-collapsed: {len(bodies['torch']):,} lines byte-equal between "
        f"the backends, {n_us} lines with US counts; the object "
        "gVCF path, no score_tuples launch by design")
    records += runs.values()
    return records, stitched


def run_mnv_paths(work: str, device):
    """Phase I: the reference bench's MNV stage (direct arm) on the card,
    then its BAM with -gVCF true in both backends. Returns each run's
    record."""
    from pisces_tpu_torch.apps.accuracy import run_mnv_accuracy

    out = os.path.join(work, "mnv")
    t0 = time.perf_counter()
    res = run_mnv_accuracy(out, device=device)
    wall = time.perf_counter() - t0
    if (res.n_truth, res.recall, res.precision) != (40, 1.0, 1.0):
        raise AssertionError(f"MNV accuracy: {res}; want recall = precision "
                             "= 1.00 on 40 haplotypes")
    log(f"MNV accuracy (direct -CallMNVs arm, 40 haplotypes, 300x over "
        f"30 kb, generation and the call on the card): {wall:.2f} s; "
        f"recall {res.recall:.3f}, precision {res.precision:.3f} "
        f"(tp={res.tp} fp={res.fp} fn={res.fn})")
    region = os.path.join(work, "mnv.picard")
    with open(region, "w") as f:
        f.write("@HD\tVN:1.6\nchrM2\t%d\t%d\n" % MNV_GVCF_REGION)
    runs, bodies = _option_runs(
        "MNV gVCF", os.path.join(out, "mnv.bam"), os.path.join(out, "genome"),
        os.path.join(work, "gvcf"),
        ("-CallMNVs", "true", "-MaxMNVLength", "100", "-MaxGapBetweenMNV",
         "10", "-IntervalPaths", region))
    if bodies["torch"] != bodies["numpy"]:
        raise AssertionError("MNV gVCF: bodies differ between the backends")
    n_mnv = sum(len(ln.split("\t")[3]) > 1 and ln.split("\t")[4] != "."
                for ln in bodies["torch"])
    log(f"MNV gVCF in {MNV_GVCF_REGION}: {len(bodies['torch']):,} lines, "
        f"{n_mnv} MNV lines, byte-equal between the backends (the object "
        "path: no score_tuples launch by design)")
    return [{"run": "MNV accuracy", "wall_s": wall}, *runs.values()]


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------

TUPLE_BYTES = 6 * 4 + 7 * 4 + 2 * 4    # tuple in, seven int32 and two f32 out


def tuple_case(label, tuples, params):
    """A timing case of the tuple kernel on `tuples`."""
    from pisces_tpu_torch.ops import scoring_kernels as K
    out = K.score_reference_tuples(tuples, params)
    return {"kernel": "score_tuples", "label": label, "n": tuples.shape[0],
            "inputs": (tuples, None), "params": params,
            "wrapper": lambda: K.score_reference_tuples(tuples, params),
            "plain": lambda: K.score_reference_tuples_plain(tuples, params),
            "ops": tuple_kernel_ops(tuples, out, params),
            "bytes": tuples.shape[0] * TUPLE_BYTES}


def loci_case(label, counts, ref_code, params):
    """A timing case of the counts kernel on (counts, ref_code)."""
    from pisces_tpu_torch.ops import scoring_kernels as K
    out = K.score_reference_loci(counts, ref_code, params)
    return {"kernel": "score_loci", "label": label, "n": counts.shape[0],
            "inputs": (counts, ref_code), "params": params,
            "wrapper": lambda: K.score_reference_loci(counts, ref_code,
                                                      params),
            "plain": lambda: K.score_reference_loci_plain(counts, ref_code,
                                                          params),
            "ops": loci_kernel_ops(out, params),
            "bytes": counts.shape[0] * LOCI_BYTES}


def direct(lib, case):
    """(fn, out): fn() launches the case's kernel of `lib` through its C
    launcher alone, into `out`, made once."""
    import torch
    from pisces_tpu_torch.ops import scoring_kernels as K
    out = torch.empty((K.OUT_ROWS[case["kernel"]], case["n"]),
                      dtype=torch.int32, device=case["inputs"][0].device)
    return lib.bind(case["kernel"], case["inputs"], out, case["params"]), out


def time_kernel(case, lib):
    """The wrapper's time (CUDA events over TIMING_ITERS back-to-back
    calls), the kernel's device-only time, the C launcher's time alone
    (events), the plain version's (5 calls) and the bound, logged."""
    fn, _ = direct(lib, case)
    kernel = case["kernel"] + "_kernel"
    r = {"ms": cuda_ms(case["wrapper"]),
         "launcher_ms": cuda_ms(fn),
         "plain_ms": cuda_ms(case["plain"], iters=5)}
    r["device_ms"], r["device_ms_source"], r["device_events"] = device_ms(
        case["wrapper"], kernel, fn)
    r["bound_ms"], r["bound_by"] = bound(case["ops"], case["bytes"])
    n = case["n"]
    log(f"{case['kernel']} at {case['label']}: wrapper {r['ms']:.4f} ms, "
        f"device {r['device_ms']:.4f} ms ({r['device_ms_source']}, "
        f"{r['device_events']} of {TIMING_ITERS} launches traced), "
        f"C launcher alone {r['launcher_ms']:.4f} ms, "
        f"plain {r['plain_ms']:.3f} ms; bound "
        f"{r['bound_ms']:.6f} ms ({r['bound_by']}: "
        f"{case['ops'] / n:,.0f} f32 operations and {case['bytes'] // n} "
        f"bytes per locus), device time {r['bound_ms'] / r['device_ms']:.1%}"
        f" of the bound's; {n / r['device_ms'] * 1e3:,.0f} loci/s")
    return r


def main_smoke() -> int:
    if not os.path.isdir(os.path.join(REPO, "pisces_tpu_torch")):
        raise SystemExit("chip_smoke: FAIL: no pisces_tpu_torch package "
                         "beside chip_smoke.py")
    sys.path.insert(0, REPO)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: FAIL: CUDA is not available")
    from pisces_tpu_torch.ops import scoring_kernels as K
    from pisces_tpu_torch.ops.scoring_params import ScoringParams
    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    smi = _nvidia_smi()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    # phase 1: build the CUDA kernels (nvcc) and the native host module
    # (g++) side by side
    from concurrent.futures import ThreadPoolExecutor
    from pisces_tpu_torch.io import native
    with ThreadPoolExecutor(1) as pool:
        host_build = pool.submit(native.build_native)
        lib = K.build_kernels()
        nlib = host_build.result()
    log("built " + ", ".join(os.path.relpath(p, REPO)
                             for p in lib.paths.values())
        + f" in {lib.build_seconds:.1f} s")
    for line in lib.build_log.splitlines():
        if "ptxas" in line or line.endswith(":"):
            log(line.strip())
    zlib_version = nlib.lib.zlibVersion
    zlib_version.restype = ctypes.c_char_p
    log(f"built {os.path.relpath(nlib.path, REPO)} (g++ from "
        f"pisces_tpu_torch/io/_native/*.cpp) in {nlib.build_seconds:.1f} s; "
        f"zlib: the system <zlib.h> and -lz, runtime "
        f"{zlib_version().decode()}")

    # phase 2: kernels against their plain versions
    err = {"score_tuples": check_tuple_kernel(device),
           "score_loci": check_loci_kernel(device)}

    # phase 3: the main path; its workload stays for phase A
    work = os.path.join(REPO, "build", "chip_smoke")
    try:
        launches, seen, rec, e2e = run_main_path(work, device)

        # phase 4: the mesh path on the Python flow's events
        mesh_launches, mesh_err, tiles, mesh_runs = run_mesh_path(rec,
                                                                  device)
        err["score_loci"] = max(err["score_loci"], mesh_err)
        del rec

        # phase 5: the entry points
        err["score_loci"] = max(err["score_loci"], run_entry_points(device))

        # phase A: the main path's chromosome in windows
        main_body = e2e.pop("body")
        win_runs = run_windowed_path(work, device, main_body)

        # phase E: the ploidies on the same workload, then the germline
        # harness
        ploidy_runs = run_ploidy_paths(work, device)

        # phase G: the caller options on the same workload
        option_runs = run_option_paths(work, main_body)
        del main_body
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # phase B: the schedulers; phase D: multi-host on the same workload
    work = os.path.join(REPO, "build", "chip_smoke_sched")
    try:
        sched_runs, sched_bam, sched_genome, serial = \
            run_scheduler_paths(work)
        mh_runs = run_multihost_paths(work, sched_bam, sched_genome, serial)
        del serial
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # phases H and I: tagged input, then MNV calling
    work = os.path.join(REPO, "build", "chip_smoke_tagged")
    try:
        tagged_runs, stitched_tuples = run_tagged_paths(work)
        mnv_runs = run_mnv_paths(work, device)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # phase C: WGS streaming in child processes
    work = os.path.join(REPO, "build", "chip_smoke_wgs")
    try:
        run_wgs_path(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # phase F: the EM at genome scale and the AdaptiveGT satellite
    work = os.path.join(REPO, "build", "chip_smoke_em")
    try:
        em = run_em_path(work, device)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # time each kernel and its plain version on the main paths' own inputs
    # and at 200,000 random tuples
    tuples, params = max(seen, key=lambda s: s[0].shape[0])
    out = K.score_reference_tuples(tuples, params)
    err["score_tuples"] = max(err["score_tuples"], compare_scores(
        "score_tuples", out, K.score_reference_tuples_plain(tuples, params)))
    big = torch.from_numpy(random_tuples(200_000)).to(device)
    cases = [tuple_case(f"the main path's {tuples.shape[0]:,} tuples",
                        tuples, params),
             tuple_case("200,000 random tuples", big, ScoringParams())]
    for n in MESH_SHARDS:
        counts, ref_code, lparams = tiles[n][0]
        lout = K.score_reference_loci(counts, ref_code, lparams)
        err["score_loci"] = max(err["score_loci"], compare_scores(
            f"score_loci ({n}-shard mesh tile)", lout,
            K.score_reference_loci_plain(counts, ref_code, lparams)))
        log(f"score_loci on the {n}-shard mesh's first tile: matches its "
            "plain version (integers and by-direction tuples exact, sb_gatk "
            "within 1e-3 dB above -40 dB and 5% below)")
        cases.append(loci_case(f"the {n}-shard mesh's {counts.shape[0]:,} "
                               "loci per launch", counts, ref_code, lparams))
    timed = [time_kernel(c, lib) for c in cases]

    reads_s = N_READS / e2e["wall_s"]
    lines_s = e2e["lines"] / e2e["wall_s"]
    log(f"end to end, native flow (-backend torch): {e2e['wall_s']:.2f} s, "
        f"{reads_s:,.0f} reads/s, {lines_s:,.0f} gVCF lines/s; "
        f"-backend numpy {e2e['host_wall_s']:.2f} s; Python flow "
        f"(-backend torch) {e2e['py_wall_s']:.2f} s, "
        f"{N_READS / e2e['py_wall_s']:,.0f} reads/s")
    for flow, key in (("native flow, -backend torch", "stages"),
                      ("native flow, -backend numpy", "host_stages"),
                      ("Python flow, -backend torch", "py_stages")):
        log(f"stages ({flow}): " + ", ".join(
            f"{k} {v['seconds']:.2f} s ({v['calls']} calls)"
            for k, v in e2e[key].items()))
    for r in mesh_runs:
        log(f"mesh {r['shards']} shard(s): {r['wall_s']:.2f} s, stages " +
            ", ".join(f"{k} {v['seconds']:.2f} s"
                      for k, v in r["stages"].items()) +
            f"; {r['stats']}")
    log(f"peak device memory (main path): {e2e['peak_bytes'] / 2**20:.1f} MiB")
    for r in mh_runs:
        log(f"{r['run']}: {r['wall_s']:.2f} s against {sched_runs[0]['wall_s']:.2f}"
            f" s serial (phase B)")
    log(f"EM at {EM_OBS:,} observations on the card: {em['em_ms']:.1f} ms")
    log(f"phase H(a): {stitched_tuples:,} tuples with non-zero stitched "
        "columns reached score_tuples")
    for r in win_runs + sched_runs + ploidy_runs:
        if r.get("stages"):
            log(f"stages ({r['run']}): " + ", ".join(
                f"{k} {v['seconds']:.2f} s ({v['calls']} calls)"
                for k, v in r["stages"].items()))

    # the tuple kernel's line carries the main path's tuples, the counts
    # kernel's the 1-shard mesh run: its launches and the tile it launched on
    t, lt = timed[0], timed[2]
    log("score_loci launches per mesh run: " + ", ".join(
        f"{n} shard(s) {mesh_launches[n]}" for n in MESH_SHARDS))
    kernels = [{
        "name": "score_tuples",
        "route": "cuda",
        "source": "pisces_tpu_torch/csrc/score_tuples.cu",
        "replaces": "pisces_tpu/ops/pallas_scoring.py:245",
        "launches": launches["score_tuples"],
        "launches_by_path": {
            "main": launches["score_tuples"],
            **{r["run"]: r["launches"]
               for r in (win_runs + sched_runs + mh_runs + ploidy_runs
                         + option_runs + tagged_runs + mnv_runs)
               if "launches" in r}},
        "max_abs_err": err["score_tuples"],
        "ms": t["ms"],
        "device_ms": t["device_ms"],
        "device_ms_source": t["device_ms_source"],
        "device_ms_events": t["device_events"],
        "device_ms_calls": TIMING_ITERS,
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
    }, {
        "name": "score_loci",
        "route": "cuda",
        "source": "pisces_tpu_torch/csrc/score_loci.cu",
        "replaces": "pisces_tpu/ops/pallas_scoring.py:220",
        "launches": mesh_launches[MESH_SHARDS[0]],
        "launches_by_path": {f"mesh {n} shard(s)": mesh_launches[n]
                             for n in MESH_SHARDS},
        "max_abs_err": err["score_loci"],
        "ms": lt["ms"],
        "device_ms": lt["device_ms"],
        "device_ms_source": lt["device_ms_source"],
        "device_ms_events": lt["device_events"],
        "device_ms_calls": TIMING_ITERS,
        "plain_ms": lt["plain_ms"],
        "bound_ms": lt["bound_ms"],
        "bound_by": lt["bound_by"],
        "library_ms": None,
    }]
    log(f"chip_smoke ran {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main_smoke())
