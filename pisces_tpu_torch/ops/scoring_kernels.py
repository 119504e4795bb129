"""Hand-written Hopper kernels for per-locus scoring, with their plain
PyTorch versions.

`score_reference_tuples` scores unique (support, coverage)-by-direction
tuples of gVCF reference loci. It replaces the reference package's Pallas
kernel `_tuples_kernel` (pisces_tpu/ops/pallas_scoring.py:245-258, reached
through `score_reference_tuples_pallas` :295-313) with the CUDA C++ kernel in
csrc/score_tuples.cu.

`score_reference_loci` scores reference loci from their raw [L, 6, 3]
counts and reference codes, for the mesh step (parallel/sharding.py) and
entry.py. It replaces `_scoring_kernel` (:220-242, reached through
`score_reference_loci_pallas` :316-336) with csrc/score_loci.cu. Support is
the count of the row the reference code names, for any code 0-5: the XLA
semantics of the path it serves, where the Pallas kernel gives zero support
at a reference N.

Both kernels share the scoring math (csrc/score_locus.cuh), are built for
sm_90a with nvcc at first use and bound with ctypes; their sources say what
bounds them and what their design does about that.

`score_reference_tuples_plain` is a line-by-line torch transliteration of
the Pallas kernels' `_score_rows` and its f32 helpers (:49-217), and
`score_reference_loci_plain` its counts prologue in torch in front of it.
Each wrapper takes its plain version only for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises. The CPU tests hold the plain
versions against the Pallas kernels in interpret mode, and chip_smoke.py
holds the kernels against the plain versions on the card.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, Optional

import torch

from pisces_tpu_torch.domain.types import (
    COVERAGE_CONTRIBUTING_ALLELES, NUM_ALLELE_TYPES, NUM_DIRECTION_TYPES,
    AlleleType, Genotype,
)
from pisces_tpu_torch.ops.scoring_params import (
    FILTER_BIT_LOW_DEPTH, FILTER_BIT_LOW_VARIANT_QSCORE, ScoringParams,
)

N_SERIES = 64        # Poisson-tail series terms (the kernels stop earlier
                     # at the exact exit, csrc/score_locus.cuh)
LN10 = 2.302585092994046
HALF_LN_2PI = 0.9189385332046727
_F32 = torch.float32

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, "csrc")
_HEADER = os.path.join(_CSRC, "score_locus.cuh")
# each kernel's source; each builds into a library of its own
SOURCES = {name: os.path.join(_CSRC, f"{name}.cu")
           for name in ("score_tuples", "score_loci")}
BUILD_DIR = os.path.join(_PKG_DIR, "build")
# -fmad=false: no FMA contraction, so each f32 step rounds like the plain
# version's; no fast math: logf/expf/divide keep their IEEE accuracy, which
# decides the integer Q at rounding boundaries
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC")

# kernel launches since the last reset, counted by the wrapper where it
# launches (chip_smoke.py reads them to show the main path used the kernel),
# under _count_lock: scheduler and window threads launch concurrently
launch_counts: Dict[str, int] = {name: 0 for name in SOURCES}
_count_lock = threading.Lock()
# the first build: two threads that start it at once would each run nvcc
_build_lock = threading.Lock()


def reset_launch_counts() -> None:
    with _count_lock:
        for k in launch_counts:
            launch_counts[k] = 0


# ---------------------------------------------------------------------------
# Plain version: the Pallas kernel's f32 math in torch, step for step
# ---------------------------------------------------------------------------

def _lgamma1p(k):
    """lgamma(k+1) for k >= 0 via 8-step shift + Stirling (f32, ~1e-6)."""
    z = k + 1.0
    shift = torch.zeros_like(z)
    for _ in range(8):
        small = z < 8.0
        shift = torch.where(small, shift - torch.log(z), shift)
        z = torch.where(small, z + 1.0, z)
    zi = 1.0 / z
    zi2 = zi * zi
    stir = ((z - 0.5) * torch.log(z) - z + HALF_LN_2PI
            + zi * (1.0 / 12.0 - zi2 * (1.0 / 360.0 - zi2 / 1260.0)))
    return stir + shift


def _log_pmf(k, lam):
    """ln Poisson pmf(k; lam), safe at k=0 / lam=0."""
    return k * torch.log(torch.clamp(lam, min=1e-30)) - lam - _lgamma1p(k)


def _upper_series(k, lam):
    """S = sum_{j>=0} prod_{i=1..j} lam/(k+i)  (>=1; tail = pmf(k)*S)."""
    term = torch.ones_like(k)
    acc = torch.ones_like(k)
    for j in range(1, N_SERIES + 1):
        term = term * lam / (k + float(j))
        acc = acc + term
    return acc


def _lower_series(m, lam):
    """S = sum_{j>=0} prod_{i=0..j-1} (m-i)/lam  (P(X<=m) = pmf(m)*S)."""
    safe_lam = torch.clamp(lam, min=1e-30)
    term = torch.ones_like(m)
    acc = torch.ones_like(m)
    for j in range(1, N_SERIES + 1):
        term = term * torch.clamp(m - float(j - 1), min=0.0) / safe_lam
        acc = acc + term
    return acc


def _poisson_tail(k, lam):
    """(tail, log10_tail) where tail = P(X >= k): the upper series when
    k > lam, the lower-series complement otherwise; k <= 0 gives (1, 0)."""
    up_log = (_log_pmf(k, lam) + torch.log(_upper_series(k, lam))) / LN10
    m = torch.clamp(k - 1.0, min=0.0)
    low = torch.exp(_log_pmf(m, lam)) * _lower_series(m, lam)
    low_tail = torch.clamp(1.0 - low, min=1e-38)
    use_upper = k > lam
    log10_tail = torch.where(use_upper, up_log, torch.log10(low_tail))
    tail = torch.where(use_upper, torch.exp(up_log * LN10), low_tail)
    tail = torch.where(k <= 0.0, torch.ones_like(tail), tail)
    log10_tail = torch.where(k <= 0.0, torch.zeros_like(log10_tail),
                             log10_tail)
    return tail, log10_tail


def _lower_cdf(m, lam):
    """P(X <= trunc(m)) in linear space (used by the GQ Poisson gate)."""
    mt = torch.trunc(torch.clamp(m, min=0.0))
    low = torch.exp(_log_pmf(mt, lam)) * _lower_series(mt, lam)
    upper = (torch.exp(_log_pmf(mt + 1.0, lam))
             * _upper_series(mt + 1.0, lam))
    return torch.where(mt + 1.0 > lam, torch.clamp(1.0 - upper, min=0.0),
                       torch.clamp(low, max=1.0))


def _sb_stats(support, coverage, noise_freq, log1m_noise):
    """Extended-model PopulateStats: (chance_false_pos, chance_var_gt_zero)."""
    zero = support <= 0.0
    z_cvfgz = torch.exp(coverage * log1m_noise)        # (1-noise)^cov
    tail, _lt = _poisson_tail(support, coverage * noise_freq)
    nz_cvfgz = torch.clamp(1.0 - tail, min=0.0)         # P(X <= s-1)
    cvfgz = torch.where(zero, z_cvfgz, nz_cvfgz)
    cfp = torch.where(zero, 1.0 - z_cvfgz, torch.clamp(tail, min=0.0))
    return cfp, cvfgz


def noise_constants(params: ScoringParams):
    """(noise_freq, log1m_noise): computed in f64 on the host, then cast to
    f32 by the callers, as the Pallas kernel does."""
    import math
    nf = 10.0 ** (-params.noise_level / 10.0)
    return nf, math.log1p(-nf)


def score_reference_tuples_plain(tuples: torch.Tensor, params: ScoringParams,
                                 num_no_calls: Optional[torch.Tensor] = None):
    """Plain torch version of the tuple kernel (same contract as
    score_reference_tuples). Runs on the tensor's device."""
    _check_inputs(tuples, num_no_calls)
    dev = tuples.device
    nf, l1m = noise_constants(params)
    noise_freq = torch.tensor(nf, dtype=_F32, device=dev)
    log1m_noise = torch.tensor(l1m, dtype=_F32, device=dev)

    def f32(x):
        return torch.tensor(float(x), dtype=_F32, device=dev)

    rows = tuples.to(_F32)
    sup_dir = [rows[:, 0], rows[:, 1], rows[:, 2]]
    cov_dir = [rows[:, 3], rows[:, 4], rows[:, 5]]
    total = cov_dir[0] + cov_dir[1] + cov_dir[2]
    support = sup_dir[0] + sup_dir[1] + sup_dir[2]

    # ---- Poisson q-score: p = P(X >= support), lam = err * cov ----
    lam = noise_freq * total
    _tail, log10_p = _poisson_tail(support, lam)
    q = torch.clamp(-10.0 * log10_p, 0.0, float(params.max_variant_qscore))
    qi = torch.round(q).to(torch.int32)         # half to even, as jnp.round
    qi = torch.where((support <= 0.0) | (total <= 0.0),
                     torch.zeros_like(qi), qi)

    freq = torch.where(total <= 0.0, torch.zeros_like(total),
                       torch.clamp(support / torch.clamp(total, min=1.0),
                                   max=1.0))

    # ---- strand bias (Extended model) ----
    ss = tuples[:, 2]
    sc = tuples[:, 5]
    half_s = torch.div(ss, 2, rounding_mode="floor").to(_F32)
    half_c = torch.div(sc, 2, rounding_mode="floor").to(_F32)
    ov_cfp, ov_cvfgz = _sb_stats(support, total, noise_freq, log1m_noise)
    fw_cfp, fw_cvfgz = _sb_stats(sup_dir[0] + half_s, cov_dir[0] + half_c,
                                 noise_freq, log1m_noise)
    rv_cfp, rv_cvfgz = _sb_stats(sup_dir[1] + half_s, cov_dir[1] + half_c,
                                 noise_freq, log1m_noise)
    one = torch.ones_like(ov_cvfgz)
    denom = torch.where(ov_cvfgz == 0.0, one, ov_cvfgz)
    fwd = torch.where(ov_cvfgz == 0.0, one, fw_cvfgz * rv_cfp / denom)
    rev = torch.where(ov_cvfgz == 0.0, one, rv_cvfgz * fw_cfp / denom)
    score = torch.maximum(fwd, rev)
    cov_both = (cov_dir[0] + half_c > 0.0) & (cov_dir[1] + half_c > 0.0)
    score = torch.where(cov_both, score, torch.zeros_like(score))
    gatk = torch.where(score > 0.0,
                       10.0 * torch.log10(torch.clamp(score, min=1e-38)),
                       torch.full_like(score, -1e38))
    gatk = torch.where(support > 0.0, gatk, torch.zeros_like(gatk))

    # ---- somatic genotype (reference loci: is_reference=True) ----
    f_min = f32(params.min_frequency_filter)

    def code(g):
        return torch.full_like(qi, int(g))

    gt = code(Genotype.HOMOZYGOUS_REF)
    gt = torch.where(freq < f_min, code(Genotype.REF_LIKE_NOCALL), gt)
    gt = torch.where((freq >= f_min) & ((1.0 - freq) > f_min),
                     code(Genotype.REF_AND_NOCALL), gt)
    gt = torch.where(total < f32(params.min_depth),
                     code(Genotype.REF_LIKE_NOCALL), gt)

    # ---- GQ (SomaticGenotypeQualityCalculator, hom branch) ----
    non_allele = (1.0 - freq) * total
    expected = f32(params.target_lod) * total
    p1 = torch.pow(f32(10.0), -qi.to(_F32) / 10.0)
    p2 = _lower_cdf(non_allele, expected)
    hom_q = -10.0 * torch.log10(torch.clamp(p1 + p2, min=1e-38))
    hom_q = torch.where(non_allele >= expected,
                        torch.full_like(hom_q, float(params.min_gq)), hom_q)
    is_hom = gt == int(Genotype.HOMOZYGOUS_REF)
    raw = torch.where(is_hom, hom_q, qi.to(_F32))
    gq = torch.round(torch.clamp(raw, float(params.min_gq),
                                 float(params.max_gq))).to(torch.int32)
    gq = torch.where((total <= 0.0) | (gt == int(Genotype.REF_LIKE_NOCALL)),
                     torch.full_like(gq, int(params.min_gq)), gq)

    zero_i = torch.zeros_like(qi)
    fb = torch.where(total < f32(params.low_depth_filter),
                     torch.full_like(qi, 1 << FILTER_BIT_LOW_DEPTH), zero_i)
    fb = fb | torch.where((qi < params.variant_qscore_filter)
                          & (total != 0.0),
                          torch.full_like(qi, 1 << FILTER_BIT_LOW_VARIANT_QSCORE),
                          zero_i)

    nc = (num_no_calls if num_no_calls is not None else zero_i)
    return _out_dict(tuples[:, 0:3], tuples[:, 3:6], total.to(torch.int32),
                     support.to(torch.int32), qi, gt, gq, fb, nc, freq, gatk)


_COV_ALLELES = tuple(int(a) for a in COVERAGE_CONTRIBUTING_ALLELES)


def score_reference_loci_plain(counts: torch.Tensor, ref_code: torch.Tensor,
                               params: ScoringParams):
    """Plain torch version of the counts kernel (same contract as
    score_reference_loci): the Pallas prologue in f32, with support taken
    from the row the reference code names, then the tuple math. Runs on the
    tensors' device."""
    _check_loci_inputs(counts, ref_code)
    c = counts.to(_F32)
    cov = c[:, _COV_ALLELES[0], :]
    for a in _COV_ALLELES[1:]:
        cov = cov + c[:, a, :]
    ok = (ref_code >= 0) & (ref_code < NUM_ALLELE_TYPES)
    rows = torch.arange(counts.shape[0], device=counts.device)
    sup = c[rows, torch.where(ok, ref_code, 0).to(torch.int64), :]
    sup = torch.where(ok[:, None], sup, torch.zeros_like(sup))
    tuples = torch.cat([sup, cov], 1).to(torch.int32)
    nc = counts[:, int(AlleleType.N), :].sum(dim=1, dtype=torch.int32)
    return score_reference_tuples_plain(tuples, params, num_no_calls=nc)


def _out_dict(sup_by_dir, cov_by_dir, total, support, q, gt, gq, fb, nc,
              freq, gatk):
    """The Pallas wrapper's output contract (_out_dict, :261-274)."""
    return {
        "total_coverage": total,
        "support": support,
        "variant_qscore": q,
        "genotype": gt,
        "gq": gq,
        "filter_bits": fb,
        "num_no_calls": nc,
        "frequency": freq,
        "sb_gatk": gatk,
        "coverage_by_dir": cov_by_dir,
        "support_by_dir": sup_by_dir,
    }


# ---------------------------------------------------------------------------
# The CUDA kernels: build, bind, launch
# ---------------------------------------------------------------------------

class _ScoreParams(ctypes.Structure):
    """Mirror of `struct ScoreParams` in csrc/score_locus.cuh."""

    _fields_ = [(name, ctypes.c_float) for name in (
        "noise_freq", "log1m_noise", "max_variant_qscore",
        "min_frequency_filter", "min_depth", "target_lod", "min_gq",
        "max_gq", "low_depth_filter")] + [(name, ctypes.c_int32) for name in (
            "variant_qscore_filter", "min_gq_int", "gt_hom_ref",
            "gt_ref_like_nocall", "gt_ref_and_nocall", "bit_low_depth",
            "bit_low_variant_qscore")]


@functools.lru_cache(maxsize=None)
def _c_params(params: ScoringParams) -> _ScoreParams:
    """The C params of `params`, made once per ScoringParams."""
    nf, l1m = noise_constants(params)
    return _ScoreParams(
        nf, l1m, float(params.max_variant_qscore),
        float(params.min_frequency_filter), float(params.min_depth),
        float(params.target_lod), float(params.min_gq), float(params.max_gq),
        float(params.low_depth_filter), int(params.variant_qscore_filter),
        int(params.min_gq), int(Genotype.HOMOZYGOUS_REF),
        int(Genotype.REF_LIKE_NOCALL), int(Genotype.REF_AND_NOCALL),
        FILTER_BIT_LOW_DEPTH, FILTER_BIT_LOW_VARIANT_QSCORE)


_P = ctypes.c_void_p
# each launcher's C arguments: its two input pointers, n, its output
# pointers, params, the device ordinal and the stream
_ARGTYPES = {
    "score_tuples": [_P, _P, ctypes.c_int64, _P, _P,
                     ctypes.POINTER(_ScoreParams), ctypes.c_int, _P],
    "score_loci": [_P, _P, ctypes.c_int64, _P, _P, _P,
                   ctypes.POINTER(_ScoreParams), ctypes.c_int, _P],
}


# rows of each kernel's one int32 output buffer [rows, n]: seven int32 rows,
# then two f32 rows, then (counts kernel) the six by-direction rows
OUT_ROWS = {"score_tuples": 9, "score_loci": 15}


class KernelLibrary:
    """The built kernel libraries and what their build reported."""

    def __init__(self, paths: Dict[str, str], build_seconds: float,
                 build_log: str):
        self.paths = paths
        self.build_seconds = build_seconds
        self.build_log = build_log
        self.launchers = {}
        for name, path in paths.items():
            fn = getattr(ctypes.CDLL(path), f"{name}_launch")
            fn.restype = ctypes.c_int
            fn.argtypes = _ARGTYPES[name]
            self.launchers[name] = fn

    def bind(self, name: str, inputs, out: torch.Tensor,
             params: ScoringParams):
        """A call with no arguments that launches kernel `name` on the
        CUDA tensors `inputs` (None for an absent optional one) into `out`
        (int32 [OUT_ROWS[name], n] on their device), on the device's current
        stream, and raises on a refused launch. The pointers, the C params
        and the stream are taken once, here; it counts no launch."""
        fn = self.launchers[name]
        n = out.shape[1]
        p = out.data_ptr()
        outs = (p, p + 7 * n * 4) + ((p + 9 * n * 4,)
                                      if name == "score_loci" else ())
        args = (*(t.data_ptr() if t is not None else None for t in inputs),
                n, *outs, ctypes.byref(_c_params(params)), out.device.index,
                torch.cuda.current_stream(out.device).cuda_stream)

        def launch() -> None:
            err = fn(*args)
            if err != 0:
                raise RuntimeError(f"{name} kernel launch failed: CUDA "
                                   f"error {err}")
        return launch


_library: Optional[KernelLibrary] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def build_kernels() -> KernelLibrary:
    """Build (once per source and flag set) and load the kernel libraries.

    Each .so goes into pisces_tpu_torch/build/, named by a hash of its
    source, the shared header and the flags, so an edited source never
    loads a stale build. Missing libraries build in parallel, one nvcc per
    source; a failed build raises. Threads build once, under a lock."""
    with _build_lock:
        return _build_kernels()


def _build_kernels() -> KernelLibrary:
    global _library
    if _library is not None:
        return _library
    with open(_HEADER, "rb") as f:
        header = f.read()
    paths = {}
    for name, src in SOURCES.items():
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read() + header
                                    + " ".join(NVCC_FLAGS).encode())
        paths[name] = os.path.join(
            BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")
    t0 = time.perf_counter()
    todo = [name for name, out in paths.items() if not os.path.exists(out)]
    logs = []
    if todo:
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = _nvcc()
        builds = {}
        try:
            for name in todo:
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                builds[name] = (tmp, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", tmp, SOURCES[name]],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            failed = []
            for name, (tmp, proc) in builds.items():
                out, _ = proc.communicate()
                logs.append(f"{name}:\n{out}")
                if proc.returncode != 0:
                    failed.append(name)
                else:
                    os.replace(tmp, paths[name])
            if failed:
                raise RuntimeError("nvcc failed building "
                                   + ", ".join(SOURCES[n] for n in failed)
                                   + ":\n" + "\n".join(logs))
        finally:
            for tmp, proc in builds.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                if os.path.exists(tmp):
                    os.remove(tmp)
    _library = KernelLibrary(paths, time.perf_counter() - t0, "".join(logs))
    return _library


def _check_inputs(tuples: torch.Tensor,
                  num_no_calls: Optional[torch.Tensor]) -> None:
    if tuples.dtype != torch.int32 or tuples.dim() != 2 \
            or tuples.shape[1] != 6:
        raise ValueError(f"tuples must be int32 [U, 6], got "
                         f"{tuples.dtype} {tuple(tuples.shape)}")
    if not tuples.is_contiguous():
        raise ValueError("tuples must be contiguous")
    if num_no_calls is not None:
        if (num_no_calls.dtype != torch.int32
                or tuple(num_no_calls.shape) != (tuples.shape[0],)
                or num_no_calls.device != tuples.device
                or not num_no_calls.is_contiguous()):
            raise ValueError("num_no_calls must be a contiguous int32 [U] "
                             "tensor on the tuples' device")


def _check_loci_inputs(counts: torch.Tensor, ref_code: torch.Tensor) -> None:
    shape = (NUM_ALLELE_TYPES, NUM_DIRECTION_TYPES)
    if (counts.dtype != torch.int32 or counts.dim() != 3
            or tuple(counts.shape[1:]) != shape):
        raise ValueError(f"counts must be int32 [L, 6, 3], got "
                         f"{counts.dtype} {tuple(counts.shape)}")
    if not counts.is_contiguous():
        raise ValueError("counts must be contiguous")
    if (ref_code.dtype != torch.int32
            or tuple(ref_code.shape) != (counts.shape[0],)
            or ref_code.device != counts.device
            or not ref_code.is_contiguous()):
        raise ValueError("ref_code must be a contiguous int32 [L] tensor on "
                         "the counts' device")


def _launch(name: str, inputs, n: int, params: ScoringParams) -> torch.Tensor:
    """Launch kernel `name` over n loci on its inputs' device and current
    stream into one new int32 [OUT_ROWS[name], n] output buffer, and count
    the launch; raises on a refused launch."""
    out = torch.empty((OUT_ROWS[name], n), dtype=torch.int32,
                      device=inputs[0].device)
    if n > 0:
        build_kernels().bind(name, inputs, out, params)()
        with _count_lock:
            launch_counts[name] += 1
    return out


def _on_cuda(t: torch.Tensor) -> bool:
    """False for a CPU tensor (the plain version runs); True for a CUDA
    tensor (the kernel runs); raises for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return True


def score_reference_tuples(tuples: torch.Tensor, params: ScoringParams,
                           num_no_calls: Optional[torch.Tensor] = None):
    """Score gVCF reference loci from their direction tuples.

    Args:
      tuples: int32 [U, 6] (support F, R, S, coverage F, R, S), contiguous
      params: ScoringParams
      num_no_calls: optional int32 [U] N-call counts (passed through)
    Returns the dict contract of the Pallas wrapper: [U] total_coverage,
    support, variant_qscore, genotype, gq, filter_bits, num_no_calls
    (int32), frequency, sb_gatk (f32), and the [U, 3] by-direction inputs.

    On a CPU tensor this is the plain version; on a CUDA tensor it launches
    the sm_90a kernel on the tensor's device and current stream.
    """
    _check_inputs(tuples, num_no_calls)
    if not _on_cuda(tuples):
        return score_reference_tuples_plain(tuples, params, num_no_calls)
    out = _launch("score_tuples", (tuples, num_no_calls), tuples.shape[0],
                  params)
    return _out_dict(tuples[:, 0:3], tuples[:, 3:6], *out[:7],
                     *out[7:].view(_F32))


def score_reference_loci(counts: torch.Tensor, ref_code: torch.Tensor,
                         params: ScoringParams):
    """Score gVCF reference loci from their counts.

    Args:
      counts: int32 [L, 6, 3] anchor-summed counts (allele, direction),
        contiguous
      ref_code: int32 [L] reference allele codes, on the counts' device
      params: ScoringParams
    Returns the dict contract of the Pallas wrapper
    (score_reference_loci_pallas): [L] total_coverage, support,
    variant_qscore, genotype, gq, filter_bits, num_no_calls (int32),
    frequency, sb_gatk (f32), and [L, 3] coverage_by_dir, support_by_dir.

    On a CPU tensor this is the plain version; on a CUDA tensor it launches
    the sm_90a kernel on the tensor's device and current stream.
    """
    _check_loci_inputs(counts, ref_code)
    if not _on_cuda(counts):
        return score_reference_loci_plain(counts, ref_code, params)
    n = counts.shape[0]
    out = _launch("score_loci", (counts, ref_code), n, params)
    by_dir = out[9:].view(2, n, 3)
    return _out_dict(by_dir[1], by_dir[0], *out[:7], *out[7:9].view(_F32))
