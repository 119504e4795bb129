"""Other versions of the scoring kernels timed against this package's, in
turns on one card.

    python -m pisces_tpu_torch.kernel_ab [LABEL=CSRC_DIR ...]

Measurement only: nothing on the package's paths imports this module, and
each version it times is built from a copy of the sources, never from an
option of the committed ones. Each LABEL=CSRC_DIR is another version's
kernel sources (score_tuples.cu, score_loci.cu and score_locus.cuh with
this package's C interface), such as a parent commit's, unpacked with
`git archive <commit> pisces_tpu_torch/csrc | tar -x -C <dir>`. Besides
those it builds four copies of this package's csrc, each with functions
of score_locus.cuh replaced:

  split    split_roles() always true: the 32-locus role-split tile;
  thread   split_roles() always false: one thread per locus;
  loads    stage() with plain 16-byte loads through the registers;
  bulk     stage() with one cp.async.bulk (TMA bulk copy) per staged array
           onto an mbarrier.

On seeded synthetic inputs (reference loci like a 750x panel's, random
and deep ones, at sizes on both sides of the shape switch, and one
unaligned view), every version's integer outputs must equal this
package's kernels' (it says whether the floats are bit-equal too); then
each case is timed device-only (torch.profiler over 50 launches through
each C launcher) in turns: this package's, the others, the others in
reverse, this package's. Copies and libraries go under
pisces_tpu_torch/build/ab/.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Dict

import numpy as np
import torch

from pisces_tpu_torch.ops import scoring_kernels as K
from pisces_tpu_torch.ops.scoring_params import ScoringParams
from pisces_tpu_torch.utils.metrics import kernel_device_ms

AB_DIR = os.path.join(K.BUILD_DIR, "ab")
ITERS = 50
FILES = ("score_locus.cuh", "score_tuples.cu", "score_loci.cu")

SPLIT_ROLES = "inline bool split_roles("
STAGE = "__device__ inline void stage("
STAGE_WAIT = "__device__ inline void stage_wait("

_LOADS = r'''__device__ inline void stage(int32_t* dst, const int32_t* __restrict__ src,
                             int count) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int quads = count >> 2;
    const int4* s = reinterpret_cast<const int4*>(src);
    int4* d = reinterpret_cast<int4*>(dst);
    for (int i = threadIdx.x; i < quads; i += blockDim.x) d[i] = __ldg(s + i);
    done = quads << 2;
  }
  for (int i = done + threadIdx.x; i < count; i += blockDim.x)
    dst[i] = __ldg(src + i);
}
'''

_BULK = r'''__device__ inline uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ inline uint64_t* stage_bar() {
  __shared__ uint64_t bar;
  return &bar;
}
__device__ inline void stage_init() {
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 ::"r"(smem_u32(stage_bar())) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}
__device__ inline void stage(int32_t* dst, const int32_t* __restrict__ src,
                             int count) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int bytes = (count * 4) & ~15;
    done = bytes / 4;
    if (threadIdx.x == 0 && bytes > 0) {
      const uint32_t bar = smem_u32(stage_bar());
      asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n"
                   ::"r"(bar), "r"(bytes) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n"
          ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
    }
  }
  for (int i = done + threadIdx.x; i < count; i += blockDim.x)
    dst[i] = __ldg(src + i);
}
'''

_BULK_WAIT = r'''__device__ inline void stage_wait() {
  const uint32_t bar = smem_u32(stage_bar());
  if (threadIdx.x == 0)
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 ::"r"(bar) : "memory");
  uint32_t ok = 0;
  for (int spin = 0; !ok; ++spin) {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(ok) : "r"(bar), "r"(0) : "memory");
    if (spin > (1 << 22)) __trap();  // a lost copy fails, never hangs
  }
}
'''

# each variant: the functions of score_locus.cuh it replaces, and whether
# the kernels call stage_init() before they stage
VARIANTS = {
    "split": ({SPLIT_ROLES: "inline bool split_roles(int64_t, int) "
                            "{ return true; }\n"}, False),
    "thread": ({SPLIT_ROLES: "inline bool split_roles(int64_t, int) "
                             "{ return false; }\n"}, False),
    "loads": ({STAGE: _LOADS,
               STAGE_WAIT: "__device__ inline void stage_wait() {}\n"},
              False),
    "bulk": ({STAGE: _BULK, STAGE_WAIT: _BULK_WAIT}, True),
}


def replace_function(text: str, signature: str, body: str) -> str:
    """`text` with the function that starts at `signature` (through its
    closing brace at column 0) replaced by `body`."""
    i = text.index(signature)
    j = text.index("\n}\n", i) + 3
    return text[:i] + body + text[j:]


def variant_sources(name: str) -> Dict[str, str]:
    """{file name: text} of this package's csrc with VARIANTS[name]."""
    funcs, init = VARIANTS[name]
    out = {}
    for f in FILES:
        with open(os.path.join(K._CSRC, f)) as fh:
            out[f] = fh.read()
    for signature, body in funcs.items():
        out[FILES[0]] = replace_function(out[FILES[0]], signature, body)
    if init:
        for f in FILES[1:]:
            out[f] = out[f].replace("  stage(", "  stage_init();\n  stage(",
                                    1)
    return out


def build_versions(dirs: Dict[str, str]) -> Dict[str, K.KernelLibrary]:
    """Build the kernels of each {label: csrc dir} into AB_DIR/label/, one
    nvcc per source, all at once; a failed build raises."""
    procs = {}
    t0 = time.perf_counter()
    try:
        for label, src in dirs.items():
            os.makedirs(os.path.join(AB_DIR, label), exist_ok=True)
            for name in K.SOURCES:
                lib = os.path.join(AB_DIR, label, f"lib{name}.so")
                procs[label, name] = (lib, subprocess.Popen(
                    [K._nvcc(), *K.NVCC_FLAGS, "-o", lib,
                     os.path.join(src, f"{name}.cu")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
        logs = {}
        for (label, name), (_, proc) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {label} {name}:\n{out}")
            logs[label] = logs.get(label, "") + f"{name}:\n{out}"
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    seconds = time.perf_counter() - t0
    return {label: K.KernelLibrary(
        {name: procs[label, name][0] for name in K.SOURCES}, seconds,
        logs[label]) for label in dirs}


def _tuples(rng, n: int, kind: str) -> np.ndarray:
    """int32 [n, 6] (support, coverage)-by-direction tuples: `panel` like a
    750x panel's reference loci, `random` support anywhere within
    coverage, `deep` coverage up to 5,000 with support close to it."""
    if kind == "random":
        cov = rng.integers(0, 500, size=(n, 3))
        sup = (cov * rng.random((n, 3))).astype(np.int64)
    else:
        cov = rng.integers(150, 350, size=(n, 3)) if kind == "panel" \
            else rng.integers(0, 1_667, size=(n, 3))
        sup = np.maximum(cov - rng.integers(0, 4, size=(n, 3)), 0)
    return np.concatenate([sup, cov], 1).astype(np.int32)


def _loci(rng, tuples: np.ndarray):
    """(counts [n, 6, 3], ref codes [n]) whose derived tuples are `tuples`:
    the support on the reference row, the rest on another base."""
    n = len(tuples)
    ref = rng.integers(0, 4, n)
    other = (ref + 1 + rng.integers(0, 3, n)) % 4
    counts = np.zeros((n, 6, 3), np.int64)
    rows = np.arange(n)
    counts[rows, ref, :] = tuples[:, :3]
    counts[rows, other, :] = tuples[:, 3:] - tuples[:, :3]
    return counts.astype(np.int32), ref.astype(np.int32)


def cases(device):
    """(kernel, label, inputs) of every timed case."""
    rng = np.random.default_rng(0)
    out = []
    for n, kind in ((6_119, "panel"), (50_000, "random"),
                    (100_000, "random"), (150_000, "random"),
                    (200_000, "random")):
        t = torch.from_numpy(_tuples(rng, n, kind)).to(device)
        out.append(("score_tuples", f"{n:,} {kind} tuples", (t, None)))
    # a view one int32 in: staged one int32 a thread in every version
    flat = torch.zeros(4_099 * 6 + 1, dtype=torch.int32, device=device)
    flat[1:] = torch.from_numpy(_tuples(rng, 4_099, "random").reshape(-1))
    out.append(("score_tuples", "4,099 random tuples, unaligned",
                (flat[1:].view(4_099, 6), None)))
    for n, kind in ((25_088, "deep"), (50_176, "panel"), (50_176, "random"),
                    (100_096, "deep"), (200_192, "panel"),
                    (200_192, "random")):
        counts, ref = _loci(rng, _tuples(rng, n, kind))
        out.append(("score_loci", f"{n:,} {kind} loci",
                    (torch.from_numpy(counts).to(device),
                     torch.from_numpy(ref).to(device))))
    return out


def compare(libs: Dict[str, K.KernelLibrary], device) -> None:
    """Check and time every case on every version, and print each."""
    params = ScoringParams()
    for kernel, label, inputs in cases(device):
        n = inputs[0].shape[0]
        runs, outs = {}, {}
        for version, lib in libs.items():
            outs[version] = torch.empty((K.OUT_ROWS[kernel], n),
                                        dtype=torch.int32, device=device)
            runs[version] = lib.bind(kernel, inputs, outs[version], params)
            runs[version]()
        torch.cuda.synchronize()
        want = outs["this"]
        floats = []
        for version, got in outs.items():
            if not (torch.equal(got[:7], want[:7])
                    and torch.equal(got[9:], want[9:])):
                raise AssertionError(f"{version} {kernel} at {label}: "
                                     "integer outputs differ")
            if not torch.equal(got, want):
                floats.append(version)
        others = [v for v in libs if v != "this"]
        times = {v: [] for v in libs}
        for version in ["this", *others, *others[::-1], "this"]:
            ms, seen = kernel_device_ms(runs[version], f"{kernel}_kernel",
                                        ITERS)
            times[version].append("n/a" if ms is None else
                                  f"{ms:.5f}" + ("" if seen == ITERS
                                                 else f" ({seen} events)"))
        print(f"{kernel} at {label}: integers equal; floats "
              + (f"differ in {', '.join(floats)}" if floats
                 else "bit-equal") + "; device ms "
              + "; ".join(f"{v} " + " / ".join(ts)
                          for v, ts in times.items()), flush=True)


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: CUDA is not available")
    dirs = {"this": K._CSRC}
    for spec in argv if argv is not None else sys.argv[1:]:
        label, _, path = spec.partition("=")
        dirs[label] = os.path.abspath(path)
    for name in VARIANTS:
        d = os.path.join(AB_DIR, name, "csrc")
        os.makedirs(d, exist_ok=True)
        for f, text in variant_sources(name).items():
            with open(os.path.join(d, f), "w") as fh:
                fh.write(text)
        dirs[name] = d
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    print(f"kernel_ab on {smi[0] if smi else torch.cuda.get_device_name(0)}",
          flush=True)
    libs = build_versions(dirs)
    for label, lib in libs.items():
        regs = [ln.split("info    : ")[-1] for ln in lib.build_log.splitlines()
                if "registers" in ln]
        print(f"built {label}: " + "; ".join(regs), flush=True)
    compare(libs, torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
