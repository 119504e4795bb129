"""Job scheduling: (bam x chromosome) data parallelism with ordered output.

Maps the reference's parallelism mechanisms (SURVEY §2.5) onto host
executors:
  P1  thread-per-(bam,chr) jobs with a bounded pool (JobManager.cs:27-149,
      BaseGenomeProcessor.cs:40-135) -> ThreadPoolExecutor
  P2  per-bam ordered throttling (AutoResetEvent chains) -> completion
      buffer drained in genome order per bam
  P3  per-chr output sharding + concatenation (GenomeProcessor.cs:81-186)
      -> per-chr temp VCFs merged after the header
  P4/P5 multi-process per-chromosome -> a spawned multiprocessing pool

Chromosome references are loaded once and shared across bams (the chr
reference caching/refcounting of BaseGenomeProcessor.cs:137-183).

The jobs call the port's apps/pisces.call_chromosome and process_bam with
the run's `device` and `backend`: worker threads launch the scoring kernels
on the current stream of the device, and spawned children each open their
own CUDA context on it.
"""
from __future__ import annotations

import concurrent.futures as cf
import functools
import json
import os
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from pisces_tpu_torch.utils.logger import log
from pisces_tpu_torch.utils.metrics import metrics


class JobManager:
    """Bounded-thread job runner with the reference's error modes
    (None / Wait / Terminate)."""

    def __init__(self, max_threads: int, error_mode: str = "terminate"):
        self.max_threads = max(1, max_threads)
        self.error_mode = error_mode

    def process(self, jobs: List[Callable[[], None]]) -> None:
        """Run the jobs on the pool; each job's spans nest under the span
        open here."""
        if not jobs:
            return
        errors: List[BaseException] = []
        with cf.ThreadPoolExecutor(max_workers=self.max_threads) as pool:
            futures = [pool.submit(metrics.carry(j)) for j in jobs]
            for f in cf.as_completed(futures):
                exc = f.exception()
                if exc is not None:
                    errors.append(exc)
                    if self.error_mode == "terminate":
                        for other in futures:
                            other.cancel()
                        break
        if errors and self.error_mode in ("terminate", "wait"):
            raise errors[0]


class ChrReferenceCache:
    """Load each chromosome once; drop it when all bams are done with it."""

    def __init__(self, genome, n_consumers: int):
        self._genome = genome
        self._n_consumers = n_consumers
        self._lock = threading.Lock()
        self._cache: Dict[str, object] = {}
        self._remaining: Dict[str, int] = {}

    def get(self, name: str):
        with self._lock:
            if name not in self._cache:
                self._cache[name] = self._genome.get_chr_reference(name)
                self._remaining[name] = self._n_consumers
            return self._cache[name]

    def release(self, name: str) -> None:
        with self._lock:
            if name in self._remaining:
                self._remaining[name] -= 1
                if self._remaining[name] <= 0:
                    self._cache.pop(name, None)
                    self._remaining.pop(name, None)
                    # also drop it from the Genome-level LRU, or the
                    # release frees nothing
                    self._genome.evict_chr_reference(name)


@dataclass
class _ChrResult:
    chrom_name: str
    alleles: Optional[object] = None
    done: bool = False


class OrderedChromosomeWriter:
    """P2: workers complete chromosomes in any order; the writer emits them
    in genome order for one output vcf."""

    def __init__(self, chrom_names: List[str]):
        self._order = chrom_names
        self._results: Dict[str, _ChrResult] = {
            c: _ChrResult(c) for c in chrom_names}
        self._cond = threading.Condition()

    def submit(self, chrom_name: str, alleles) -> None:
        with self._cond:
            r = self._results[chrom_name]
            r.alleles = alleles
            r.done = True
            self._cond.notify_all()

    def drain(self, write_fn: Callable[[str, object], None]) -> None:
        """Blocks until every chromosome is emitted, in order."""
        for name in self._order:
            with self._cond:
                while not self._results[name].done:
                    self._cond.wait()
                alleles = self._results[name].alleles
            write_fn(name, alleles)
            # free memory as we go
            self._results[name].alleles = None


def process_bams_parallel(options, bam_paths: List[str], genome,
                          max_threads: int = 8, device="cuda",
                          backend: str = "torch",
                          thread_by_chr: bool = False) -> List[str]:
    """GenomeProcessor.Execute equivalent: all (bam, chr) jobs through one
    bounded pool of threads, each a whole chromosome through
    call_chromosome, with per-bam in-order VCF emission. The devices and
    the mesh are set up once for the run (apps/pisces.scoring_setup)."""
    from pisces_tpu_torch.apps import pisces as app
    from pisces_tpu_torch.calling.intervals import make_region_mapper
    from pisces_tpu_torch.io.vcf_write import VcfWriter, VcfWriterConfig

    score_device, mesh = app.scoring_setup(options, device, backend)
    chrom_names = genome.chromosome_names
    cache = ChrReferenceCache(genome, len(bam_paths))
    # as in the reference's scheduler, the jobs take the forced alleles
    # but not -PriorsPath, and no bias tables are written
    forced = (app.load_forced_alleles(options.forced_alleles_paths)
              if options.forced_alleles_paths else None)

    outputs = []
    writers: Dict[str, Tuple[VcfWriter, OrderedChromosomeWriter]] = {}
    for bam_path in bam_paths:
        out_vcf = app.default_vcf_path(options, bam_path)
        outputs.append(out_vcf)
        # sample column = bam file name incl. extension (reference
        # VcfFileWriter; cf. shipped expected outputs "PhiX_S3.bam")
        writer = VcfWriter(out_vcf,
                           VcfWriterConfig(options, has_forced_gt=bool(forced)),
                           genome.directory,
                           os.path.basename(bam_path),
                           genome.chromosome_lengths, options.command_line)
        writer.write_header()
        writers[bam_path] = (writer, OrderedChromosomeWriter(chrom_names))

    # The native handle's decoded-batch state is consumed by the downstream
    # pileup call, so a handle cannot be shared across concurrently-running
    # jobs. A per-bam pool bounds the number of full-file inflations to the
    # number of concurrent jobs instead of one per (bam, chr).
    pools: Dict[str, List] = {p: [] for p in bam_paths}
    pool_lock = threading.Lock()

    def _borrow(bam_path: str):
        with pool_lock:
            if pools[bam_path]:
                return pools[bam_path].pop()
        return app.open_bam(bam_path)

    def _give_back(bam_path: str, reader) -> None:
        with pool_lock:
            pools[bam_path].append(reader)

    def _emit(writer: "VcfWriter", chrom_name: str, payload) -> None:
        """Write one chromosome's results through a (possibly headerless)
        writer: spliced fast-gVCF streams or object-path alleles + mapper."""
        if not payload:
            return
        alleles, intervals = payload
        if isinstance(alleles, tuple):
            app.write_spliced(writer, alleles[0], alleles[1])
            return
        chrom = genome.get_chr_reference(chrom_name)
        mapper = make_region_mapper(options, chrom, intervals)
        with metrics.stage("vcf_write"):
            writer.write(alleles, mapper)
            writer.write_remaining(mapper)

    def _compute(chrom_name: str, bam):
        """The per-(bam, chr) calling work; returns the emit payload. Its
        result owns its arrays (apps/pisces._trim_window_result says why),
        so emission may wait while the handle serves the next job."""
        if chrom_name not in bam.header.ref_names:
            return []
        chrom = cache.get(chrom_name)
        try:
            intervals = app._load_intervals(options, chrom_name)
            alleles = app.call_chromosome(options, chrom, bam, intervals,
                                          score_device, mesh, forced)
            return (alleles, intervals)
        finally:
            cache.release(chrom_name)

    if thread_by_chr:
        # GenomeProcessor.cs:81-186 "one writer per bam and per chr": each
        # job writes a headerless per-chromosome shard the moment it
        # finishes (no ordering wait, no in-memory holding of out-of-order
        # results); after the pool drains, shards are byte-concatenated
        # onto the header file in genome order (CombinePerChromosomeFiles).
        shard_paths: Dict[Tuple[str, str], str] = {}
        shard_lock = threading.Lock()

        def job(bam_path: str, chrom_name: str) -> None:
            with metrics.stage("scheduler.job", cpu=True):
                bam = _borrow(bam_path)
                try:
                    payload = _compute(chrom_name, bam)
                    if not payload:
                        return
                    writer, _ = writers[bam_path]
                    shard = (f"{outputs[bam_paths.index(bam_path)]}_"
                             f"{chrom_name}")
                    shard_writer = VcfWriter(
                        shard, writer.config, genome.directory,
                        os.path.basename(bam_path),
                        genome.chromosome_lengths, options.command_line)
                    try:
                        _emit(shard_writer, chrom_name, payload)
                    finally:
                        shard_writer.close()
                    with shard_lock:
                        shard_paths[(bam_path, chrom_name)] = shard
                finally:
                    _give_back(bam_path, bam)

        JobManager(max_threads).process(
            [functools.partial(job, b, c) for c in chrom_names
             for b in bam_paths])
        for bam_path, out_vcf in zip(bam_paths, outputs):
            writer, _ = writers[bam_path]
            writer.close()  # header-only so far
            with open(out_vcf, "ab") as out_f:
                for chrom_name in chrom_names:
                    shard = shard_paths.get((bam_path, chrom_name))
                    if shard is None:
                        continue
                    with open(shard, "rb") as s:
                        out_f.write(s.read())
                    os.remove(shard)
        return outputs

    def job(bam_path: str, chrom_name: str) -> None:
        _, ordered = writers[bam_path]
        with metrics.stage("scheduler.job", cpu=True):
            bam = _borrow(bam_path)
            try:
                try:
                    payload = _compute(chrom_name, bam)
                except Exception:
                    ordered.submit(chrom_name, [])
                    raise
                ordered.submit(chrom_name, payload)
            finally:
                _give_back(bam_path, bam)

    drainers = []
    for bam_path in bam_paths:
        writer, ordered = writers[bam_path]

        def drain(writer=writer, ordered=ordered):
            ordered.drain(lambda chrom_name, payload:
                          _emit(writer, chrom_name, payload))
            writer.close()
        t = threading.Thread(target=metrics.carry(drain), daemon=True)
        t.start()
        drainers.append(t)

    JobManager(max_threads).process(
        [functools.partial(job, b, c) for c in chrom_names
         for b in bam_paths])
    for t in drainers:
        t.join()
    return outputs


def process_chromosomes_multiprocess(options, bam_path: str, genome_dir: str,
                                     n_processes: int = 4, device="cuda",
                                     backend: str = "torch",
                                     resume: bool = False) -> str:
    """P4/P5: one spawned worker process per chromosome, each running
    process_bam on it alone (-WindowSize included) with the run's device
    and backend; per-chr vcf shards merged by byte concatenation after the
    header (MultiProcess + ThreadByChr). A child that fails raises here: no
    child falls back to the host or the CPU.

    The parent builds the host library (and, on CUDA, the kernels) before
    it spawns, so that the children load them instead of each compiling.
    Shards are written atomically (tmp + rename), so a shard file on disk
    is a completed unit of work. With resume=True a killed run restarts at
    shard granularity: completed chromosomes are not re-called (the
    checkpoint/resume design SURVEY.md flags as the upgrade of the
    reference's crash-retains-completed-chr-files behavior,
    GenomeProcessor.cs:156-186)."""
    import multiprocessing as mp

    from pisces_tpu_torch.apps.pisces import default_vcf_path, scoring_setup
    from pisces_tpu_torch.io.fasta import Genome
    from pisces_tpu_torch.io.native import build_native

    scoring_setup(options, device, backend)
    device = str(device)   # pickles into the children
    build_native()
    if device.startswith("cuda"):
        from pisces_tpu_torch.ops.scoring_kernels import build_kernels
        build_kernels()

    genome = Genome(genome_dir)
    final_vcf = default_vcf_path(options, bam_path)
    out_dir = os.path.dirname(final_vcf)
    stem = os.path.basename(bam_path)
    stem = stem[:-4] if stem.endswith(".bam") else stem
    manifest_path = os.path.join(out_dir, f"{stem}.progress.json")

    chrom_names = genome.chromosome_names
    shard_of = {c: os.path.join(out_dir, f"{stem}.vcf_{c}")
                for c in chrom_names}
    done = {c for c in chrom_names
            if resume and os.path.exists(shard_of[c])}
    if done:
        log(f"resume: skipping {len(done)} completed shard(s): "
            + ",".join(sorted(done)))
    todo = [c for c in chrom_names if c not in done]
    args = [(options, bam_path, genome_dir, c, device, backend, shard_of[c])
            for c in todo]

    def write_manifest():
        with open(manifest_path + ".tmp", "w") as f:
            json.dump({"bam": bam_path, "completed": sorted(done),
                       "total": len(chrom_names)}, f, indent=1)
        os.replace(manifest_path + ".tmp", manifest_path)

    write_manifest()
    if args:
        # spawn, never fork: the parent holds threads and a CUDA context
        ctx = mp.get_context("spawn")
        with ctx.Pool(min(n_processes, len(args))) as pool:
            for chrom, _path in pool.imap_unordered(_run_chromosome_shard,
                                                    args):
                done.add(chrom)
                write_manifest()

    # merge: full header from shard 0, then data lines of each shard in order
    with open(final_vcf, "w", newline="\n") as out:
        wrote_header = False
        for c in chrom_names:
            sp = shard_of[c]
            if not os.path.exists(sp):
                continue
            with open(sp) as f:
                for line in f:
                    if not line.startswith("#") or not wrote_header:
                        out.write(line)
            wrote_header = True
            os.unlink(sp)
    if os.path.exists(manifest_path):
        os.unlink(manifest_path)
    return final_vcf


def _run_chromosome_shard(args):
    """A spawned child's work: one chromosome through process_bam into its
    shard (temporary file, then rename)."""
    options, bam_path, genome_dir, chrom_name, device, backend, out_path = args
    from pisces_tpu_torch.apps.pisces import process_bam
    from pisces_tpu_torch.io.fasta import Genome
    options.chromosome_filter = chrom_name
    tmp_path = out_path + ".tmp"
    process_bam(options, bam_path, Genome(genome_dir), out_vcf=tmp_path,
                device=device, backend=backend)
    os.replace(tmp_path, out_path)
    return chrom_name, out_path
