"""Pisces-equivalent somatic small-variant caller application (the port).

Orchestration port of exe/Pisces (Program.cs:11-53, Logic/Factory.cs:30-399,
Logic/SmallVariantCaller.cs:79-116, Logic/Processing/GenomeProcessor.cs:13-193):
per (BAM x chromosome) work, candidate finding + pileup counts + per-locus
scoring, VCF/gVCF output.

The port runs chromosomes through the native read flow (the C++ BAM decode
and pileup pass of io/native, as the reference package's default run), with
somatic, diploid (-ploidy diploid) and adaptive (-ploidy adaptive)
genotyping, haploid on the sex chromosomes with -gender, the
default filters, optional -IntervalPaths, forced alleles
(-ForcedAlleles), known priors (-PriorsPath, -TrimMnvPriors), the
bias tables (-OutputBiasFiles), MNV calling (-CallMNVs), stitched (XD) and
read-collapsed (XV/XW, -ReportRcCounts) input, amplicon bias (-abfilter,
XN tags), -CoverageMethod exact, -WindowSize streaming over the
.bai, the schedulers of parallel/scheduler.py (-MaxThreads, several BAMs,
-ThreadByChr, -MultiProcess with -Resume), -MultiHost (one process of a
multi-host job, parallel/multihost.py) and -MeshDevices N (the gVCF
reference scoring and large candidate batches sharded over N devices of
-device's type, parallel/sharding.py, from Python read events).

    python -m pisces_tpu_torch.apps.pisces -bam B -g G -o O -gVCF true \\
        [-device cuda|cpu] [-backend torch|numpy] [-ploidy P [-gender G]] \\
        [-MeshDevices N] [-WindowSize W] [-MaxThreads T [-ThreadByChr true]] \\
        [-MultiProcess true [-Resume true]] [-MultiHost true]
"""
from __future__ import annotations

import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from pisces_tpu_torch.device import resolve_device
from pisces_tpu_torch.domain.types import (
    BASE_TO_ALLELE, AlleleCategory, CoverageMethod, PloidyModel,
)
from pisces_tpu_torch.io.bam import filter_batch
from pisces_tpu_torch.io.fasta import ChrReference, Genome
from pisces_tpu_torch.io.native import (
    NativeBamReader, has_collapsed_tags, native_pileup, open_bam,
)
from pisces_tpu_torch.io.vcf_write import VcfWriter, VcfWriterConfig
from pisces_tpu_torch.calling.caller import (
    AlleleCaller, CallerConfig, make_reference_candidates,
)
from pisces_tpu_torch.calling.collapser import VariantCollapser
from pisces_tpu_torch.calling.source import AlleleSource
from pisces_tpu_torch.genotype import get_ploidy_for_chr
from pisces_tpu_torch.options import PiscesApplicationOptions
from pisces_tpu_torch.pileup.candidates import (
    Candidate, find_candidates_batch,
)
from pisces_tpu_torch.pileup.candidates_fast import (
    aggregate_native_mismatches, find_indel_candidates,
)
from pisces_tpu_torch.pileup.counts import (
    build_counts_device, build_counts_host, candidate_anchor_positions,
)
from pisces_tpu_torch.pileup.events import build_base_events
from pisces_tpu_torch.utils.logger import log
from pisces_tpu_torch.utils.metrics import metrics


def _fast_gvcf_eligible(options: PiscesApplicationOptions,
                        forced_alleles=None) -> bool:
    """Whether the columnar fast-gVCF reference path applies.

    The tuple kernel implements SOMATIC ref-line GT/GQ; diploid
    thresholding routes through a vectorized f64 host twin
    (fast_gvcf._score_host_tuples_diploid); haploid and adaptive ploidy go
    through the object path. MNV mode and collapsed-count reporting need
    per-candidate objects; crushed loci with forced alleles need the
    colocated writer to merge ref+forced lines; a LowGQ filter threshold
    needs the per-allele filter pass."""
    v = options.variant_calling_parameters
    w = options.vcf_writing_parameters
    return (w.output_gvcf_file
            and options.use_fast_gvcf
            and not options.call_mnvs
            and not w.report_rc_counts
            and v.ploidy_model in (PloidyModel.SOMATIC,
                                   PloidyModel.DIPLOID_BY_THRESHOLDING)
            and v.low_genotype_quality_filter is None
            and (w.allow_multiple_vcf_lines_per_loci or not forced_alleles))


def call_chromosome(options: PiscesApplicationOptions, chrom: ChrReference,
                    bam, intervals=None, device="cuda", mesh=None,
                    forced_alleles=None, priors=None):
    """Run the full calling pipeline for one chromosome.

    `bam` is a reader from io/native.open_bam, or a window's _RegionView
    over a lazy one. The native reader takes the native flow: C++ decode,
    then one C++ pileup pass for the counts, the unique gVCF tuples and the
    SNV mismatches. Runs that need per-read candidate objects (-CallMNVs,
    amplicon tracking, tagged stitched or read-collapsed input) find their
    candidates with the per-read state machine of pileup/candidates and, on
    a native batch, count with the C++ pass (stitched reads with their XD
    per-base directions); the Python reader (open_bam(prefer_native=False))
    takes the Python flow: read events and a torch count build. `device` is
    the torch device for the Python flow's
    count build, the tuple-scoring kernel and large candidate batches
    ("cuda" unless the caller passes "cpu"); None runs everything on the
    host in numpy (-backend numpy). `mesh` (parallel/sharding.Mesh,
    -MeshDevices > 1) scores the gVCF reference loci sharded over its
    devices from the read events, so it always takes the Python events.
    `forced_alleles` (load_forced_alleles) are reported whatever their
    support; `priors` (load_priors) are the collapser's known variants.
    Returns the called alleles in genome order, plus the columnar reference
    lines (positions, lines) when the fast gVCF path applies.
    """
    device = resolve_device(device) if device is not None else None
    cfg = CallerConfig.from_options(options)
    cfg.device = device
    cfg.mesh = mesh
    bf = options.bam_filter_parameters
    v = options.variant_calling_parameters
    track_amplicons = v.amplicon_bias_filter_threshold is not None
    source_is_stitched = (bam.header.source_is_stitched
                          or options.use_stitched_xd_info)
    need_tags = (track_amplicons or source_is_stitched
                 or bam.header.source_is_collapsed
                 or options.vcf_writing_parameters.report_rc_counts)

    ref_id = bam.header.ref_index(chrom.name)
    # the native handle may sit behind a window's _RegionView
    reader = getattr(bam, "reader", bam)
    native = isinstance(reader, NativeBamReader)
    with metrics.stage("bam_fetch"):
        # the native reader serves seq/qual/cigar as zero-copy views into
        # its decode buffers: this call consumes the batch before the
        # handle's next fetch, and its pileup does not invalidate them
        batch = (bam.fetch(ref_id=ref_id, parse_tags=need_tags,
                           as_views=True) if native
                 else bam.fetch(ref_id=ref_id, parse_tags=need_tags))
    metrics.count("reads", batch.n)
    keep = filter_batch(batch, bf.minimum_map_quality, bf.remove_duplicates,
                        bf.only_use_proper_pairs)

    # stitched (XD) directions: a native batch's come from its C++ decode,
    # a Python batch's a read at a time
    base_dirs = del_dirs = None
    if source_is_stitched and batch.xd_tags is not None:
        with metrics.stage("xd_directions"):
            if batch._from_native_handle:
                base_dirs, del_dirs, n_stitched = reader.xd_directions()
            else:
                from pisces_tpu_torch.pileup.directions import (
                    batch_base_directions, has_stitched_segment,
                )
                base_dirs = batch_base_directions(batch, keep)
                n_stitched = sum(map(has_stitched_segment, batch.xd_tags))
        metrics.count("reads_stitched", n_stitched)

    # the native flow needs a batch from the native handle and no per-read
    # candidate objects (MNVs, amplicons, read-collapsed counts); the mesh
    # scores from the read events, so -MeshDevices keeps the Python events
    # on the natively decoded batch
    counts_native = batch._from_native_handle and mesh is None
    if (counts_native and not options.call_mnvs and not track_amplicons
            and not options.vcf_writing_parameters.report_rc_counts
            and not has_collapsed_tags(batch.extra_tags)):
        # C++ pass: events, count scatter, scoring tuples and SNV mismatch
        # extraction in one go; indels come from the CIGAR walk before it.
        # No read takes the per-read state machine (its counter reads 0)
        metrics.count("reads_state_machine", 0)
        with metrics.stage("candidates"):
            indels = find_indel_candidates(
                chrom.name, chrom.sequence, batch, keep,
                bf.minimum_base_call_quality, options.tracked_anchor_size,
                track_open_ended=options.collapse, base_dirs=base_dirs,
                del_dirs=del_dirs)
        anchor_positions = candidate_anchor_positions(indels)
        with metrics.stage("pileup"):
            pc, mm = native_pileup(reader, keep, bf.minimum_base_call_quality,
                                   options.tracked_anchor_size,
                                   anchor_positions,
                                   ref_codes=BASE_TO_ALLELE[chrom.sequence],
                                   track_open_ended=options.collapse,
                                   base_dirs=base_dirs)
        with metrics.stage("candidates"):
            snvs = aggregate_native_mismatches(chrom.name, chrom.sequence,
                                               *mm)
        candidates = indels
    else:
        snvs = None
        with metrics.stage("candidates"):
            candidates, _ = find_candidates_batch(
                chrom.name, chrom.sequence, batch, keep,
                bf.minimum_base_call_quality, options.call_mnvs,
                options.max_size_mnv, options.max_gap_between_mnv,
                options.tracked_anchor_size, track_open_ended=options.collapse,
                track_amplicons=track_amplicons)
        anchor_positions = candidate_anchor_positions(candidates)
        with metrics.stage("pileup"):
            if counts_native:
                pc, _ = native_pileup(reader, keep,
                                      bf.minimum_base_call_quality,
                                      options.tracked_anchor_size,
                                      anchor_positions, base_dirs=base_dirs)
            else:
                ev = build_base_events(batch, keep,
                                       bf.minimum_base_call_quality,
                                       options.tracked_anchor_size,
                                       base_dirs=base_dirs)
                if device is not None:
                    pc = build_counts_device(
                        ev, anchor_size=options.tracked_anchor_size,
                        anchored_positions=anchor_positions, device=device)
                else:
                    pc = build_counts_host(
                        ev, anchor_size=options.tracked_anchor_size,
                        anchored_positions=anchor_positions)

    amp_cov = None
    read_summaries = None
    if track_amplicons:
        from pisces_tpu_torch.pileup.amplicons import amplicon_coverage
        with metrics.stage("pileup"):
            amp_cov = amplicon_coverage(batch, keep,
                                        bf.minimum_base_call_quality)
    if options.coverage_method == CoverageMethod.EXACT:
        from pisces_tpu_torch.ops.exact_coverage import build_read_summaries
        with metrics.stage("pileup"):
            read_summaries = build_read_summaries(batch, keep, base_dirs)
    source = AlleleSource(pc, expect_stitched_reads=source_is_stitched,
                          amplicon_coverage=amp_cov)

    if forced_alleles:
        from pisces_tpu_torch.io.vcf_read import classify
        existing = {(c.position, c.ref_allele, c.alt_allele)
                    for c in candidates}
        if snvs is not None:
            held = snvs.take(snvs.rows_in(
                f[1:] for f in forced_alleles if f[0] == chrom.name))
            existing.update(zip(held.position.tolist(),
                                map(chr, held.ref_base),
                                map(chr, held.alt_base)))
        for (chrom_name, pos, ref, alt) in sorted(forced_alleles):
            if chrom_name != chrom.name or (pos, ref, alt) in existing:
                continue
            fc = Candidate(chrom.name, pos, ref, alt, classify(ref, alt))
            fc.is_forced = True
            candidates.append(fc)

    # effective ploidy is per chromosome (chrM always somatic; sex
    # chromosomes go haploid with -gender — GenotypeCreator
    # .GetPloidyForThisChr); only somatic/diploid ref rules are columnar
    eff_ploidy = get_ploidy_for_chr(v.ploidy_model, v.is_male, chrom.name)
    fast_gvcf = (_fast_gvcf_eligible(options, forced_alleles)
                 and eff_ploidy in (PloidyModel.SOMATIC,
                                    PloidyModel.DIPLOID_BY_THRESHOLDING))
    if options.vcf_writing_parameters.output_gvcf_file and not fast_gvcf:
        candidates = candidates + make_reference_candidates(
            chrom.name, chrom.sequence, pc, intervals)

    collapser = None
    if options.collapse:
        collapser = VariantCollapser(
            priors.get(chrom.name) if priors else None,
            options.exclude_mnvs_from_collapsing,
            cfg.consider_anchor_information,
            options.collapse_freq_threshold, options.collapse_freq_ratio_threshold)

    caller = AlleleCaller(cfg, chrom.sequence, collapser, intervals,
                          read_summaries=read_summaries)
    if forced_alleles:
        caller.forced_alleles = {f for f in forced_alleles
                                 if f[0] == chrom.name}
    n_candidates = len(candidates) + (len(snvs) if snvs is not None else 0)
    with metrics.stage("allele_calling"):
        by_position = caller.call(candidates, source, snvs=snvs)
        if (options.vcf_writing_parameters.report_rc_counts
                and batch.extra_tags is not None):
            from pisces_tpu_torch.pileup.collapsed import (
                assign_collapsed_totals, collapsed_total_counts,
            )
            assign_collapsed_totals(by_position, collapsed_total_counts(
                batch, keep, bf.minimum_base_call_quality, base_dirs))
    metrics.count("candidates_scored", n_candidates)

    ref_lines = None
    if fast_gvcf:
        from pisces_tpu_torch.calling.fast_gvcf import (
            format_reference_lines, score_reference_positions,
        )
        from pisces_tpu_torch.ops.scoring_params import ScoringParams
        params = ScoringParams(
            noise_level=v.noise_level_used_for_q_scoring,
            max_variant_qscore=v.maximum_variant_qscore,
            min_variant_qscore=v.minimum_variant_qscore,
            variant_qscore_filter=v.minimum_variant_qscore_filter,
            min_frequency=v.minimum_frequency,
            min_frequency_filter=max(v.minimum_frequency_filter,
                                     v.minimum_frequency),
            target_lod=cfg.target_lod_frequency,
            min_depth=v.minimum_coverage,
            low_depth_filter=v.low_depth_filter or v.minimum_coverage,
            min_gq=v.minimum_genotype_qscore,
            max_gq=v.maximum_genotype_qscore,
            sb_acceptance=v.strand_bias_acceptance_criteria,
            no_call_filter=v.no_call_filter_threshold)
        diploid_params = (v.diploid_snv_thresholding_parameters
                          if eff_ploidy == PloidyModel.DIPLOID_BY_THRESHOLDING
                          else None)
        with metrics.stage("gvcf_scoring"):
            # the mesh scores somatic reference lines only; diploid ones
            # take the f64 host twin
            if mesh is not None and diploid_params is None:
                from pisces_tpu_torch.parallel.sharding import (
                    sharded_score_reference_positions,
                )
                positions, scored, shard_stats = \
                    sharded_score_reference_positions(
                        ev, chrom.sequence, params, mesh, intervals)
                for name, n in shard_stats.items():
                    metrics.count(name, n)
            else:
                positions, scored = score_reference_positions(
                    pc, chrom.sequence, params, device=device,
                    intervals=intervals, diploid_snv_params=diploid_params)
        metrics.count("loci_scored", len(positions))
        metrics.device_watermark(device)
        if scored is not None:
            # loci whose ref allele was suppressed by a coexisting variant
            # that genotyping later pruned entirely (diploid sub-threshold
            # case) emit NOTHING — mirror the object path's locus pruning
            suppressed = caller.ref_suppressed_positions - {
                p for p, lst in by_position.items() if lst}
            if suppressed:
                m = ~np.isin(positions, np.fromiter(suppressed, np.int64))
                positions = positions[m]
                scored["inv"] = scored["inv"][m]
                scored["ref_base"] = scored["ref_base"][m]
            wcfg = VcfWriterConfig(options)
            with metrics.stage("gvcf_formatting"):
                ref_lines = (positions, format_reference_lines(
                    chrom.name, positions, scored, wcfg,
                    v.low_depth_filter or v.minimum_coverage,
                    v.minimum_variant_qscore_filter))

    out: List = []
    for pos in sorted(by_position):
        out.extend(by_position[pos])
    log(f"{chrom.name}: {caller.total_num_called} alleles called. "
        f"{caller.total_num_collapsed} variants collapsed.")
    if fast_gvcf:
        return out, ref_lines
    return out


def write_spliced(writer, variant_alleles, ref_lines) -> None:
    """Merge the columnar reference-line stream with object-path variant
    alleles, in position order; ref lines at emitted-variant positions are
    pruned (ComputeGenotypeAndFilterAllele ref-pruning semantics) UNLESS
    every variant there is forced-to-report — the reference keeps the
    locus's reference allele when only forced alleles coexist
    (AlleleCaller.cs:143-150 guards the prune on a non-forced variant).
    `ref_lines` is None or (positions, fast_gvcf.RefLineBlock)."""
    with metrics.stage("vcf_write"):
        variant_positions = {}
        for a in variant_alleles:
            variant_positions.setdefault(a.position, []).append(a)
        if ref_lines is None:
            positions, lines = np.empty(0, np.int64), None
        else:
            positions, lines = ref_lines
            positions = np.asarray(positions, dtype=np.int64)
        fh = writer._fh
        ri = 0
        n_ref = len(positions)

        def _bulk_refs_upto(j: int) -> None:
            nonlocal ri
            if j > ri:
                # one buffer-slice write, no per-line string objects
                lines.write_range(fh, ri, j)
                ri = j

        for pos in sorted(variant_positions):
            # bulk-write the run of reference lines before this variant locus
            _bulk_refs_upto(int(np.searchsorted(positions, pos)))
            has_ref_line = ri < n_ref and int(positions[ri]) == pos
            at_pos = variant_positions[pos]
            keep_ref = has_ref_line and all(a.is_forced_to_report
                                            for a in at_pos)
            if writer.config.allow_multiple_vcf_lines_per_loci:
                # locus ordering is by (ref, alt) with the reference line
                # keyed by its base (AlleleCaller.cs:172-176 sort)
                ref_key = None
                if keep_ref:
                    ref_base = lines.line(ri).split("\t", 4)[3]
                    ref_key = (ref_base, ref_base)
                for a in at_pos:
                    if ref_key is not None and ref_key <= (a.ref_allele,
                                                           a.alt_allele):
                        fh.write(lines.line(ri) + "\n")
                        ref_key = None
                    writer.write_colocated([a])
                if ref_key is not None:
                    fh.write(lines.line(ri) + "\n")
            else:
                if keep_ref:
                    fh.write(lines.line(ri) + "\n")
                writer.write_colocated(at_pos)
            if has_ref_line:
                ri += 1
        _bulk_refs_upto(n_ref)


def load_forced_alleles(paths: List[str]) -> set:
    """Factory.GetForcedAlleles: load (chrom, pos, ref, alt) tuples from VCFs,
    rejecting invalid alts."""
    from pisces_tpu_torch.io.vcf_read import read_header_and_variants
    out = set()
    for path in paths:
        _, variants = read_header_and_variants(path)
        for v in variants:
            for alt in v.alt_allele.split(","):
                ref = v.ref_allele.upper()
                a = alt.upper()
                if a == ref or any(ch not in "ACGT" for ch in a):
                    log(f"Invalid forced genotyping variant: {v.chrom}:"
                        f"{v.position} {ref}>{a}")
                    continue
                out.add((v.chrom, v.position, ref, a))
    return out


def load_priors(path: str, trim_mnv: bool = False):
    """Load known collapsable variants (-PriorsPath) into per-chromosome
    Candidate lists for the collapser (Factory.cs priors + TrimMnvPriors:
    strip the shared leading reference base of padded MNV priors)."""
    from pisces_tpu_torch.io.vcf_read import read_header_and_variants

    by_chrom: Dict[str, list] = {}
    _hdr, variants = read_header_and_variants(path)
    for v in variants:
        for alt in v.alt_allele.split(","):
            if alt in (".", "<M>", "*"):
                continue
            pos, ref, a = v.position, v.ref_allele, alt
            if trim_mnv and len(ref) > 1 and len(a) > 1 and ref[0] == a[0]:
                pos, ref, a = pos + 1, ref[1:], a[1:]
            if len(ref) == len(a):
                cat = (AlleleCategory.SNV if len(ref) == 1
                       else AlleleCategory.MNV)
            elif len(ref) > len(a):
                cat = AlleleCategory.DELETION
            else:
                cat = AlleleCategory.INSERTION
            by_chrom.setdefault(v.chrom, []).append(
                Candidate(v.chrom, pos, ref, a, cat))
    return by_chrom


class _RegionView:
    """One genomic window of a lazy indexed reader, shown to call_chromosome
    as if it were the whole file, so each window runs with bounded memory
    (the streaming analog of the reference's 1000-bp block recycling,
    RegionStateManager.cs:425-439, scaled to .bai granularity)."""

    def __init__(self, reader, ref_id: int, beg0: int, end0: int):
        self.reader = reader
        self.header = reader.header
        self._region = (ref_id, beg0, end0)

    def fetch(self, ref_id=None, parse_tags: bool = False,
              as_views: bool = False):
        if as_views:
            return self.reader.fetch_region(*self._region,
                                            parse_tags=parse_tags,
                                            as_views=True)
        return self.reader.fetch_region(*self._region, parse_tags=parse_tags)


def _trim_window_result(result, w0: int, w1: int):
    """Keep the loci inside the window [w0 + 1, w1] (1-based). The result
    owns its arrays (native_pileup copies the gVCF positions; the lines
    live in their own render buffer), so a trimmed window stays valid after
    its handle's next fetch."""
    if not isinstance(result, tuple):
        return [a for a in result if w0 < a.position <= w1], None
    alleles, ref_lines = result
    alleles = [a for a in alleles if w0 < a.position <= w1]
    if ref_lines is not None:
        positions, lines = ref_lines
        # window-interior positions form a contiguous run
        lo = int(np.searchsorted(positions, w0 + 1))
        hi = int(np.searchsorted(positions, w1, side="right"))
        ref_lines = (positions[lo:hi], lines.slice(lo, hi))
    return alleles, ref_lines


def call_chromosome_windowed(options, chrom, reader, ref_id: int,
                             intervals=None, device="cuda", mesh=None,
                             reader_factory=None, pipeline_threads: int = 1,
                             forced_alleles=None, priors=None):
    """Stream one chromosome in options.window_size slices. Yields
    (result, w_start1, w_end1) per window, result as _trim_window_result
    gives it. Counts at in-window positions are complete because
    fetch_region selects reads by overlap, and options.window_margin covers
    spanning-variant endpoint lookups past the window edge. `device`,
    `mesh`, `forced_alleles` and `priors` reach every window as
    call_chromosome takes them.

    With pipeline_threads > 1 and a reader_factory, windows run on worker
    threads, each with its OWN reader handle (a lazy fetch rewrites its
    handle's decode buffers), while earlier windows are written: the input
    overlap of SURVEY M3. Results are yielded strictly in window order."""
    L = len(chrom.sequence)
    win = options.window_size
    margin = options.window_margin
    windows = [(w0, min(w0 + win, L)) for w0 in range(0, L, win)]

    def run(handle, w0: int, w1: int):
        with metrics.stage("window", cpu=True):
            view = _RegionView(handle, ref_id, max(0, w0 - margin),
                               min(L, w1 + margin))
            result = call_chromosome(options, chrom, view, intervals, device,
                                     mesh, forced_alleles, priors)
            return _trim_window_result(result, w0, w1)

    if pipeline_threads <= 1 or reader_factory is None or len(windows) <= 1:
        for w0, w1 in windows:
            yield run(reader, w0, w1), w0 + 1, w1
        return

    from concurrent.futures import ThreadPoolExecutor

    n_workers = min(pipeline_threads, len(windows))
    execs = [ThreadPoolExecutor(max_workers=1) for _ in range(n_workers)]
    handles: List = [None] * n_workers

    def work(slot: int, w0: int, w1: int):
        if handles[slot] is None:
            handles[slot] = reader_factory()
        return run(handles[slot], w0, w1)

    try:
        # each window's spans nest under the span open where it is handed
        # to its worker
        futures = [execs[i].submit(metrics.carry(work), i, *windows[i])
                   for i in range(n_workers)]
        for i, (w0, w1) in enumerate(windows):
            trimmed = futures[i].result()
            futures[i] = None  # drop the result: bounded-memory streaming
            nxt = i + n_workers
            if nxt < len(windows):
                futures.append(execs[nxt % n_workers].submit(
                    metrics.carry(work), nxt % n_workers, *windows[nxt]))
            yield trimmed, w0 + 1, w1
    finally:
        for ex in execs:
            ex.shutdown(wait=True)


def scoring_setup(options: PiscesApplicationOptions, device="cuda",
                  backend: str = "torch"):
    """Check a run's options and devices once: returns (score_device, mesh),
    the torch device that scores (None for -backend numpy, which keeps all
    scoring but the mesh's on the f64 host path) and the -MeshDevices mesh
    of that many devices of `device`'s type (None without one; raises when
    CUDA has fewer cards). `device` is "cuda" unless the caller asks for
    "cpu"; it raises when CUDA is absent."""
    if backend not in ("torch", "numpy"):
        raise ValueError(f"backend must be torch or numpy, got {backend!r}")
    device = resolve_device(device)
    options.validate()
    mesh = None
    if options.mesh_devices > 1:
        from pisces_tpu_torch.parallel.sharding import get_mesh
        mesh = get_mesh(options.mesh_devices, device)
    return (device if backend == "torch" else None), mesh


def default_vcf_path(options: PiscesApplicationOptions, bam_path: str) -> str:
    """<output dir or the BAM's dir>/<BAM stem>.genome.vcf (.vcf without
    gVCF); makes the directory."""
    stem = os.path.basename(bam_path)
    if stem.endswith(".bam"):
        stem = stem[:-4]
    suffix = ".genome.vcf" if options.vcf_writing_parameters.output_gvcf_file \
        else ".vcf"
    out_dir = options.output_directory or os.path.dirname(bam_path)
    os.makedirs(out_dir, exist_ok=True)
    return os.path.join(out_dir, stem + suffix)


def process_bam(options: PiscesApplicationOptions, bam_path: str,
                genome: Genome, out_vcf: Optional[str] = None,
                device="cuda", backend: str = "torch") -> str:
    """Call one BAM, chromosome by chromosome; returns the VCF path.

    The BAM opens with io/native.open_bam, so the run takes the native
    flow; a caller that swaps in open_bam(path, prefer_native=False, lazy)
    gets the pure-Python reader and flow. With options.window_size > 0 and
    a sibling .bai each chromosome streams in windows through a lazy
    reader (call_chromosome_windowed; two pipeline threads when the host
    has more than two cores and options.max_num_threads allows), and the
    whole file is never inflated; without the .bai a WARNING is logged and
    the chromosome runs whole, as in the reference.

    Forced alleles and priors load once a run; with
    -OutputBiasFiles the strand- and amplicon-bias tables are written
    beside the VCF (io/bias_writers). `device` and `backend` as
    scoring_setup takes them.
    """
    score_device, mesh = scoring_setup(options, device, backend)
    forced_alleles = (load_forced_alleles(options.forced_alleles_paths)
                      if options.forced_alleles_paths else None)
    priors = (load_priors(options.priors_path, options.trim_mnv_priors)
              if options.priors_path else None)
    if out_vcf is None:
        out_vcf = default_vcf_path(options, bam_path)
    gvcf = options.vcf_writing_parameters.output_gvcf_file
    has_bai = options.window_size > 0 and os.path.exists(bam_path + ".bai")
    lazy = open_bam(bam_path, lazy=True) if has_bai else None
    bam = None if has_bai else open_bam(bam_path)
    header = (lazy or bam).header
    # the reference package measured window pipelining slower on a 2-core
    # host (GIL and bandwidth contention with the writer), so windows
    # overlap only where cores are plentiful
    cores = os.cpu_count() or 1
    n_pipe = 1 if cores <= 2 else max(1, min(2, options.max_num_threads))

    wcfg = VcfWriterConfig(options, has_forced_gt=bool(forced_alleles))
    # the reference's sample column is the bam file name incl. extension
    # (VcfFileWriter header; cf. shipped expected outputs "PhiX_S3.bam")
    sample = os.path.basename(bam_path)
    bias_writers = []
    if options.output_bias_files:
        from pisces_tpu_torch.io.bias_writers import (
            AmpliconBiasFileWriter, StrandBiasFileWriter,
        )
        bias_writers = [StrandBiasFileWriter(out_vcf),
                        AmpliconBiasFileWriter(out_vcf)]
        for bw in bias_writers:
            bw.write_header()

    with VcfWriter(out_vcf, wcfg, genome.directory, sample,
                   genome.chromosome_lengths, options.command_line) as writer:
        writer.write_header()
        from pisces_tpu_torch.calling.intervals import make_region_mapper
        for chrom_name in genome.chromosome_names:
            if chrom_name not in header.ref_names:
                log(f"skipping {chrom_name}: not in bam")
                continue
            if options.chromosome_filter and chrom_name != options.chromosome_filter:
                continue
            chrom = genome.get_chr_reference(chrom_name)
            intervals = _load_intervals(options, chrom_name)
            t0 = time.time()
            # windows need no intervals, plain-VCF output, or the columnar
            # fast-gVCF path (which folds RegionMapper interval padding
            # into its per-window reference lines)
            win_ok = (intervals is None or not gvcf
                      or _fast_gvcf_eligible(options, forced_alleles))
            if options.window_size > 0 and win_ok and lazy is not None:
                alleles = []
                for (w_alleles, ref_lines), _w0, _w1 in \
                        call_chromosome_windowed(
                            options, chrom, lazy,
                            header.ref_index(chrom_name), intervals,
                            score_device, mesh,
                            reader_factory=lambda: open_bam(bam_path,
                                                            lazy=True),
                            pipeline_threads=n_pipe,
                            forced_alleles=forced_alleles, priors=priors):
                    write_spliced(writer, w_alleles, ref_lines)
                    if bias_writers:
                        alleles.extend(w_alleles)
            else:
                if options.window_size > 0 and win_ok:
                    log(f"window mode requested but {bam_path}.bai missing; "
                        "processing whole chromosome", "WARNING")
                if bam is None:
                    bam = open_bam(bam_path)
                result = call_chromosome(options, chrom, bam, intervals,
                                         score_device, mesh, forced_alleles,
                                         priors)
                if isinstance(result, tuple):
                    alleles, ref_lines = result
                    write_spliced(writer, alleles, ref_lines)
                else:
                    alleles = result
                    mapper = make_region_mapper(options, chrom, intervals)
                    with metrics.stage("vcf_write"):
                        writer.write(alleles, mapper)
                        writer.write_remaining(mapper)
            for bw in bias_writers:
                bw.write(alleles)
            log(f"Completed processing chr {chrom_name} in "
                f"{time.time() - t0:.2f} secs")
    for bw in bias_writers:
        bw.close()
    return out_vcf


def _load_intervals(options: PiscesApplicationOptions, chrom_name: str):
    if not options.interval_paths:
        return None
    from pisces_tpu_torch.calling.intervals import (
        ChrIntervalSet, read_picard_intervals,
    )
    by_chrom = read_picard_intervals(options.interval_paths[0])
    regions = by_chrom.get(chrom_name, [])
    if not regions and not any(by_chrom.values()):
        return None
    return ChrIntervalSet(regions, chrom_name)


def main(argv=None) -> int:
    from pisces_tpu_torch.apps._pisces_main import (
        _b, _normalize, build_parser, options_from_args,
    )
    raw = list(argv if argv is not None else sys.argv[1:])
    args = build_parser().parse_args(_normalize(raw))
    options = options_from_args(args, raw)
    bam_paths = options.bam_paths
    device = resolve_device(args.device)

    def execute() -> int:
        from pisces_tpu_torch.utils.metrics import profiler_trace
        with profiler_trace(args.profiledir):
            _execute_inner()
        snap = metrics.report()
        if snap["counters"].get("loci_scored"):
            sec = snap["stages"].get("gvcf_scoring", {}).get("seconds", 0)
            if sec:
                log(f"loci scored/sec: "
                    f"{snap['counters']['loci_scored'] / sec:,.0f}")
        if args.metricsjson:
            metrics.write_json(args.metricsjson)
        return 0

    def _execute_inner() -> None:
        from pisces_tpu_torch.parallel import scheduler
        if _b(args.multihost):
            from pisces_tpu_torch.parallel.multihost import (
                process_bam_multihost,
            )
            for bam_path in bam_paths:
                out = process_bam_multihost(options, bam_path, args.genome,
                                            device, args.backend)
                if out:
                    log(f"wrote {out}")
        elif _b(args.multiprocess) and not _b(args.insidesubprocess):
            for bam_path in bam_paths:
                out = scheduler.process_chromosomes_multiprocess(
                    options, bam_path, args.genome, args.max_threads,
                    device, args.backend, resume=_b(args.resume))
                log(f"wrote {out}")
        elif args.max_threads > 1 or len(bam_paths) > 1:
            for out in scheduler.process_bams_parallel(
                    options, bam_paths, Genome(args.genome),
                    args.max_threads, device, args.backend,
                    thread_by_chr=options.thread_by_chr):
                log(f"wrote {out}")
        else:
            out = process_bam(options, bam_paths[0], Genome(args.genome),
                              device=device, backend=args.backend)
            log(f"wrote {out}")

    from pisces_tpu_torch.utils.app import run_application
    log_dir = args.out or os.path.dirname(os.path.abspath(bam_paths[0]))
    with metrics.sample():
        return run_application(args.baselogname or "Pisces", execute,
                               options, log_dir)


if __name__ == "__main__":
    sys.exit(main())
