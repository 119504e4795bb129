"""Pisces CLI argument surface.

Mirrors the reference's parser composition (PiscesOptionsParser.cs:130-141
wiring BamProcessorParsingUtils + BamFilterOptionsUtils +
VariantCallingOptionsParserUtils + VcfWritingParserUtils), including every
flag alias. Flags are case-insensitive like the NDesk-based reference
parser; booleans accept true/false strings.
"""
from __future__ import annotations

import argparse
from typing import List

from pisces_tpu_torch.domain.types import (
    CoverageMethod, NoiseModel, PloidyModel, StrandBiasModel,
)
from pisces_tpu_torch.options import PiscesApplicationOptions


def _b(s: str) -> bool:
    return str(s).strip().lower() in ("true", "1", "yes")


def _normalize(argv: List[str]) -> List[str]:
    """Lowercase flag tokens (value tokens untouched) so flags are
    case-insensitive like the reference parser; split '-flag=value'."""
    out = []
    for tok in argv:
        if tok.startswith("-") and not tok[1:2].isdigit():
            if "=" in tok:
                flag, val = tok.split("=", 1)
                out.append(flag.lower())
                out.append(val)
            else:
                out.append(tok.lower())
        else:
            out.append(tok)
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pisces-tpu-torch",
        description="Somatic variant caller (PyTorch/CUDA port)")
    a = p.add_argument
    # ---- BamProcessorParsingUtils ----
    a("-b", "-bam", "-bampaths", dest="bam", required=True,
      help="bam path(s), comma separated")
    a("-g", "-genomepaths", "-genomefolders", dest="genome", required=True)
    a("-o", "-out", "-outfolder", dest="out", default=None)
    a("-t", "-maxthreads", "-maxnumthreads", dest="max_threads", type=int,
      default=1)
    a("-threadbychr", default="false")
    a("-multiprocess", default="false")
    a("-insidesubprocess", default="false")
    a("-chrfilter", default=None)
    # ---- app-level (PiscesOptionsParser) ----
    a("-i", "-intervalpaths", dest="intervals", default=None)
    a("-forcedalleles", default=None)
    a("-callmnvs", default="false")
    a("-maxmnvlength", type=int, default=3)
    a("-maxgapbetweenmnv", "-maxrefgapinmnv", dest="maxgapbetweenmnv",
      type=int, default=1)
    a("-outputsbfiles", "-outputbiasfiles", dest="outputsbfiles",
      default="false")
    a("-collapse", "-collapsevariants", dest="collapse", default="true")
    a("-collapsefreqthreshold", type=float, default=0.0)
    a("-collapsefreqratiothreshold", type=float, default=0.5)
    a("-priorspath", default=None)
    a("-trimmnvpriors", default="false")
    a("-coveragemethod", default="approximate",
      help="approximate or exact")
    a("-baselogname", default=None)
    a("-d", "-debug", dest="debug", default="false")
    a("-usestitchedxd", default="false")
    a("-trackedanchorsize", type=int, default=5)
    # ---- BamFilterOptionsUtils ----
    a("-minbq", "-minbasecallquality", dest="minbq", type=int, default=20)
    a("-minmq", "-minmapquality", dest="minmq", type=int, default=1)
    a("-filterduplicates", "-duplicatereadfilter", dest="filterduplicates",
      default="true")
    a("-pp", "-onlyuseproperpairs", dest="properpairs", default="false")
    # ---- VariantCallingOptionsParserUtils ----
    a("-minvq", "-minvariantqscore", dest="minvq", type=int, default=20)
    a("-c", "-mindp", "-mindepth", "-mincoverage", dest="mindp", type=int,
      default=10)
    a("-minvf", "-minimumvariantfrequency", "-minimumfrequency",
      dest="minvf", type=float, default=0.01)
    a("-targetlodfrequency", "-targetvf", dest="targetlod", type=float,
      default=None)
    a("-vqfilter", "-variantqualityfilter", dest="vqfilter", type=int,
      default=30)
    a("-vffilter", "-minvariantfrequencyfilter", dest="vffilter",
      type=float, default=None)
    a("-gqfilter", "-genotypequalityfilter", dest="gqfilter", type=int,
      default=None)
    a("-repeatfilter_toberetired", "-repeatfilter", dest="repeatfilter",
      type=int, default=None)
    a("-mindpfilter", "-mindepthfilter", dest="mindpfilter", type=int,
      default=None)
    a("-ssfilter", "-enablesinglestrandfilter", dest="ssfilter",
      default="false")
    a("-nl", "-noiselevelforqmodel", dest="noiselevel", type=int,
      default=None)
    a("-noisemodel", default="flat", help="flat or window")
    a("-ploidy", default="somatic")
    a("-diploidsnvgenotypeparameters", default=None)
    a("-diploidindelgenotypeparameters", default=None)
    a("-adaptivegenotypeparameters_snvmodel", default=None)
    a("-adaptivegenotypeparameters_indelmodel", default=None)
    a("-adaptivegenotypeparameters_snvprior", default=None)
    a("-adaptivegenotypeparameters_indelprior", default=None)
    a("-sbmodel", default="extended", help="poisson or extended")
    a("-maxvq", "-maxvariantqscore", dest="maxvq", type=int, default=100)
    a("-maxgq", "-maxgenotypeqscore", dest="maxgq", type=int, default=100)
    a("-mingq", "-mingenotypeqscore", dest="mingq", type=int, default=0)
    a("-sbfilter", "-maxacceptablestrandbiasfilter", dest="sbfilter",
      type=float, default=0.5)
    a("-gender", default=None, help="male or female (sex chromosomes)")
    a("-maxgp", "-maxgenotypeposteriorscore", type=int, default=None,
      help="cap on adaptive-GT phred genotype posteriors (GP column)")
    a("-rmxnfilter", default="5,9,0.35")
    a("-ncfilter", type=float, default=0.6)
    a("-abfilter", type=float, default=None)
    # ---- VcfWritingParserUtils ----
    a("-gvcf", default="true")
    a("-crushvcf", default=None)
    a("-reportnocalls", default="false")
    a("-reportrccounts", default="false")
    a("-reporttscounts", default="false")
    a("-reportsuspiciouscoveragefraction", default="false")
    # ---- rebuild extensions ----
    a("-backend", default="torch", choices=["torch", "numpy"],
      help="per-locus scoring backend (default torch: the count build, the "
           "tuple-scoring kernel and large candidate batches run on -device; "
           "integer outputs are exact vs the f64 host path, and floats "
           "emitted in variant lines stay on the host f64 path for byte "
           "parity). numpy forces everything onto the host, except the "
           "-MeshDevices reference scoring.")
    a("-device", default="cuda", choices=["cuda", "cpu"],
      help="torch device (default cuda; raises when CUDA is absent)")
    a("-resume", default="false",
      help="with -MultiProcess: skip completed chromosome shards")
    a("-windowsize", type=int, default=0,
      help="stream chromosomes in windows of this many bases via the .bai "
           "index (whole chromosomes, with a WARNING, without one); "
           "0 = whole-chromosome")
    a("-meshdevices", type=int, default=0,
      help="shard the gVCF reference scoring and large candidate batches "
           "over a mesh of N devices of -device's type (with cuda, N "
           "cards); 0 or 1 = single device")
    a("-multihost", default="false",
      help="run as one process of a torch.distributed multi-host job "
           "(coordinator/pid via JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, "
           "JAX_PROCESS_ID, as the reference package reads them); "
           "chromosomes partition across hosts, host 0 merges the "
           "per-chromosome shards")
    a("-profiledir", default=None,
      help="capture a torch.profiler trace (Chrome trace format) of the "
           "run, with its stage spans, into this directory's trace.json")
    a("-metricsjson", default=None,
      help="write stage timings / counters / device memory watermark as "
           "JSON to this path at exit")
    return p


def options_from_args(args, argv) -> PiscesApplicationOptions:
    o = PiscesApplicationOptions()
    o.bam_paths = args.bam.split(",")
    o.genome_paths = [args.genome]
    o.output_directory = args.out
    o.command_line = " ".join(argv)
    o.max_num_threads = args.max_threads
    o.thread_by_chr = _b(args.threadbychr)
    o.chromosome_filter = args.chrfilter
    if args.intervals:
        o.interval_paths = args.intervals.split(",")
    if args.forcedalleles:
        o.forced_alleles_paths = args.forcedalleles.split(",")
    o.call_mnvs = _b(args.callmnvs)
    o.max_size_mnv = args.maxmnvlength
    o.max_gap_between_mnv = args.maxgapbetweenmnv
    o.output_bias_files = _b(args.outputsbfiles)
    o.collapse = _b(args.collapse)
    o.collapse_freq_threshold = args.collapsefreqthreshold
    o.collapse_freq_ratio_threshold = args.collapsefreqratiothreshold
    o.priors_path = args.priorspath
    o.trim_mnv_priors = _b(args.trimmnvpriors)
    o.coverage_method = (CoverageMethod.EXACT
                         if args.coveragemethod.lower() == "exact"
                         else CoverageMethod.APPROXIMATE)
    o.debug_mode = _b(args.debug)
    o.use_stitched_xd_info = _b(args.usestitchedxd)
    o.tracked_anchor_size = args.trackedanchorsize
    o.window_size = args.windowsize
    o.mesh_devices = args.meshdevices

    bf = o.bam_filter_parameters
    bf.minimum_base_call_quality = args.minbq
    bf.minimum_map_quality = args.minmq
    bf.remove_duplicates = _b(args.filterduplicates)
    bf.only_use_proper_pairs = _b(args.properpairs)

    v = o.variant_calling_parameters
    v.minimum_variant_qscore = args.minvq
    v.minimum_coverage = args.mindp
    v.minimum_frequency = args.minvf
    if args.targetlod is not None:
        v.target_lod_frequency = args.targetlod
    v.minimum_variant_qscore_filter = args.vqfilter
    if args.vffilter is not None:
        v.minimum_frequency_filter = args.vffilter
    if args.gqfilter is not None:
        v.low_genotype_quality_filter = args.gqfilter
    if args.repeatfilter is not None:
        v.indel_repeat_filter = args.repeatfilter
    if args.mindpfilter is not None:
        v.low_depth_filter = args.mindpfilter
    v.filter_out_variants_present_only_one_strand = _b(args.ssfilter)
    if args.noiselevel is not None:
        v.forced_noise_level = args.noiselevel
    v.noise_model = (NoiseModel.WINDOW
                     if args.noisemodel.lower() == "window"
                     else NoiseModel.FLAT)
    ploidy = args.ploidy.lower()
    if ploidy in ("diploid", "diploidbythresholding"):
        v.ploidy_model = PloidyModel.DIPLOID_BY_THRESHOLDING
    elif ploidy in ("diploidbyadaptivegt", "adaptive"):
        v.ploidy_model = PloidyModel.DIPLOID_BY_ADAPTIVE_GT
    else:
        v.ploidy_model = PloidyModel.SOMATIC

    def _thresholds(spec, target):
        parts = [float(x) for x in spec.split(",")]
        target.minor_vf, target.major_vf = parts[0], parts[1]
        if len(parts) > 2:
            target.sum_vf_for_multi_allelic_site = parts[2]
    if args.diploidsnvgenotypeparameters:
        _thresholds(args.diploidsnvgenotypeparameters,
                    v.diploid_snv_thresholding_parameters)
    if args.diploidindelgenotypeparameters:
        _thresholds(args.diploidindelgenotypeparameters,
                    v.diploid_indel_thresholding_parameters)
    ag = v.adaptive_genotyping_parameters
    for flag, attr in [("adaptivegenotypeparameters_snvmodel", "snv_model"),
                       ("adaptivegenotypeparameters_indelmodel", "indel_model"),
                       ("adaptivegenotypeparameters_snvprior", "snv_prior"),
                       ("adaptivegenotypeparameters_indelprior", "indel_prior")]:
        val = getattr(args, flag)
        if val:
            setattr(ag, attr, tuple(float(x) for x in val.split(",")))
    v.strand_bias_model = (StrandBiasModel.POISSON
                           if args.sbmodel.lower() == "poisson"
                           else StrandBiasModel.EXTENDED)
    v.maximum_variant_qscore = args.maxvq
    v.maximum_genotype_qscore = args.maxgq
    v.minimum_genotype_qscore = args.mingq
    v.strand_bias_acceptance_criteria = args.sbfilter
    if args.gender:
        v.is_male = args.gender.lower() == "male"
    if args.maxgp is not None:
        v.adaptive_genotyping_parameters.max_genotype_posteriors = args.maxgp
    if args.rmxnfilter.lower() == "false":
        v.rmxn_filter_max_length_repeat = None
        v.rmxn_filter_min_repetitions = None
    else:
        parts = args.rmxnfilter.split(",")
        v.rmxn_filter_max_length_repeat = int(parts[0])
        v.rmxn_filter_min_repetitions = int(parts[1])
        if len(parts) > 2:
            v.rmxn_filter_frequency_limit = float(parts[2])
    v.no_call_filter_threshold = args.ncfilter
    if args.abfilter is not None:
        v.amplicon_bias_filter_threshold = args.abfilter

    w = o.vcf_writing_parameters
    w.output_gvcf_file = _b(args.gvcf)
    if args.crushvcf is not None:
        w.force_crush = _b(args.crushvcf)
    w.report_no_calls = _b(args.reportnocalls)
    w.report_rc_counts = _b(args.reportrccounts)
    w.report_ts_counts = _b(args.reporttscounts)
    w.report_suspicious_coverage_fraction = \
        _b(args.reportsuspiciouscoveragefraction)
    return o
