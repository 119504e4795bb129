"""VariantQualityRecalibration (VQR).

Port of exe/VariantQualityRecalibration: pass 1 counts mutation-category
rates (FFPE C>T, oxidation G>T, ...) and amplicon-edge suspects from the vcf
(SignatureSorter.cs:39-110, MutationCounter.cs, EdgeIssueCountData.cs); pass
2 z-scores each category against the trimmed-mean baseline and rewrites
variant q-scores (QualityRecalibration.cs:26-380).
"""
from __future__ import annotations

import argparse
import math
import os
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from pisces_tpu_torch.domain.types import AlleleCategory
from pisces_tpu_torch.ops import stats
from pisces_tpu_torch.io.vcf_read import (
    VcfVariant, classify, parse_vcf_line, read_header_and_variants,
    trim_trailing_bases, update_vcf_loci_by_loci,
)

SNV_CATEGORIES = ["AtoC", "AtoG", "AtoT", "CtoA", "CtoG", "CtoT",
                  "GtoA", "GtoC", "GtoT", "TtoA", "TtoC", "TtoG"]
# file order matches the reference's counts files (Expected.counts):
# the 12 substitutions, then Insertion, Deletion, Reference, Other
ALL_CATEGORIES = SNV_CATEGORIES + ["Insertion", "Deletion", "Reference", "Other"]


def mutation_category(ref: str, alt: str, filters: str = "") -> str:
    """MutationCounter.GetMutationCategory."""
    if "ForcedReport" in filters:
        return "Other"
    cat = classify(*trim_trailing_bases(ref, alt)) if alt != "." else AlleleCategory.REFERENCE
    if cat == AlleleCategory.REFERENCE:
        return "Reference"
    if cat == AlleleCategory.DELETION:
        return "Deletion"
    if cat == AlleleCategory.INSERTION:
        return "Insertion"
    if cat == AlleleCategory.SNV:
        name = f"{ref}to{alt}"
        for c in SNV_CATEGORIES:
            if c.lower() == name.lower():
                return c
    return "Other"


@dataclass
class CountData:
    counts_by_category: Dict[str, float] = field(
        default_factory=lambda: {c: 0.0 for c in ALL_CATEGORIES})
    num_possible_variants: float = 0.0

    @property
    def total_mutations(self) -> float:
        return sum(v for k, v in self.counts_by_category.items()
                   if k != "Reference")

    @property
    def observed_mutation_rate(self) -> float:
        if self.num_possible_variants == 0:
            return 0.0
        return self.total_mutations / self.num_possible_variants

    def add(self, category: str) -> bool:
        self.num_possible_variants += 1
        if category != "Reference":
            self.counts_by_category[category] += 1
            return True
        return False


@dataclass
class _BufferedAllele:
    chrom: str
    position: int
    total_coverage: int
    ref: str
    alt: str


class EdgeIssueCountData(CountData):
    """Trailing-window amplicon-edge detection (EdgeIssueCountData.cs)."""

    def __init__(self, extent: int):
        super().__init__()
        self.counts_by_category = {c: 0.0 for c in ALL_CATEGORIES}
        self.num_possible_variants = 0.0
        self.extent = extent
        self.buffer: List[Optional[_BufferedAllele]] = [None] * (2 * extent + 1)
        self.test_index = extent
        self.suspects: Dict[str, List[int]] = {}

    @staticmethod
    def detect_edge(test_index: int, buf: List[Optional[_BufferedAllele]]) -> bool:
        test = buf[test_index]
        if test is None or test.total_coverage == 0:
            return False
        for i, b in enumerate(buf):
            if i == test_index:
                continue
            if b is None:
                return True
            if b.total_coverage < 0.5 * test.total_coverage:
                return True
            if b.chrom != test.chrom:
                return True
            dist = test.position - b.position
            max_allowed = test_index - i
            if max_allowed > 0:
                if dist > max_allowed:
                    return True
            else:
                if dist < max_allowed:
                    return True
        return False

    def add(self, allele: Optional[_BufferedAllele]) -> None:
        self.buffer.pop(0)
        self.buffer.append(allele)
        if self.detect_edge(self.test_index, self.buffer):
            test = self.buffer[self.test_index]
            cat = mutation_category(test.ref, test.alt)
            self.num_possible_variants += 1
            if cat != "Reference":
                self.counts_by_category[cat] += 1
                self.suspects.setdefault(test.chrom, []).append(test.position)


def strain_vcf(vcf_path: str, extent: int = 4, loci_count: int = -1):
    """Pass 1: returns (basic CountData, EdgeIssueCountData)."""
    basic = CountData()
    edge = EdgeIssueCountData(extent)
    _, variants = read_header_and_variants(vcf_path)
    for v in variants:
        for alt in v.alt_allele.split(","):
            if alt in ("<M>", "*"):
                continue
            ref_t, alt_t = (v.ref_allele, alt) if alt == "." else \
                trim_trailing_bases(v.ref_allele, alt)
            cat = mutation_category(ref_t, alt_t, v.filters)
            basic.add(cat)
            dp = int(v.genotypes.get("DP", v.info_fields.get("DP", "0")) or 0)
            edge.add(_BufferedAllele(v.chrom, v.position, dp, ref_t, alt_t))
    for _ in range(extent):
        edge.add(None)
    if loci_count > 0:
        # SignatureSorter overrides the denominator for BOTH counters with
        # the supplied loci count (ExpectedGivenLociNum.{counts,edgecounts})
        basic.num_possible_variants = loci_count
        edge.num_possible_variants = loci_count
    return basic, edge


def _count_str(v: float) -> str:
    """C# double.ToString(): integral values print without a decimal."""
    return str(int(v)) if float(v).is_integer() else str(v)


def write_counts_file(path: str, counts: CountData) -> None:
    """MutationCounter counts-file layout, matching Expected.counts
    line-for-line (CountsByCategory header, category block, blank line,
    totals)."""
    with open(path, "w") as f:
        f.write("\nCountsByCategory\n")
        for cat, v in counts.counts_by_category.items():
            f.write(f"{cat}\t{_count_str(v)}\n")
        f.write("\nAllPossibleVariants\t%s\n" % _count_str(counts.num_possible_variants))
        f.write("VariantsCountedTowardEstimate\t%s\n" % _count_str(counts.total_mutations))
        f.write("MismatchEstimate(%%)\t%.4f\n" % (counts.observed_mutation_rate * 100))


def read_counts_file(path: str) -> CountData:
    counts = CountData()
    with open(path) as f:
        in_counts = False
        for line in f:
            line = line.strip()
            if line == "CountsByCategory":
                in_counts = True
                continue
            if not line:
                in_counts = False
                continue
            parts = line.split("\t")
            if in_counts and len(parts) == 2:
                counts.counts_by_category[parts[0]] = float(parts[1])
            elif parts[0] == "AllPossibleVariants":
                counts.num_possible_variants = float(parts[1])
    return counts


def get_phred_scaled_calibrated_rates(baseline_q: int, z_factor: float,
                                      counts: CountData) -> Dict[str, int]:
    """GetPhredScaledCalibratedRates: trimmed-mean z-test over the 12 SNV
    categories; over-threshold categories get a phred-scaled noise rate."""
    base_noise = float(stats.q_to_p(baseline_q))
    snv_counts = {c: counts.counts_by_category[c] for c in SNV_CATEGORIES}
    sorted_counts = sorted(snv_counts.values())
    if len(snv_counts) != 12:
        return {}
    trimmed = sorted_counts[2:10]
    avg = sum(trimmed) / 8.0
    var = sum((avg - x) ** 2 for x in trimmed) / 8.0
    threshold = avg + z_factor * math.sqrt(var)
    out = {}
    for cat, count in snv_counts.items():
        if count > threshold:
            observed = (count / counts.num_possible_variants
                        if counts.num_possible_variants > 0 else 0.0)
            out[cat] = int(stats.p_to_q(observed + base_noise))  # floor
    return out


def get_edge_risk_rates(baseline_q: int, warn_threshold: float,
                        basic: CountData, edge: CountData) -> Dict[str, int]:
    """GetPhredScaledCalibratedRatesForEdges."""
    out = {}
    muts_not_edge = basic.total_mutations - edge.total_mutations
    loci_not_edge = basic.num_possible_variants - edge.num_possible_variants
    if loci_not_edge <= 0 or edge.total_mutations <= 0:
        return out
    rate_not_edge = muts_not_edge / loci_not_edge
    null_expected = rate_not_edge * edge.num_possible_variants
    probably_wrong = edge.total_mutations - null_expected
    est_error_rate = probably_wrong / edge.total_mutations
    for cat in edge.counts_by_category:
        proportion = edge.counts_by_category[cat] / edge.total_mutations
        est_by_cat = proportion * est_error_rate
        if est_by_cat > 0:
            out[cat] = int(stats.p_to_q(est_by_cat))
    return out


def _parse_sample_fields(v: VcfVariant):
    return v.format.split(":"), v.sample.split(":")


def _format_allele_line(a) -> str:
    """Serialize one CalledAllele the way the reference VcfFileWriter does
    (recalibrated lines are round-tripped through CalledAllele, which
    normalizes FORMAT to GT:GQ:AD:DP:VF:NL:SB and recomputes DP via
    GetDepthCountInt / VF from support over coverage)."""
    from pisces_tpu_torch.domain.types import Genotype
    from pisces_tpu_torch.io.vcf_write import VcfFormatter, VcfWriterConfig
    fmtr = VcfFormatter(VcfWriterConfig())
    total_depth = fmtr.get_depth_count([a])
    fmt, smp = fmtr.construct_format_and_sample([a], total_depth)
    ref_s, alt_s = fmtr.uncrushed_ref_and_alt(a)
    if a.genotype in (Genotype.HOMOZYGOUS_REF, Genotype.REF_LIKE_NOCALL,
                      Genotype.REF_AND_NOCALL, Genotype.HEMIZYGOUS_NOCALL,
                      Genotype.HEMIZYGOUS_REF):
        alt_s = "."
    return (f"{a.chromosome}\t{a.position}\t.\t{ref_s}\t{alt_s}\t"
            f"{a.variant_qscore}\t{fmtr.map_filters([a])}\tDP={total_depth}\t"
            f"{fmt}\t{smp}")


def _update_allele(a, cat: str, rates: Dict[str, int], max_q: int,
                   filter_q: int, subsample: bool) -> bool:
    """UpdateVariantQScoreAndRefilter (QualityRecalibration.cs:197-245):
    mutates the allele in place; subsampled depth/support feed the Poisson
    q-score only. Returns True if an update was applied."""
    from pisces_tpu_torch.domain.types import FilterType

    if cat not in rates:
        return False
    if a.variant_qscore < 1:
        # HaveInfoToUpdateQ false: no value change, but the line still
        # counts as modified (re-serialized) in the reference
        return True
    depth = float(a.total_coverage)
    call_count = float(a.allele_support)

    rate = rates[cat]
    denominator = float(stats.q_to_p(rate))
    sub_to = 1.0 / denominator if denominator > 0 else 0.0
    if rate == 0 or denominator == 0:
        subsample = False
    if subsample and depth > sub_to:
        call_count = call_count * sub_to / depth
        depth = sub_to

    new_q = int(stats.assign_poisson_qscore(
        np.array([int(call_count)]), np.array([int(depth)]), rate,
        min(a.variant_qscore, max_q))[0])

    a.variant_qscore = new_q
    a.genotype_qscore = new_q
    a.noise_level_applied = rate
    if new_q < filter_q and FilterType.LOW_VARIANT_QSCORE not in a.filters:
        a.add_filter(FilterType.LOW_VARIANT_QSCORE)
    return True


def _update_line(v: VcfVariant, basic_rates: Dict[str, int],
                 edge_rates: Dict[str, int], edge_suspect: bool,
                 max_q: int, filter_q: int) -> Optional[str]:
    """Apply basic + edge recalibration to one SNV line; both updates
    mutate the same CalledAllele before one re-serialization (the
    reference applies both to `inAllele`, QualityRecalibration.cs:137-151)."""
    from pisces_tpu_torch.io.vcf_read import to_called_alleles

    cat = mutation_category(v.ref_allele, v.alt_allele, v.filters)
    alleles = to_called_alleles(v)
    if len(alleles) != 1:
        return None
    a = alleles[0]
    updated = _update_allele(a, cat, basic_rates, max_q, filter_q, False)
    if edge_suspect:
        updated |= _update_allele(a, cat, edge_rates, max_q, filter_q, True)
    return _format_allele_line(a) if updated else None


def recalibrate_vcf(vcf_path: str, out_dir: Optional[str] = None,
                    z_factor: float = 2.0, max_q: int = 100,
                    filter_q: int = 30, baseline_q: int = 20,
                    do_basic: bool = True, do_edge: bool = False,
                    extent: int = 4, loci_count: int = -1,
                    align_warn_threshold: float = 10.0) -> str:
    out_dir = out_dir or os.path.dirname(vcf_path)
    os.makedirs(out_dir, exist_ok=True)
    basic, edge = strain_vcf(vcf_path, extent, loci_count)

    stem = os.path.basename(vcf_path)
    write_counts_file(os.path.join(out_dir, stem.replace(".vcf", ".counts")),
                      basic)
    if do_edge:
        write_counts_file(os.path.join(out_dir, stem.replace(".vcf", ".edgecounts")),
                          edge)

    basic_rates = get_phred_scaled_calibrated_rates(baseline_q, z_factor, basic) \
        if do_basic else {}
    # the edge update is gated on the category exceeding the z-threshold in
    # the EDGE counts (AmpliconEdgeVariantsLookupTable, QualityRecalibration
    # .cs:108,145) but applies the edge-risk rate (EdgeRiskLookupTable, :125)
    edge_gate = get_phred_scaled_calibrated_rates(baseline_q, z_factor, edge) \
        if do_edge else {}
    edge_risk = get_edge_risk_rates(baseline_q, align_warn_threshold, basic,
                                    edge) if (do_basic and do_edge) else {}
    edge_rates = {c: edge_risk[c] for c in edge_gate if c in edge_risk}

    out_path = os.path.join(out_dir, stem + ".recal")
    return _apply_recalibration(vcf_path, out_path, basic_rates, edge_rates,
                                edge.suspects, max_q, filter_q,
                                do_basic, do_edge)


def recalibrate_with_counts(vcf_path: str, counts_path: str,
                            out_dir: Optional[str] = None,
                            z_factor: float = 2.0, max_q: int = 100,
                            filter_q: int = 30, baseline_q: int = 20) -> str:
    """QualityRecalibration.Recalibrate with a precomputed .counts file
    (QualityRecalibration.cs:26-56 + CountsFileReader)."""
    out_dir = out_dir or os.path.dirname(vcf_path)
    os.makedirs(out_dir, exist_ok=True)
    counts = read_counts_file(counts_path)
    rates = get_phred_scaled_calibrated_rates(baseline_q, z_factor, counts)
    out_path = os.path.join(out_dir, os.path.basename(vcf_path) + ".recal")
    return _apply_recalibration(vcf_path, out_path, rates, {}, {}, max_q,
                                filter_q, True, False)


def _vqr_adjusted_header(header: List[str], cmdline: str) -> List[str]:
    """VQRVcfWriter.WriteHeader + AdjustHeaderLines (VQRVcfWriter.cs:42-110):
    filters the default Pisces writer config would emit but the original
    header lacks (or words differently) are inserted after the last
    ##FILTER line with a ', by VQR' suffix; the VQR version + cmdline
    lines go after the first four original header lines."""
    from pisces_tpu_torch.io.vcf_write import VcfFormatter, VcfWriterConfig
    from pisces_tpu_torch.io.vcf_read import parse_filter_string
    from pisces_tpu_torch.options import PiscesApplicationOptions
    from pisces_tpu_torch.domain.types import FilterType

    opts = PiscesApplicationOptions()
    opts.vcf_writing_parameters.output_gvcf_file = True
    gen = dict(VcfFormatter(VcfWriterConfig(opts)).generate_filter_strings())
    for ft in (FilterType.RMXN, FilterType.INDEL_REPEAT_LENGTH,
               FilterType.NO_CALL):
        gen.pop(ft, None)

    orig = {}
    for line in header:
        if line.startswith("##FILTER"):
            fid = line.split(",")[0].replace("##FILTER=<ID=", "")
            types = parse_filter_string(fid)
            if len(types) == 1 and types[0] not in orig:
                orig[types[0]] = line

    out = list(header)
    last = -1
    for i, l in enumerate(out):
        if "##FILTER" in l:
            last = i
    if last == -1:
        last = max(len(out) - 2, -1)
    for ft, line in gen.items():
        if ft not in orig or line.strip() != orig[ft].strip():
            last += 1
            out.insert(last, line.replace('">', ', by VQR">'))

    offset = min(4, len(out) - 1)
    return (out[:offset]
            + ["##VariantQualityRecalibrator=VQR 1.0.0.0", cmdline]
            + out[offset:])


def _apply_recalibration(vcf_path: str, out_path: str, basic_rates,
                         edge_rates, edge_suspects, max_q: int, filter_q: int,
                         do_basic: bool, do_edge: bool) -> str:
    def update(group: List[VcfVariant]):
        changed = False
        out_lines = []
        for v in group:
            line = None
            # skip refs / non-SNVs / forced (CanSkipVcfLine)
            if (v.alt_allele != "." and len(v.ref_allele) == 1
                    and len(v.alt_allele) == 1
                    and "forcedreport" not in v.filters.lower()):
                suspect = (do_edge and bool(edge_rates)
                           and v.position in edge_suspects.get(v.chrom, []))
                line = _update_line(v, basic_rates if do_basic else {},
                                    edge_rates, suspect, max_q, filter_q)
            if line is not None:
                changed = True
                out_lines.append(line)
            else:
                out_lines.append(v.raw_line)
        return out_lines if changed else None

    cmdline = f"##VQR_cmdline=\"-vcf {vcf_path}\""
    update_vcf_loci_by_loci(
        vcf_path, out_path, update,
        header_list_fn=lambda h: _vqr_adjusted_header(h, cmdline))
    return out_path


def main(argv=None) -> int:
    """VQR CLI with the reference flag surface (VQROptionsParser.cs:
    vcf/o/log, z, q, f, b, locicount, dobasicchecks,
    doampliconpositionchecks, extentofedgeregion,
    alignmentwarningthreshold), case-insensitive."""
    from pisces_tpu_torch.apps._pisces_main import _normalize

    def _b(s) -> bool:
        return str(s).strip().lower() in ("true", "1", "yes")

    p = argparse.ArgumentParser(prog="vqr",
                                description="variant quality recalibration")
    p.add_argument("-vcf", required=True)
    p.add_argument("-o", "-out", "-outfolder", dest="out", default=None)
    p.add_argument("-log", default=None)
    p.add_argument("-z", "-zfactor", dest="zfactor", type=float, default=2.0)
    p.add_argument("-q", "-maxqscore", dest="maxqscore", type=int, default=100)
    p.add_argument("-f", "-filterqscore", dest="filterqscore", type=int,
                   default=30)
    p.add_argument("-b", "-baseqnoise", dest="baseqnoise", type=int,
                   default=20)
    p.add_argument("-dobasicchecks", default="true")
    p.add_argument("-doampliconpositionchecks", "-doedgecounts",
                   dest="doedgechecks", default="false")
    p.add_argument("-extentofedgeregion", type=int, default=4)
    p.add_argument("-locicount", type=int, default=-1)
    p.add_argument("-alignmentwarningthreshold", type=float, default=10.0)
    args = p.parse_args(_normalize(list(argv if argv is not None
                                        else sys.argv[1:])))
    recalibrate_vcf(args.vcf, args.out, args.zfactor, args.maxqscore,
                    args.filterqscore, args.baseqnoise,
                    do_basic=_b(args.dobasicchecks),
                    do_edge=_b(args.doedgechecks),
                    extent=args.extentofedgeregion, loci_count=args.locicount,
                    align_warn_threshold=args.alignmentwarningthreshold)
    return 0


if __name__ == "__main__":
    sys.exit(main())
