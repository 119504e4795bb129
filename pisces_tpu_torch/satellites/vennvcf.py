"""VennVcf: pairwise Venn intersection of two VCFs + consensus building.

Port of exe/VennVcf (VennVcf.cs:100-540 pairwise streaming/pairing,
ConsensusBuilder.cs:36-500 consensus scoring with pooled Poisson q-scores and
probe-pool bias computed through the strand-bias machinery with pools as
strands).
"""
from __future__ import annotations

import argparse
import math
import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from pisces_tpu_torch.domain.types import (
    AlleleCategory, FilterType, Genotype, StrandBiasModel,
)
from pisces_tpu_torch.calling.alleles import CalledAllele
from pisces_tpu_torch.ops import stats
from pisces_tpu_torch.io.vcf_read import (
    VcfVariant, iter_colocated, read_header_and_variants, to_called_alleles,
)

AGREED_ON_REFERENCE = 0
AGREED_ON_ALTERNATE = 1
ONE_REFERENCE_ONE_ALTERNATE = 2
CAN_NOT_COMBINE = 3


def get_comparison_case(a: Optional[CalledAllele], b: Optional[CalledAllele]) -> int:
    if a is None or b is None:
        return CAN_NOT_COMBINE
    ref_a = a.category == AlleleCategory.REFERENCE
    ref_b = b.category == AlleleCategory.REFERENCE
    if ref_a and ref_b:
        return AGREED_ON_REFERENCE
    if ref_a != ref_b:
        return ONE_REFERENCE_ONE_ALTERNATE
    if (a.ref_allele == b.ref_allele and a.alt_allele == b.alt_allele):
        return AGREED_ON_ALTERNATE
    raise ValueError("unpairable variants submitted for comparison")


def select_pairs(pool_a: List[CalledAllele], pool_b: List[CalledAllele]):
    """VennProcessor.SelectPairs."""
    results = []
    if len(pool_a) == 1 and pool_a[0].category == AlleleCategory.REFERENCE:
        for vb in pool_b:
            results.append((pool_a[0], vb))
        if not pool_b:
            results.append((pool_a[0], None))
    elif len(pool_b) == 1 and pool_b[0].category == AlleleCategory.REFERENCE:
        for va in pool_a:
            results.append((va, pool_b[0]))
        if not pool_a:
            results.append((None, pool_b[0]))
    else:
        matched_b = set()
        for va in pool_a:
            found = False
            for j, vb in enumerate(pool_b):
                if (va.ref_allele == vb.ref_allele
                        and va.alt_allele == vb.alt_allele):
                    results.append((va, vb))
                    matched_b.add(j)
                    found = True
                    break
            if not found:
                results.append((va, None))
        for j, vb in enumerate(pool_b):
            if j not in matched_b:
                results.append((None, vb))
    return results


def _defensive_genotype(v: CalledAllele) -> None:
    if v.genotype in (Genotype.ALT_AND_NOCALL, Genotype.HEMIZYGOUS_ALT):
        v.genotype = Genotype.HOMOZYGOUS_ALT
    if v.genotype in (Genotype.REF_AND_NOCALL, Genotype.HEMIZYGOUS_REF):
        v.genotype = Genotype.HOMOZYGOUS_REF
    if v.genotype == Genotype.HEMIZYGOUS_NOCALL:
        v.genotype = Genotype.REF_LIKE_NOCALL


def _has_ref_allele(v: CalledAllele) -> bool:
    return v.genotype in (Genotype.REF_AND_NOCALL, Genotype.HOMOZYGOUS_REF,
                          Genotype.HEMIZYGOUS_REF, Genotype.HETEROZYGOUS_ALT_REF)


def _has_alt_allele(v: CalledAllele) -> bool:
    return v.genotype in (Genotype.ALT_AND_NOCALL, Genotype.HOMOZYGOUS_ALT,
                          Genotype.HETEROZYGOUS_ALT1_ALT2,
                          Genotype.HETEROZYGOUS_ALT_REF)


def _combine_nl(a, b) -> int:
    if a is None:
        return b.noise_level_applied
    if b is None:
        return a.noise_level_applied
    if a.noise_level_applied == b.noise_level_applied:
        return a.noise_level_applied
    p1 = float(stats.q_to_p(a.noise_level_applied))
    p2 = float(stats.q_to_p(b.noise_level_applied))
    return int(round(float(stats.p_to_q((p1 + p2) / 2.0))))


def _poisson_q(count, depth, noise, maxq) -> int:
    return int(stats.assign_poisson_qscore(np.array([count]), np.array([depth]),
                                           noise, maxq)[0])


class ConsensusBuilder:
    """ConsensusBuilder.cs. NOTE: the default min_frequency_filter is -1,
    the UNVALIDATED VariantCallingParameters default
    (VariantCallingParameters.cs:60) — VennProcessor is constructed without
    Validate() in the reference, so a one-sided ref (vf 0 is NOT < -1)
    genotypes as ./. (AltLikeNoCall) rather than 0/0. Tests that set the
    filter explicitly (HG19/C64, 0.03) get 0/0 instead."""

    def __init__(self, min_frequency=0.01, min_frequency_filter=-1.0,
                 min_coverage=10, max_qscore=100,
                 probe_pool_bias_threshold=0.5):
        self.min_frequency = min_frequency
        self.min_frequency_filter = min_frequency_filter
        self.min_coverage = min_coverage
        self.max_qscore = max_qscore
        self.pb_threshold = probe_pool_bias_threshold

    def combine(self, a: Optional[CalledAllele], b: Optional[CalledAllele],
                case: int) -> CalledAllele:
        src = a if a is not None else b
        cons = CalledAllele(src.chromosome, src.position, src.ref_allele,
                            src.alt_allele, src.category)
        for v in (a, b):
            if v is not None:
                _defensive_genotype(v)
                cons.ref_allele = v.ref_allele

        # reference/alt combining: prefer the longer ref representation
        if a is not None and b is not None and len(a.ref_allele) != len(b.ref_allele):
            longer = a if len(a.ref_allele) > len(b.ref_allele) else b
            cons.ref_allele = longer.ref_allele
            cons.alt_allele = longer.alt_allele
        elif case in (AGREED_ON_ALTERNATE, CAN_NOT_COMBINE):
            alt_src = a if (a is not None and not a.is_ref_type) else \
                (b if b is not None and not b.is_ref_type else src)
            cons.ref_allele = alt_src.ref_allele
            cons.alt_allele = alt_src.alt_allele
        elif case == ONE_REFERENCE_ONE_ALTERNATE:
            alt_src = a if (a is not None and not a.is_ref_type) else b
            cons.ref_allele = alt_src.ref_allele
            cons.alt_allele = alt_src.alt_allele

        # combine filters
        cons.filters = []
        for v in (a, b):
            if v is not None:
                for f in v.filters:
                    if f not in cons.filters:
                        cons.filters.append(f)

        ref_a = a.reference_support if a is not None else 0
        ref_b = b.reference_support if b is not None else 0
        alt_a = 0 if (a is None or a.is_ref_type) else a.allele_support
        alt_b = 0 if (b is None or b.is_ref_type) else b.allele_support
        dp_a = a.total_coverage if a is not None else 0
        dp_b = b.total_coverage if b is not None else 0

        total = dp_a + dp_b
        ref_depth = ref_a + ref_b
        alt_depth = alt_a + alt_b
        vf = 0.0 if (alt_depth == 0 or total == 0) else alt_depth / total
        vf_a = 0.0 if (alt_a == 0 or dp_a == 0) else alt_a / dp_a
        vf_b = 0.0 if (alt_b == 0 or dp_b == 0) else alt_b / dp_b

        cons.total_coverage = total
        cons.allele_support = alt_depth
        cons.reference_support = ref_depth
        cons.noise_level_applied = _combine_nl(a, b)
        if a is not None and b is not None:
            # C# Math.Max propagates NaN
            if math.isnan(a.strand_bias_gatk) or math.isnan(b.strand_bias_gatk):
                cons.strand_bias_gatk = float("nan")
            else:
                cons.strand_bias_gatk = max(a.strand_bias_gatk,
                                            b.strand_bias_gatk)
        else:
            cons.strand_bias_gatk = src.strand_bias_gatk

        gt = self._genotype(a, b, case, total, vf, vf_a, vf_b)

        alt_changed_to_ref = False
        if (gt in (Genotype.HOMOZYGOUS_REF, Genotype.REF_LIKE_NOCALL)
                and case == ONE_REFERENCE_ONE_ALTERNATE):
            cons.alt_allele = "."
            cons.ref_allele = cons.ref_allele[:1]
            cons.allele_support = cons.reference_support
            alt_changed_to_ref = True
        cons.genotype = gt

        # LowDP on consensus rows comes ONLY from the input lines' filters
        # (CombineFilters = MergeFilters union, ConsensusBuilder.cs:485-488)
        self._pool_bias(cons, case, alt_a, alt_b, dp_a, dp_b, alt_changed_to_ref)
        # per-pool component alleles for the debug columns (VennVcfFormatter.
        # AddCustomTags prints each component's OWN Frequency/AlleleSupport/
        # TotalCoverage — for ref components that is the REF-supporting
        # frequency and count, not 0)
        cons.pool_stats = (
            None if a is None else (a.frequency, a.allele_support,
                                    a.total_coverage),
            None if b is None else (b.frequency, b.allele_support,
                                    b.total_coverage))

        if case == AGREED_ON_REFERENCE or alt_changed_to_ref or \
                (case == CAN_NOT_COMBINE and alt_depth == 0):
            cons.variant_qscore = _poisson_q(ref_depth, total,
                                             cons.noise_level_applied,
                                             self.max_qscore)
        else:
            cons.variant_qscore = _poisson_q(alt_depth, total,
                                             cons.noise_level_applied,
                                             self.max_qscore)
        cons.genotype_qscore = cons.variant_qscore
        # Consensus.SetType() (ConsensusBuilder.cs:243): recompute the
        # category from the combined ref/alt strings
        if cons.alt_allele in (".", cons.ref_allele):
            cons.category = AlleleCategory.REFERENCE
            cons.allele_support = cons.reference_support
        else:
            from pisces_tpu_torch.io.vcf_read import classify
            cons.category = classify(cons.ref_allele, cons.alt_allele)
        return cons

    def _genotype(self, a, b, case, total, vf, vf_a, vf_b) -> Genotype:
        ref_present = any(v is not None and _has_ref_allele(v) for v in (a, b))
        alt_present = any(v is not None and _has_alt_allele(v) for v in (a, b))
        if not alt_present and ref_present:
            gt = Genotype.HOMOZYGOUS_REF
        elif alt_present and ref_present:
            gt = Genotype.HETEROZYGOUS_ALT_REF
        elif alt_present:
            gt = Genotype.HOMOZYGOUS_ALT
        else:
            return Genotype.REF_LIKE_NOCALL

        if case != AGREED_ON_REFERENCE:
            if vf < self.min_frequency:
                if vf_a < self.min_frequency_filter and vf_b < self.min_frequency_filter:
                    gt = Genotype.HOMOZYGOUS_REF
                else:
                    gt = Genotype.ALT_LIKE_NOCALL
            elif vf < self.min_frequency_filter:
                gt = Genotype.ALT_LIKE_NOCALL
        elif total < self.min_coverage:
            gt = Genotype.REF_LIKE_NOCALL
        return gt

    def _pool_bias(self, cons, case, alt_a, alt_b, dp_a, dp_b,
                   alt_changed_to_ref):
        cons.pool_bias_gatk = -100.0
        cons.pool_bias_score = 0.0
        if alt_changed_to_ref or case == AGREED_ON_REFERENCE:
            return
        if case in (ONE_REFERENCE_ONE_ALTERNATE, CAN_NOT_COMBINE):
            cons.add_filter(FilterType.POOL_BIAS)
            cons.pool_bias_gatk = 0.0
            cons.pool_bias_score = 1.0
            return
        sb = stats.compute_strand_bias(
            np.array([[alt_a, alt_b, 0]]), np.array([[dp_a, dp_b, 0]]),
            cons.noise_level_applied, self.min_frequency, self.pb_threshold,
            int(StrandBiasModel.EXTENDED))
        cons.pool_bias_gatk = float(np.clip(sb["gatk_bias_score"][0], -100, 0))
        cons.pool_bias_score = float(min(1.0, sb["bias_score"][0]))
        if not sb["bias_acceptable"][0]:
            cons.add_filter(FilterType.POOL_BIAS)


def _read_loci(path: str):
    _, variants = read_header_and_variants(path)
    for group in iter_colocated(variants):
        alleles = []
        for v in group:
            alleles.extend(to_called_alleles(v))
        yield (group[0].chrom, group[0].position), alleles, group


def guess_sample_name(filename: str) -> Tuple[str, str]:
    """VennProcessor.GuessSampleNameFromVcf (VennVcf.cs:72-91)."""
    import re
    m = re.match(r"^(.+)_S(\d+)(.genome)?(.cftr)?.vcf(.gz)?$", filename,
                 re.IGNORECASE)
    if m:
        return m.group(1), "S" + m.group(2)
    trimmed = (filename.replace(".vcf", "").replace(".gz", "")
               .replace(".genome", ""))
    return trimmed, trimmed


def _venn_file_name(out_dir, op, names, nums, i, j):
    """VennProcessor.GetVennFileName (VennVcf.cs:307-327)."""
    if names[i] == names[j]:
        if nums[i] != nums[j]:
            fn = f"{names[i]}_{nums[i]}_{op}_{nums[j]}.vcf"
        else:
            fn = f"{names[i]}_{nums[i]}_dir{i}_{op}_{nums[j]}_dir{j}.vcf"
    else:
        fn = f"{names[i]}_{op}_{names[j]}.vcf"
    return os.path.join(out_dir, fn)


def do_pairwise_venn(path_a: str, path_b: str, out_dir: str,
                     consensus: bool = True,
                     debug: bool = False,
                     min_frequency: float = 0.01,
                     min_frequency_filter: float = -1.0) -> Dict[str, str]:
    """Produces the four A/B and/not venn VCFs + consensus VCF
    (VennProcessor.DoPairwiseVenn). min_frequency_filter defaults to the
    reference's unvalidated -1 (see ConsensusBuilder docstring)."""
    os.makedirs(out_dir, exist_ok=True)
    names, nums = zip(*(guess_sample_name(os.path.basename(p))
                        for p in (path_a, path_b)))
    paths = {
        "a_only": _venn_file_name(out_dir, "not", names, nums, 0, 1),
        "b_only": _venn_file_name(out_dir, "not", names, nums, 1, 0),
        "both": _venn_file_name(out_dir, "and", names, nums, 0, 1),
        "b_and": _venn_file_name(out_dir, "and", names, nums, 1, 0),
        "consensus": os.path.join(out_dir, "Consensus.vcf"),
    }
    header_a, _ = read_header_and_variants(path_a)

    builder = ConsensusBuilder(min_frequency=min_frequency,
                               min_frequency_filter=min_frequency_filter)
    files = {k: open(p, "w", newline="\n") for k, p in paths.items()}
    for k in files:
        for line in header_a:
            files[k].write(line + "\n")

    from pisces_tpu_torch.io.vcf_write import dotnet_format

    def _sb_str(sb: float) -> str:
        if math.isnan(sb):
            return "NaN"  # C# double.NaN.ToString()
        return dotnet_format(max(-100.0, min(0.0, sb)), 4)

    def write_consensus(fh, c: CalledAllele):
        gt = c.genotype_str()
        # ref-like genotypes print ALT "." regardless of the combined alt
        # string (VcfFileWriter ref-line rule, same as write_colocated)
        alt = c.alt_allele
        if (c.category == AlleleCategory.REFERENCE
                or c.genotype in (Genotype.HOMOZYGOUS_REF,
                                  Genotype.REF_LIKE_NOCALL,
                                  Genotype.REF_AND_NOCALL,
                                  Genotype.HEMIZYGOUS_NOCALL,
                                  Genotype.HEMIZYGOUS_REF)):
            alt = "."
        vf = 0.0 if c.total_coverage == 0 else c.allele_support / c.total_coverage
        if c.category == AlleleCategory.REFERENCE:
            vf = 0.0 if c.total_coverage == 0 else 1.0 - (c.reference_support / c.total_coverage)
        filters = ";".join(
            {FilterType.POOL_BIAS: "PB", FilterType.LOW_DEPTH: "LowDP",
             FilterType.LOW_VARIANT_QSCORE: "q30",
             FilterType.STRAND_BIAS: "SB"}.get(f, "Other")
            for f in c.filters) or "PASS"
        # ref rows carry a single AD value (GetAlleleCountString isReference)
        ad = (str(c.allele_support)
              if c.category == AlleleCategory.REFERENCE
              else f"{c.reference_support},{c.allele_support}")
        fmt = "GT:GQ:AD:DP:VF:NL:SB:PB"
        smp = (f"{gt}:{c.genotype_qscore}:"
               f"{ad}:{c.total_coverage}:"
               f"{dotnet_format(vf, 3)}:{c.noise_level_applied}:"
               f"{_sb_str(c.strand_bias_gatk)}:"
               f"{dotnet_format(getattr(c, 'pool_bias_gatk', -100.0), 4)}")
        if debug and getattr(c, "pool_stats", None) is not None:
            comp_a, comp_b = c.pool_stats
            def col(comp, idx, fmt3=False):
                if comp is None:
                    return "NA"
                return dotnet_format(comp[idx], 3) if fmt3 else str(comp[idx])
            fmt += ":VF0:VF1:AD0:AD1:DP0:DP1"
            smp += (f":{col(comp_a, 0, True)}:{col(comp_b, 0, True)}"
                    f":{col(comp_a, 1)}:{col(comp_b, 1)}"
                    f":{col(comp_a, 2)}:{col(comp_b, 2)}")
        fh.write("\t".join([
            c.chromosome, str(c.position), ".", c.ref_allele, alt,
            str(c.variant_qscore), filters, f"DP={c.total_coverage}",
            fmt, smp]) + "\n")

    gen_a = _read_loci(path_a)
    gen_b = _read_loci(path_b)
    item_a = next(gen_a, None)
    item_b = next(gen_b, None)

    def loc_key(item):
        return (item[0][0], item[0][1])

    # chromosome ordering follows input A's ##contig list, falling back to
    # the hg-style forced order then ordinal compare (ChrCompare.cs:9-40,
    # AlleleCompareByLoci built from GetChrListFromVcfHeader, VcfVcf.cs:114)
    contigs = []
    for line in header_a:
        if "##contig=<ID=" in line:
            name = line.split("ID=")[1].split(",")[0]
            if name not in contigs:
                contigs.append(name)
    if not contigs:
        contigs = ["chr1", "chr2", "chr3", "chr4", "chr5, chr6", "chr7",
                   "chr8", "chr9", "chr10", "chr11", "chr12", "chr13",
                   "chr14", "chr15, chr16", "chr17", "chr18", "chr19",
                   "chr20", "chr21", "chr22", "chrX", "chrY", "chrM"]
    chr_rank = {c: i for i, c in enumerate(contigs)}

    def loc_before(x, y):
        """True if locus x orders at-or-before y."""
        cx, cy = x[0], y[0]
        if cx != cy:
            rx, ry = chr_rank.get(cx), chr_rank.get(cy)
            if rx is not None and ry is not None:
                return rx < ry
            return cx < cy  # ordinal, like String.Compare
        return x[1] <= y[1]

    while item_a is not None or item_b is not None:
        if item_b is None or (item_a is not None
                              and loc_before(loc_key(item_a), loc_key(item_b))):
            current = loc_key(item_a)
        else:
            current = loc_key(item_b)
        alleles_a, lines_a = ([], [])
        alleles_b, lines_b = ([], [])
        if item_a is not None and loc_key(item_a) == current:
            alleles_a, lines_a = item_a[1], item_a[2]
            item_a = next(gen_a, None)
        if item_b is not None and loc_key(item_b) == current:
            alleles_b, lines_b = item_b[1], item_b[2]
            item_b = next(gen_b, None)

        pairs = select_pairs(alleles_a, alleles_b)
        consensus_at_locus: List[CalledAllele] = []
        last_ref: Optional[CalledAllele] = None
        for va, vb in pairs:
            case = get_comparison_case(va, vb)
            if case == AGREED_ON_ALTERNATE:
                if va is not None and not va.is_ref_type:
                    files["both"].write(_line_for(va, lines_a) + "\n")
                if vb is not None and not vb.is_ref_type:
                    files["b_and"].write(_line_for(vb, lines_b) + "\n")
            elif va is not None and not va.is_ref_type and (vb is None or vb.is_ref_type):
                files["a_only"].write(_line_for(va, lines_a) + "\n")
            elif vb is not None and not vb.is_ref_type and (va is None or va.is_ref_type):
                files["b_only"].write(_line_for(vb, lines_b) + "\n")
            if consensus:
                cons = builder.combine(va, vb, case)
                if cons.genotype == Genotype.HOMOZYGOUS_REF:
                    if last_ref is None:
                        last_ref = cons
                    else:
                        for f in cons.filters:
                            if f not in last_ref.filters:
                                last_ref.filters.append(f)
                        last_ref.noise_level_applied = min(
                            last_ref.noise_level_applied, cons.noise_level_applied)
                        last_ref.genotype_qscore = min(last_ref.genotype_qscore,
                                                       cons.genotype_qscore)
                        last_ref.variant_qscore = min(last_ref.variant_qscore,
                                                      cons.genotype_qscore)
                        continue
                consensus_at_locus.append(cons)
        # colocated consensus records in (ref, alt) order (AlleleCompareByLoci)
        consensus_at_locus.sort(key=lambda c: (c.ref_allele, c.alt_allele))
        for c in consensus_at_locus:
            write_consensus(files["consensus"], c)

    for fh in files.values():
        fh.close()
    if not consensus:
        os.unlink(paths.pop("consensus"))
    return paths


def _line_for(allele: CalledAllele, lines: List[VcfVariant]) -> str:
    for v in lines:
        if allele.alt_allele in v.alt_allele.split(",") or \
                (allele.is_ref_type and v.alt_allele == "."):
            return v.raw_line
    return lines[0].raw_line if lines else ""


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="venn-vcf")
    p.add_argument("-if", dest="input_files", required=True,
                   help="comma separated pair: a.vcf,b.vcf or [a.vcf,b.vcf]")
    p.add_argument("-o", "--out", "-outfolder", dest="out", required=True)
    p.add_argument("-consensus", default="true")
    p.add_argument("-debug", default="false")
    p.add_argument("-log", default=None, help="log file name base")
    args = p.parse_args(argv)
    files = args.input_files.strip("[]").split(",")
    do_pairwise_venn(files[0].strip(), files[1].strip(), args.out,
                     args.consensus.lower() == "true")
    return 0


if __name__ == "__main__":
    sys.exit(main())
