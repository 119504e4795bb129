"""VCF reading: streaming records, locus grouping, CalledAllele conversion.

Covers the reference's AlleleReader / VcfReader / VcfVariantUtilities layer
(src/lib/Pisces.IO/AlleleReader.cs:1-640, VcfVariantUtilities.cs:1-626)
including crushed-line unpacking, plus the VcfUpdater streaming-rewrite
pattern (VcfUpdater.cs:14-150) used by Psara/VQR/Reformat.
"""
from __future__ import annotations

import gzip
import io
from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, List, Tuple

from pisces_tpu_torch.domain.types import AlleleCategory, Genotype
from pisces_tpu_torch.calling.alleles import CalledAllele


@dataclass
class VcfVariant:
    chrom: str
    position: int
    id: str
    ref_allele: str
    alt_allele: str          # may contain multiple comma-separated alts
    quality: str
    filters: str
    info: str
    format: str = ""
    sample: str = ""
    raw_line: str = ""

    @property
    def info_fields(self) -> Dict[str, str]:
        out = {}
        for kv in self.info.split(";"):
            if "=" in kv:
                k, v = kv.split("=", 1)
                out[k] = v
            elif kv:
                out[kv] = ""
        return out

    @property
    def genotypes(self) -> Dict[str, str]:
        if not self.format or not self.sample:
            return {}
        return dict(zip(self.format.split(":"), self.sample.split(":")))

    def to_line(self) -> str:
        fields = [self.chrom, str(self.position), self.id, self.ref_allele,
                  self.alt_allele, self.quality, self.filters, self.info]
        if self.format:
            fields += [self.format, self.sample]
        return "\t".join(fields)


def open_maybe_gzip(path: str):
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"))
    return open(path)


def parse_vcf_line(line: str) -> VcfVariant:
    f = line.rstrip("\n").split("\t")
    return VcfVariant(
        chrom=f[0], position=int(f[1]), id=f[2], ref_allele=f[3],
        alt_allele=f[4], quality=f[5], filters=f[6], info=f[7],
        format=f[8] if len(f) > 8 else "",
        sample=f[9] if len(f) > 9 else "",
        raw_line=line.rstrip("\n"))


def read_header_and_variants(path: str) -> Tuple[List[str], Iterator[VcfVariant]]:
    fh = open_maybe_gzip(path)
    header = []
    pos = 0
    for line in fh:
        # a UTF-8 BOM may precede the first header line; treat it as part
        # of the header (the reference passes it through byte-for-byte)
        if line.lstrip("﻿").startswith("#"):
            header.append(line.rstrip("\n"))
        else:
            fh.seek(0)
            break
    def gen():
        for line in fh:
            if line.lstrip("﻿").startswith("#"):
                continue
            if line.strip():
                yield parse_vcf_line(line)
        fh.close()
    return header, gen()


def iter_colocated(variants: Iterable[VcfVariant]) -> Iterator[List[VcfVariant]]:
    """Group consecutive records with the same (chrom, position)."""
    group: List[VcfVariant] = []
    for v in variants:
        if group and (v.chrom != group[0].chrom
                      or v.position != group[0].position):
            yield group
            group = []
        group.append(v)
    if group:
        yield group


def _genotype_from_string(gt: str, n_alts: int = 1) -> Genotype:
    """VcfVariantUtilities.MapGTString (VcfVariantUtilities.cs:503-544):
    phase separators are normalized away; unknown strings map to
    RefLikeNoCall."""
    gt = gt.replace("|", "/")
    mapping = {
        "1/1": Genotype.HOMOZYGOUS_ALT, "0/0": Genotype.HOMOZYGOUS_REF,
        "0/1": Genotype.HETEROZYGOUS_ALT_REF, "1/0": Genotype.HETEROZYGOUS_ALT_REF,
        "1/2": Genotype.HETEROZYGOUS_ALT1_ALT2,
        "2/1": Genotype.HETEROZYGOUS_ALT1_ALT2,
        "0/.": Genotype.REF_AND_NOCALL, "./0": Genotype.REF_AND_NOCALL,
        "1/.": Genotype.ALT_AND_NOCALL, "./1": Genotype.ALT_AND_NOCALL,
        "0": Genotype.HEMIZYGOUS_REF, "1": Genotype.HEMIZYGOUS_ALT,
        ".": Genotype.HEMIZYGOUS_NOCALL,
        "*/*": Genotype.OTHERS, "2/2": Genotype.OTHERS,
    }
    if gt in mapping:
        return mapping[gt]
    if gt == "./.":
        if n_alts == 0:
            return Genotype.REF_LIKE_NOCALL
        if n_alts == 1:
            return Genotype.ALT_LIKE_NOCALL
        return Genotype.ALT12_LIKE_NOCALL
    return Genotype.REF_LIKE_NOCALL


def trim_trailing_bases(ref: str, alt: str) -> Tuple[str, str]:
    """Uncrush normalization: remove shared trailing bases down to length 1."""
    while len(ref) > 1 and len(alt) > 1 and ref[-1] == alt[-1]:
        ref = ref[:-1]
        alt = alt[:-1]
    return ref, alt


def classify(ref: str, alt: str) -> AlleleCategory:
    if alt in (".", ref):
        return AlleleCategory.REFERENCE
    if len(ref) == len(alt):
        return AlleleCategory.SNV if len(alt) == 1 else AlleleCategory.MNV
    if len(ref) == 1 and len(alt) > 1:
        return AlleleCategory.INSERTION
    if len(alt) == 1 and len(ref) > 1:
        return AlleleCategory.DELETION
    return AlleleCategory.UNSUPPORTED


def _filter_threshold(tag: str) -> int:
    """VcfVariantUtilities.LookForThresholdValue: int value of tag[1:], -1 if
    unparsable (reference: VcfVariantUtilities.cs:475-480)."""
    try:
        return int(tag[1:])
    except ValueError:
        return -1


def parse_filter_string(filters: str) -> list:
    """Inverse of VcfFormatter's filter-string mapping, matching
    VcfVariantUtilities.MapFilterString (VcfVariantUtilities.cs:404-472):
    case-insensitive, and any unrecognised non-PASS tag maps to
    FilterType.UNKNOWN so the allele reads as non-passing downstream
    (Scylla's PassingVariantsOnly checks Filters.Count == 0,
    NeighborhoodBuilder.cs:175-180)."""
    from pisces_tpu_torch.domain.types import FilterType
    out = []
    if not filters:
        return out
    fs = filters.strip().lower()
    if fs in (".", "", "pass"):
        return out
    for tag in fs.split(";"):
        tag = tag.strip()
        if tag in (".", ""):
            continue
        thr = _filter_threshold(tag)
        if "lowq" in tag or (tag[0] == "q" and thr > 0):
            out.append(FilterType.LOW_VARIANT_QSCORE)
        elif tag == "pb":
            out.append(FilterType.POOL_BIAS)
        elif tag == "sb":
            out.append(FilterType.STRAND_BIAS)
        elif tag == "ab":
            out.append(FilterType.AMPLICON_BIAS)
        elif tag in ("lowdp", "lowdepth"):
            out.append(FilterType.LOW_DEPTH)
        elif tag in ("lowvariantfreq", "lowfreq"):
            out.append(FilterType.LOW_VARIANT_FREQUENCY)
        elif tag == "lowgq" or tag[:2] == "gq":
            out.append(FilterType.LOW_GENOTYPE_QUALITY)
        elif tag[0] == "r" and thr > 0:
            out.append(FilterType.INDEL_REPEAT_LENGTH)
        elif _is_rmxn(tag):
            out.append(FilterType.RMXN)
        elif tag == "multiallelicsite":
            out.append(FilterType.MULTI_ALLELIC_SITE)
        elif tag == "forcedreport":
            out.append(FilterType.FORCED_REPORT)
        elif tag == "nc":
            out.append(FilterType.NO_CALL)
        elif tag != "pass":
            out.append(FilterType.UNKNOWN)
    return out


def _is_rmxn(tag: str) -> bool:
    """VcfVariantUtilities.IsRMxN (VcfVariantUtilities.cs:371-395):
    'r<M>x<N>' with both parts integer."""
    if not tag or tag[0] != "r":
        return False
    parts = tag[1:].split("x")
    if len(parts) != 2:
        return False
    try:
        int(parts[0]); int(parts[1])
    except ValueError:
        return False
    return True


def _trim_unsupported(allele) -> None:
    """VcfVariantUtilities.TrimUnsupportedAlleleType (VcfVariantUtilities.cs:
    320-354): rescue a complex allele by trimming trailing then preceding
    agreement, always keeping one base of agreement; shifts the position by
    the preceding trim."""
    ref, alt = allele.ref_allele, allele.alt_allele
    n_trail = 0
    while (n_trail < min(len(ref), len(alt)) - 1
           and ref[-1 - n_trail] == alt[-1 - n_trail]):
        n_trail += 1
    ref = ref[:len(ref) - n_trail]
    alt = alt[:len(alt) - n_trail]
    n_pre = 0
    while (n_pre < min(len(ref), len(alt)) - 1
           and ref[n_pre] == alt[n_pre]):
        n_pre += 1
    ref, alt = ref[n_pre:], alt[n_pre:]
    allele.ref_allele, allele.alt_allele = ref, alt
    allele.position += n_pre
    allele.category = classify(ref, alt)


def to_called_alleles(v: VcfVariant,
                      should_trim: bool = False) -> List[CalledAllele]:
    """AlleleReader.ConvertColumnsToVariant-style conversion incl.
    crushed-line unpacking (AlleleReader.cs:93-250). Alleles keep their raw
    REF/ALT strings — the reference never normalizes trailing agreement;
    only Unsupported complex types are rescued, and only when should_trim
    is set (the AlleleReader constructor default is False)."""
    alts = v.alt_allele.split(",")
    gts = v.genotypes
    out: List[CalledAllele] = []
    real_alts = [a for a in alts if a not in ("<M>", ".", "*")]

    ad_values = gts.get("AD", "").split(",") if "AD" in gts else []
    dp = int(gts.get("DP", v.info_fields.get("DP", "0")) or 0)
    vf_values = gts.get("VF", "").split(",") if "VF" in gts else []

    n_real = max(len(real_alts), 1)
    alt_index = 0
    for alt in alts:
        if alt in ("<M>", "*"):
            continue
        if alt == ".":
            ref, a = v.ref_allele, "."
            cat = AlleleCategory.REFERENCE
        else:
            ref, a = v.ref_allele, alt
            cat = classify(ref, a)
        allele = CalledAllele(v.chrom, v.position, ref,
                              a if a != "." else ref, cat)
        allele.variant_qscore = int(float(v.quality)) if v.quality not in (".", "") else 0
        allele.total_coverage = dp
        allele.filters = parse_filter_string(v.filters)
        if "GT" in gts:
            # numAlts counts every entry in the ALT column (AlleleReader.cs:
            # 131-140), 0 when this allele is the ref line
            allele.genotype = _genotype_from_string(
                gts["GT"], 0 if alt == "." else len(alts))
        if "GQ" in gts:
            try:
                allele.genotype_qscore = int(float(gts["GQ"]))
            except ValueError:
                pass
        if "NL" in gts:
            try:
                allele.noise_level_applied = int(gts["NL"])
            except ValueError:
                pass
        if "SB" in gts:
            try:
                allele.strand_bias_gatk = float(gts["SB"])
            except ValueError:
                pass
        else:
            # AlleleReader.cs:115 defaults GATK strand bias to -100
            allele.strand_bias_gatk = -100.0
        # AD semantics per AlleleReader.ConvertColumnsToVariant
        # (AlleleReader.cs:176-217): ref lines read AD[0] as ref support;
        # single-alt lines are refSupport,altSupport; on multi-alt lines
        # whose AD has no more entries than alts (CRUSHED format), ref
        # support is derived as max(0, DP - sum of the per-alt ADs) and
        # each allele's support is AD[its full alt-list index].
        def _ad(i):
            try:
                return int(ad_values[i])
            except (IndexError, ValueError):
                return 0
        if cat == AlleleCategory.REFERENCE:
            if ad_values and ad_values[0]:
                allele.allele_support = _ad(0)
                allele.reference_support = allele.allele_support
            if vf_values and vf_values[0]:
                # VF on ref lines is the non-ref fraction
                pass
        else:
            ref_support = _ad(0)
            alt_support = _ad(1) if len(ad_values) > 1 else 0
            num_alts = len(alts)
            if num_alts >= 2 and "AD" in gts:
                full_index = alts.index(alt)
                if len(ad_values) <= num_alts:
                    total_alt = sum(_ad(j) for j in range(num_alts))
                    alt_support = _ad(full_index)
                    ref_support = max(0, dp - total_alt)
                # else: AD lists ref first; keep AD[0]/AD[1] (reference
                # keeps altSupport = AD[1] for every allele of the line)
            allele.reference_support = ref_support
            allele.allele_support = alt_support
            alt_index += 1
        if should_trim and allele.category == AlleleCategory.UNSUPPORTED:
            _trim_unsupported(allele)
        out.append(allele)
    return out


def read_alleles(path: str) -> Iterator[CalledAllele]:
    _, variants = read_header_and_variants(path)
    for v in variants:
        for a in to_called_alleles(v):
            yield a


# ---------------------------------------------------------------------------
# Streaming rewrite (VcfUpdater equivalent)
# ---------------------------------------------------------------------------

def update_vcf_loci_by_loci(in_path: str, out_path: str, update_fn,
                            header_fn=None, header_list_fn=None) -> None:
    """Stream a VCF, apply update_fn(group: List[VcfVariant]) ->
    Optional[List[str]] per co-located group (None = keep original lines,
    [] = delete), write result. header_fn may transform header lines;
    header_list_fn may restructure the whole header list first."""
    header, variants = read_header_and_variants(in_path)
    if header_list_fn is not None:
        header = header_list_fn(list(header))
    with open(out_path, "w", newline="\n") as out:
        for line in header:
            if header_fn is not None:
                line = header_fn(line)
                if line is None:
                    continue
            out.write(line + "\n")
        for group in iter_colocated(variants):
            result = update_fn(group)
            if result is None:
                for v in group:
                    out.write(v.raw_line + "\n")
            else:
                for line in result:
                    out.write(line + "\n")
