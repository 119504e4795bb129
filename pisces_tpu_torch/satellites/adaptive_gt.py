"""AdaptiveGenotyper tool: two-pass germline re-genotyper.

Port of src/tools/AdaptiveGenotyper (Program.cs:10-55, Recalibration.cs:1-104,
VariantReader.cs): reads a Pisces gVCF, fits the binomial MixtureModel to
(AD, DP) observations genome-wide (separately for SNVs and indels), and
rewrites GT/GQ/GP per locus.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional, Tuple

import numpy as np

from pisces_tpu_torch.domain.types import AlleleCategory
from pisces_tpu_torch.genotype import adaptive
from pisces_tpu_torch.io.vcf_read import (
    VcfVariant, read_header_and_variants, update_vcf_loci_by_loci,
)

GT_STRINGS = {0: "0/0", 1: "0/1", 2: "1/1"}


# --- faithful port of VariantReader.GetVariantFrequencies ------------------
# (tools/AdaptiveGenotyper/VariantReader.cs:36-307). Reference lines with
# non-ref VF < 0.02 are SKIPPED (only noisy refs feed the hom-ref
# component); refs that survive go to BOTH collections; MNVs count as
# indels; non-digit chromosomes (chrX/chrY/chrM) are excluded; multi-
# allelic and within-deletion loci get the reference's special handling.

_MULTIALLELIC_THRESHOLD = 0.8
_HET_THRESHOLD = 0.2
_HOMALT_THRESHOLD = 0.7


def _has_alt(a) -> bool:
    from pisces_tpu_torch.domain.types import Genotype
    return a.genotype in (Genotype.ALT_AND_NOCALL, Genotype.HOMOZYGOUS_ALT,
                          Genotype.HETEROZYGOUS_ALT1_ALT2,
                          Genotype.HETEROZYGOUS_ALT_REF)


def _alt_support(a) -> int:
    """VariantReader.GetAlternateAlleleSupport."""
    if _has_alt(a):
        return a.allele_support
    return a.total_coverage - a.allele_support


def _alt_vf(a) -> float:
    """VariantReader.GetAlternateAlleleFrequency."""
    if _has_alt(a):
        return a.frequency
    if a.total_coverage == 0:
        return float("nan")
    return _alt_support(a) / a.total_coverage


def _variant_type(a) -> str:
    """VariantReader.GetVariantType: SNVs only; any longer allele (incl.
    MNVs) is 'indel'; ref rows are 'none'."""
    if a.category == AlleleCategory.REFERENCE:
        return "none"
    if a.category == AlleleCategory.SNV:
        return "snv"
    if len(a.ref_allele) > 1 or len(a.alt_allele) > 1:
        return "indel"
    return "error"


def _should_skip(a) -> bool:
    """VariantReader.ShouldSkipVariant (VariantReader.cs:248-266)."""
    from pisces_tpu_torch.domain.types import FilterType
    if FilterType.LOW_DEPTH in a.filters:
        return True
    vf = _alt_vf(a)
    if vf < 0.02 and len(a.ref_allele) == len(a.alt_allele):
        return True
    if len(a.ref_allele) != len(a.alt_allele) and vf == 1:
        return True
    return False


class _Collection:
    """RecalibratedVariantsCollection (ad/dp lists keyed by chr:pos)."""

    def __init__(self):
        self.keys: List[str] = []
        self.ad: List[int] = []
        self.dp: List[int] = []

    def add(self, a) -> None:
        dp = a.total_coverage
        ad = _alt_support(a)
        if dp >= adaptive.MAX_EFFECTIVE_DEPTH:
            ad = int(ad / dp * adaptive.MAX_EFFECTIVE_DEPTH)
            dp = adaptive.MAX_EFFECTIVE_DEPTH
        self.keys.append(f"{a.chromosome}:{a.position}")
        self.ad.append(ad)
        self.dp.append(dp)

    def remove_last(self) -> None:
        self.keys.pop()
        self.ad.pop()
        self.dp.pop()


def _read_uncrushed_alleles(vcf_path: str):
    from pisces_tpu_torch.io.vcf_read import to_called_alleles
    _, variants = read_header_and_variants(vcf_path)
    for v in variants:
        alleles = to_called_alleles(v)
        if len(alleles) > 1:
            raise ValueError("Input file should not have crushed variants")
        if alleles:
            yield alleles[0]


def _process_multiallelic(last_var, variant, nxt, snv: _Collection,
                          indel: _Collection):
    """VariantReader.ProcessMultiAllelicVariant (VariantReader.cs:171-246)."""
    variants = [last_var, variant]
    vf = [_alt_vf(last_var), _alt_vf(variant)]
    top = sorted(range(2), key=lambda i: vf[i])
    top.reverse()
    ref_vf = 1 - vf[0] - vf[1]

    curr = 2
    while True:
        variant = nxt()
        if variant is None or not (variant.chromosome == last_var.chromosome
                                   and variant.position == last_var.position):
            break
        variants.append(variant)
        new_vf = _alt_vf(variant)
        vf.append(new_vf)
        if new_vf > vf[top[0]]:
            top[1] = top[0]
            top[0] = curr
        elif new_vf > vf[top[1]]:
            top[1] = curr
        ref_vf -= vf[curr]
        curr += 1
        last_var = variant

    t0 = _variant_type(variants[0])
    if t0 == "snv":
        snv.remove_last()
    elif t0 == "indel":
        indel.remove_last()

    ta, tb = _variant_type(variants[top[0]]), _variant_type(variants[top[1]])
    if ta == "snv" and tb == "snv":
        curr_loci = snv
    elif ta == "indel" and tb == "indel":
        curr_loci = indel
    else:
        return variant

    if ((curr_loci is indel
         or _alt_vf(variants[top[0]]) + _alt_vf(variants[top[1]])
         > _MULTIALLELIC_THRESHOLD
         or _alt_vf(variants[top[0]]) + ref_vf > _MULTIALLELIC_THRESHOLD)
            and not _should_skip(variants[top[0]])
            and not (vf[top[0]] > _HET_THRESHOLD
                     and vf[top[0]] < _HOMALT_THRESHOLD
                     and vf[top[1]] > _HET_THRESHOLD)):
        curr_loci.add(variants[top[0]])
    return variant


def _process_deletion(deletion_var, variant, nxt, snv: _Collection,
                      indel: _Collection):
    """VariantReader.ProcessDeletion (VariantReader.cs:125-169)."""
    from pisces_tpu_torch.domain.types import Genotype
    for _i in range(1, len(deletion_var.ref_allele)):
        if variant is None:
            break
        if _should_skip(variant):
            continue
        if _has_alt(variant):
            (snv if _variant_type(variant) == "snv" else indel).add(variant)
        last_var = variant
        variant = nxt()
        if variant is None:
            break
        if (variant.chromosome == last_var.chromosome
                and variant.position == last_var.position
                and _has_alt(last_var)):
            (snv if _variant_type(last_var) == "snv" else indel).remove_last()
        while (variant is not None
               and variant.position == last_var.position
               and variant.chromosome == last_var.chromosome):
            last_var = variant
            variant = nxt()
        if variant is None:
            break
        if (variant.position > deletion_var.position
                + len(deletion_var.ref_allele) - 1
                and variant.chromosome == deletion_var.chromosome):
            break
    return variant


def get_variant_frequencies(vcf_path: str) -> Tuple[_Collection, _Collection]:
    """VariantReader.GetVariantFrequencies (VariantReader.cs:36-100)."""
    from pisces_tpu_torch.domain.types import Genotype
    snv, indel = _Collection(), _Collection()
    stream = _read_uncrushed_alleles(vcf_path)

    def nxt():
        return next(stream, None)

    last_var = None
    variant = nxt()
    while variant is not None:
        if (last_var is not None
                and variant.chromosome == last_var.chromosome
                and variant.position == last_var.position):
            variant = _process_multiallelic(last_var, variant, nxt, snv, indel)
        if (last_var is not None and variant is not None
                and len(last_var.ref_allele) > 1
                and last_var.genotype != Genotype.HOMOZYGOUS_REF
                and variant.position == last_var.position + 1):
            variant = _process_deletion(last_var, variant, nxt, snv, indel)
        if variant is None:
            break
        if _should_skip(variant) or not any(c.isdigit()
                                            for c in variant.chromosome):
            variant = nxt()
            continue
        vt = _variant_type(variant)
        if vt == "none":
            snv.add(variant)
            indel.add(variant)
        elif vt == "snv":
            snv.add(variant)
        elif vt == "indel":
            indel.add(variant)
        last_var = variant
        variant = nxt()
    return snv, indel


def collect_observations(vcf_path: str):
    snv, indel = get_variant_frequencies(vcf_path)
    return (np.array(snv.ad), np.array(snv.dp),
            np.array(indel.ad), np.array(indel.dp))


def write_model_file(path: str, models) -> None:
    with open(path, "w") as f:
        for means, weights in models:
            f.write(",".join(str(x) for x in means) + "\n")
            f.write(",".join(str(x) for x in weights) + "\n")


def read_model_file(path: str):
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append([float(x) for x in line.split(",")])
    if len(rows) not in (2, 4):
        raise ValueError("Invalid model file")
    models = [(np.array(rows[0]), np.array(rows[1]))]
    if len(rows) == 4:
        models.append((np.array(rows[2]), np.array(rows[3])))
    return models


def make_locus_update(snv_model, indel_model, output_gvcf: bool = False):
    """Adaptive rewrite of one colocated locus (tools/AdaptiveGenotyper/
    LocusProcessor.cs:15-224): pick the top two alleles by frequency; a
    single variant gets the prefit mixture-model genotype/GQ/GP; a true
    multi-allelic het becomes a crushed 1/2 record with multinomial
    posteriors over both models; hom-ref/ref-no-call loci are deleted
    unless emitting gVCF. chrM stays somatic (untouched)."""
    import numpy as np

    from pisces_tpu_torch.domain.types import AlleleCategory, Genotype, PloidyModel
    from pisces_tpu_torch.io.vcf_read import to_called_alleles
    from pisces_tpu_torch.io.vcf_write import VcfFormatter, VcfWriterConfig
    from pisces_tpu_torch.options import PiscesApplicationOptions

    o = PiscesApplicationOptions()
    o.variant_calling_parameters.ploidy_model = PloidyModel.DIPLOID_BY_ADAPTIVE_GT
    o.validate()
    fmtr = VcfFormatter(VcfWriterConfig(o))

    def model_for(a):
        if a.category in (AlleleCategory.INSERTION, AlleleCategory.DELETION):
            return indel_model
        return snv_model

    def preprocess(a):
        ad = min(a.allele_support, a.total_coverage)
        dp = a.total_coverage
        if a.category == AlleleCategory.REFERENCE:
            ad = a.reference_support
        if dp > adaptive.MAX_EFFECTIVE_DEPTH:
            ad = int(ad / dp * adaptive.MAX_EFFECTIVE_DEPTH)
            dp = adaptive.MAX_EFFECTIVE_DEPTH
        return ad, dp

    def update_genotype(a, cat):
        if cat == 0 or a.category == AlleleCategory.REFERENCE:
            a.genotype = Genotype.HOMOZYGOUS_REF
        elif cat == 1:
            a.genotype = Genotype.HETEROZYGOUS_ALT_REF
        else:
            a.genotype = Genotype.HOMOZYGOUS_ALT

    def format_locus(variants):
        first = variants[0]
        total_depth = fmtr.get_depth_count(variants)
        fmt, smp = fmtr.construct_format_and_sample(variants, total_depth)
        if len(variants) == 1:
            ref_s, alt_s = fmtr.uncrushed_ref_and_alt(first)
        else:
            ref_s, alt_s = fmtr.merge_crushed_ref_and_alt(variants)
        if first.genotype in (Genotype.HOMOZYGOUS_REF,
                              Genotype.REF_LIKE_NOCALL,
                              Genotype.REF_AND_NOCALL):
            alt_s = "."
        joint_q = min(v.variant_qscore for v in variants)
        return (f"{first.chromosome}\t{first.position}\t.\t{ref_s}\t{alt_s}\t"
                f"{joint_q}\t{fmtr.map_filters(variants)}\t"
                f"DP={total_depth}\t{fmt}\t{smp}")

    def update(group: List[VcfVariant]):
        from pisces_tpu_torch.genotype import get_ploidy_for_chr
        alleles = [a for v in group for a in to_called_alleles(v)]
        if not alleles:
            return None
        if get_ploidy_for_chr(PloidyModel.DIPLOID_BY_ADAPTIVE_GT, False,
                              group[0].chrom) != \
                PloidyModel.DIPLOID_BY_ADAPTIVE_GT:
            # chrM (somatic) / chrY (haploid, IsMale=false): untouched,
            # but LocusProcessor.GetTypeOfUpdate still deletes ref-like
            # rows when not emitting gVCF (LocusProcessor.cs:15-60)
            if not output_gvcf and alleles[0].genotype in (
                    Genotype.HOMOZYGOUS_REF, Genotype.REF_LIKE_NOCALL):
                return []
            return None
        variants = [a for a in alleles
                    if a.category != AlleleCategory.REFERENCE]
        # GetTopTwoAlleles: keep the second only if it beats the ref vf
        if len(variants) >= 2:
            variants.sort(key=lambda a: -a.frequency)
            ref_vf = 1.0 - sum(a.frequency for a in variants)
            ordered = variants[:2] if ref_vf <= variants[1].frequency \
                else [variants[0]]
        elif variants:
            ordered = [variants[0]]
        else:
            ordered = [alleles[0]]

        if len(ordered) == 1:
            a = ordered[0]
            means, priors = model_for(a)
            ad, dp = preprocess(a)
            cat, q, gp = adaptive.calculate_q_and_posteriors(
                ad, dp, means, priors)
            update_genotype(a, cat)
            a.genotype_qscore = q
            a.genotype_posteriors = gp
            out = [a]
        else:
            a1, a2 = ordered
            means1, _p1 = model_for(a1)
            cat, _q, _gp = adaptive.calculate_q_and_posteriors(
                *preprocess(a1), *model_for(a1))
            if cat != 1:
                update_genotype(a1, cat)
                _c2, q, gp = adaptive.calculate_q_and_posteriors(
                    *preprocess(a1), *model_for(a1))
                a1.genotype_qscore = q
                a1.genotype_posteriors = gp
                out = [a1]
            else:
                dp = a1.total_coverage
                ad2 = a1.allele_support
                ad1 = a2.allele_support
                ad0 = dp - ad1 - ad2
                if ad0 < 0:
                    ad0 = 0
                    dp = ad1 + ad2
                q, gp = adaptive.get_multinomial_qscores(
                    np.array([ad0, ad1, ad2]), dp,
                    [model_for(a1)[0], model_for(a2)[0]])
                for a in (a1, a2):
                    a.genotype = Genotype.HETEROZYGOUS_ALT1_ALT2
                    a.genotype_qscore = q
                    a.genotype_posteriors = gp
                out = [a1, a2]

        if not output_gvcf and out[0].genotype in (
                Genotype.HOMOZYGOUS_REF, Genotype.REF_LIKE_NOCALL):
            return []  # DeleteCompletely
        return [format_locus(out)]

    return update


def recalibrate(vcf_path: str, out_dir: Optional[str] = None,
                model_file: Optional[str] = None, backend: str = "torch",
                device="cuda") -> str:
    """Fit (or read) the SNV and indel models and rewrite the VCF; returns
    the recalibrated VCF's path. Without a model file the fit runs on the
    f64 host EM (backend "numpy") or the torch EM on `device` (backend
    "torch": "cuda" unless the caller asks for "cpu"; raises when CUDA is
    absent)."""
    if backend not in ("torch", "numpy"):
        raise ValueError(f"backend must be torch or numpy, got {backend!r}")
    if backend == "torch":
        from pisces_tpu_torch.device import resolve_device
        device = resolve_device(device)
    out_dir = out_dir or os.path.dirname(vcf_path)
    os.makedirs(out_dir, exist_ok=True)
    snv_ad, snv_dp, indel_ad, indel_dp = collect_observations(vcf_path)

    if model_file:
        models = read_model_file(model_file)
        snv_model = models[0]
        indel_model = models[1] if len(models) > 1 else models[0]
    else:
        # BUG-COMPATIBLE with the reference: MixtureModel.FitMixtureModel
        # passes the STATIC _defaultMeans array by reference and the ctor
        # stores it without copying (MixtureModel.cs:70,103-119,415-425), so
        # the SNV fit mutates the shared array, the indel fit STARTS from
        # the SNV-fitted means, and afterwards BOTH models alias the same
        # (indel-final) means — the model file records them twice and SNV
        # recalibration uses the indel means. Weights stay per-model.
        if backend == "torch":
            # device EM with the same chained starting means: the indel fit
            # starts from the SNV-fitted means and both models share the
            # indel-final means (the reference's aliasing, reproduced)
            snv_means, snv_weights = adaptive.fit_mixture_model_torch(
                snv_ad, snv_dp, device=device)
            if len(indel_ad) > 0:
                shared_means, indel_weights = adaptive.fit_mixture_model_torch(
                    indel_ad, indel_dp, starting_means=snv_means,
                    device=device)
            else:
                shared_means, indel_weights = snv_means, snv_weights
        else:
            fit = adaptive.fit_mixture_model(snv_ad, snv_dp)
            snv_weights = fit.weights
            if len(indel_ad) > 0:
                ifit = adaptive.fit_mixture_model(indel_ad, indel_dp,
                                                  starting_means=fit.means)
                shared_means = ifit.means
                indel_weights = ifit.weights
            else:
                shared_means = fit.means
                indel_weights = fit.weights
        snv_model = (shared_means, snv_weights)
        indel_model = (shared_means, indel_weights)
        write_model_file(
            os.path.join(out_dir,
                         os.path.basename(vcf_path).replace(".vcf", ".model")),
            [snv_model, indel_model])

    # AdaptiveGtWriter.RewriteVcf naming (AdaptiveGtWriter.cs:50-56)
    base = os.path.basename(vcf_path)
    if "genome." in base:
        out_name = base.replace("genome", "recal")
    else:
        out_name = base.replace(".vcf", ".recal.vcf")
    out_path = os.path.join(out_dir, out_name)

    # AdaptiveGtOptions: OutputGvcfFile always false (AdaptiveGtOptions.cs:22)
    update = make_locus_update(snv_model, indel_model, output_gvcf=False)

    def header_fn(line: str):
        if line.startswith("#CHROM"):
            return ('##FORMAT=<ID=GP,Number=G,Type=Float,Description='
                    '"Genotype Posterior">\n' + line)
        return line

    update_vcf_loci_by_loci(vcf_path, out_path, update, header_fn)
    return out_path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="adaptive-gt")
    p.add_argument("-vcf", required=True)
    p.add_argument("-log", default=None, help="log file name base")
    p.add_argument("-o", "--out", "-outfolder", dest="out", default=None)
    p.add_argument("-models", default=None)
    p.add_argument("-backend", default="torch", choices=["torch", "numpy"],
                   help="EM of the model fit: torch (f32 on -device, "
                        "default) or numpy (f64 host)")
    p.add_argument("-device", default="cuda", choices=["cuda", "cpu"],
                   help="torch device of -backend torch (default cuda; "
                        "raises when CUDA is absent)")
    args = p.parse_args(argv)
    recalibrate(args.vcf, args.out, args.models, backend=args.backend,
                device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
