"""Side-channel bias tables.

Ports of Pisces.IO/StrandBiasFileWriter.cs:1-181 (per-variant strand-bias
stats table, <out>.ReadStrandBias.txt) and AmpliconBiasFileWriter.cs:1-138.
"""
from __future__ import annotations

from typing import Iterable

from pisces_tpu_torch.calling.alleles import CalledAllele


def _num(x) -> str:
    """C#-style double.ToString()."""
    if x != x:
        return "NaN"
    if x == float("inf"):
        return "Infinity"
    if x == float("-inf"):
        return "-Infinity"
    if float(x) == int(x) and abs(x) < 1e15:
        return str(int(x))
    return repr(float(x))


class StrandBiasFileWriter:
    def __init__(self, vcf_path: str):
        self.path = vcf_path.replace(".vcf", ".ReadStrandBias.txt")
        self._fh = open(self.path, "w", newline="\n")

    def write_header(self) -> None:
        cols = []
        for prefix in ("Overall_", "Forward_", "Reverse_"):
            # column-major interleave per reference HeaderHelper stride
            cols.append(prefix)
        stats_names = ["ChanceFalsePos", "ChanceFalseNeg", "Freq", "Support",
                       "Coverage"]
        ordered = []
        for name in stats_names:
            for prefix in ("Overall_", "Forward_", "Reverse_"):
                ordered.append(prefix + name)
        header = "Chr\tPosition\tReference\tAlternate\t" + "\t".join(ordered)
        header += "".join(f"\tRawCoverageCountByReadType_{i}" for i in range(3))
        header += "".join(f"\tRawSupportCountByReadType_{i}" for i in range(3))
        header += ("\tBiasScore\tBiasAcceptable?\tVarPresentOnBothStrands?"
                   "\tCoverageAvailableOnBothStrands?\t")
        self._fh.write(header + "\n")

    def write(self, alleles: Iterable[CalledAllele]) -> None:
        for v in alleles:
            if v.ref_allele == v.alt_allele:
                continue  # skip ref calls
            sb = getattr(v, "sb_detail", None)
            vals = []
            stats_names = ["chance_false_pos", "chance_false_neg", "frequency",
                           "support", "coverage"]
            for name in stats_names:
                for group in ("overall", "forward", "reverse"):
                    x = float(sb[group][name][0]) if sb else float("nan")
                    vals.append(_num(x))
            row = (f"{v.chromosome}\t{v.position}\t{v.ref_allele}\t"
                   f"{v.alt_allele}\t" + "\t".join(vals))
            row += "".join(f"\t{int(c)}" for c in v.coverage_by_direction)
            row += "".join(f"\t{int(s)}" for s in v.support_by_direction)
            row += (f"\t{_num(v.strand_bias_score)}"
                    f"\t{v.strand_bias_acceptable}"
                    f"\t{v.var_present_on_both_strands}"
                    f"\t{v.cov_present_on_both_strands}\t")
            self._fh.write(row + "\n")

    def close(self) -> None:
        self._fh.close()


class AmpliconBiasFileWriter:
    def __init__(self, vcf_path: str):
        self.path = vcf_path.replace(".vcf", ".AmpliconBias.txt")
        self._fh = open(self.path, "w", newline="\n")

    def write_header(self) -> None:
        self._fh.write("Chr\tPosition\tReference\tAlternate\tAmplicon\tFreq\t"
                       "Support\tCoverage\tChanceItsReal\tConfidenceQScore\t"
                       "BiasDetected\n")

    def write(self, alleles: Iterable[CalledAllele]) -> None:
        for v in alleles:
            if v.ref_allele == v.alt_allele:
                continue
            results = getattr(v, "amplicon_bias_results", None)
            if not results:
                continue
            for name, r in results.items():
                self._fh.write(
                    f"{v.chromosome}\t{v.position}\t{v.ref_allele}\t"
                    f"{v.alt_allele}\t{name}\t{_num(r['frequency'])}\t"
                    f"{_num(r['support'])}\t{_num(r['coverage'])}\t"
                    f"{_num(r['chance_its_real'])}\t{r['qscore']}\t"
                    f"{r['bias_detected']}\n")

    def close(self) -> None:
        self._fh.close()
