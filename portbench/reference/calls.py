"""The VCF/gVCF body the plain reference expects for a sample.

From the reference's own pileup counts by forward, reverse and stitched
direction (the configuration's read layout's counts, portbench/layouts)
and the scoring arithmetic (portbench/reference/scoring.py), following the
reference caller's rules for the deployments of portbench/configs:

- SNV candidates: every alt base seen at a position. One is callable when
  its frequency is at least the minimum (f32), its Poisson q at least the
  minimum q and, without gVCF output, its depth at least the minimum
  depth; it is reported inside the intervals.
- Filters of a variant: LowDP, q30, NC (no-call fraction), SB (extended
  strand-bias model), R5x9 (RMxN), LowVariantFreq.
- Somatic: one line per called allele, the somatic genotype and GQ; with
  gVCF, a reference line at every other interval position, scored from
  its reference-allele and coverage tuple.
- Diploid (thresholding): the alleles of a locus are genotyped together,
  pruned to what the genotype allows, and written crushed on one line.

Each line is a dict of the fields compare.py reads.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from portbench.reference import scoring as S
from portbench.reference.scoring import Precision


def three_directions(by_dir: np.ndarray) -> np.ndarray:
    """Counts by direction [.., 3] (forward, reverse, stitched) as they
    are; [.., 2] forward/reverse with a zero stitched column."""
    if by_dir.shape[-1] == 3:
        return by_dir
    return np.concatenate([by_dir, np.zeros(by_dir.shape[:-1] + (1,),
                                            by_dir.dtype)], axis=-1)


def _snv_candidates(c: np.ndarray, seq: np.ndarray):
    """(pos, alt allele code) of every alt base seen, in genome order, and
    the per-position arrays the scoring needs; c is counts[1:] in three
    directions."""
    ref_code = S.BASE_TO_ALLELE[seq].astype(np.int64)          # 0-based pos
    cov_by_dir = c[:, list(S.COVERAGE_ALLELES), :].sum(axis=1)  # [L, 3]
    ar = np.arange(len(seq))
    ref_by_dir = c[ar, ref_code, :]
    alt_tot = c[:, :4, :].sum(axis=2)                          # [L, 4]
    alt_tot[ar, ref_code] = 0
    pos0, alt = np.nonzero(alt_tot)
    return pos0, alt, cov_by_dir, ref_by_dir


def score_snvs(counts, seq, cfg: dict, pr: Precision) -> Dict[str, np.ndarray]:
    """Every SNV candidate of a chromosome with its scores and filters;
    counts [len(seq) + 1, 6, 2 or 3] by direction (three_directions)."""
    c = three_directions(counts)[1:]
    pos0, alt, cov_by_dir, ref_by_dir = _snv_candidates(c, seq)
    sup_by_dir = c[pos0, alt, :]
    cov3 = cov_by_dir[pos0]
    support = sup_by_dir.sum(axis=1)
    total = cov3.sum(axis=1)
    ref_sup = ref_by_dir[pos0].sum(axis=1)
    no_calls = c[pos0, S.N, :].sum(axis=1)
    freq = S.frequency(support, total)
    ref_freq = S.frequency(ref_sup, total)
    noise = cfg["noise_q"]
    q = S.variant_qscores(support, total, noise, cfg["max_q"], pr)
    gatk, sb_ok = S.strand_bias(sup_by_dir, cov3, noise, cfg["sb_accept"], pr)
    # AlleleCaller._is_callable: without gVCF output a locus under the
    # minimum depth is not called
    callable_ = ((total == 0) | (freq >= np.float32(cfg["min_freq"]))) \
        & (q >= cfg["min_q"]) & (cfg["gvcf"] | (total >= cfg["min_dp"]))
    return {"pos": pos0 + 1, "alt": alt, "support": support, "total": total,
            "ref_sup": ref_sup, "no_calls": no_calls, "freq": freq,
            "ref_freq": ref_freq, "q": q, "gatk": gatk, "sb_ok": sb_ok,
            "callable": callable_}


def _filters(i: int, snv: dict, seq_str: str, cfg: dict) -> frozenset:
    out = set()
    total, q = int(snv["total"][i]), int(snv["q"][i])
    if total < cfg["low_dp"]:
        out.add("LowDP")
    if q < cfg["q_filter"] and total != 0:
        out.add(f"q{cfg['q_filter']}")
    nc = int(snv["no_calls"][i])
    frac_nc = 0.0 if total + nc == 0 else nc / float(total + nc)
    if frac_nc > cfg["nc_filter"]:
        out.add("NC")
    if not snv["sb_ok"][i]:
        out.add("SB")
    pos = int(snv["pos"][i])
    ref_b = seq_str[pos - 1]
    alt_b = S.ALLELE_CHARS[int(snv["alt"][i])]
    mx, reps, lim = cfg["rmxn"]
    if S.rmxn_filtered(pos, ref_b, alt_b, float(snv["freq"][i]), seq_str,
                       mx, reps, lim):
        out.add(f"R{mx}x{reps}")
    if np.float32(snv["freq"][i]) < np.float32(cfg["min_freq"]):
        out.add("LowVariantFreq")
    return frozenset(out)


def _sb(gatk) -> float:
    return float(np.clip(gatk, -100.0, 0.0))


def somatic_variant_lines(snv: dict, seq_str: str, cfg: dict,
                          pr: Precision) -> Dict[int, List[dict]]:
    sel = np.flatnonzero(snv["callable"])
    gt = S.somatic_genotypes(np.zeros(sel.size, bool), snv["freq"][sel],
                             snv["ref_freq"][sel], snv["total"][sel],
                             cfg["min_freq"], cfg["min_dp"])
    gq = S.somatic_gq(gt, snv["q"][sel], snv["freq"][sel], snv["total"][sel],
                      cfg["min_freq"], 0, cfg["max_gq"], pr)
    out: Dict[int, List[dict]] = {}
    for j, i in enumerate(sel.tolist()):
        pos = int(snv["pos"][i])
        total = int(snv["total"][i])
        sup, rs = int(snv["support"][i]), int(snv["ref_sup"][i])
        out.setdefault(pos, []).append({
            "ref": seq_str[pos - 1], "alt": S.ALLELE_CHARS[int(snv["alt"][i])],
            "qual": int(snv["q"][i]), "filters": _filters(i, snv, seq_str, cfg),
            "dp_info": max(rs + sup, total), "gt": S.GT_STRINGS[int(gt[j])],
            "gq": int(gq[j]), "ad": (rs, sup), "dp": max(rs + sup, total),
            "vf": float(snv["freq"][i]), "nl": cfg["noise_q"],
            "sb": _sb(snv["gatk"][i])})
    for lines in out.values():
        lines.sort(key=lambda d: (d["ref"], d["alt"]))
    return out


def reference_lines(counts, seq, cfg: dict, pr: Precision) -> dict:
    """Columnar reference-line fields at every position 1..len(seq); the
    tuples (reference support and coverage, three directions each) are the
    score_tuples kernel's."""
    ref_code = S.BASE_TO_ALLELE[seq].astype(np.int64)
    c = three_directions(counts)[1:]
    ar = np.arange(len(seq))
    sup_by_dir = c[ar, ref_code, :]
    cov_by_dir = c[:, list(S.COVERAGE_ALLELES), :].sum(axis=1)
    support = sup_by_dir.sum(axis=1)
    total = cov_by_dir.sum(axis=1)
    noise = cfg["noise_q"]
    q = S.variant_qscores(support, total, noise, cfg["max_q"], pr)
    q = np.where((total == 0) | (support <= 0), 0, q)
    freq = S.frequency(support, total)
    gatk, _ok = S.strand_bias(sup_by_dir, cov_by_dir, noise,
                              cfg["sb_accept"], pr)
    gatk = np.where(support > 0, gatk, 0.0)
    gt = S.somatic_genotypes(np.ones(len(seq), bool), freq, freq, total,
                             cfg["min_freq"], cfg["min_dp"])
    gq = S.somatic_gq(gt, q, freq, total, cfg["min_freq"], 0, cfg["max_gq"],
                      pr)
    low_dp = total < cfg["low_dp"]
    low_q = (q < cfg["q_filter"]) & (total != 0)
    vf = np.where(total == 0, 0.0, 1.0 - freq.astype(np.float64))
    # every block of the chromosome holds reads in these samples, so no
    # position is interval padding: NL is the noise level where the
    # reference allele has support, else 0
    return {"qual": q, "low_dp": low_dp, "low_q": low_q, "total": total,
            "gt": gt, "gq": gq, "support": support, "freq": freq, "vf": vf,
            "nl": np.where(support > 0, noise, 0),
            "sb": np.clip(gatk, -100.0, 0.0), "tuples": np.concatenate(
                [sup_by_dir, cov_by_dir], axis=1)}


def diploid_lines(snv: dict, seq_str: str, cfg: dict,
                  pr: Precision) -> Dict[int, List[dict]]:
    """Crushed diploid lines at each locus with callable SNVs."""
    sel = np.flatnonzero(snv["callable"])
    by_pos: Dict[int, list] = {}
    for i in sel.tolist():
        pos = int(snv["pos"][i])
        by_pos.setdefault(pos, []).append({
            "i": i, "pos": pos, "ref": seq_str[pos - 1],
            "alt": S.ALLELE_CHARS[int(snv["alt"][i])],
            "freq": float(snv["freq"][i]), "ref_freq": float(snv["ref_freq"][i]),
            "total": int(snv["total"][i])})
    minor, major, sum_multi = cfg["diploid_snv"]
    out: Dict[int, List[dict]] = {}
    for pos, alleles in by_pos.items():
        gt, kept = S.diploid_genotype(alleles, minor, major, sum_multi,
                                      cfg["min_dp"])
        if not kept:
            continue
        kept.sort(key=lambda a: (a["ref"], a["alt"]))
        gqs, filters = [], set()
        for a in kept:
            i = a["i"]
            gqs.append(S.diploid_gq(gt, int(snv["total"][i]),
                                    int(snv["support"][i]), a["freq"], 0,
                                    cfg["max_gq"], pr))
            filters |= _filters(i, snv, seq_str, cfg)
            if a["multi"]:
                filters.add("MultiAllelicSite")
        first = kept[0]["i"]
        rs = int(snv["ref_sup"][first])
        sups = [int(snv["support"][a["i"]]) for a in kept]
        dp = max(rs + sups[0], max(int(snv["total"][a["i"]]) for a in kept))
        dp = max(dp, sum(sups))
        if len(kept) == 1:
            alt_s, ad = kept[0]["alt"], (rs, sups[0])
            vf = kept[0]["freq"]
        else:
            alt_s, ad = ",".join(a["alt"] for a in kept), tuple(sups)
            vf = sum(s / dp for s in sups) if dp else float("nan")
        if gt in (S.GT_HOM_REF, S.GT_REF_NOCALL, S.GT_REF_AND_NOCALL):
            alt_s = "."
        out[pos] = [{
            "ref": kept[0]["ref"], "alt": alt_s,
            "qual": min(int(snv["q"][a["i"]]) for a in kept),
            "filters": frozenset(filters), "dp_info": dp,
            "gt": S.GT_STRINGS[gt], "gq": min(gqs), "ad": ad, "dp": dp,
            "vf": vf, "nl": cfg["noise_q"], "sb": _sb(snv["gatk"][first])}]
    return out
