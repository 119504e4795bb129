"""Scylla phasing engine: variant sites, veads, neighborhoods.

Ports of VariantPhasing/Models/VariantSite.cs, Vead.cs, VeadGroup.cs,
Agreement.cs, VcfNeighborhood.cs, CallableNeighborhood.cs and
Logic/VeadFinder.cs: each read is compressed to its per-site states
("vead" = variant read), identical veads group together, and clusters of
agreeing vead groups become phased MNVs.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from pisces_tpu_torch.domain.types import AlleleCategory, Genotype
from pisces_tpu_torch.calling.alleles import CalledAllele

# SubsequenceType
MATCH_SEQ = 0
INSERTION_SEQ = 1
DELETION_SEQ = 2

# StateOfPhasingSiteInRead
FOUND_THIS = 0
INSUFFICIENT = 1
FOUND_DIFFERENT = 2
FOUND_REFERENCE = 3
IDONTKNOW = 4


@dataclass
class VariantSite:
    position: int            # 1-based vcf position
    ref: str = "N"
    alt: str = "N"
    chrom: str = ""
    original_allele: Optional[CalledAllele] = None
    is_passing: bool = False

    @property
    def is_indel(self) -> bool:
        return len(self.ref) != len(self.alt)

    @property
    def true_first_base_of_diff(self) -> int:
        return self.position + 1 if self.is_indel else self.position

    @property
    def true_ref(self) -> str:
        return self.ref[1:] if self.is_indel else self.ref

    @property
    def true_alt(self) -> str:
        return self.alt[1:] if self.is_indel else self.alt

    @property
    def has_ref_data(self) -> bool:
        return self.ref != "N"

    @property
    def has_alt_data(self) -> bool:
        return self.alt != "N"

    @property
    def has_ref_and_alt(self) -> bool:
        return self.has_ref_data and self.has_alt_data

    @property
    def has_no_data(self) -> bool:
        return self.ref == "N" and self.alt == "N"

    @property
    def is_reference(self) -> bool:
        return self.ref == self.alt and len(self.alt) == 1

    def subsequence_type(self) -> int:
        if len(self.ref) > len(self.alt):
            return DELETION_SEQ
        if len(self.ref) < len(self.alt):
            return INSERTION_SEQ
        return MATCH_SEQ

    def copy(self) -> "VariantSite":
        return VariantSite(self.position, self.ref, self.alt, self.chrom,
                           self.original_allele, self.is_passing)

    def state_key(self) -> Tuple[int, str, str]:
        return (self.position, self.ref, self.alt)


@dataclass
class Vead:
    name: str
    site_results: List[VariantSite]

    def key(self):
        return tuple(s.state_key() for s in self.site_results)


class VeadGroup:
    def __init__(self, vead: Vead):
        self.representative = vead
        self.num_veads = 1

    @property
    def site_results(self) -> List[VariantSite]:
        return self.representative.site_results

    @property
    def num_sites_per_vead(self) -> int:
        return sum(1 for s in self.site_results if s.has_ref_and_alt)

    @property
    def num_sites_in_group(self) -> int:
        return self.num_sites_per_vead * self.num_veads

    def add_support(self) -> None:
        self.num_veads += 1

    def to_depths(self) -> np.ndarray:
        return np.array([self.num_veads if s.has_ref_and_alt else 0
                         for s in self.site_results])

    def to_nocalls(self) -> np.ndarray:
        return np.array([0 if s.has_ref_and_alt else self.num_veads
                         for s in self.site_results])


def agreement(vg1: VeadGroup, vg2: VeadGroup) -> Tuple[int, int]:
    """(num_agreement, num_disagreement) between two vead groups."""
    agree = disagree = 0
    for s1, s2 in zip(vg1.site_results, vg2.site_results):
        if s1.alt == "N" or s2.alt == "N":
            continue
        if s1.alt == s2.alt and s1.ref == s2.ref:
            agree += 1
        else:
            disagree += 1
    return agree, disagree


def agreement_score(a: Tuple[int, int]) -> int:
    return a[0] - a[1]


def depth_at_sites(vead_groups) -> Tuple[np.ndarray, np.ndarray]:
    """VeadGroup.DepthAtSites: per-site total depth and nocall counts."""
    vgs = list(vead_groups)
    if not vgs:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    n = len(vgs[0].site_results)
    depths = np.zeros(n, np.int64)
    nocalls = np.zeros(n, np.int64)
    for vg in vgs:
        depths += vg.to_depths()
        nocalls += vg.to_nocalls()
    return depths, nocalls


# ---------------------------------------------------------------------------
# Vead finding (VeadFinder)
# ---------------------------------------------------------------------------

class VeadFinder:
    """Map each read to per-site states (VeadFinder.cs)."""

    def __init__(self, min_base_quality: int = 20,
                 min_number_variants_in_read: int = 1):
        self.min_bq = min_base_quality
        self.min_variants = min_number_variants_in_read

    def find_variant_results(self, sites: List[VariantSite], pos1: int,
                             cigar_ops: np.ndarray, cigar_lens: np.ndarray,
                             seq_chars: str, quals: np.ndarray
                             ) -> Optional[List[VariantSite]]:
        found, last_pos = self._set_candidates_in_read(
            pos1, cigar_ops, cigar_lens, seq_chars, quals)
        return self._match(sites, found, pos1, last_pos)

    def _set_candidates_in_read(self, pos1, ops, lens, seq, quals):
        found = {MATCH_SEQ: [], INSERTION_SEQ: [], DELETION_SEQ: []}
        cycle = 0
        ref_pos = pos1 - 1  # 0-based walker like reference (read.Position)
        for op, ln in zip(ops, lens):
            ln = int(ln)
            vs_pos = ref_pos + 1
            if op == 4:  # S
                cycle += ln
            elif op in (0, 7, 8):  # M
                bases = list(seq[cycle:cycle + ln])
                for i in range(ln):
                    if quals[cycle + i] < self.min_bq:
                        bases[i] = "N"
                vs = VariantSite(vs_pos, "R" * ln, "".join(bases))
                found[MATCH_SEQ].append(vs)
                cycle += ln
                ref_pos += ln
            elif op == 1:  # I
                ok = quals[cycle] >= self.min_bq
                vs = VariantSite(vs_pos - 1, "", seq[cycle:cycle + ln])
                if not ok:
                    vs.ref = "N"
                    vs.alt = "N"
                found[INSERTION_SEQ].append(vs)
                cycle += ln
            elif op in (2, 3):  # D/N
                after = quals[cycle] if cycle < len(quals) else quals[cycle - 1]
                before = quals[cycle - 1] if cycle > 0 else after
                ok = before >= self.min_bq and after >= self.min_bq
                vs = VariantSite(vs_pos - 1, "R" * ln, "")
                if not ok:
                    vs.ref = "N"
                    vs.alt = "N"
                found[DELETION_SEQ].append(vs)
                ref_pos += ln
        return found, ref_pos + 1

    @staticmethod
    def _check_match(look_for: VariantSite, in_read: VariantSite) -> int:
        idx = look_for.position - in_read.position
        if (idx + len(look_for.alt) > len(in_read.alt)) or idx < 0:
            return INSUFFICIENT
        sub = in_read.alt[idx:idx + len(look_for.alt)]
        if sub == look_for.alt:
            return FOUND_THIS
        if "N" in sub:
            return INSUFFICIENT
        if sub == look_for.ref:
            return FOUND_REFERENCE
        return FOUND_DIFFERENT

    def _have_ref_evidence(self, site: VariantSite, found) -> bool:
        test = VariantSite(site.position, site.ref[:1], site.ref[:1])
        for vs in found[MATCH_SEQ]:
            r = self._check_match(test, vs)
            if r in (FOUND_THIS, FOUND_REFERENCE):
                return True
        return False

    def _match(self, sites, found, first_pos, last_pos):
        results: List[Optional[VariantSite]] = [None] * len(sites)
        num_found = 0
        for i, site in enumerate(sites):
            if (site.true_first_base_of_diff < first_pos
                    or site.true_first_base_of_diff > last_pos):
                results[i] = self._empty(site)
                continue
            num_found += 1
            stype = site.subsequence_type()
            if not found[stype]:
                if self._have_ref_evidence(site, found):
                    results[i] = self._ref_match(site)
                else:
                    results[i] = self._empty(site)
                continue
            result = IDONTKNOW
            for vf in found[stype]:
                if result == FOUND_THIS:
                    break
                if site.position < vf.position:
                    if self._have_ref_evidence(site, found):
                        results[i] = self._ref_match(site)
                    else:
                        results[i] = self._empty(site)
                    break
                if stype == INSERTION_SEQ:
                    if vf.position != site.position:
                        continue
                    ins = site.alt[1:]
                    if vf.has_no_data:
                        result = INSUFFICIENT
                    elif vf.alt == ins:
                        result = FOUND_THIS
                    else:
                        result = FOUND_DIFFERENT
                elif stype == DELETION_SEQ:
                    if vf.position != site.position:
                        continue
                    want = len(site.ref) - len(site.alt)
                    got = len(vf.ref)
                    if vf.has_no_data:
                        result = INSUFFICIENT
                    elif want == got:
                        result = FOUND_THIS
                    else:
                        result = FOUND_DIFFERENT
                else:
                    result = self._check_match(site, vf)
            if results[i] is not None:
                continue
            if result == IDONTKNOW and self._have_ref_evidence(site, found):
                result = FOUND_REFERENCE
            if result in (IDONTKNOW, INSUFFICIENT):
                results[i] = self._empty(site)
            elif result == FOUND_THIS:
                results[i] = site.copy()
            elif result == FOUND_DIFFERENT:
                results[i] = self._diff(site)
            else:
                results[i] = self._ref_match(site)
        if num_found >= self.min_variants:
            return results
        return None

    @staticmethod
    def _empty(site: VariantSite) -> VariantSite:
        c = site.copy()
        c.ref = "N"
        c.alt = "N"
        return c

    @staticmethod
    def _ref_match(site: VariantSite) -> VariantSite:
        c = site.copy()
        c.ref = site.ref[:1]
        c.alt = site.ref[:1]
        return c

    @staticmethod
    def _diff(site: VariantSite) -> VariantSite:
        c = site.copy()
        c.ref = "X"
        c.alt = "X"
        return c
