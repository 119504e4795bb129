"""Open-ended candidate collapsing (VariantCollapser port).

Reference: exe/Pisces/Logic/VariantCalling/VariantCollapser.cs:31-245,
including the deterministic tie-break sort chains (cs:41-47, 221-245) that
define output content.
"""
from __future__ import annotations

import functools
from typing import List, Optional

from pisces_tpu_torch.domain.types import AlleleCategory
from pisces_tpu_torch.pileup.candidates import Candidate
from pisces_tpu_torch.calling.alleles import map_candidate
from pisces_tpu_torch.calling.source import AlleleSource
from pisces_tpu_torch.ops.coverage import compute_coverage


class VariantCollapser:
    def __init__(self, known_variants: Optional[List[Candidate]] = None,
                 exclude_mnvs: bool = False,
                 consider_anchor_information: bool = True,
                 freq_threshold: float = 0.0,
                 freq_ratio_threshold: float = 0.5):
        self.known_variants = known_variants
        self.exclude_mnvs = exclude_mnvs
        self.consider_anchor_information = consider_anchor_information
        self.freq_threshold = freq_threshold
        self.freq_ratio_threshold = freq_ratio_threshold
        self.total_num_collapsed = 0

    def _frequency(self, cand: Candidate, source: AlleleSource) -> float:
        called = map_candidate(cand)
        cov = compute_coverage(source, called.category, called.position,
                               called.ref_allele, called.alt_allele,
                               called.allele_support, called.well_anchored_support,
                               self.consider_anchor_information)
        called.total_coverage = cov.total_coverage
        return called.frequency

    def collapse(self, candidates: List[Candidate],
                 source: AlleleSource) -> List[Candidate]:
        if self.exclude_mnvs:
            targets = [c for c in candidates if c.category != AlleleCategory.MNV]
        else:
            targets = list(candidates)

        self._annotate_known(targets)

        to_collapse = sorted(
            (c for c in targets if c.open_on_left or c.open_on_right),
            key=lambda c: (-c.length,
                           -int(c.open_on_left and c.open_on_right),
                           -int(c.open_on_left or c.open_on_right),
                           c.ref_allele, c.alt_allele, c.support,
                           int(c.open_on_right), int(c.open_on_left)))

        # position index: every CanCollapse relation constrains the target to
        # lie within the candidate's length of its position, so only a small
        # window of targets needs scanning (the reference scans whole batches,
        # but its batches are single blocks; whole-chromosome batches need
        # the index to avoid quadratic work)
        from collections import defaultdict
        by_pos = defaultdict(list)
        for v in targets:
            by_pos[v.position].append(v)
        max_len = max((v.length for v in targets), default=1)

        removed = set()
        for cand in to_collapse:
            if id(cand) in removed:
                continue
            window = []
            for p in range(cand.position - max_len - 1,
                           cand.position + max_len + 2):
                window.extend(v for v in by_pos.get(p, ())
                              if id(v) not in removed)
            match = self._get_match(cand, window, source)
            if match is not None:
                self.total_num_collapsed += 1
                self._merge(match, cand)
                removed.add(id(cand))
        if removed:
            candidates = [v for v in candidates if id(v) not in removed]
        return candidates

    def _annotate_known(self, candidates: List[Candidate]) -> None:
        if not self.known_variants:
            return
        for c in candidates:
            if any(c.equals_allele(k) for k in self.known_variants):
                c.is_known = True
                c.open_on_left = False
                c.open_on_right = False

    @staticmethod
    def _merge(to_keep: Candidate, merged: Candidate) -> None:
        to_keep.support_by_direction += merged.support_by_direction
        to_keep.well_anchored_by_direction += merged.well_anchored_by_direction
        to_keep.open_on_left = to_keep.open_on_left and merged.open_on_left
        to_keep.open_on_right = to_keep.open_on_right and merged.open_on_right

    @staticmethod
    def _can_collapse(to_collapse: Candidate, potential: Candidate) -> bool:
        C, P = to_collapse, potential
        ins, dele = AlleleCategory.INSERTION, AlleleCategory.DELETION
        if ((C.category == ins) != (P.category == ins)
                or (C.category == dele) != (P.category == dele)
                or C.length > P.length
                or (C.fully_anchored and not P.fully_anchored)):
            return False
        c_bases = C.ref_allele if C.category == dele else C.alt_allele
        p_bases = P.ref_allele if P.category == dele else P.alt_allele

        if C.fully_anchored and P.fully_anchored:
            return C.equals_allele(P)

        if C.category == dele:
            if C.open_on_right:
                return P.position == C.position  # left anchor
            return (P.position + len(p_bases) - 1
                    == C.position + len(c_bases) - 1)  # right anchor

        if C.open_on_right:
            return (P.position == C.position
                    and p_bases[:len(c_bases)] == c_bases)

        if C.category == ins:
            return (P.position == C.position
                    and p_bases[len(p_bases) - len(c_bases) + 1:] == c_bases[1:])

        # snv/mnv open on the left: anchored on the right
        return (P.position + len(P.alt_allele) - 1
                == C.position + len(C.alt_allele) - 1
                and P.alt_allele[len(P.alt_allele) - len(C.alt_allele):]
                == C.alt_allele)

    def _get_match(self, to_collapse: Candidate, targets: List[Candidate],
                   source: AlleleSource) -> Optional[Candidate]:
        potential = [c for c in targets
                     if c is not to_collapse and self._can_collapse(to_collapse, c)]
        if not potential:
            return None
        for v in potential:
            v.frequency = self._frequency(v, source)
        to_collapse_freq = self._frequency(to_collapse, source)

        def cmp(first: Candidate, second: Candidate) -> int:
            if first.is_known and not second.is_known:
                return -1
            if not first.is_known and second.is_known:
                return 1
            if first.fully_anchored and not second.fully_anchored:
                return -1
            if not first.fully_anchored and second.fully_anchored:
                return 1
            if first.length != second.length:
                return -1 if first.length > second.length else 1
            if abs(first.frequency - second.frequency) > 0.0:
                return -1 if first.frequency > second.frequency else 1
            if first.position != second.position:
                return -1 if first.position < second.position else 1
            return (-1 if first.alt_allele < second.alt_allele
                    else (1 if first.alt_allele > second.alt_allele else 0))

        potential.sort(key=functools.cmp_to_key(cmp))

        exact = next((m for m in potential
                      if m.equals_allele(to_collapse)
                      and not m.open_on_left and not m.open_on_right), None)
        if exact is not None:
            return exact
        for m in potential:
            if m.frequency < self.freq_threshold:
                continue
            # C# double semantics: x/0 = +inf (passes), 0/0 = NaN (fails)
            if to_collapse_freq == 0:
                ratio_ok = m.frequency > 0
            else:
                ratio_ok = m.frequency / to_collapse_freq > self.freq_ratio_threshold
            if ratio_ok:
                return m
        return None
