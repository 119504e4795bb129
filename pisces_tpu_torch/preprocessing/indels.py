"""Indel evidence collection, filtering, and ranked lookup for realignment.

Port of the Gemini candidate-indel selection stack:
  - per-read indel extraction with anchors/qualities
    (IndelCollection/IndelTargetFinder.cs:11-94)
  - evidence accumulation per indel key: observations, direction counts,
    reputable support, mess (NM beyond the indel), anchors, quality
    (IndelCollection/IndelEvidenceHelper.cs:22-210)
  - multi-criteria filtering with strong-indel rescue and scoring
    (CandidateIndelSelection/BasicIndelFilterer.cs:1-407)
  - genome contextualization: repeat/duplication detection, homopolymer
    trust, reference prefix/suffix context, collapse of effectively-same
    deletions and same-position competition
    (CandidateIndelSelection/HashableIndelSource.cs:1-482)
  - bucketed ranked KNN lookup (Realignment/ChromosomeIndelSource.cs:1-256)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

OP_M, OP_I, OP_D, OP_N, OP_S = 0, 1, 2, 3, 4


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

@dataclass
class PreIndel:
    """PreIndel (Gemini/Models/PreIndel.cs): a raw indel observation/candidate.
    position is the 1-based coordinate of the anchor base before the event."""
    chromosome: str
    position: int
    ref_allele: str
    alt_allele: str
    left_anchor: int = 0
    right_anchor: int = 0
    average_quality: int = 0
    in_multi: bool = False
    other_indel: str = ""
    observations: int = 0
    score: int = 0

    @property
    def is_insertion(self) -> bool:
        return len(self.alt_allele) > len(self.ref_allele)

    @property
    def length(self) -> int:
        return abs(len(self.alt_allele) - len(self.ref_allele))

    def key(self) -> str:
        return indel_key(self.chromosome, self.position, self.ref_allele,
                         self.alt_allele)


def indel_key(chrom: str, pos: int, ref: str, alt: str) -> str:
    """Helper.CandidateToString format: 'chrom:pos ref>alt'."""
    return f"{chrom}:{pos} {ref}>{alt}"


def parse_indel_key(key: str) -> PreIndel:
    chrom, rest = key.split(":", 1)
    pos_s, alleles = rest.split(" ", 1)
    ref, alt = alleles.split(">", 1)
    return PreIndel(chrom, int(pos_s), ref, alt)


@dataclass
class IndelEvidence:
    """IndelEvidence (IndelEvidenceHelper.cs:22-63)."""
    observations: int = 0
    left_anchor: int = 0
    right_anchor: int = 0
    mess: int = 0
    quality: int = 0
    forward: int = 0
    reverse: int = 0
    stitched: int = 0
    reputable_support: int = 0
    is_repeat: int = 0
    is_split: int = 0
    position: int = 0
    outcome: str = ""

    def add(self, other: "IndelEvidence") -> None:
        self.observations += other.observations
        self.left_anchor += other.left_anchor
        self.right_anchor += other.right_anchor
        self.mess += other.mess
        self.quality += other.quality
        self.forward += other.forward
        self.reverse += other.reverse
        self.stitched += other.stitched
        self.reputable_support += other.reputable_support
        self.is_repeat += other.is_repeat
        self.is_split += other.is_split
        self.position = other.position

    def row(self) -> str:
        return ",".join(str(x) for x in (
            self.observations, self.left_anchor, self.right_anchor,
            self.mess, self.quality, self.forward, self.reverse,
            self.stitched, self.reputable_support, self.is_repeat,
            self.is_split)) + "," + self.outcome


@dataclass(frozen=True)
class HashableIndel:
    """HashableIndel (ReadRealignmentLogic/Models/AlignmentResult.cs:7-34)."""
    chromosome: str
    position: int
    ref_allele: str
    alt_allele: str
    is_insertion: bool
    length: int
    score: int = 0
    in_multi: bool = False
    other_indel: str = ""
    is_repeat: bool = False
    repeat_unit: str = ""
    is_duplication: bool = False
    is_untrustworthy_in_repeat_region: bool = False
    ref_prefix: str = ""
    ref_suffix: str = ""
    num_bases_in_ref_suffix_before_unique: int = 0
    num_repeats_nearby: int = 0
    num_approx_dups_left: int = 0
    num_approx_dups_right: int = 0

    @property
    def string_rep(self) -> str:
        return indel_key(self.chromosome, self.position, self.ref_allele,
                         self.alt_allele)

    @property
    def hard_to_call(self) -> bool:
        return (self.is_insertion and self.length > 5) or self.is_duplication


# ---------------------------------------------------------------------------
# per-read extraction + evidence recording
# ---------------------------------------------------------------------------

def find_read_indels(chrom: str, pos1: int, cigar, seq: str, quals,
                     refseq_str: str, min_base_quality: int = 10
                     ) -> List[PreIndel]:
    """IndelTargetFinder.FindIndels with actual reference alleles (the
    reference stores N placeholders and contextualizes later; taking the
    bases from the reference genome up front is equivalent and keeps one
    key convention everywhere)."""
    out: List[PreIndel] = []
    read_i = 0
    ref_i = pos1  # 1-based position of the NEXT reference base
    n_ops = len(cigar)
    for oi, (op, ln) in enumerate(cigar):
        if op == OP_I:
            total_q = 0
            bad = 0
            for k in range(ln):
                if read_i + k >= len(quals):
                    break
                q = quals[read_i + k]
                total_q += int(q)
                if q < min_base_quality:
                    bad += 1
            ok = (bad / float(ln)) <= 0.1
            anchor_pos = ref_i - 1
            if ok and 1 <= anchor_pos <= len(refseq_str):
                ref_base = refseq_str[anchor_pos - 1]
                out.append(PreIndel(
                    chrom, anchor_pos, ref_base,
                    ref_base + seq[read_i:read_i + ln],
                    left_anchor=(cigar[oi - 1][1]
                                 if oi > 0 and cigar[oi - 1][0] == OP_M else 0),
                    right_anchor=(cigar[oi + 1][1]
                                  if oi < n_ops - 1 and cigar[oi + 1][0] == OP_M
                                  else 0),
                    average_quality=total_q // ln))
        elif op == OP_D:
            q_here = quals[read_i] if read_i < len(quals) else 0
            q_next = quals[read_i + 1] if read_i + 1 < len(quals) else 0
            ok = q_here >= min_base_quality and q_next >= min_base_quality
            anchor_pos = ref_i - 1
            if ok and 1 <= anchor_pos and anchor_pos + ln <= len(refseq_str):
                ref_bases = refseq_str[anchor_pos - 1:anchor_pos + ln]
                out.append(PreIndel(
                    chrom, anchor_pos, ref_bases, ref_bases[0],
                    left_anchor=(cigar[oi - 1][1]
                                 if oi > 0 and cigar[oi - 1][0] == OP_M else 0),
                    right_anchor=(cigar[oi + 1][1]
                                  if oi < n_ops - 1 and cigar[oi + 1][0] == OP_M
                                  else 0),
                    average_quality=(int(q_here) + int(q_next)) // 2))
        if op in (OP_M, OP_I, OP_S, 7, 8):
            read_i += ln
        if op in (OP_M, OP_D, OP_N, 7, 8):
            ref_i += ln
    return out


def record_indel_evidence(indels: List[PreIndel],
                          lookup: Dict[str, IndelEvidence],
                          is_reverse: bool, is_reputable: bool,
                          stitched: bool, mate_unmapped_or_other_chrom: bool,
                          total_nm: int) -> None:
    """IndelEvidenceHelper.FindIndelsAndRecordEvidence (post-extraction
    half): accumulate per-key metrics for singles and multi pairs."""
    if not indels:
        return
    is_multi = len(indels) > 1
    span_needed = 0
    if is_multi:
        first = indels[0].position
        last = indels[-1]
        last_pos = (last.position + 1 if not last.is_insertion
                    else last.position + last.length)
        span_needed = last_pos - first

    def read_level(ev: IndelEvidence) -> None:
        ev.observations += 1
        if stitched:
            ev.stitched += 1
        elif is_reverse:
            ev.reverse += 1
        else:
            ev.forward += 1
        if is_reputable:
            ev.reputable_support += 1
        if mate_unmapped_or_other_chrom:
            ev.is_split += 1

    if not is_multi or span_needed > 25:
        for indel in indels:
            ev = lookup.setdefault(indel.key(), IndelEvidence())
            read_level(ev)
            ev.position = indel.position
            ev.left_anchor += indel.left_anchor
            ev.right_anchor += indel.right_anchor
            ev.mess += max(0, total_nm - indel.length)
            ev.quality += indel.average_quality
    if is_multi and len(indels) == 2:
        key = "|".join(i.key() for i in indels)
        ev = lookup.setdefault(key, IndelEvidence())
        read_level(ev)
        ev.position = indels[0].position
        ev.left_anchor += indels[0].left_anchor
        ev.right_anchor += indels[1].right_anchor
        ev.mess += max(0, total_nm - sum(i.length for i in indels))
        ev.quality += min(i.average_quality for i in indels)


# ---------------------------------------------------------------------------
# filtering + scoring (BasicIndelFilterer)
# ---------------------------------------------------------------------------

class BasicIndelFilterer:
    def __init__(self, found_threshold: int, anchor_threshold: int,
                 strict_anchor_threshold: int = 0,
                 strict_found_threshold: int = 0, max_mess: int = 20):
        self._found = found_threshold
        self._anchor = anchor_threshold
        self._strict_anchor = strict_anchor_threshold
        self._strict_found = strict_found_threshold
        self._max_mess = max_mess

    def get_realignable_preindels(self, lookup: Dict[str, IndelEvidence],
                                  allow_rescue: bool) -> List[PreIndel]:
        edge_threshold = max(self._found + 1, self._found * 1.5)
        to_add: List[PreIndel] = []
        multis: Dict[str, Tuple[PreIndel, List[IndelEvidence]]] = {}

        for key, ev in lookup.items():
            if ev.observations == 0:
                ev.outcome = "LowObservations"
                continue
            if ev.observations < self._strict_found:
                ev.outcome = "LowObservations"
                continue
            if ev.reputable_support < 1:
                ev.outcome = "LowReputableSupport"
                continue
            parts = key.split("|")
            if len(parts) > 2:
                continue
            if len(parts) == 2:
                i1 = parse_indel_key(parts[0])
                i2 = parse_indel_key(parts[1])
                i1.in_multi = i2.in_multi = True
                i1.other_indel = i2.key()
                i2.other_indel = i1.key()
                for sub in (i1, i2):
                    mk = sub.key() + "|" + sub.other_indel
                    if mk not in multis:
                        multis[mk] = (sub, [])
                    multis[mk][1].append(ev)
            else:
                entry = self._extract(ev, key, edge_threshold, allow_rescue,
                                      [parse_indel_key(key)])
                if entry:
                    to_add.extend(entry)

        for mk, (sub, evs) in multis.items():
            merged = IndelEvidence()
            for e in evs:
                merged.add(e)
            entry = self._extract(merged, mk, edge_threshold, allow_rescue,
                                  [sub])
            if entry:
                to_add.extend(entry)
        return to_add

    def _is_strong(self, avg_quals, reputable_frac, avg_left, avg_mess,
                   avg_right, rev_support, obs, fwd_support, key,
                   stitched_support) -> bool:
        """IsStrong (BasicIndelFilterer.cs:186-221)."""
        if obs < self._strict_found:
            return False
        if min(avg_left, avg_right) < self._strict_anchor:
            return False
        strong = (avg_quals > 32
                  and ((reputable_frac > 0.75 and min(avg_left, avg_right) > 30
                        and avg_mess <= 0.4)
                       or (avg_mess <= max(1.5, min(avg_left, avg_right) / 20)
                           and reputable_frac > 0.6
                           and abs((fwd_support - rev_support)
                                   + stitched_support) < 0.25))
                  and ((obs > 2 and avg_left > 20 and avg_right > 20)
                       or (avg_left > 30 and avg_right > 30)))
        if "|" in key and not strong:
            strong = (avg_quals > 34 and avg_mess <= 1
                      and avg_left > 10 and avg_right > 10)
        return strong

    def _extract(self, ev: IndelEvidence, key: str, edge_threshold: float,
                 allow_rescue: bool,
                 indels: List[PreIndel]) -> Optional[List[PreIndel]]:
        obs = ev.observations
        fwd = ev.forward / float(obs)
        rev = ev.reverse / float(obs)
        stitched = ev.stitched / float(obs)
        reputable_frac = ev.reputable_support / float(obs)
        avg_left = ev.left_anchor / float(obs)
        avg_right = ev.right_anchor / float(obs)
        avg_quals = ev.quality / float(obs)
        avg_mess = ev.mess / float(obs)

        strong = False
        if allow_rescue:
            strong = self._is_strong(avg_quals, reputable_frac, avg_left,
                                     avg_mess, avg_right, rev, obs, fwd, key,
                                     stitched)
        out = [self._scored(i, ev, fwd, rev, reputable_frac, avg_quals,
                            stitched) for i in indels]

        if (len(indels) == 1 and out[0].length == 1
                and (obs < self._found * 0.8 or obs <= 2)):
            ev.outcome = "SuperWeakSmall"
            return None
        if self._should_remove(obs, avg_left, avg_right, strong, avg_quals,
                               avg_mess, ev.left_anchor, ev.right_anchor,
                               edge_threshold, ev):
            return None
        ev.outcome = ev.outcome or "Kept"
        return out

    def _should_remove(self, obs, avg_left, avg_right, strong, avg_quals,
                       avg_mess, left, right, edge_threshold,
                       ev: IndelEvidence) -> bool:
        """ShouldRemoveVariant (BasicIndelFilterer.cs:328-365)."""
        if (obs < self._found or avg_left < self._anchor
                or avg_right < self._anchor or avg_mess > self._max_mess):
            if strong:
                ev.outcome = "Rescued"
            else:
                ev.outcome = "BelowThreshold"
                return True
        if obs == 1 and (min(left, right) < 5 or avg_mess > 1
                         or avg_quals < 30):
            ev.outcome = "PoorSingle"
            return True
        if obs <= edge_threshold and (avg_mess > 2 or avg_quals < 25):
            ev.outcome = "PoorEdge"
            return True
        return False

    @staticmethod
    def _scored(indel: PreIndel, ev: IndelEvidence, fwd, rev, reputable,
                avg_quals, stitched) -> PreIndel:
        """GetIndelFromEntry scoring (BasicIndelFilterer.cs:385-406)."""
        obs = ev.observations
        avg_anchor = (ev.left_anchor + ev.right_anchor) // obs
        avg_mess = ev.mess / float(obs)
        balance = (fwd / max(1.0, rev)) if fwd >= rev else (rev / max(1.0, fwd))
        anchor_balance = (ev.left_anchor / float(max(1, ev.right_anchor))
                          if ev.left_anchor >= ev.right_anchor
                          else ev.right_anchor / float(max(1, ev.left_anchor)))
        avg_clean_anchor = ((avg_anchor - avg_mess) / float(avg_anchor)
                            if avg_anchor else 0.0)
        score = int(max(0, int(
            obs * (1 / balance) * (1 / anchor_balance)
            * (1 + reputable + (stitched / balance))
            * (avg_quals / 30) * avg_clean_anchor * 10))
            * (1 + (indel.length // 5))  # C# integer division
            * ((obs - ev.is_split - ev.is_repeat) / float(obs)))
        indel.observations = obs
        indel.score = score
        return indel


# ---------------------------------------------------------------------------
# genome contextualization (HashableIndelSource)
# ---------------------------------------------------------------------------

def hamming_mismatches(s1: str, s2: str) -> Optional[int]:
    if len(s1) != len(s2):
        return None
    return sum(1 for a, b in zip(s1, s2) if a != b)


def is_repeat_with_unit(bases: str, max_unit: int) -> Tuple[bool, str]:
    """OverlapEvaluator.IsRepeat(string, int, out unit)."""
    n = len(bases)
    window = 1
    while window <= min(n - 1, max_unit):
        limit = 2 if n >= 5 else n - window
        units = []
        i = 0
        while i <= limit:
            u = bases[i:i + window]
            if len(u) == window and u not in units:
                units.append(u)
            i += 1
        for unit in units:
            if n == len(unit):
                continue
            mult = n // len(unit)
            base_seq = unit * mult
            if bases == base_seq:
                return True, unit
            if bases.startswith(base_seq):
                rest = bases[len(base_seq):]
                if rest and unit.startswith(rest):
                    return True, unit
        window += 1
    return False, ""


def compute_rmxn_for_indel(variant_pos0: int, variant_bases: str,
                           refseq_str: str, max_unit: int
                           ) -> Tuple[int, str]:
    """Helper.ComputeRMxNLengthForIndel (Helper.cs:103-154)."""
    best = 0
    best_unit = ""
    length = len(variant_bases)
    bookends = []
    for i in range(length - min(max_unit, length), length):
        bookends.append(variant_bases[:length - i])
        bookends.append(variant_bases[i:])
    for bookend in bookends:
        if not bookend:
            continue
        back = variant_pos0
        while True:
            nb = back - len(bookend)
            if nb < 0:
                break
            if refseq_str[nb:nb + len(bookend)] != bookend:
                break
            back = nb
        count = 0
        cur = back
        while cur + len(bookend) <= len(refseq_str):
            if refseq_str[cur:cur + len(bookend)] != bookend:
                break
            count += 1
            cur += len(bookend)
        if count > best:
            best = count
            best_unit = bookend
    return best, best_unit


def is_duplication(refseq_str: str, ref_pos: int, is_rep: bool,
                   repeat_unit: str, alt: str, min_allele_len: int = 4
                   ) -> bool:
    """Helper.IsDuplication (Helper.cs:156-197). ref_pos is the 1-based
    anchor position (used as a 0-based index past the anchor, matching the
    reference's convention of position being the index after the base)."""
    if len(alt) < min_allele_len:
        return False
    if is_rep:
        lo = ref_pos - len(repeat_unit)
        if lo >= 0 and refseq_str[lo:ref_pos] == repeat_unit:
            return True
        if refseq_str[ref_pos + 1:ref_pos + 1 + len(repeat_unit)] == repeat_unit:
            return True
        return False
    allele_seq = alt[1:]
    for i in range(-2, 3):
        start = ref_pos + i
        if start < 0:
            continue
        if refseq_str[start:start + len(alt) - 1] == allele_seq:
            return True
    return False


def is_in_homopolymer_stretch(refseq_str: str, ref_pos: int,
                              threshold: float = 0.66) -> bool:
    """Helper.IsInHomopolymerStretch (Helper.cs:199-240)."""
    counts = {"A": 0, "T": 0, "C": 0, "G": 0}
    total = 0
    for i in range(-10, 11):
        p = ref_pos + i
        if p < 0:
            continue
        if p >= len(refseq_str):
            break
        b = refseq_str[p].upper()
        total += 1
        if b in counts:
            counts[b] += 1
    if not total:
        return False
    return max(counts.values()) / float(total) > threshold


def get_hashable_indel(refseq_str: str, pre: PreIndel) -> HashableIndel:
    """HashableIndelSource.GetHashableIndel (HashableIndelSource.cs:53-236)."""
    pos = pre.position
    ref = refseq_str[pos - 1:pos - 1 + len(pre.ref_allele)]
    alt = (ref + pre.alt_allele[1:]) if len(ref) == 1 else ref[0]
    is_ins = len(alt) > len(ref)
    variant_bases = alt[1:] if is_ins else ref[1:]
    length = abs(len(ref) - len(alt))

    is_rep, repeat_unit = is_repeat_with_unit(variant_bases, 3)
    dup = is_duplication(refseq_str, pos, is_rep, repeat_unit, alt)

    num_dups_left = num_dups_right = 0
    if is_ins and pre.length > 3:
        cur = pos
        while cur + pre.length <= len(refseq_str) - pre.length:
            seg = refseq_str[cur:cur + pre.length]
            mm = hamming_mismatches(seg, variant_bases)
            if mm is not None and mm <= 1:
                num_dups_right += 1
                cur += pre.length
            else:
                break
        cur = pos - pre.length
        while cur >= 0:
            seg = refseq_str[cur:cur + pre.length]
            mm = hamming_mismatches(seg, variant_bases)
            if mm is not None and mm <= 1:
                num_dups_left += 1
                cur -= pre.length
            else:
                break

    repeats, new_unit = compute_rmxn_for_indel(pos, variant_bases,
                                               refseq_str, 6)
    if repeats >= 6:
        is_rep = True
        repeat_unit = new_unit

    other = ""
    if pre.in_multi and pre.other_indel:
        o = parse_indel_key(pre.other_indel)
        oref = refseq_str[o.position - 1:o.position - 1 + len(o.ref_allele)]
        oalt = (oref + o.alt_allele[1:]) if len(oref) == 1 else oref[0]
        other = indel_key(o.chromosome, o.position, oref, oalt)

    untrustworthy = (length == 1
                     and is_in_homopolymer_stretch(refseq_str, pos))

    offset = max(10, 3 * pre.length)
    prefix_start = max(0, pos - 1 - offset - 1)
    ref_prefix = refseq_str[prefix_start:pos]
    suffix_start = pos + len(ref) - 1
    ref_suffix = refseq_str[suffix_start:suffix_start + offset]

    n_unique = 0
    if is_ins:
        probe = repeat_unit if is_rep else alt
        if probe:
            i = 0
            while i < len(ref_suffix) - len(probe):
                if ref_suffix[i:i + len(probe)] == probe:
                    n_unique += 1
                    i += len(probe)
                else:
                    break

    return HashableIndel(
        chromosome=pre.chromosome, position=pos, ref_allele=ref,
        alt_allele=alt, is_insertion=is_ins, length=length, score=pre.score,
        in_multi=pre.in_multi, other_indel=other, is_repeat=is_rep,
        repeat_unit=repeat_unit, is_duplication=dup,
        is_untrustworthy_in_repeat_region=untrustworthy,
        ref_prefix=ref_prefix, ref_suffix=ref_suffix,
        num_bases_in_ref_suffix_before_unique=n_unique,
        num_repeats_nearby=repeats, num_approx_dups_left=num_dups_left,
        num_approx_dups_right=num_dups_right)


def get_final_indels_for_chromosome(pre_indels: List[PreIndel],
                                    refseq_str: str) -> List[HashableIndel]:
    """HashableIndelSource.GetFinalIndelsForChromosome: contextualize and
    prune weak/duplicative candidates (HashableIndelSource.cs:268-478)."""
    if not pre_indels:
        return []
    supports = sorted(p.observations for p in pre_indels)
    median_support = supports[len(supports) // 2]
    threshold_untrustworthy = median_support / 5

    indels: Dict[HashableIndel, List[PreIndel]] = {}
    for pre in pre_indels:
        h = get_hashable_indel(refseq_str, pre)
        if h.score == 0:
            continue
        if (h.is_untrustworthy_in_repeat_region
                and pre.observations < threshold_untrustworthy
                and not h.in_multi):
            continue
        indels.setdefault(h, []).append(pre)

    # collapse neighboring same-length deletions with essentially the same
    # consequence
    to_remove: set = set()
    for indel in sorted(indels, key=lambda x: -x.score):
        if indel.in_multi or indel in to_remove:
            continue
        thresh = 75
        nearby = [x for x in indels
                  if x != indel and not x.in_multi
                  and abs(indel.position - x.position) <= thresh
                  and x.is_insertion == indel.is_insertion
                  and x.length == indel.length
                  and x.score * 2 < indel.score]
        if not nearby:
            continue
        width = thresh * 2
        snip_start = max(indel.position - width, 0)
        end_adj = 0 if indel.is_insertion else indel.length
        snip_end = min(indel.position + width + end_adj, len(refseq_str))

        def effective(x: HashableIndel) -> str:
            adj = 0 if x.is_insertion else x.length
            pre_len = x.position - snip_start
            post = snip_start + pre_len + adj
            var_seq = x.alt_allele[1:] if x.is_insertion else ""
            return (refseq_str[snip_start:snip_start + pre_len] + var_seq
                    + refseq_str[post:snip_end])

        eff = effective(indel)
        for near in nearby:
            eff2 = effective(near)
            mism = sum(1 for a, b in zip(eff, eff2) if a != b)
            if mism <= 1:
                to_remove.add(near)
    for x in to_remove:
        del indels[x]

    # same-position competition
    to_remove = set()
    for indel in list(indels):
        if indel.in_multi or indel in to_remove:
            continue
        same_pos = [x for x in indels
                    if x.position == indel.position
                    and x.is_insertion == indel.is_insertion
                    and x != indel and not x.in_multi]
        if not same_pos:
            continue
        removed = 0
        for x in same_pos:
            if x.score * 2 < indel.score and not x.hard_to_call:
                to_remove.add(x)
                removed += 1
        if len(same_pos) - removed > 2:
            to_remove.add(indel)
            to_remove.update(same_pos)
    for x in to_remove:
        if x in indels:
            del indels[x]

    return list(indels)


# ---------------------------------------------------------------------------
# ranked bucketed lookup (ChromosomeIndelSource)
# ---------------------------------------------------------------------------

def is_match(pre: PreIndel, h: HashableIndel) -> bool:
    """Helper.IsMatch(PreIndel, HashableIndel): same locus+type+length
    (alleles may differ in representation, e.g. N placeholders)."""
    return (pre.position == h.position
            and pre.is_insertion == h.is_insertion
            and pre.length == h.length)


class ChromosomeIndelSource:
    """Bucketed ranked indel lookup (ChromosomeIndelSource.cs:23-256)."""

    MAX_DISTANCE = 250
    MAX_TOP = 5
    MAX_EXTRA_MULTI = 3

    def __init__(self, indels: List[HashableIndel], bucket_size: int = 1000):
        self.indels = indels
        self._bucket_size = bucket_size
        self._buckets: Dict[int, List[HashableIndel]] = {}
        if not indels:
            self.lowest = 0
            self.highest = 0
            return
        self.lowest = min(x.position for x in indels)
        self.highest = max(x.position for x in indels)
        for indel in indels:
            b = (indel.position - self.lowest) // bucket_size
            self._buckets.setdefault(b, []).append(indel)

    def any_indels_nearby(self, position: int) -> bool:
        if not self.indels:
            return False
        return (self.lowest - self._bucket_size <= position
                <= self.highest + self._bucket_size)

    def get_relevant_indels(self, position: int,
                            preselected: Optional[List[PreIndel]] = None,
                            confirmed: Optional[List[HashableIndel]] = None
                            ) -> List[HashableIndel]:
        if (not self.indels or position > self.highest + self._bucket_size
                or position < self.lowest - self._bucket_size):
            return []
        found: Dict[HashableIndel, bool] = {}
        exact = (position - self.lowest) // self._bucket_size
        for i in range(3):
            bucket = self._buckets.get(exact - 1 + i)
            if not bucket:
                continue
            added = 0
            for item in sorted(bucket, key=lambda v: -v.score):
                if ((added >= self.MAX_TOP and not item.in_multi)
                        or added >= self.MAX_TOP + self.MAX_EXTRA_MULTI):
                    continue
                if abs(item.position - position) <= self.MAX_DISTANCE:
                    added += 1
                    found[item] = True

        def is_preselected(x: HashableIndel) -> bool:
            if not preselected:
                return False
            return any(is_match(p, x) for p in preselected) or (
                x.in_multi and any(p.key() == x.other_indel
                                   for p in preselected))

        def is_favored(x: HashableIndel) -> bool:
            if x.hard_to_call and is_preselected(x):
                return True
            if confirmed and (any(c.string_rep == x.string_rep
                                  for c in confirmed)
                              or (x.in_multi
                                  and any(c.string_rep == x.other_indel
                                          for c in confirmed))):
                return True
            return False

        ranked = sorted(found, key=lambda x: (
            not is_favored(x), -x.score, not is_preselected(x), x.string_rep))

        if len(ranked) > self.MAX_TOP:
            keep = ranked[:self.MAX_TOP]
            keep += [x for x in ranked if x.in_multi][:self.MAX_EXTRA_MULTI]
            keep += [x for x in ranked if is_preselected(x)]
            seen = set()
            filtered = []
            for x in keep:
                if x not in seen:
                    seen.add(x)
                    filtered.append(x)
        else:
            filtered = ranked

        if confirmed:
            near_confirmed = any(
                (c.position >= position and c.position - position < 100)
                or (c.position <= position and position - c.position < 50)
                for c in confirmed)
            if near_confirmed:
                def take(x: HashableIndel) -> bool:
                    return x.is_duplication or any(
                        c.string_rep == x.string_rep for c in confirmed) or (
                        x.in_multi and any(c.string_rep == x.other_indel
                                           for c in confirmed))
                to_confirmed = [x for x in filtered if take(x)]
                if to_confirmed:
                    filtered = to_confirmed
        return filtered
