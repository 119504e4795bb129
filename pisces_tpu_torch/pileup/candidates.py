"""Candidate variant discovery from columnar read batches.

Faithful re-derivation of the reference CIGAR walk
(CandidateVariantFinder.cs:36-168, 334-445): SNV/MNV extraction with MNV
build-up rules, insertion/deletion extraction with quality gates, support
direction, well-anchored support, and open-ended annotation.

Two paths:
  - find_candidates_read(): exact per-read state machine (any options);
  - find_snv_candidates_vectorized(): batch path for call_mnvs=False (the
    reference default), used on the hot path.

Candidate de-dup across reads is an order-insensitive keyed aggregation
(commutative sums per (pos, ref, alt, openL, openR) key), replacing
RegionState.AddCandidate (cs:94-174).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from pisces_tpu_torch.domain.types import (
    NUM_DIRECTION_TYPES, AlleleCategory, AlleleType,
)
from pisces_tpu_torch.io.bam import OP_D, OP_I, OP_M, OP_S, ReadBatch
from pisces_tpu_torch.pileup.events import read_directions
from pisces_tpu_torch.utils.metrics import metrics

ALLELE_CHARS = np.frombuffer(b"AGCTN-", dtype=np.uint8)
_N = int(AlleleType.N)


@dataclass
class Candidate:
    """Aggregated candidate allele (CandidateAllele equivalent)."""

    chromosome: str
    position: int           # 1-based
    ref_allele: str
    alt_allele: str
    category: AlleleCategory
    support_by_direction: np.ndarray = field(
        default_factory=lambda: np.zeros(NUM_DIRECTION_TYPES, dtype=np.int64))
    well_anchored_by_direction: np.ndarray = field(
        default_factory=lambda: np.zeros(NUM_DIRECTION_TYPES, dtype=np.int64))
    open_on_left: bool = False
    open_on_right: bool = False
    is_known: bool = False
    is_forced: bool = False
    frequency: float = 0.0  # scratch, used by collapser
    support_by_amplicon: Optional[Dict[str, int]] = None
    read_collapsed_counts: Optional[np.ndarray] = None  # [8] UMI categories

    @property
    def support(self) -> int:
        return int(self.support_by_direction.sum())

    @property
    def well_anchored_support(self) -> int:
        return int(self.well_anchored_by_direction.sum())

    @property
    def fully_anchored(self) -> bool:
        return not (self.open_on_left or self.open_on_right)

    @property
    def length(self) -> int:
        if self.category in (AlleleCategory.SNV, AlleleCategory.MNV):
            return len(self.alt_allele)
        if self.category == AlleleCategory.INSERTION:
            return len(self.alt_allele) - 1
        if self.category == AlleleCategory.DELETION:
            return len(self.ref_allele) - 1
        return len(self.ref_allele)

    def equals_allele(self, other: "Candidate") -> bool:
        return (self.position == other.position
                and self.alt_allele == other.alt_allele
                and self.category == other.category
                and self.ref_allele == other.ref_allele)

    def key(self, track_open_ended: bool):
        base = (self.position, self.ref_allele, self.alt_allele, int(self.category))
        if track_open_ended:
            return base + (self.open_on_left, self.open_on_right)
        return base

    def max_allele_endpoint(self) -> int:
        """Block-spill endpoint (RegionState.UpdateMaxPosition)."""
        if self.category == AlleleCategory.DELETION:
            return self.position + len(self.ref_allele)
        if self.category == AlleleCategory.INSERTION:
            return self.position + 1
        if self.category == AlleleCategory.MNV:
            return self.position + len(self.ref_allele) - 1
        return 0


class CandidateAggregator:
    """Order-preserving keyed aggregation of per-read candidate observations."""

    def __init__(self, track_open_ended: bool):
        self.track_open_ended = track_open_ended
        self._by_key: Dict[tuple, Candidate] = {}

    def add(self, cand: Candidate) -> None:
        key = cand.key(self.track_open_ended)
        existing = self._by_key.get(key)
        if existing is None:
            self._by_key[key] = cand
        else:
            existing.support_by_direction += cand.support_by_direction
            existing.well_anchored_by_direction += cand.well_anchored_by_direction
            if cand.support_by_amplicon:
                if existing.support_by_amplicon is None:
                    existing.support_by_amplicon = {}
                for name, n in cand.support_by_amplicon.items():
                    existing.support_by_amplicon[name] = (
                        existing.support_by_amplicon.get(name, 0) + n)
            if cand.read_collapsed_counts is not None:
                if existing.read_collapsed_counts is None:
                    existing.read_collapsed_counts = cand.read_collapsed_counts.copy()
                else:
                    existing.read_collapsed_counts += cand.read_collapsed_counts

    def add_counts(self, cand: Candidate, direction: int, well_anchored: bool,
                   count: int = 1) -> None:
        key = cand.key(self.track_open_ended)
        existing = self._by_key.get(key)
        if existing is None:
            self._by_key[key] = cand
            existing = cand
            existing.support_by_direction = np.zeros(NUM_DIRECTION_TYPES, np.int64)
            existing.well_anchored_by_direction = np.zeros(NUM_DIRECTION_TYPES, np.int64)
        existing.support_by_direction[direction] += count
        if well_anchored:
            existing.well_anchored_by_direction[direction] += count

    def candidates(self) -> List[Candidate]:
        return list(self._by_key.values())


def _well_anchored(position: int, read_start1: int, read_end1: int,
                   alt_len: int, anchor_size: int) -> bool:
    anchor = min(position - read_start1, read_end1 - position)
    return anchor > min(anchor_size - 1, alt_len - 1)


def find_candidates_read(
    chrom: str,
    refseq: np.ndarray,          # uint8 ASCII uppercase
    refseq_codes: np.ndarray,    # int8 AlleleType codes of refseq
    pos1: int,                   # 1-based read start
    end1: int,                   # 1-based last ref-consumed position
    ops: np.ndarray, lens: np.ndarray,
    seq: np.ndarray,             # int8 allele codes
    qual: np.ndarray,
    direction,                   # int (uniform) or int8 array per base
    min_bq: int,
    call_mnvs: bool,
    max_mnv_len: int,
    max_gap: int,
    anchor_size: int,
    expanded_info=None,          # (expanded_dirs, expanded_index_of) for XD reads
    amplicon_name=None,          # XN tag; tracked for SNV/MNV candidates only
) -> List[Candidate]:
    """Exact per-read candidate state machine (ProcessCigarOps)."""
    candidates: List[Candidate] = []
    ref_len = len(refseq)
    start_read = 0
    start_ref0 = pos1 - 1  # 0-based

    uniform_dir = None if isinstance(direction, np.ndarray) else int(direction)

    def _support_dir(category: AlleleCategory, start_idx: int, alt_len: int) -> int:
        if uniform_dir is not None:
            return uniform_dir
        from pisces_tpu_torch.pileup.directions import support_direction
        exp_d, exp_i = expanded_info if expanded_info is not None else (None, None)
        return support_direction(int(category), direction, start_idx, alt_len,
                                 exp_d, exp_i)

    def flush(var_start_read: int, var_start_ref0: int, var_len: int,
              intervening: int, open_left: bool, open_right: bool):
        if intervening >= 1:
            var_len -= intervening
            open_right = False
        if var_len >= 1:
            ref_bases = refseq[var_start_ref0:var_start_ref0 + var_len].tobytes().decode()
            alt_bases = ALLELE_CHARS[seq[var_start_read:var_start_read + var_len]].tobytes().decode()
            cat = AlleleCategory.MNV if var_len > 1 else AlleleCategory.SNV
            c = Candidate(chrom, var_start_ref0 + 1, ref_bases, alt_bases, cat,
                          open_on_left=open_left, open_on_right=open_right)
            d = _support_dir(cat, var_start_read, len(alt_bases))
            c.support_by_direction[d] = 1
            if _well_anchored(c.position, pos1, end1, len(alt_bases), anchor_size):
                c.well_anchored_by_direction[d] = 1
            if amplicon_name:
                c.support_by_amplicon = {amplicon_name: 1}
            candidates.append(c)

    def should_build(mnv_len: int, intervening: int, ref_next: bool) -> bool:
        if not call_mnvs:
            return False
        if ref_next and mnv_len == 0:
            return False
        if mnv_len + 1 > max_mnv_len:
            return False
        if intervening + (1 if ref_next else 0) > max_gap:
            return False
        return True

    for oi in range(len(ops)):
        op, ln = int(ops[oi]), int(lens[oi])
        if op == OP_M or op == 7 or op == 8:  # M / = / X
            var_len = 0
            intervening = 0
            open_left = False
            i = 0
            while i < ln:
                if start_ref0 + i >= ref_len:
                    break
                q_ok = qual[start_read + i] >= min_bq
                rb = int(refseq_codes[start_ref0 + i])
                bb = int(seq[start_read + i])
                at_end = i == ln - 1
                starting_at_end = at_end and var_len == 0
                if bb == _N or rb == _N or not q_ok:
                    flush(start_read + i - var_len, start_ref0 + i - var_len,
                          var_len, intervening, open_left, True)
                    var_len = 0
                    intervening = 0
                    open_left = True
                elif bb == rb:
                    if should_build(var_len, intervening, True) and not starting_at_end:
                        var_len += 1
                        intervening += 1
                    else:
                        flush(start_read + i - var_len, start_ref0 + i - var_len,
                              var_len, intervening, open_left, False)
                        var_len = 0
                        intervening = 0
                        open_left = False
                else:
                    if should_build(var_len, intervening, False) and not starting_at_end:
                        var_len += 1
                        intervening = 0
                    else:
                        flush(start_read + i - var_len, start_ref0 + i - var_len,
                              var_len, intervening, open_left, False)
                        var_len = 1
                        intervening = 0
                        open_left = False
                i += 1
            flush(start_read + ln - var_len, start_ref0 + ln - var_len,
                  var_len, intervening, open_left, False)
        elif op == OP_I:
            if not (start_ref0 - 1 >= ref_len or start_ref0 == 0):
                if qual[start_read] >= min_bq:
                    ref_base = chr(refseq[start_ref0 - 1])
                    added = ALLELE_CHARS[seq[start_read:start_read + ln]].tobytes().decode()
                    c = Candidate(chrom, start_ref0, ref_base, ref_base + added,
                                  AlleleCategory.INSERTION)
                    d = _support_dir(AlleleCategory.INSERTION, start_read, ln + 1)
                    c.support_by_direction[d] = 1
                    if _well_anchored(c.position, pos1, end1, ln + 1, anchor_size):
                        c.well_anchored_by_direction[d] = 1
                    candidates.append(c)
        elif op == OP_D:
            if not (start_ref0 + ln >= ref_len):
                n_q = len(qual)
                if n_q > 0:
                    after = qual[start_read] if start_read < n_q else qual[start_read - 1]
                    before = qual[start_read - 1] if start_read > 0 else after
                    if after >= min_bq and before >= min_bq:
                        ref_bases = refseq[start_ref0 - 1:start_ref0 + ln].tobytes().decode()
                        c = Candidate(chrom, start_ref0, ref_bases, ref_bases[0],
                                      AlleleCategory.DELETION)
                        d = _support_dir(AlleleCategory.DELETION, start_read, 1)
                        c.support_by_direction[d] = 1
                        if _well_anchored(c.position, pos1, end1, ln, anchor_size):
                            c.well_anchored_by_direction[d] = 1
                        candidates.append(c)
        # advance cursors
        if op in (OP_M, OP_I, OP_S, 7, 8):
            start_read += ln
        if op in (OP_M, OP_D, 3, 7, 8):  # M/D/N/=/X
            start_ref0 += ln

    _annotate_open_ends(candidates, pos1, end1, ops, lens)
    return candidates


def _annotate_open_ends(candidates: List[Candidate], pos1: int, end1: int,
                        ops: np.ndarray, lens: np.ndarray) -> None:
    """CandidateVariantFinder.Annotate (cs:496-553): `pos1` and `end1` are
    the read's first and last aligned reference positions, 1-based."""
    if not candidates or len(ops) == 0:
        return
    first_op = int(ops[0])
    last_op = int(ops[-1])
    if first_op == OP_S and len(ops) > 1:
        first_op = int(ops[1])
    if last_op == OP_S and len(ops) > 1:
        last_op = int(ops[-2])

    for c in candidates:
        if first_op in (OP_M, 7, 8):
            if (c.position == pos1 and
                    c.category in (AlleleCategory.MNV, AlleleCategory.SNV)):
                c.open_on_left = True
        elif first_op == OP_I:
            if c.position == pos1 - 1 and c.category == AlleleCategory.INSERTION:
                c.open_on_left = True
        elif first_op == OP_D:
            if c.position == pos1 - 1 and c.category == AlleleCategory.DELETION:
                c.open_on_left = True

        if last_op in (OP_M, 7, 8):
            if (c.position + len(c.alt_allele) - 1 == end1 and
                    c.category in (AlleleCategory.MNV, AlleleCategory.SNV)):
                c.open_on_right = True
        elif last_op == OP_I:
            if c.position == end1 and c.category == AlleleCategory.INSERTION:
                c.open_on_right = True
        elif last_op == OP_D:
            if c.position == end1 and c.category == AlleleCategory.DELETION:
                c.open_on_right = True


def find_candidates_batch(
    chrom: str,
    refseq: np.ndarray,
    batch: ReadBatch,
    keep: np.ndarray,
    min_bq: int,
    call_mnvs: bool = False,
    max_mnv_len: int = 3,
    max_gap: int = 1,
    anchor_size: int = 5,
    track_open_ended: bool = True,
    track_amplicons: bool = False,
) -> Tuple[List[Candidate], CandidateAggregator]:
    """Find + aggregate candidates for all kept reads of a batch.

    When MNV calling is off (the reference default) the vectorized fast path
    replaces the per-read state machine; equivalence is asserted in tests.
    """
    from pisces_tpu_torch.domain.types import BASE_TO_ALLELE
    if not call_mnvs and not track_amplicons and batch.extra_tags is None:
        from pisces_tpu_torch.pileup.candidates_fast import (
            find_indel_candidates, find_snv_candidates_vectorized,
        )
        # an untagged batch (both readers set extra_tags wherever they set
        # xd_tags): each read's bases take its strand direction
        snvs = find_snv_candidates_vectorized(
            chrom, refseq, batch, keep, min_bq, anchor_size, track_open_ended)
        indels = find_indel_candidates(
            chrom, refseq, batch, keep, min_bq, anchor_size, track_open_ended)
        return snvs + indels, None
    refseq_codes = BASE_TO_ALLELE[refseq]
    dirs = read_directions(batch)
    agg = CandidateAggregator(track_open_ended)
    kept = np.nonzero(keep)[0]
    metrics.count("reads_state_machine", len(kept))
    for i in kept:
        s, e = batch.cigar_off[i], batch.cigar_off[i + 1]
        qs, qe = batch.seq_off[i], batch.seq_off[i + 1]
        xd = batch.xd_tags[i] if batch.xd_tags is not None else None
        if xd:
            from pisces_tpu_torch.pileup.directions import (
                expanded_maps, sequenced_direction_map)
            dir_arg = sequenced_direction_map(
                xd, batch.cigar_ops[s:e], batch.cigar_lens[s:e])
            exp_info = expanded_maps(xd, batch.cigar_ops[s:e],
                                     batch.cigar_lens[s:e])
        else:
            dir_arg = int(dirs[i])
            exp_info = None
        cands = find_candidates_read(
            chrom, refseq, refseq_codes,
            int(batch.pos[i]) + 1, int(batch.end_pos[i]) + 1,
            batch.cigar_ops[s:e], batch.cigar_lens[s:e],
            batch.seq[qs:qe], batch.qual[qs:qe],
            dir_arg, min_bq, call_mnvs, max_mnv_len, max_gap, anchor_size,
            expanded_info=exp_info,
            amplicon_name=(batch.xn_tags[i] if (track_amplicons
                           and batch.xn_tags is not None) else None))
        if batch.extra_tags is not None:
            from pisces_tpu_torch.pileup.collapsed import (
                candidate_collapsed_counts, is_collapsed, is_duplex,
                pair_direction,
            )
            tags = batch.extra_tags[i]
            if is_collapsed(tags):
                pd = pair_direction(int(batch.flag[i]), tags.get("XR"))
                dup = is_duplex(tags)
                for c in cands:
                    d = int(c.support_by_direction.argmax())
                    c.read_collapsed_counts = candidate_collapsed_counts(
                        d, dup, pd)
        for c in cands:
            agg.add(c)
    return agg.candidates(), agg
