"""Vectorized candidate discovery for the call_mnvs=False default.

With MNV build-up disabled, the reference CIGAR walk reduces to per-base
rules that vectorize over the whole batch:
  - SNV at each mapped mismatch (both bases ACGT, qual >= minBq);
    open-on-right iff the next sequenced base continues the same M op and is
    low-quality/N (the state machine's bad-base flush), open flags also from
    read-boundary annotation
  - insertions/deletions per I/D cigar op with the flank-quality gates
Aggregation is a keyed np.unique reduction instead of per-read objects.

Equivalence with the exact per-read state machine
(pileup/candidates.find_candidates_read) is asserted in tests; the exact
path remains the MNV-mode, amplicon and read-collapsed implementation.
Stitched (XD) reads take their per-base directions from base_dirs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from pisces_tpu_torch.domain.types import (
    BASE_TO_ALLELE, NUM_DIRECTION_TYPES, AlleleCategory, AlleleType,
)
from pisces_tpu_torch.io.bam import OP_D, OP_I, OP_M, OP_S, ReadBatch
from pisces_tpu_torch.pileup.candidates import (
    ALLELE_CHARS, Candidate, _well_anchored,
)
from pisces_tpu_torch.pileup.events import expand_batch, read_directions

_N = int(AlleleType.N)


def find_snv_candidates_vectorized(
    chrom: str,
    refseq: np.ndarray,
    batch: ReadBatch,
    keep: np.ndarray,
    min_bq: int,
    anchor_size: int = 5,
    track_open_ended: bool = True,
) -> List[Candidate]:
    """SNV candidates over the whole batch in one pass (untagged reads:
    each base takes its read's strand direction)."""
    refseq_codes = BASE_TO_ALLELE[refseq]
    ex = expand_batch(batch, keep)
    dirs = read_directions(batch)

    mapped = ex.gpos >= 1
    in_ref = ex.gpos <= len(refseq)
    sel = mapped & in_ref
    gpos = ex.gpos[sel]
    seq_idx = ex.seq_idx[sel]
    read_idx = ex.read_idx[sel]

    read_code = batch.seq[seq_idx]
    ref_code = refseq_codes[gpos - 1]
    quals = batch.qual[seq_idx]
    good = (quals >= min_bq) & (read_code != _N) & (ref_code != _N)
    mismatch = good & (read_code != ref_code)

    if not mismatch.any():
        return []

    m_gpos = gpos[mismatch]
    m_seq_idx = seq_idx[mismatch]
    m_read = read_idx[mismatch]
    m_alt = read_code[mismatch]

    m_dir = dirs[m_read].astype(np.int64)

    start1 = batch.pos.astype(np.int64) + 1
    end1 = batch.end_pos.astype(np.int64) + 1

    # open_on_right (state machine): next sequenced base is in the same M op
    # (its gpos is gpos+1) and is bad (low qual / read N / ref N)
    next_seq_idx = m_seq_idx + 1
    read_last_seq = batch.seq_off[m_read + 1] - 1
    has_next = next_seq_idx <= read_last_seq
    nn = np.where(has_next, next_seq_idx, m_seq_idx)
    # map next seq index to its gpos via the expansion: build a lookup
    gpos_by_seq = np.full(len(batch.seq), -9, dtype=np.int64)
    gpos_by_seq[ex.seq_idx] = ex.gpos
    next_gpos = gpos_by_seq[nn]
    same_op = has_next & (next_gpos == m_gpos + 1)
    next_code = batch.seq[nn]
    next_qual = batch.qual[nn]
    next_ref_ok = np.ones(len(m_gpos), dtype=bool)
    nr = m_gpos + 1 <= len(refseq)
    next_ref_code = np.where(nr, refseq_codes[np.minimum(m_gpos, len(refseq) - 1)], _N)
    next_bad = ((next_qual < min_bq) | (next_code == _N)
                | (next_ref_code == _N))
    open_right_sm = same_op & next_bad

    # boundary annotation (Annotate): first/last effective cigar op is M
    n_ops = np.diff(batch.cigar_off)
    has_ops = n_ops > 0
    fi = np.minimum(batch.cigar_off[:-1], max(len(batch.cigar_ops) - 1, 0))
    li = np.maximum(batch.cigar_off[1:] - 1, 0)
    f_op = batch.cigar_ops[fi] if len(batch.cigar_ops) else np.zeros(batch.n, np.uint8)
    l_op = batch.cigar_ops[li] if len(batch.cigar_ops) else np.zeros(batch.n, np.uint8)
    f2 = np.minimum(fi + 1, max(len(batch.cigar_ops) - 1, 0))
    l2 = np.maximum(li - 1, 0)
    f_eff = np.where((f_op == OP_S) & (n_ops > 1),
                     batch.cigar_ops[f2] if len(batch.cigar_ops) else f_op, f_op)
    l_eff = np.where((l_op == OP_S) & (n_ops > 1),
                     batch.cigar_ops[l2] if len(batch.cigar_ops) else l_op, l_op)
    is_m = lambda o: (o == OP_M) | (o == 7) | (o == 8)
    first_op_m = has_ops & is_m(f_eff)
    last_op_m = has_ops & is_m(l_eff)

    open_left = (track_open_ended & first_op_m[m_read]
                 & (m_gpos == start1[m_read]))
    open_right = open_right_sm | (last_op_m[m_read] & (m_gpos == end1[m_read]))
    if not track_open_ended:
        open_left = np.zeros(len(m_gpos), dtype=bool)
        open_right = np.zeros(len(m_gpos), dtype=bool)

    anchor = np.minimum(m_gpos - start1[m_read], end1[m_read] - m_gpos)
    well_anchored = anchor > 0  # min(A-1, altLen-1) = 0 for SNVs

    return _aggregate_snv_events(chrom, refseq, m_gpos, m_alt, m_dir,
                                 open_left, open_right,
                                 well_anchored).to_candidates()


@dataclass
class SnvCandidateBatch:
    """SNV candidates of one chromosome as columns (a struct of arrays).

    Row i is the candidate `ref_base[i]` > `alt_base[i]` at the 1-based
    `position[i]` (both ASCII codes), with its support and well-anchored
    support by direction (int64 [n, 3]) and its open-ended flags. Rows are
    sorted by (position, alt code, open_on_left, open_on_right), the order
    the keyed aggregation gives. The caller scores the rows as columns and
    builds objects only for those it reports; `to_candidates` gives the
    same rows as `Candidate` objects."""

    chromosome: str
    position: np.ndarray
    ref_base: np.ndarray
    alt_base: np.ndarray
    support_by_direction: np.ndarray
    well_anchored_by_direction: np.ndarray
    open_on_left: np.ndarray
    open_on_right: np.ndarray

    def __len__(self) -> int:
        return len(self.position)

    def take(self, rows) -> "SnvCandidateBatch":
        """The batch of the given rows (an index array or a row mask)."""
        return SnvCandidateBatch(
            self.chromosome, self.position[rows], self.ref_base[rows],
            self.alt_base[rows], self.support_by_direction[rows],
            self.well_anchored_by_direction[rows], self.open_on_left[rows],
            self.open_on_right[rows])

    def candidate(self, i: int) -> Candidate:
        """Row i as a Candidate holding copies of its supports."""
        c = Candidate(self.chromosome, int(self.position[i]),
                      chr(self.ref_base[i]), chr(self.alt_base[i]),
                      AlleleCategory.SNV,
                      open_on_left=bool(self.open_on_left[i]),
                      open_on_right=bool(self.open_on_right[i]))
        c.support_by_direction = self.support_by_direction[i].copy()
        c.well_anchored_by_direction = self.well_anchored_by_direction[i].copy()
        return c

    def to_candidates(self) -> List[Candidate]:
        return [self.candidate(i) for i in range(len(self))]

    def rows_in(self, alleles: Iterable[Tuple[int, str, str]]) -> np.ndarray:
        """Row mask of the rows equal to one of the (position, ref, alt)
        alleles; alleles that are no single-base change match no row."""
        keys = [_allele_key(pos, ord(ref), ord(alt))
                for pos, ref, alt in alleles if len(ref) == len(alt) == 1]
        return np.isin(_allele_key(self.position,
                                   self.ref_base.astype(np.int64),
                                   self.alt_base.astype(np.int64)),
                       np.asarray(keys, dtype=np.int64))


def _allele_key(pos, ref, alt):
    return (pos << 16) | (ref << 8) | alt


def _aggregate_snv_events(chrom, refseq, m_gpos, m_alt, m_dir, open_left,
                          open_right, well_anchored) -> SnvCandidateBatch:
    """Keyed np.unique aggregation of per-base SNV events.

    Support tallies are one 2-D scatter-add over (candidate, direction)
    instead of per-candidate 3-vectors — the per-candidate np.zeros +
    np.add.at pairs were ~7us each at WGS candidate counts."""
    key = (((m_gpos * 6 + m_alt.astype(np.int64)) * 2
            + open_left.astype(np.int64)) * 2 + open_right.astype(np.int64))
    uniq, inverse = np.unique(key, return_inverse=True)
    n_u = len(uniq)
    dir_i = m_dir.astype(np.int64)
    sup2d = np.zeros((n_u, NUM_DIRECTION_TYPES), dtype=np.int64)
    np.add.at(sup2d, (inverse, dir_i), 1)
    wa2d = np.zeros((n_u, NUM_DIRECTION_TYPES), dtype=np.int64)
    np.add.at(wa2d, (inverse[well_anchored], dir_i[well_anchored]), 1)
    pos_all = ((uniq >> 2) // 6).astype(np.int64)
    return SnvCandidateBatch(
        chrom, pos_all, refseq[pos_all - 1],
        ALLELE_CHARS[((uniq >> 2) % 6).astype(np.int64)], sup2d, wa2d,
        ((uniq >> 1) & 1).astype(bool), (uniq & 1).astype(bool))


def find_indel_candidates(
    chrom: str,
    refseq: np.ndarray,
    batch: ReadBatch,
    keep: np.ndarray,
    min_bq: int,
    anchor_size: int = 5,
    track_open_ended: bool = True,
    base_dirs: Optional[np.ndarray] = None,
    del_dirs: Optional[np.ndarray] = None,
) -> List[Candidate]:
    """Insertion/deletion candidates per I/D cigar op (sparse loop).

    A stitched read's (XD) insertion takes its support direction from
    base_dirs, and its deletion from del_dirs, the direction of the
    expanded XD entries between the deletion's flanking bases (the state
    machine's rule); both come from NativeBamReader.xd_directions, and
    together."""
    from pisces_tpu_torch.pileup.directions import support_direction
    dirs = read_directions(batch)
    agg: Dict[tuple, Candidate] = {}
    ref_len = len(refseq)
    # vectorized pre-filter: only reads whose cigar contains I or D
    has_id = np.zeros(batch.n, dtype=bool)
    if len(batch.cigar_ops):
        id_mask = (batch.cigar_ops == OP_I) | (batch.cigar_ops == OP_D)
        op_read = np.repeat(np.arange(batch.n), np.diff(batch.cigar_off))
        np.logical_or.at(has_id, op_read[id_mask], True)
    kept = np.nonzero(keep & has_id)[0]
    start1 = batch.pos.astype(np.int64) + 1
    end1 = batch.end_pos.astype(np.int64) + 1
    for i in kept:
        s, e = batch.cigar_off[i], batch.cigar_off[i + 1]
        ops = batch.cigar_ops[s:e]
        lens = batch.cigar_lens[s:e]
        qs = batch.seq_off[i]
        quals = batch.qual[qs:batch.seq_off[i + 1]]
        seq = batch.seq[qs:batch.seq_off[i + 1]]
        pos1 = int(start1[i])
        read_cursor = 0
        ref_cursor0 = pos1 - 1
        per_read: List[Tuple[Candidate, int, int]] = []
        for oi, (op, ln) in enumerate(zip(ops, lens)):
            ln = int(ln)
            if op == OP_I:
                if not (ref_cursor0 - 1 >= ref_len or ref_cursor0 == 0):
                    if quals[read_cursor] >= min_bq:
                        ref_base = chr(refseq[ref_cursor0 - 1])
                        added = ALLELE_CHARS[seq[read_cursor:read_cursor + ln]]\
                            .tobytes().decode()
                        c = Candidate(chrom, ref_cursor0, ref_base,
                                      ref_base + added, AlleleCategory.INSERTION)
                        per_read.append((c, read_cursor, s + oi))
            elif op == OP_D:
                if not (ref_cursor0 + ln >= ref_len) and len(quals) > 0:
                    after = quals[read_cursor] if read_cursor < len(quals) \
                        else quals[read_cursor - 1]
                    before = quals[read_cursor - 1] if read_cursor > 0 else after
                    if after >= min_bq and before >= min_bq:
                        ref_bases = refseq[ref_cursor0 - 1:ref_cursor0 + ln]\
                            .tobytes().decode()
                        c = Candidate(chrom, ref_cursor0, ref_bases,
                                      ref_bases[0], AlleleCategory.DELETION)
                        per_read.append((c, read_cursor, s + oi))
            if op in (OP_M, OP_I, OP_S, 7, 8):
                read_cursor += ln
            if op in (OP_M, OP_D, 3, 7, 8):
                ref_cursor0 += ln

        if not per_read:
            continue
        # open-end annotation for indels (Annotate)
        f = ops[0]
        if f == OP_S and len(ops) > 1:
            f = ops[1]
        l = ops[-1]
        if l == OP_S and len(ops) > 1:
            l = ops[-2]
        max_pos = int(end1[i])
        xd = batch.xd_tags[i] if batch.xd_tags is not None else None
        for c, start_read, op_at in per_read:
            if track_open_ended:
                if f == OP_I and c.category == AlleleCategory.INSERTION \
                        and c.position == pos1 - 1:
                    c.open_on_left = True
                if f == OP_D and c.category == AlleleCategory.DELETION \
                        and c.position == pos1 - 1:
                    c.open_on_left = True
                if l == OP_I and c.category == AlleleCategory.INSERTION \
                        and c.position == max_pos:
                    c.open_on_right = True
                if l == OP_D and c.category == AlleleCategory.DELETION \
                        and c.position == max_pos:
                    c.open_on_right = True
            if xd and base_dirs is not None:
                d = (int(del_dirs[op_at])
                     if c.category == AlleleCategory.DELETION else
                     support_direction(int(c.category),
                                       base_dirs[qs:batch.seq_off[i + 1]],
                                       start_read, len(c.alt_allele)))
            else:
                d = int(dirs[i])
            alt_len = (len(c.alt_allele)
                       if c.category == AlleleCategory.INSERTION else 1)
            c.support_by_direction[d] = 1
            if _well_anchored(c.position, pos1, max_pos, alt_len, anchor_size):
                c.well_anchored_by_direction[d] = 1
            key = c.key(track_open_ended)
            if key in agg:
                agg[key].support_by_direction += c.support_by_direction
                agg[key].well_anchored_by_direction += c.well_anchored_by_direction
            else:
                agg[key] = c
    return list(agg.values())


def aggregate_native_mismatches(chrom: str, refseq: np.ndarray, gpos, alt,
                                dirs, flags) -> SnvCandidateBatch:
    """Aggregate the C++ pileup pass's SNV mismatch events
    (io/native.native_pileup with reference codes) into the chromosome's
    SNV candidates, as columns."""
    open_right = (flags & 1) != 0
    open_left = (flags & 2) != 0
    well_anchored = (flags & 4) != 0
    return _aggregate_snv_events(chrom, refseq, gpos, alt, dirs,
                                 open_left, open_right, well_anchored)
