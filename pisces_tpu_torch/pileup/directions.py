"""Stitched-read direction maps (XD tag).

The stitcher annotates merged reads with an XD direction string (e.g.
"20F30S21R") describing per-base directions over the cigar-expanded read.
Reference: Read.GetDirectionInfo / CreateSequencedBaseDirectionMap
(Pisces.Domain/Models/Read.cs:390-682).
"""
from __future__ import annotations

import re
from typing import List, Optional, Tuple

import numpy as np

from pisces_tpu_torch.domain.types import DirectionType
from pisces_tpu_torch.io.bam import OP_CONSUMES_READ, FLAG_REVERSE, ReadBatch

_XD_RE = re.compile(r"(\d+)([FRS])")
_DIR_CODE = {"F": int(DirectionType.FORWARD), "R": int(DirectionType.REVERSE),
             "S": int(DirectionType.STITCHED)}


def parse_xd(xd: str) -> List[Tuple[int, int]]:
    """XD string -> [(length, direction_code)]."""
    return [(int(n), _DIR_CODE[c]) for n, c in _XD_RE.findall(xd)]


def expand_xd(xd: str) -> np.ndarray:
    """Per-expanded-base direction codes."""
    ops = parse_xd(xd)
    total = sum(n for n, _ in ops)
    out = np.empty(total, dtype=np.int8)
    i = 0
    for n, d in ops:
        out[i:i + n] = d
        i += n
    return out


def sequenced_direction_map(xd: str, cigar_ops: np.ndarray,
                            cigar_lens: np.ndarray) -> np.ndarray:
    """Project the expanded XD directions onto sequenced bases
    (CreateSequencedBaseDirectionMap): read-span cigar ops keep their
    direction entries; D/N ops consume direction entries but no bases."""
    expanded = expand_xd(xd)
    read_len = int(cigar_lens[OP_CONSUMES_READ[cigar_ops]].sum())
    out = np.empty(read_len, dtype=np.int8)
    exp_i = 0
    seq_i = 0
    for op, ln in zip(cigar_ops, cigar_lens):
        ln = int(ln)
        if OP_CONSUMES_READ[op]:
            n = min(ln, len(expanded) - exp_i)
            out[seq_i:seq_i + n] = expanded[exp_i:exp_i + n]
            if n < ln:  # XD shorter than read: pad with last direction
                out[seq_i + n:seq_i + ln] = expanded[-1] if len(expanded) else 0
            seq_i += ln
            exp_i += ln
        elif op in (2, 3):  # D/N consume expanded entries only
            exp_i += ln
    return out


def has_stitched_segment(xd: Optional[str]) -> bool:
    """Whether an XD string holds a stitched (S) segment."""
    return bool(xd) and any(n > 0 and d == _DIR_CODE["S"]
                            for n, d in parse_xd(xd))


def batch_base_directions(batch: ReadBatch, keep: np.ndarray) -> np.ndarray:
    """Per-sequenced-base direction codes for the whole batch, aligned with
    batch.seq; reads without an XD tag get their strand direction. A read
    at a time in Python, for batches of the Python reader: the native
    reader's batches take NativeBamReader.xd_directions, the same values
    from its C++ decode."""
    out = np.empty(len(batch.seq), dtype=np.int8)
    read_dirs = np.where((batch.flag & FLAG_REVERSE) != 0,
                         np.int8(DirectionType.REVERSE),
                         np.int8(DirectionType.FORWARD))
    for i in range(batch.n):
        s, e = batch.seq_off[i], batch.seq_off[i + 1]
        xd = batch.xd_tags[i] if batch.xd_tags is not None else None
        if keep[i] and xd:
            cs, ce = batch.cigar_off[i], batch.cigar_off[i + 1]
            dm = sequenced_direction_map(xd, batch.cigar_ops[cs:ce],
                                         batch.cigar_lens[cs:ce])
            out[s:e] = dm[: e - s]
        else:
            out[s:e] = read_dirs[i]
    return out


def support_direction(category: int, dir_map: np.ndarray,
                      start_index_in_read: int, alt_len: int,
                      expanded_dirs: Optional[np.ndarray] = None,
                      expanded_index_of: Optional[np.ndarray] = None) -> int:
    """CandidateVariantFinder.GetSupportDirection (cs:396-445).

    category uses AlleleCategory codes; alt_len = len(alt allele).
    expanded_dirs/expanded_index_of enable the stitched-deletion path.
    """
    from pisces_tpu_torch.domain.types import AlleleCategory
    n = len(dir_map)
    if category in (int(AlleleCategory.SNV), int(AlleleCategory.REFERENCE)):
        return int(dir_map[start_index_in_read])

    left = start_index_in_read - 1
    right = (start_index_in_read if category == int(AlleleCategory.DELETION)
             else start_index_in_read + alt_len)
    last = n - 1
    if right == 0:
        return int(dir_map[right])
    if left == last:
        return int(dir_map[last])

    if left == right - 1:  # deletions
        if expanded_dirs is not None and expanded_index_of is not None:
            li = int(expanded_index_of[left]) + 1
            ri = int(expanded_index_of[right]) - 1
            if 0 <= li < len(expanded_dirs) and 0 <= ri < len(expanded_dirs):
                start_d = int(expanded_dirs[li])
                end_d = int(expanded_dirs[ri])
                return end_d if start_d == int(DirectionType.STITCHED) else start_d
        start_d = int(dir_map[left])
        end_d = int(dir_map[right])
        return end_d if start_d == int(DirectionType.STITCHED) else start_d

    direction = int(DirectionType.FORWARD)
    for i in range(left + 1, right):
        direction = int(dir_map[i])
        if direction == int(DirectionType.STITCHED):
            return direction
    return direction


def expanded_maps(xd: str, cigar_ops: np.ndarray, cigar_lens: np.ndarray):
    """Returns (expanded_dirs, expanded_index_of_sequenced): for each
    sequenced base, its index in the expanded (cigar) coordinate space."""
    expanded = expand_xd(xd)
    read_len = int(cigar_lens[OP_CONSUMES_READ[cigar_ops]].sum())
    idx = np.empty(read_len, dtype=np.int64)
    exp_i = 0
    seq_i = 0
    for op, ln in zip(cigar_ops, cigar_lens):
        ln = int(ln)
        if OP_CONSUMES_READ[op]:
            idx[seq_i:seq_i + ln] = np.arange(exp_i, exp_i + ln)
            seq_i += ln
            exp_i += ln
        elif op in (2, 3):
            exp_i += ln
    return expanded, idx
