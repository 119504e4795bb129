"""BAM .bai index: read, build, write, and region queries.

Counterpart of the reference's Alignment.IO BamIndex (BamIndex.cs:1-697) and
BamReader.Jump (BamReader.cs:22-677): the SAMv1 binning scheme (R-tree of
2^14..2^29 bins) plus a 16 kb linear index of smallest virtual offsets.
Virtual offset = (BGZF block file offset << 16) | offset within inflated
block.
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

BAI_MAGIC = b"BAI\x01"
PSEUDO_BIN = 37450
LINEAR_SHIFT = 14  # 16 kb windows
MAX_BIN = ((1 << 18) - 1) // 7 + 1  # 37449 real bins


def reg2bin(beg: int, end: int) -> int:
    """Smallest bin containing [beg, end) (SAMv1 spec algorithm)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def reg2bins(beg: int, end: int) -> List[int]:
    """All bins that may contain reads overlapping [beg, end)."""
    end -= 1
    bins = [0]
    for shift, base in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(base + (beg >> shift), base + (end >> shift) + 1))
    return bins


@dataclass
class RefIndex:
    bins: Dict[int, List[Tuple[int, int]]] = field(default_factory=dict)
    linear: List[int] = field(default_factory=list)
    mapped: int = 0
    unmapped: int = 0


@dataclass
class BamIndex:
    refs: List[RefIndex]
    n_no_coor: int = 0

    def min_offset(self, ref_id: int) -> Optional[int]:
        """Virtual offset of the first read on ref_id, None if no reads."""
        ref = self.refs[ref_id]
        best = None
        for b, chunks in ref.bins.items():
            if b == PSEUDO_BIN:
                continue
            for beg, _ in chunks:
                if best is None or beg < best:
                    best = beg
        return best

    def max_offset(self, ref_id: int) -> Optional[int]:
        ref = self.refs[ref_id]
        best = None
        for b, chunks in ref.bins.items():
            if b == PSEUDO_BIN:
                continue
            for _, end in chunks:
                if best is None or end > best:
                    best = end
        return best

    def query(self, ref_id: int, beg: int, end: int) -> List[Tuple[int, int]]:
        """Merged chunk list possibly containing reads overlapping
        [beg, end) (0-based half-open), pruned by the linear index."""
        ref = self.refs[ref_id]
        beg = max(beg, 0)
        min_lin = 0
        w = beg >> LINEAR_SHIFT
        if w < len(ref.linear):
            min_lin = ref.linear[w]
        chunks = []
        for b in reg2bins(beg, end):
            for c_beg, c_end in ref.bins.get(b, ()):
                if c_end > min_lin:
                    chunks.append((max(c_beg, min_lin), c_end))
        chunks.sort()
        merged: List[Tuple[int, int]] = []
        for c in chunks:
            if merged and c[0] <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], c[1]))
            else:
                merged.append(c)
        return merged


def read_bai(path: str) -> BamIndex:
    with open(path, "rb") as f:
        d = f.read()
    if d[:4] != BAI_MAGIC:
        raise ValueError(f"{path}: not a .bai file")
    p = 4
    (n_ref,) = struct.unpack_from("<i", d, p)
    p += 4
    refs = []
    for _ in range(n_ref):
        ref = RefIndex()
        (n_bin,) = struct.unpack_from("<i", d, p)
        p += 4
        for _ in range(n_bin):
            b, n_chunk = struct.unpack_from("<Ii", d, p)
            p += 8
            chunks = []
            for _ in range(n_chunk):
                beg, end = struct.unpack_from("<QQ", d, p)
                p += 16
                chunks.append((beg, end))
            if b == PSEUDO_BIN and n_chunk == 2:
                ref.mapped, ref.unmapped = chunks[1]
            else:
                ref.bins[b] = chunks
        (n_intv,) = struct.unpack_from("<i", d, p)
        p += 4
        ref.linear = list(struct.unpack_from(f"<{n_intv}Q", d, p))
        p += 8 * n_intv
        refs.append(ref)
    n_no_coor = struct.unpack_from("<Q", d, p)[0] if p + 8 <= len(d) else 0
    return BamIndex(refs, n_no_coor)


def read_sibling_bai(bam_path: str) -> Optional[BamIndex]:
    """The index at bam_path + ".bai", or None when there is none."""
    path = bam_path + ".bai"
    return read_bai(path) if os.path.exists(path) else None


def write_bai(index: BamIndex, path: str) -> str:
    out = [BAI_MAGIC, struct.pack("<i", len(index.refs))]
    for ref_id, ref in enumerate(index.refs):
        has_meta = ref.mapped or ref.unmapped
        out.append(struct.pack("<i", len(ref.bins) + (1 if has_meta else 0)))
        for b in sorted(ref.bins):
            chunks = ref.bins[b]
            out.append(struct.pack("<Ii", b, len(chunks)))
            for beg, end in chunks:
                out.append(struct.pack("<QQ", beg, end))
        if has_meta:
            off_beg = index.min_offset(ref_id) or 0
            off_end = index.max_offset(ref_id) or 0
            out.append(struct.pack("<Ii", PSEUDO_BIN, 2))
            out.append(struct.pack("<QQ", off_beg, off_end))
            out.append(struct.pack("<QQ", ref.mapped, ref.unmapped))
        out.append(struct.pack("<i", len(ref.linear)))
        out.append(struct.pack(f"<{len(ref.linear)}Q", *ref.linear))
    out.append(struct.pack("<Q", index.n_no_coor))
    with open(path, "wb") as f:
        f.write(b"".join(out))
    return path


class BaiBuilder:
    """Accumulates (ref_id, beg, end, voff_start, voff_end) of records
    written in coordinate order and emits a BamIndex."""

    def __init__(self, n_refs: int):
        self.refs = [RefIndex() for _ in range(n_refs)]
        self.n_no_coor = 0

    def add(self, ref_id: int, beg: int, end: int, voff_start: int,
            voff_end: int, mapped: bool = True) -> None:
        if ref_id < 0:
            self.n_no_coor += 1
            return
        ref = self.refs[ref_id]
        if mapped:
            ref.mapped += 1
        else:
            ref.unmapped += 1
        b = reg2bin(beg, max(end, beg + 1))
        chunks = ref.bins.setdefault(b, [])
        if chunks and chunks[-1][1] == voff_start:
            chunks[-1] = (chunks[-1][0], voff_end)  # extend adjacent chunk
        else:
            chunks.append((voff_start, voff_end))
        w_beg = beg >> LINEAR_SHIFT
        w_end = max(end - 1, beg) >> LINEAR_SHIFT
        if len(ref.linear) <= w_end:
            ref.linear.extend([0] * (w_end + 1 - len(ref.linear)))
        for w in range(w_beg, w_end + 1):
            if ref.linear[w] == 0 or voff_start < ref.linear[w]:
                ref.linear[w] = voff_start

    def build(self) -> BamIndex:
        return BamIndex(self.refs, self.n_no_coor)
