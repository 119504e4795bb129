"""BAM container reader producing columnar read batches.

Replaces the reference's C# BamReader (src/lib/Alignment.IO/BamReader.cs:22-677)
with a decode path that emits fixed-dtype numpy columns (positions, flags,
CIGAR op arrays, seq codes, quals) ready for host->device DMA, instead of
per-read objects.

This is the pure-Python read flow of the port (open_bam(prefer_native=
False)): whole-file decode and per-chromosome extraction, or with lazy=True
region fetches over the .bai. The default reader is the C++ one,
io/native.NativeBamReader, with the same ReadBatch contract (tags included:
XD stitched directions, XN amplicons, XR/XU/XV/XW read-collapsed marks).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from pisces_tpu_torch.io import bgzf
from pisces_tpu_torch.domain.types import BASE_TO_ALLELE

# BAM flag bits
FLAG_PAIRED = 0x1
FLAG_PROPER_PAIR = 0x2
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_MATE_REVERSE = 0x20
FLAG_FIRST_MATE = 0x40
FLAG_SECOND_MATE = 0x80
FLAG_SECONDARY = 0x100
FLAG_QC_FAIL = 0x200
FLAG_DUPLICATE = 0x400
FLAG_SUPPLEMENTARY = 0x800

# CIGAR op codes per BAM spec: MIDNSHP=X
CIGAR_OPS = "MIDNSHP=X"
OP_M, OP_I, OP_D, OP_N, OP_S, OP_H, OP_P, OP_EQ, OP_X = range(9)
# ops consuming read / reference
OP_CONSUMES_READ = np.array([1, 1, 0, 0, 1, 0, 0, 1, 1], dtype=bool)
OP_CONSUMES_REF = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1], dtype=bool)

# 4-bit seq code -> allele code ('=ACMGRSVTWYHKDBN')
_SEQ_NIBBLE_CHARS = b"=ACMGRSVTWYHKDBN"
SEQ_CODE_TO_ALLELE = np.array(
    [BASE_TO_ALLELE[c] for c in _SEQ_NIBBLE_CHARS], dtype=np.int8)
SEQ_CODE_TO_CHAR = np.frombuffer(_SEQ_NIBBLE_CHARS, dtype=np.uint8)


@dataclass
class ReadBatch:
    """Columnar alignment batch. All coordinates are 0-based (BAM native)."""

    n: int
    ref_id: np.ndarray      # int32 [n]
    pos: np.ndarray         # int32 [n] 0-based leftmost mapped position
    mapq: np.ndarray        # uint8 [n]
    flag: np.ndarray        # uint16 [n]
    cigar_off: np.ndarray   # int64 [n+1] into cigar_ops/cigar_lens
    cigar_ops: np.ndarray   # uint8 [total_ops]
    cigar_lens: np.ndarray  # int32 [total_ops]
    seq_off: np.ndarray     # int64 [n+1] into seq/qual
    seq: np.ndarray         # int8 allele codes [total_bases]
    qual: np.ndarray        # uint8 [total_bases]
    end_pos: np.ndarray     # int32 [n] 0-based inclusive end (last ref-consumed base)
    xd_tags: Optional[list] = None  # per-read stitched direction strings (XD)
    xn_tags: Optional[list] = None  # per-read amplicon names (XN)
    extra_tags: Optional[list] = None  # per-read dicts incl. XR/XV/XW (UMI)
    names: Optional[list] = None       # read names (decoded on request)
    mate_ref_id: Optional[np.ndarray] = None  # int32 [n] next_refID
    mate_pos: Optional[np.ndarray] = None     # int32 [n] 0-based next_pos
    # True on a batch that io/native.NativeBamReader decoded: its reader's
    # handle holds the same batch, which the native pileup pass reads
    _from_native_handle = False

    def read_len(self, i: int) -> int:
        return int(self.seq_off[i + 1] - self.seq_off[i])


@dataclass
class BamHeader:
    text: str
    ref_names: List[str]
    ref_lengths: List[int]

    def ref_index(self, name: str) -> int:
        return self.ref_names.index(name)

    @property
    def source_is_stitched(self) -> bool:
        """Reference detects stitched input from @PG lines mentioning the
        stitcher (BamFileAlignmentExtractor.cs)."""
        for line in self.text.splitlines():
            if line.startswith("@PG") and ("stitcher" in line.lower()):
                return True
        return False

    @property
    def source_is_collapsed(self) -> bool:
        for line in self.text.splitlines():
            if line.startswith("@PG") and ("reco" in line.lower() or
                                           "umi" in line.lower()):
                return True
        return False


class BamReader:
    """Whole-file BAM reader with per-chromosome columnar extraction.

    With lazy=True the file stays compressed and fetch_region() inflates
    only the BGZF blocks the sibling .bai maps to the query (the
    reference's BamReader.Jump, Alignment.IO/BamReader.cs:22-677); a lazy
    reader has no fetch(), as io/native's lazy reader has none."""

    def __init__(self, path: str, lazy: bool = False):
        self.path = path
        with open(path, "rb") as f:
            raw = f.read()
        self._raw: Optional[bytes] = raw if lazy else None
        self._bai = None
        if lazy:
            buf = bytearray()
            for _, _, chunk in bgzf.iter_blocks(raw):
                buf.extend(chunk)
                self._data = bytes(buf)
                try:
                    self.header, self._records_start = self._parse_header()
                    break
                except (struct.error, ValueError, IndexError):
                    continue
            else:
                raise ValueError(f"{path}: could not parse BAM header")
        else:
            self._data = bgzf.decompress(raw)
            self.header, self._records_start = self._parse_header()
        self._record_offsets: Optional[np.ndarray] = None

    def index(self):
        """The sibling .bai (io/bai.BamIndex), read once; None without one."""
        if self._bai is None:
            from pisces_tpu_torch.io.bai import read_sibling_bai
            self._bai = read_sibling_bai(self.path) or False
        return self._bai or None

    def _parse_header(self) -> Tuple[BamHeader, int]:
        d = self._data
        if d[:4] != b"BAM\x01":
            raise ValueError(f"{self.path} is not a BAM file")
        l_text = struct.unpack_from("<i", d, 4)[0]
        if len(d) < 8 + l_text + 4:
            raise ValueError("truncated header")
        text = d[8:8 + l_text].rstrip(b"\x00").decode("utf-8", errors="replace")
        off = 8 + l_text
        n_ref = struct.unpack_from("<i", d, off)[0]
        off += 4
        names, lengths = [], []
        for _ in range(n_ref):
            l_name = struct.unpack_from("<i", d, off)[0]
            if len(d) < off + 8 + l_name:
                raise ValueError("truncated header refs")
            names.append(d[off + 4: off + 4 + l_name - 1].decode())
            lengths.append(struct.unpack_from("<i", d, off + 4 + l_name)[0])
            off += 8 + l_name
        return BamHeader(text, names, lengths), off

    def _scan_record_offsets(self) -> np.ndarray:
        if self._record_offsets is not None:
            return self._record_offsets
        if self._raw is not None:
            raise ValueError(f"{self.path}: a lazy reader serves "
                             "fetch_region() only")
        d = self._data
        offsets = []
        off = self._records_start
        n = len(d)
        while off + 4 <= n:
            block_size = int.from_bytes(d[off:off + 4], "little", signed=True)
            offsets.append(off)
            off += 4 + block_size
        self._record_offsets = np.array(offsets + [off], dtype=np.int64)
        return self._record_offsets

    @property
    def n_records(self) -> int:
        return len(self._scan_record_offsets()) - 1

    @staticmethod
    def parse_all_tags(d: bytes, p: int, rec_end: int) -> Dict[str, object]:
        """General typed tag decode (TagUtils analog, Alignment.Domain/
        BamCommon.cs): every tag in the record's tag block as a Python
        value — ints (cCsSiI), floats (f), chars (A), strings (Z/H), and
        typed arrays (B)."""
        _SIZE = {ord("A"): 1, ord("c"): 1, ord("C"): 1, ord("s"): 2,
                 ord("S"): 2, ord("i"): 4, ord("I"): 4, ord("f"): 4}
        _FMT = {ord("c"): "<b", ord("C"): "<B", ord("s"): "<h",
                ord("S"): "<H", ord("i"): "<i", ord("I"): "<I",
                ord("f"): "<f"}
        out: Dict[str, object] = {}
        while p + 3 <= rec_end:
            tag = d[p:p + 2].decode("ascii", errors="replace")
            typ = d[p + 2]
            p += 3
            if typ == ord("A"):
                out[tag] = chr(d[p])
                p += 1
            elif typ in _FMT:
                out[tag] = struct.unpack_from(_FMT[typ], d, p)[0]
                p += _SIZE[typ]
            elif typ in (ord("Z"), ord("H")):
                end = d.find(b"\x00", p, rec_end)
                end = end if end >= 0 else rec_end
                out[tag] = d[p:end].decode("ascii", errors="replace")
                p = end + 1
            elif typ == ord("B"):
                sub = d[p]
                count = struct.unpack_from("<i", d, p + 1)[0]
                vals = [struct.unpack_from(_FMT[sub], d,
                                           p + 5 + _SIZE[sub] * k)[0]
                        for k in range(count)] if sub in _FMT else []
                out[tag] = vals
                p += 5 + _SIZE.get(sub, 1) * count
            else:
                break
        return out

    @staticmethod
    def _parse_string_tags(d: bytes, p: int, rec_end: int) -> Dict[str, object]:
        """Extract Z-typed tags (XD stitched directions, XN amplicon, XR pair
        direction) and int tags (XV/XW UMI counts) from a record's tag block."""
        _TYPE_SIZE = {ord("A"): 1, ord("c"): 1, ord("C"): 1, ord("s"): 2,
                      ord("S"): 2, ord("i"): 4, ord("I"): 4, ord("f"): 4}
        _INT_FMT = {ord("c"): "<b", ord("C"): "<B", ord("s"): "<h",
                    ord("S"): "<H", ord("i"): "<i", ord("I"): "<I"}
        out: Dict[str, object] = {}
        while p + 3 <= rec_end:
            tag = d[p:p + 2].decode("ascii", errors="replace")
            typ = d[p + 2]
            p += 3
            if typ in _TYPE_SIZE:
                if tag in ("XV", "XW") and typ in _INT_FMT:
                    out[tag] = struct.unpack_from(_INT_FMT[typ], d, p)[0]
                p += _TYPE_SIZE[typ]
            elif typ in (ord("Z"), ord("H")):
                end = d.index(b"\x00", p, rec_end) if b"\x00" in d[p:rec_end] else rec_end
                if tag in ("XD", "XN", "XR", "XW", "XU"):
                    out[tag] = d[p:end].decode("ascii", errors="replace")
                p = end + 1
            elif typ == ord("B"):
                sub = d[p]
                count = struct.unpack_from("<i", d, p + 1)[0]
                p += 5 + _TYPE_SIZE.get(sub, 1) * count
            else:
                break
        return out

    def fetch(self, ref_id: Optional[int] = None,
              parse_tags: bool = False,
              parse_names: bool = False) -> ReadBatch:
        """Decode records (optionally only those mapped to ref_id) into a
        batch; parse_tags=True also decodes the tags pileup reads (XD, XN,
        XR, XU, XV, XW) into xd_tags, xn_tags and extra_tags, and
        parse_names=True the read names."""
        offsets = self._scan_record_offsets()
        d = self._data
        n_total = len(offsets) - 1

        ref_ids = np.empty(n_total, dtype=np.int32)
        poss = np.empty(n_total, dtype=np.int32)
        mapqs = np.empty(n_total, dtype=np.uint8)
        flags = np.empty(n_total, dtype=np.uint16)
        keep = np.zeros(n_total, dtype=bool)

        # first sweep: fixed header fields
        for i in range(n_total):
            off = offsets[i]
            rid, pos = struct.unpack_from("<ii", d, off + 4)
            l_rn, mq = d[off + 12], d[off + 13]
            flg = struct.unpack_from("<H", d, off + 18)[0]
            ref_ids[i] = rid
            poss[i] = pos
            mapqs[i] = mq
            flags[i] = flg
            keep[i] = (ref_id is None) or (rid == ref_id)

        idx = np.nonzero(keep)[0]
        return self._decode_selected(d, offsets[:-1], ref_ids, poss, mapqs,
                                     flags, idx, parse_tags, parse_names)

    def _decode_selected(self, d, offsets, ref_ids, poss, mapqs, flags,
                         idx, parse_tags: bool = False,
                         parse_names: bool = False) -> ReadBatch:
        m = len(idx)
        cigar_off = np.zeros(m + 1, dtype=np.int64)
        seq_off = np.zeros(m + 1, dtype=np.int64)
        cigar_ops_l: List[np.ndarray] = []
        cigar_lens_l: List[np.ndarray] = []
        seq_l: List[np.ndarray] = []
        qual_l: List[np.ndarray] = []
        end_pos = np.empty(m, dtype=np.int32)
        mate_ref_id = np.empty(m, dtype=np.int32)
        mate_pos = np.empty(m, dtype=np.int32)
        xd_tags: Optional[list] = [] if parse_tags else None
        xn_tags: Optional[list] = [] if parse_tags else None
        extra_tags: Optional[list] = [] if parse_tags else None
        names: Optional[list] = [] if parse_names else None

        for j, i in enumerate(idx):
            off = int(offsets[i])
            l_read_name = d[off + 12]
            n_cigar = struct.unpack_from("<H", d, off + 16)[0]
            l_seq = struct.unpack_from("<i", d, off + 20)[0]
            mate_ref_id[j], mate_pos[j] = struct.unpack_from("<ii", d, off + 24)
            if parse_names:
                names.append(d[off + 36:off + 36 + l_read_name - 1]
                             .decode("ascii", errors="replace"))
            p = off + 36 + l_read_name
            cig = np.frombuffer(d, dtype=np.uint32, count=n_cigar, offset=p)
            ops = (cig & 0xF).astype(np.uint8)
            lens = (cig >> 4).astype(np.int32)
            p += 4 * n_cigar
            nb = (l_seq + 1) // 2
            packed = np.frombuffer(d, dtype=np.uint8, count=nb, offset=p)
            nibbles = np.empty(nb * 2, dtype=np.uint8)
            nibbles[0::2] = packed >> 4
            nibbles[1::2] = packed & 0xF
            seq_codes = SEQ_CODE_TO_ALLELE[nibbles[:l_seq]]
            p += nb
            quals = np.frombuffer(d, dtype=np.uint8, count=l_seq, offset=p).copy()
            p += l_seq
            if parse_tags:
                block_size = struct.unpack_from("<i", d, off)[0]
                tags = self._parse_string_tags(d, p, off + 4 + block_size)
                xd_tags.append(tags.get("XD"))
                xn_tags.append(tags.get("XN"))
                extra_tags.append(tags)

            cigar_ops_l.append(ops)
            cigar_lens_l.append(lens)
            seq_l.append(seq_codes)
            qual_l.append(quals)
            cigar_off[j + 1] = cigar_off[j] + n_cigar
            seq_off[j + 1] = seq_off[j] + l_seq
            ref_span = int(lens[OP_CONSUMES_REF[ops]].sum()) if n_cigar else 0
            end_pos[j] = poss[i] + max(ref_span, 1) - 1

        return ReadBatch(
            n=m,
            ref_id=ref_ids[idx],
            pos=poss[idx],
            mapq=mapqs[idx],
            flag=flags[idx],
            cigar_off=cigar_off,
            cigar_ops=np.concatenate(cigar_ops_l) if m else np.empty(0, np.uint8),
            cigar_lens=np.concatenate(cigar_lens_l) if m else np.empty(0, np.int32),
            seq_off=seq_off,
            seq=np.concatenate(seq_l) if m else np.empty(0, np.int8),
            qual=np.concatenate(qual_l) if m else np.empty(0, np.uint8),
            end_pos=end_pos,
            xd_tags=xd_tags,
            xn_tags=xn_tags,
            extra_tags=extra_tags,
            names=names,
            mate_ref_id=mate_ref_id,
            mate_pos=mate_pos,
        )

    def fetch_region(self, ref_id: int, beg0: int, end0: int,
                     parse_tags: bool = False,
                     parse_names: bool = False) -> ReadBatch:
        """Reads of ref_id overlapping [beg0, end0) (0-based half-open).
        A lazy reader inflates only the chunks its .bai maps to the query
        (IOError without one); a whole-file reader decodes the chromosome
        and masks it. parse_tags and parse_names as in fetch()."""
        if self._raw is None:
            batch = self.fetch(ref_id, parse_tags, parse_names)
            return subset_batch(batch,
                                (batch.pos < end0) & (batch.end_pos >= beg0))
        idx = self.index()
        if idx is None:
            raise IOError(f"{self.path}: a lazy region fetch needs "
                          f"{self.path}.bai")
        raw = self._raw
        offsets: List[int] = []
        ref_ids_l: List[int] = []
        poss_l: List[int] = []
        mapqs_l: List[int] = []
        flags_l: List[int] = []
        bufs: List[bytes] = []
        buf_base = 0
        for c_beg, c_end in idx.query(ref_id, beg0, end0):
            blocks = bgzf.iter_blocks(raw, c_beg >> 16)
            buf = bytearray()
            block_fo: List[int] = []   # file offset per inflated block
            block_u: List[int] = []    # inflated start of each block in buf

            def pull() -> bool:
                try:
                    fo, _, chunk = next(blocks)
                except StopIteration:
                    return False
                block_fo.append(fo)
                block_u.append(len(buf))
                buf.extend(chunk)
                return True

            if not pull():
                continue
            p = c_beg & 0xFFFF
            while True:
                # virtual offset of the record that starts at p
                bi = np.searchsorted(block_u, p, side="right") - 1
                voff = (block_fo[bi] << 16) | (p - block_u[bi])
                if voff >= c_end:
                    break
                while len(buf) < p + 36 and pull():
                    pass
                if len(buf) < p + 36:
                    break
                block_size = int.from_bytes(buf[p:p + 4], "little",
                                            signed=True)
                while len(buf) < p + 4 + block_size and pull():
                    pass
                if len(buf) < p + 4 + block_size:
                    break
                rid, pos = struct.unpack_from("<ii", buf, p + 4)
                if rid == ref_id and pos < end0:
                    offsets.append(buf_base + p)
                    ref_ids_l.append(rid)
                    poss_l.append(pos)
                    mapqs_l.append(buf[p + 13])
                    flags_l.append(struct.unpack_from("<H", buf, p + 18)[0])
                p += 4 + block_size
            bufs.append(bytes(buf))
            buf_base += len(buf)

        m = len(offsets)
        batch = self._decode_selected(
            b"".join(bufs), np.asarray(offsets, dtype=np.int64),
            np.asarray(ref_ids_l, dtype=np.int32),
            np.asarray(poss_l, dtype=np.int32),
            np.asarray(mapqs_l, dtype=np.uint8),
            np.asarray(flags_l, dtype=np.uint16), np.arange(m), parse_tags,
            parse_names)
        return subset_batch(batch, batch.end_pos >= beg0)


def subset_batch(batch: ReadBatch, mask: np.ndarray) -> ReadBatch:
    """New ReadBatch containing only reads where mask is True (re-packs the
    ragged cigar/seq/qual arrays)."""
    idx = np.nonzero(mask)[0]
    clens = (batch.cigar_off[1:] - batch.cigar_off[:-1])[idx]
    slens = (batch.seq_off[1:] - batch.seq_off[:-1])[idx]
    cigar_off = np.zeros(len(idx) + 1, dtype=np.int64)
    np.cumsum(clens, out=cigar_off[1:])
    seq_off = np.zeros(len(idx) + 1, dtype=np.int64)
    np.cumsum(slens, out=seq_off[1:])
    ctake = np.concatenate([np.arange(batch.cigar_off[i], batch.cigar_off[i + 1])
                            for i in idx]) if len(idx) else np.empty(0, np.int64)
    stake = np.concatenate([np.arange(batch.seq_off[i], batch.seq_off[i + 1])
                            for i in idx]) if len(idx) else np.empty(0, np.int64)
    return ReadBatch(
        n=len(idx),
        ref_id=batch.ref_id[idx], pos=batch.pos[idx], mapq=batch.mapq[idx],
        flag=batch.flag[idx], cigar_off=cigar_off,
        cigar_ops=batch.cigar_ops[ctake],
        cigar_lens=batch.cigar_lens[ctake],
        seq_off=seq_off, seq=batch.seq[stake], qual=batch.qual[stake],
        end_pos=batch.end_pos[idx],
        xd_tags=None if batch.xd_tags is None else [batch.xd_tags[i] for i in idx],
        xn_tags=None if batch.xn_tags is None else [batch.xn_tags[i] for i in idx],
        extra_tags=(None if batch.extra_tags is None
                    else [batch.extra_tags[i] for i in idx]),
        names=None if batch.names is None else [batch.names[i] for i in idx],
        mate_ref_id=(None if batch.mate_ref_id is None
                     else batch.mate_ref_id[idx]),
        mate_pos=None if batch.mate_pos is None else batch.mate_pos[idx],
    )


def concat_batches(a: ReadBatch, b: ReadBatch) -> ReadBatch:
    """Concatenate two batches (Gemini's -RegionSize EdgeState carry into
    the next block)."""
    if a.n == 0:
        return b
    if b.n == 0:
        return a

    def cat_opt_list(x, y):
        if x is None and y is None:
            return None
        return (x or []) + (y or [])

    def cat_opt_arr(x, y):
        if x is None or y is None:
            return None
        return np.concatenate([x, y])

    return ReadBatch(
        n=a.n + b.n,
        ref_id=np.concatenate([a.ref_id, b.ref_id]),
        pos=np.concatenate([a.pos, b.pos]),
        mapq=np.concatenate([a.mapq, b.mapq]),
        flag=np.concatenate([a.flag, b.flag]),
        cigar_off=np.concatenate([a.cigar_off,
                                  b.cigar_off[1:] + a.cigar_off[-1]]),
        cigar_ops=np.concatenate([a.cigar_ops, b.cigar_ops]),
        cigar_lens=np.concatenate([a.cigar_lens, b.cigar_lens]),
        seq_off=np.concatenate([a.seq_off, b.seq_off[1:] + a.seq_off[-1]]),
        seq=np.concatenate([a.seq, b.seq]),
        qual=np.concatenate([a.qual, b.qual]),
        end_pos=np.concatenate([a.end_pos, b.end_pos]),
        xd_tags=cat_opt_list(a.xd_tags, b.xd_tags),
        xn_tags=cat_opt_list(a.xn_tags, b.xn_tags),
        extra_tags=cat_opt_list(a.extra_tags, b.extra_tags),
        names=cat_opt_list(a.names, b.names),
        mate_ref_id=cat_opt_arr(a.mate_ref_id, b.mate_ref_id),
        mate_pos=cat_opt_arr(a.mate_pos, b.mate_pos),
    )


def filter_batch(batch: ReadBatch, min_map_quality: int = 1,
                 remove_duplicates: bool = True,
                 only_proper_pairs: bool = False) -> np.ndarray:
    """Read-level skip rules (reference: AlignmentSource.ShouldSkipRead,
    exe/Pisces/Logic/Alignment/AlignmentsSource.cs:96-104). Returns keep mask."""
    flag = batch.flag
    keep = (flag & FLAG_UNMAPPED) == 0
    keep &= (flag & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY)) == 0
    if only_proper_pairs:
        keep &= (flag & FLAG_PROPER_PAIR) != 0
    if remove_duplicates:
        keep &= (flag & FLAG_DUPLICATE) == 0
    keep &= batch.mapq >= min_map_quality
    has_cigar = (batch.cigar_off[1:] - batch.cigar_off[:-1]) > 0
    keep &= has_cigar
    keep &= batch.pos >= 0
    return keep
