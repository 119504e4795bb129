"""BAM writing (BamWriter / BamWriterInMem equivalents).

Reference: src/lib/Alignment.IO/BamWriter.cs:1-366, BamWriterInMem.cs
(in-memory sort then write). Emits coordinate-sorted BAM, deflated by
the native module's BGZF thread pool, and optionally its .bai; the
synthetic workloads (pisces_tpu_torch.synthetic) and Gemini
(preprocessing/gemini.py) write with it, and cat_bams merges Gemini's
per-chromosome shards.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from pisces_tpu_torch.io.bai import BaiBuilder, reg2bin, write_bai

# char -> 4-bit nibble code in '=ACMGRSVTWYHKDBN'
_NIBBLE = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}
_CIGAR_OPS = "MIDNSHP=X"
_NIBBLE_LUT = np.full(256, 15, dtype=np.uint8)
for _c, _i in _NIBBLE.items():
    _NIBBLE_LUT[ord(_c)] = _i
    _NIBBLE_LUT[ord(_c.lower())] = _i


_NIBBLE_HI = bytes((_NIBBLE_LUT[c] << 4) & 0xFF for c in range(256))
_NIBBLE_LO = bytes(_NIBBLE_LUT)


def _encode_seq(seq: str) -> bytes:
    """4-bit pack via bytes.translate + big-int OR — ~3x faster than the
    numpy round trip at typical read lengths (encode() is per-record hot)."""
    b = seq.encode("latin-1")
    hi = b[0::2].translate(_NIBBLE_HI)
    lo = b[1::2].translate(_NIBBLE_LO)
    if len(lo) < len(hi):
        lo += b"\x00"
    return (int.from_bytes(hi, "big")
            | int.from_bytes(lo, "big")).to_bytes(len(hi), "big")


class BamRecord:
    def __init__(self, name: str, ref_id: int, pos0: int, mapq: int, flag: int,
                 cigar: Sequence[Tuple[int, int]], seq: str, qual: Sequence[int],
                 next_ref_id: int = -1, next_pos: int = -1, tlen: int = 0,
                 tags: Optional[Dict[str, object]] = None):
        self.name = name
        self.ref_id = ref_id
        self.pos0 = pos0
        self.mapq = mapq
        self.flag = flag
        self.cigar = list(cigar)  # [(op_code, length)]
        self.seq = seq
        self.qual = list(qual)
        self.next_ref_id = next_ref_id
        self.next_pos = next_pos
        self.tlen = tlen
        self.tags = tags or {}

    def ref_end0(self) -> int:
        """0-based exclusive reference end (M/D/N/=/X consume reference)."""
        span = sum(ln for op, ln in self.cigar if op in (0, 2, 3, 7, 8))
        return self.pos0 + max(span, 1)

    def encode(self) -> bytes:
        name_b = self.name.encode() + b"\x00"
        n_cigar = len(self.cigar)
        l_seq = len(self.seq)
        rec_bin = reg2bin(self.pos0, self.ref_end0()) if self.ref_id >= 0 else 0
        body = struct.pack("<iiBBHHHiiii", self.ref_id, self.pos0,
                           len(name_b), self.mapq, rec_bin, n_cigar, self.flag,
                           l_seq, self.next_ref_id, self.next_pos, self.tlen)
        body += name_b
        for op, ln in self.cigar:
            body += struct.pack("<I", (ln << 4) | op)
        body += _encode_seq(self.seq)
        q = self.qual
        if isinstance(q, np.ndarray):
            body += np.minimum(q, 255).astype(np.uint8).tobytes()
        else:
            # list path: bytes() is a single C call; BAM quals are <= 93
            try:
                body += bytes(q)
            except (ValueError, TypeError):  # out-of-range / non-int quals
                body += np.minimum(np.asarray(q), 255).astype(
                    np.uint8).tobytes()
        for tag, value in self.tags.items():
            # ints as BAM type 'i' (the XV/XW read-collapsed counts), every
            # other value as a NUL-terminated 'Z' string
            if isinstance(value, int):
                body += tag.encode()[:2] + b"i" + struct.pack("<i", value)
            else:
                body += tag.encode()[:2] + b"Z" + value.encode() + b"\x00"
        return struct.pack("<i", len(body)) + body


def parse_cigar_string(cigar: str) -> List[Tuple[int, int]]:
    import re
    return [(_CIGAR_OPS.index(op), int(n))
            for n, op in re.findall(r"(\d+)([MIDNSHP=X])", cigar)]


class BamWriter:
    """In-memory sort + write (BamWriterInMem pattern)."""

    def __init__(self, path: str, ref_names: Sequence[str],
                 ref_lengths: Sequence[int], extra_header_text: str = ""):
        self.path = path
        self.ref_names = list(ref_names)
        self.ref_lengths = list(ref_lengths)
        self.extra_header_text = extra_header_text
        self.records: List[BamRecord] = []

    def add(self, record: BamRecord) -> None:
        self.records.append(record)

    def add_read(self, name: str, chrom: str, pos1: int, cigar: str, seq: str,
                 qual=30, flag: int = 0, mapq: int = 60,
                 tags: Optional[Dict[str, object]] = None,
                 mate_pos0: int = -1, mate_chrom: Optional[str] = None) -> None:
        """One read from text fields: 1-based pos1, a CIGAR string and a
        single quality for every base or one per base."""
        if isinstance(qual, int):
            qual = [qual] * len(seq)
        rid = self.ref_names.index(chrom)
        mate_rid = (self.ref_names.index(mate_chrom) if mate_chrom
                    else (rid if mate_pos0 >= 0 else -1))
        self.add(BamRecord(name, rid, pos1 - 1, mapq,
                           flag, parse_cigar_string(cigar), seq, qual,
                           next_ref_id=mate_rid, next_pos=mate_pos0,
                           tags=tags))

    def header_bytes(self) -> bytes:
        text = "@HD\tVN:1.6\tSO:coordinate\n"
        for name, length in zip(self.ref_names, self.ref_lengths):
            text += f"@SQ\tSN:{name}\tLN:{length}\n"
        text += self.extra_header_text
        tb = text.encode()
        out = b"BAM\x01" + struct.pack("<i", len(tb)) + tb
        out += struct.pack("<i", len(self.ref_names))
        for name, length in zip(self.ref_names, self.ref_lengths):
            nb = name.encode() + b"\x00"
            out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", length)
        return out

    def write(self, sort: bool = True, index: bool = False) -> str:
        """Write the BAM (coordinate-sorted by default). With index=True a
        sibling .bai is built from the records' virtual offsets (the
        reference's BamWriter + BamIndex.CreateIndexFromBamFile analog).

        The uncompressed stream is deflated across the native thread pool
        (the reference's BamWriterMultithreaded), in the fixed 0xFF00-byte
        chunks that io/bgzf.BgzfWriter cuts, so the bytes are the streaming
        writer's; each record's virtual offset follows from the chunking."""
        from pisces_tpu_torch.io.native import bgzf_compress_parallel
        if sort:
            self.records.sort(key=lambda r: (r.ref_id, r.pos0))
        parts = [self.header_bytes()]
        upos = [len(parts[0])]
        for r in self.records:
            enc = r.encode()
            parts.append(enc)
            upos.append(upos[-1] + len(enc))
        out, block_off = bgzf_compress_parallel(b"".join(parts))
        with open(self.path, "wb") as f:
            f.write(out)
        if index:
            builder = BaiBuilder(len(self.ref_names))
            for i, r in enumerate(self.records):
                builder.add(r.ref_id, r.pos0, r.ref_end0(),
                            _voff(block_off, upos[i]),
                            _voff(block_off, upos[i + 1]),
                            mapped=not (r.flag & 0x4))
            write_bai(builder.build(), self.path + ".bai")
        return self.path


def _voff(block_off: np.ndarray, u: int) -> int:
    """Virtual offset of uncompressed stream offset u in a BGZF file cut
    into 0xFF00-byte chunks whose file offsets are block_off."""
    b, within = divmod(u, 0xFF00)
    return (int(block_off[b]) << 16) | within


def cat_bams(shard_paths: Sequence[str], out_path: str,
             ref_names: Sequence[str], ref_lengths: Sequence[int],
             extra_header_text: str = "", index: bool = True) -> str:
    """samtools-cat analog (GeminiWorkflow.cs:62-101 merge step, done
    natively): concatenate per-chromosome sorted BAM shards at the
    record-byte level (records are never re-encoded), recompress the
    stream with the parallel BGZF deflater, and rebuild the .bai from the
    shard readers' columnar fields and the chunking's virtual offsets.
    Shards must share the output's reference dictionary and be
    coordinate-sorted, in genome order across the list."""
    from pisces_tpu_torch.io.bam import BamReader
    from pisces_tpu_torch.io.native import bgzf_compress_parallel

    w = BamWriter(out_path, ref_names, ref_lengths,
                  extra_header_text=extra_header_text)
    header = w.header_bytes()
    parts = [header]
    per_shard = []  # (batch, record_ustart[int64]) in output stream coords
    upos = len(header)
    for p in shard_paths:
        r = BamReader(p)
        offs = r._scan_record_offsets()
        stream = r._data[r._records_start:]
        parts.append(stream)
        batch = r.fetch()
        per_shard.append((batch, offs - r._records_start + upos))
        upos += len(stream)
    out, block_off = bgzf_compress_parallel(b"".join(parts))
    with open(out_path, "wb") as f:
        f.write(out)
    if index:
        builder = BaiBuilder(len(ref_names))
        for batch, ustarts in per_shard:
            for i in range(batch.n):
                builder.add(int(batch.ref_id[i]), int(batch.pos[i]),
                            int(batch.end_pos[i]) + 1,
                            _voff(block_off, int(ustarts[i])),
                            _voff(block_off, int(ustarts[i + 1])),
                            mapped=not (int(batch.flag[i]) & 0x4))
        write_bai(builder.build(), out_path + ".bai")
    return out_path
