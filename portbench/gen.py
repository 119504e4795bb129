"""Sample generator: the reads, genome, BAM, .bai and intervals of one cell.

Frozen copy, extended, of pisces_tpu_torch/synthetic.py's
generate_wgs_workload and _write_genome (commit 68f5a3446fa7): the read
profile is that generator's. This copy adds several chromosomes, any read
length, somatic SNVs at fixed VFs (titration points), germline het and hom
SNVs, Q30 base errors on every read, and a Picard intervals file; and it
deflates BGZF with zlib on a thread pool, so it needs nothing of the
program.

A configuration's reads come from its read layout,
portbench/layouts/<name>.py, named by the `layout` key of its `reads`
block (single_end where there is none; load_layout). A layout defines
make_sample(spec, seed), which draws everything from the seed and returns
the read arrays; write_sample(out_dir, sample, threads), which writes them
through write_reads, the general record writer (any read length and CIGAR,
mate fields, tags, extra header lines); and counts(sample, ch,
min_base_quality), the reference's pileup of the same arrays, never of the
program's decode of the BAM.

This module also holds the single-end read model. Read classes (CIGAR
shapes), as in the copied generator, for read length L and h = L // 2:
0 = LM, 1 = 8S(L-8)M, 2 = (L-8)M8S, 3 = (h-2)M2I(L-h)M, 4 = (h-1)M2D(L-h+1)M.
"""
from __future__ import annotations

import importlib.util
import os
import struct
import sys
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
CLIP = 8
# BAM 4-bit base codes ("=ACMGRSVTWYHKDBN")
_NIBBLE_LUT = np.full(256, 15, dtype=np.uint8)
for _c, _i in zip(b"ACGT", (1, 2, 4, 8)):
    _NIBBLE_LUT[_c] = _i
BGZF_CHUNK = 0xFF00
BGZF_EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000"
                         "000000")
LINEAR_SHIFT = 14
PSEUDO_BIN = 37450
# reads a block of BAM records (the unit of the writer's thread pool)
RECORD_BLOCK = 125_000
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclass
class ChromReads:
    """One chromosome's reference and reads, in coordinate order."""

    name: str
    seq: np.ndarray          # uint8 ASCII reference
    pos0: np.ndarray         # int64 [n] 0-based leftmost mapped base
    cls: np.ndarray          # int8 [n] read class (module docstring)
    rev: np.ndarray          # bool [n] reverse strand
    dip: np.ndarray          # bool [n] low-quality tail
    reads: np.ndarray        # uint8 [n, L] ASCII bases, read orientation


@dataclass
class Sample:
    read_len: int
    tail_len: int
    low_q: int
    high_q: int
    chroms: List[ChromReads]

    @property
    def n_reads(self) -> int:
        return sum(len(c.pos0) for c in self.chroms)


def class_layout(read_len: int):
    """Per class: (read column -> reference offset, -1 where the column is
    clipped or inserted), the reference offsets of deleted bases, the
    reference span, and the CIGAR as (op, length) pairs."""
    L, h = read_len, read_len // 2
    cols = np.arange(L)
    m0 = cols.copy()
    m1 = np.where(cols >= CLIP, cols - CLIP, -1)
    m2 = np.where(cols < L - CLIP, cols, -1)
    m3 = np.where(cols < h - 2, cols, np.where(cols < h, -1, cols - 2))
    m4 = np.where(cols < h - 1, cols, cols + 2)
    dels = [np.empty(0, np.int64)] * 4 + [np.array([h - 1, h], np.int64)]
    spans = np.array([L, L - CLIP, L - CLIP, L - 2, L + 2], np.int64)
    # BAM ops: 0 M, 1 I, 2 D, 4 S
    cigars = [[(0, L)], [(4, CLIP), (0, L - CLIP)], [(0, L - CLIP), (4, CLIP)],
              [(0, h - 2), (1, 2), (0, L - h)],
              [(0, h - 1), (2, 2), (0, L - h + 1)]]
    return [m0, m1, m2, m3, m4], dels, spans, cigars


def _mapped_runs(m: np.ndarray):
    """[c0, c1) runs of read columns whose reference offsets step by one."""
    runs, c0 = [], None
    for c in range(len(m) + 1):
        cont = (c < len(m) and m[c] >= 0 and c0 is not None
                and m[c] == m[c - 1] + 1)
        if c0 is not None and not cont:
            runs.append((c0, c))
            c0 = None
        if c < len(m) and m[c] >= 0 and c0 is None:
            c0 = c
    return runs


def _read_offsets(d: np.ndarray, cls: np.ndarray, read_len: int):
    """Read column of reference offset d (site - pos0) in reads of class
    cls; -1 where that read has no mapped base there (class_layout's maps,
    inverted)."""
    layouts = class_layout(read_len)[0]
    inv = np.full((5, read_len + 3), -1, np.int64)
    for c, m in enumerate(layouts):
        cols = np.flatnonzero(m >= 0)
        inv[c, m[cols]] = cols
    inside = (d >= 0) & (d < read_len + 3)
    return np.where(inside, inv[cls, np.clip(d, 0, read_len + 2)], -1)


def _plant(rng, ch: ChromReads, sites: np.ndarray, vafs: np.ndarray,
           read_len: int) -> None:
    """Give each read with a mapped base at a site its alt base with the
    site's VF (one alt a site, another base than the reference)."""
    max_span = read_len + 2
    for s, vf in zip(sites.tolist(), vafs.tolist()):
        lo = int(np.searchsorted(ch.pos0, s - max_span + 1))
        hi = int(np.searchsorted(ch.pos0, s, side="right"))
        idx = np.arange(lo, hi)
        off = _read_offsets(s - ch.pos0[idx], ch.cls[idx], read_len)
        ok = off >= 0
        idx, off = idx[ok], off[ok]
        ref = int(np.searchsorted(BASES, ch.seq[s]))
        alt = BASES[(ref + 1 + int(rng.integers(0, 3))) % 4]
        carry = rng.random(idx.size) < vf
        ch.reads[idx[carry], off[carry]] = alt


def make_sample(spec: dict, seed: int) -> Sample:
    """All of a sample from the seed: reference, reads, planted sites.

    spec keys: chroms (names), chrom_len, reads_per_chrom, read_len,
    profile {indel, softclip, low_q_tail, tail_len, base_error, low_q,
    high_q}, and optionally somatic {vafs, sites_per_vaf} (sites a VF a
    chromosome) and germline {sites_per_kb, hom_share}. The same spec gives
    every seed the same sizes; the seed moves positions, bases and
    carriers."""
    rng = np.random.default_rng(seed)
    L = int(spec["read_len"])
    prof = spec["profile"]
    clen = int(spec["chrom_len"])
    n = int(spec["reads_per_chrom"])
    layouts = class_layout(L)[0]
    out = []
    for name in spec["chroms"]:
        seq = BASES[rng.integers(0, 4, clen)]
        pos0 = np.sort(rng.integers(0, clen - L - 3, n)).astype(np.int64)
        u = rng.random(n)
        c_sc, c_in = prof["softclip"], prof["indel"]
        cls = np.select([u < 1 - c_sc - c_in, u < 1 - c_sc / 2 - c_in,
                         u < 1 - c_in, u < 1 - c_in / 2],
                        [0, 1, 2, 3], default=4).astype(np.int8)
        rev = rng.random(n) < 0.5
        dip = rng.random(n) < prof["low_q_tail"]
        reads = np.empty((n, L), np.uint8)
        for c in range(5):
            sel = np.flatnonzero(cls == c)
            if sel.size == 0:
                continue
            m = layouts[c]
            # runs of read columns that map to consecutive reference bases
            for c0, c1 in _mapped_runs(m):
                win = np.lib.stride_tricks.sliding_window_view(seq, c1 - c0)
                reads[sel, c0:c1] = win[pos0[sel] + m[c0]]
            free = np.flatnonzero(m < 0)
            if free.size:
                reads[sel[:, None], free[None, :]] = \
                    BASES[rng.integers(0, 4, (sel.size, free.size))]
        ch = ChromReads(name, seq, pos0, cls, rev, dip, reads)
        margin = 2 * L
        grid = np.arange(margin, clen - margin, 2 * L)
        som = spec.get("somatic")
        if som:
            vafs = np.repeat(np.asarray(som["vafs"], np.float64),
                             int(som["sites_per_vaf"]))
            k = min(vafs.size, grid.size)
            sites = np.sort(rng.choice(grid, size=k, replace=False))
            vafs = vafs[rng.permutation(vafs.size)][:k]
            _plant(rng, ch, sites, vafs, L)
        ger = spec.get("germline")
        if ger:
            k = int(round(clen / 1000 * ger["sites_per_kb"]))
            sites = rng.choice(grid, size=min(k, grid.size), replace=False)
            hom = rng.random(sites.size) < ger["hom_share"]
            # fixed het sites (0-based), such as both sides of a window join
            fixed = np.asarray([s for s in ger.get("fixed_het_sites", ())
                                if margin <= s < clen - margin], np.int64)
            sites = np.concatenate([sites, fixed])
            hom = np.concatenate([hom, np.zeros(fixed.size, bool)])
            order = np.argsort(sites, kind="stable")
            sites, hom = sites[order], hom[order]
            _plant(rng, ch, sites, np.where(hom, 1.0, 0.5), L)
        # Q30-consistent base errors on any base of any read
        n_err = int(rng.binomial(n * L, prof["base_error"]))
        flat = rng.integers(0, n * L, n_err)
        er, ec = flat // L, flat % L
        reads[er, ec] = BASES[(np.searchsorted(BASES, reads[er, ec]) + 1) % 4]
        out.append(ch)
    return Sample(L, int(prof["tail_len"]), int(prof["low_q"]),
                  int(prof["high_q"]), out)


def qualities(sample: Sample, ch: ChromReads) -> np.ndarray:
    """uint8 [n, L] base qualities: high_q, the last tail_len low_q on the
    reads with a low-quality tail."""
    q = np.full(ch.reads.shape, sample.high_q, np.uint8)
    q[np.flatnonzero(ch.dip)[:, None],
      np.arange(sample.read_len - sample.tail_len, sample.read_len)[None, :]] \
        = sample.low_q
    return q


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _write_genome(gdir: str, chroms) -> None:
    os.makedirs(gdir, exist_ok=True)
    gs = []
    for ch in chroms:
        n = len(ch.seq)
        pad = (-n) % 70
        grid = np.concatenate([ch.seq, np.zeros(pad, np.uint8)]).reshape(-1, 70)
        lines = np.concatenate(
            [grid, np.full((grid.shape[0], 1), ord("\n"), np.uint8)], axis=1)
        body = lines.tobytes()[:n + n // 70 + (1 if n % 70 else 0)]
        with open(os.path.join(gdir, f"{ch.name}.fa"), "wb") as f:
            f.write(f">{ch.name}\n".encode())
            f.write(body if body.endswith(b"\n") else body + b"\n")
        with open(os.path.join(gdir, f"{ch.name}.fa.fai"), "w") as f:
            f.write(f"{ch.name}\t{n}\t{len(ch.name) + 2}\t70\t71\n")
        gs.append(f'\t<chromosome fileName="{ch.name}.fa" '
                  f'contigName="{ch.name}" totalBases="{n}" '
                  f'isCircular="false" md5="x" ploidy="2" knownBases="{n}" />')
    with open(os.path.join(gdir, "GenomeSize.xml"), "w") as f:
        f.write('<sequenceSizes genomeName="portbench">\n'
                + "\n".join(gs) + "\n</sequenceSizes>")


def _header_bytes(chroms, header_lines=()) -> bytes:
    text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{c.name}\tLN:{len(c.seq)}\n" for c in chroms) + "".join(
        line + "\n" for line in header_lines)
    tb = text.encode()
    out = b"BAM\x01" + struct.pack("<i", len(tb)) + tb
    out += struct.pack("<i", len(chroms))
    for c in chroms:
        nb = c.name.encode() + b"\x00"
        out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", len(c.seq))
    return out


def _bins(pos0: np.ndarray, end0: np.ndarray) -> np.ndarray:
    """Vectorized reg2bin over every level (SAMv1)."""
    e = end0 - 1
    return np.select(
        [pos0 >> 14 == e >> 14, pos0 >> 17 == e >> 17, pos0 >> 20 == e >> 20,
         pos0 >> 23 == e >> 23, pos0 >> 26 == e >> 26],
        [4681 + (pos0 >> 14), 585 + (pos0 >> 17), 73 + (pos0 >> 20),
         9 + (pos0 >> 23), 1 + (pos0 >> 26)], default=0).astype(np.int64)


@dataclass
class Records:
    """One chromosome's BAM records in coordinate order, a column a field.
    The variable-length fields lie flat with [n + 1] offsets: names with
    their closing NUL, CIGAR operations as (length << 4) | op, bases as
    ASCII with their qualities under the same offsets, and each read's
    tags already encoded as BAM aux bytes (see z_tags)."""

    pos0: np.ndarray         # int64 [n] 0-based leftmost mapped base
    flag: np.ndarray         # uint16 [n]
    mapq: np.ndarray         # uint8 [n]
    next_ref: np.ndarray     # int32 [n] mate's reference id, -1 without
    next_pos: np.ndarray     # int32 [n] mate's 0-based position, -1 without
    tlen: np.ndarray         # int32 [n] template length
    names: np.ndarray        # uint8
    name_off: np.ndarray     # int64 [n + 1]
    cigar: np.ndarray        # uint32
    cigar_off: np.ndarray    # int64 [n + 1]
    seq: np.ndarray          # uint8 ASCII bases
    qual: np.ndarray         # uint8 base qualities
    seq_off: np.ndarray      # int64 [n + 1]
    aux: np.ndarray          # uint8
    aux_off: np.ndarray      # int64 [n + 1]

    def end0(self) -> np.ndarray:
        """int64 [n] 0-based end (exclusive) of each read's mapped span."""
        ops, lens = self.cigar & 0xF, (self.cigar >> 4).astype(np.int64)
        on_ref = np.isin(ops, (0, 2, 3, 7, 8))
        return self.pos0 + np.add.reduceat(np.where(on_ref, lens, 0),
                                           self.cigar_off[:-1])


def serial_names(idx: np.ndarray):
    """(names, offsets): "r%09d" with its NUL for each read number in idx,
    the names the single-end generator gives."""
    idx = np.asarray(idx, np.int64)
    names = np.empty((len(idx), 11), np.uint8)
    names[:, 0] = ord("r")
    names[:, 1:10] = 48 + (idx[:, None] // 10 ** np.arange(8, -1, -1)) % 10
    names[:, 10] = 0
    return names.reshape(-1), np.arange(len(idx) + 1, dtype=np.int64) * 11


def z_tags(tag: str, values: List[str], which: np.ndarray):
    """(aux bytes, [n + 1] offsets) of one Z-typed tag a read, read i's
    value being values[which[i]]."""
    enc = [tag.encode() + b"Z" + v.encode() + b"\x00" for v in values]
    table = np.zeros((len(enc), max(map(len, enc))), np.uint8)
    for row, e in zip(table, enc):
        row[:len(e)] = np.frombuffer(e, np.uint8)
    lens = np.array([len(e) for e in enc], np.int64)[which]
    flat = table[which][np.arange(table.shape[1])[None, :] < lens[:, None]]
    return flat, np.concatenate([[0], np.cumsum(lens)])


def _interleave(parts):
    """Each read's bytes of every part in turn: parts are (flat uint8, [n]
    lengths) pairs. Returns the flat bytes and their [n + 1] offsets.

    Each part goes as a [n, its widest] block into a row a read, at the
    read's column (a slice copy for each distinct column); a part's
    padding lies under the parts after it or past the row's end, which the
    last gather leaves out."""
    lens = np.stack([np.asarray(ln, np.int64) for _d, ln in parts])
    n = lens.shape[1]
    sizes = lens.sum(axis=0)
    col = np.cumsum(lens, axis=0) - lens
    widths = lens.max(axis=1, initial=0)
    rows = np.zeros((n, int((col + widths[:, None]).max(initial=0))),
                    np.uint8)
    for (data, ln), c, w in zip(parts, col, widths.tolist()):
        if n == 0 or w == 0:
            continue
        if (ln == w).all():
            block = data.reshape(n, w)
        else:
            block = np.zeros((n, w), np.uint8)
            block[np.arange(w)[None, :] < ln[:, None]] = data
        c0 = int(c[0])
        if (c == c0).all():
            rows[:, c0:c0 + w] = block
            continue
        for u in np.unique(c).tolist():
            sel = np.flatnonzero(c == u)
            rows[sel, u:u + w] = block[sel]
    out = rows[np.arange(rows.shape[1])[None, :] < sizes[:, None]]
    return out, np.concatenate([[0], np.cumsum(sizes)])


_FIXED = np.dtype({
    "names": ["block_size", "ref_id", "pos", "l_name", "mapq", "bin",
              "n_cigar", "flag", "l_seq", "next_ref", "next_pos", "tlen"],
    "formats": ["<i4", "<i4", "<i4", "u1", "u1", "<u2", "<u2", "<u2", "<i4",
                "<i4", "<i4", "<i4"]})


def _assemble(rec: Records, bins: np.ndarray, ref_id: int, i0: int,
              i1: int):
    """Raw BAM records of reads [i0, i1), as one uint8 array, and each
    record's size."""
    def cut(data, off):
        return data[off[i0]:off[i1]], np.diff(off[i0:i1 + 1])
    name, l_name = cut(rec.names, rec.name_off)
    cigar, n_cigar = cut(rec.cigar, rec.cigar_off)
    seq, l_seq = cut(rec.seq, rec.seq_off)
    qual, _l = cut(rec.qual, rec.seq_off)
    aux, l_aux = cut(rec.aux, rec.aux_off)
    n = i1 - i0
    # 4-bit bases, a zero nibble after each read of odd length
    nib = _NIBBLE_LUT[seq]
    if (l_seq % 2).any():
        nib = _interleave([(nib, l_seq),
                           (np.zeros(n, np.uint8), l_seq % 2)])[0]
    packed = (l_seq + 1) // 2
    fixed = np.zeros(n, _FIXED)
    fixed["block_size"] = 32 + l_name + 4 * n_cigar + packed + l_seq + l_aux
    fixed["ref_id"] = ref_id
    fixed["pos"] = rec.pos0[i0:i1]
    fixed["l_name"] = l_name
    fixed["mapq"] = rec.mapq[i0:i1]
    fixed["bin"] = bins[i0:i1]
    fixed["n_cigar"] = n_cigar
    fixed["flag"] = rec.flag[i0:i1]
    fixed["l_seq"] = l_seq
    fixed["next_ref"] = rec.next_ref[i0:i1]
    fixed["next_pos"] = rec.next_pos[i0:i1]
    fixed["tlen"] = rec.tlen[i0:i1]
    raw, off = _interleave([
        (fixed.view(np.uint8), np.full(n, _FIXED.itemsize)),
        (name, l_name), (cigar.astype("<u4").view(np.uint8), 4 * n_cigar),
        ((nib[0::2] << 4) | nib[1::2], packed), (qual, l_seq),
        (aux, l_aux)])
    return raw, np.diff(off)


def _bgzf_block(chunk: bytes, level: int) -> bytes:
    c = zlib.compressobj(level, zlib.DEFLATED, -15)
    body = c.compress(chunk) + c.flush()
    hdr = struct.pack("<4BI2BH2BHH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6,
                      ord("B"), ord("C"), 2, len(body) + 25)
    return hdr + body + struct.pack("<II", zlib.crc32(chunk) & 0xFFFFFFFF,
                                    len(chunk))


def bgzf_compress(raw: bytes, threads: int, level: int = 1):
    """(BGZF bytes with the EOF block, each block's file offset): fixed
    0xFF00-byte chunks deflated by zlib on a thread pool (zlib releases the
    GIL), so a record's virtual offset follows from its raw offset."""
    view = memoryview(raw)
    chunks = [view[i:i + BGZF_CHUNK] for i in range(0, len(raw), BGZF_CHUNK)]
    with ThreadPoolExecutor(max_workers=threads) as ex:
        blocks = list(ex.map(lambda c: _bgzf_block(bytes(c), level), chunks))
    sizes = np.array([len(b) for b in blocks], np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    return b"".join(blocks) + BGZF_EOF, offsets


def _ref_index(voff, bins, pos0, end0, clen):
    """One reference's .bai part as bytes (bins with their chunks, the
    pseudo-bin, the 16 kb linear index)."""
    n = len(voff) - 1
    out = []
    if n == 0:
        return struct.pack("<i", 0) + struct.pack("<i", 0)
    chunks: Dict[int, list] = {}
    cut = np.flatnonzero(np.diff(bins)) + 1
    seg_s = np.concatenate([[0], cut])
    seg_e = np.concatenate([cut, [n]])
    for s, e in zip(seg_s.tolist(), seg_e.tolist()):
        chunks.setdefault(int(bins[s]), []).append((int(voff[s]),
                                                    int(voff[e])))
    out.append(struct.pack("<i", len(chunks) + 1))
    for b in sorted(chunks):
        out.append(struct.pack("<Ii", b, len(chunks[b])))
        for beg, end in chunks[b]:
            out.append(struct.pack("<QQ", beg, end))
    out.append(struct.pack("<Ii", PSEUDO_BIN, 2))
    out.append(struct.pack("<QQ", int(voff[0]), int(voff[n])))
    out.append(struct.pack("<QQ", n, 0))
    n_win = int((clen - 1) >> LINEAR_SHIFT) + 1
    linear = np.zeros(n_win, np.int64)
    w_beg = pos0 >> LINEAR_SHIFT
    first = np.searchsorted(w_beg, np.arange(n_win), side="left")
    have = first < n
    linear[have] = voff[np.minimum(first[have], n - 1)]
    w_end = (end0 - 1) >> LINEAR_SHIFT
    for i in np.flatnonzero(w_end > w_beg).tolist():
        we = int(w_end[i])
        if linear[we] == 0 or voff[i] < linear[we]:
            linear[we] = int(voff[i])
    out.append(struct.pack("<i", n_win))
    out.append(linear.astype("<u8").tobytes())
    return b"".join(out)


def single_end_records(sample: Sample, ch: ChromReads,
                       first: int) -> Records:
    """A chromosome's reads as BAM records (unpaired, MAPQ 60, no tags),
    named from read number `first` on."""
    L = sample.read_len
    n = len(ch.pos0)
    cigars = class_layout(L)[3]
    table = np.zeros((len(cigars), 3), np.uint32)
    for c, cig in enumerate(cigars):
        table[c, :len(cig)] = [(ln << 4) | op for op, ln in cig]
    n_ops = np.array([len(c) for c in cigars])[ch.cls]
    names, name_off = serial_names(np.arange(first, first + n))
    return Records(
        pos0=ch.pos0, flag=np.where(ch.rev, 16, 0).astype(np.uint16),
        mapq=np.full(n, 60, np.uint8), next_ref=np.full(n, -1, np.int32),
        next_pos=np.full(n, -1, np.int32), tlen=np.zeros(n, np.int32),
        names=names, name_off=name_off,
        cigar=table[ch.cls][np.arange(3)[None, :] < n_ops[:, None]],
        cigar_off=np.concatenate([[0], np.cumsum(n_ops)]),
        seq=ch.reads.reshape(-1), qual=qualities(sample, ch).reshape(-1),
        seq_off=np.arange(n + 1, dtype=np.int64) * L,
        aux=np.zeros(0, np.uint8), aux_off=np.zeros(n + 1, np.int64))


def write_sample(out_dir: str, sample: Sample, threads: int = 8) -> dict:
    """Write the single-end sample's genome/, sample.bam, sample.bam.bai
    and intervals.picard under out_dir; returns their paths."""
    firsts = np.cumsum([0] + [len(ch.pos0) for ch in sample.chroms])
    return write_reads(out_dir, sample.chroms,
                       [single_end_records(sample, ch, int(f))
                        for ch, f in zip(sample.chroms, firsts)], threads)


def write_reads(out_dir: str, chroms, records: List[Records],
                threads: int = 8, header_lines=()) -> dict:
    """Write genome/ (chroms: each with .name and .seq), sample.bam (one
    Records a chromosome; header_lines follow the @SQ lines),
    sample.bam.bai and intervals.picard (each chromosome's whole span)
    under out_dir; returns their paths and the BAM's size."""
    os.makedirs(out_dir, exist_ok=True)
    gdir = os.path.join(out_dir, "genome")
    _write_genome(gdir, chroms)
    header = _header_bytes(chroms, header_lines)
    ends = [rec.end0() for rec in records]
    bins = [_bins(rec.pos0, end0) for rec, end0 in zip(records, ends)]
    # records in blocks of reads on a thread pool (numpy's copies and
    # gathers release the GIL), joined in order
    jobs = [(ref_id, i0, min(i0 + RECORD_BLOCK, len(rec.pos0)))
            for ref_id, rec in enumerate(records)
            for i0 in range(0, len(rec.pos0), RECORD_BLOCK)]
    with ThreadPoolExecutor(max_workers=threads) as ex:
        blocks = list(ex.map(lambda j: _assemble(records[j[0]], bins[j[0]],
                                                 *j), jobs))
    parts, per_ref = [header], []
    at = len(header)
    for ref_id, (ch, rec) in enumerate(zip(chroms, records)):
        sizes = [b[1] for j, b in zip(jobs, blocks) if j[0] == ref_id]
        sizes = np.concatenate(sizes) if sizes else np.zeros(0, np.int64)
        ustart = at + np.concatenate([[0], np.cumsum(sizes)])
        per_ref.append((ustart, bins[ref_id], rec.pos0, ends[ref_id],
                        len(ch.seq)))
        at = int(ustart[-1])
    parts += [b[0].tobytes() for b in blocks]
    del blocks
    data, block_off = bgzf_compress(b"".join(parts), threads)
    del parts
    bam = os.path.join(out_dir, "sample.bam")
    with open(bam, "wb") as f:
        f.write(data)
    index = [b"BAI\x01", struct.pack("<i", len(chroms))]
    for ustart, bins, pos0, end0, clen in per_ref:
        blk, within = np.divmod(ustart, BGZF_CHUNK)
        voff = (block_off[blk] << 16) | within
        index.append(_ref_index(voff, bins, pos0, end0, clen))
    index.append(struct.pack("<Q", 0))
    with open(bam + ".bai", "wb") as f:
        f.write(b"".join(index))
    intervals = os.path.join(out_dir, "intervals.picard")
    with open(intervals, "w") as f:
        f.write("@HD\tVN:1.4\n")
        for ch in chroms:
            f.write(f"@SQ\tSN:{ch.name}\tLN:{len(ch.seq)}\n")
        for ch in chroms:
            f.write(f"{ch.name}\t1\t{len(ch.seq)}\t+\t{ch.name}_target\n")
    return {"bam": bam, "genome": gdir, "intervals": intervals,
            "bam_bytes": len(data)}


def sample_spec(config: dict, traffic: dict, part: dict = None) -> dict:
    """The generator's spec of a cell: the configuration's reads block and
    the traffic's sizes (or those of its warm-up part)."""
    sizes = part if part is not None else traffic
    spec = dict(config["reads"])
    spec.update({k: sizes[k] for k in ("chroms", "chrom_len",
                                       "reads_per_chrom")})
    return spec


def load_layout(config: dict, root: str = ROOT):
    """The module portbench/layouts/<name>.py under root of the
    configuration's read layout (`layout` in its reads block, single_end
    where it names none)."""
    name = config["reads"].get("layout", "single_end")
    path = os.path.join(root, "portbench", "layouts", name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no read layout {name!r}: {path}")
    mod_name = f"portbench_layout_{name}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    # dataclasses look their module up in sys.modules
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def generate_inputs(config: dict, traffic: dict, seed: int, out_dir: str,
                    root: str = ROOT) -> dict:
    """Write the cell's sample and its warm-up sample under out_dir (run in
    a child process, so that the arrays are not the measured process's
    memory); returns their paths and read counts. A traffic whose
    `warmup` is "sample" warms up on the sample itself."""
    layout = load_layout(config, root)
    threads = min(8, os.cpu_count() or 1)
    sample = layout.make_sample(sample_spec(config, traffic), seed)
    paths = layout.write_sample(os.path.join(out_dir, "sample"), sample,
                                threads)
    paths["n_reads"] = sample.n_reads
    del sample
    if traffic["warmup"] == "sample":
        return {"sample": paths, "warmup": paths}
    warm = layout.make_sample(
        sample_spec(config, traffic, traffic["warmup"]), seed + 1)
    wpaths = layout.write_sample(os.path.join(out_dir, "warmup"), warm,
                                 threads)
    wpaths["n_reads"] = warm.n_reads
    return {"sample": paths, "warmup": wpaths}
