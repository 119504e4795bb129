"""Sample generator: the reads, genome, BAM, .bai and intervals of one cell.

Frozen copy, extended, of pisces_tpu_torch/synthetic.py's
generate_wgs_workload and _write_genome (commit 68f5a3446fa7): the read
profile and the structured-record BAM assembly are that generator's. This
copy adds several chromosomes, any read length, somatic SNVs at fixed VFs
(titration points), germline het and hom SNVs, Q30 base errors on every
read, and a Picard intervals file; and it deflates BGZF with zlib on a
thread pool, so it needs nothing of the program.

make_sample() draws everything from the seed and returns the read arrays;
write_sample() writes them. The reference (portbench/reference) takes the
same arrays, never the program's decode of the BAM.

Read classes (CIGAR shapes), as in the copied generator, for read length L
and h = L // 2: 0 = LM, 1 = 8S(L-8)M, 2 = (L-8)M8S, 3 = (h-2)M2I(L-h)M,
4 = (h-1)M2D(L-h+1)M.
"""
from __future__ import annotations

import os
import struct
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

def _write_genome(gdir: str, chroms: List[ChromReads]) -> None:
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


def _header_bytes(chroms: List[ChromReads]) -> bytes:
    text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{c.name}\tLN:{len(c.seq)}\n" for c in chroms)
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


def _records(sample: Sample, ch: ChromReads, ref_id: int, name_base: int,
             i0: int, i1: int):
    """Raw BAM records of reads [i0, i1) of a chromosome, in read order, as
    one uint8 array, and each record's size."""
    L = sample.read_len
    _l, _d, spans, cigars = class_layout(L)
    ch = ChromReads(ch.name, ch.seq, ch.pos0[i0:i1], ch.cls[i0:i1],
                    ch.rev[i0:i1], ch.dip[i0:i1], ch.reads[i0:i1])
    name_base += i0
    n = len(ch.pos0)
    name_len = 11  # "r%09d" + NUL
    packed = (L + 1) // 2
    nib = _NIBBLE_LUT[ch.reads]
    if L % 2:
        nib = np.concatenate([nib, np.zeros((n, 1), np.uint8)], axis=1)
    seq_packed = (nib[:, 0::2] << 4) | nib[:, 1::2]
    del nib
    qual = qualities(sample, ch)
    idx = np.arange(name_base, name_base + n, dtype=np.int64)
    names = np.empty((n, name_len), np.uint8)
    names[:, 0] = ord("r")
    names[:, 1:10] = 48 + (idx[:, None] // 10 ** np.arange(8, -1, -1)) % 10
    names[:, 10] = 0
    flags = np.where(ch.rev, 16, 0).astype(np.uint16)
    end0 = ch.pos0 + spans[ch.cls]
    bins = _bins(ch.pos0, end0)
    n_ops = np.array([len(c) for c in cigars])
    sizes = 36 + name_len + 4 * n_ops[ch.cls] + packed + L
    # every record in a row of the widest size, then the rows cut to their
    # sizes and joined in read order by one boolean gather
    width = int(sizes.max())
    rows_all = np.zeros((n, width), np.uint8)
    for nc in np.unique(n_ops):
        rec_size = 36 + name_len + 4 * nc + packed + L
        dt = np.dtype({
            "names": ["block_size", "ref_id", "pos", "l_name", "mapq", "bin",
                      "n_cigar", "flag", "l_seq", "next_ref", "next_pos",
                      "tlen", "name", "cigar", "seq", "qual"],
            "formats": ["<i4", "<i4", "<i4", "u1", "u1", "<u2", "<u2", "<u2",
                        "<i4", "<i4", "<i4", "<i4", f"({name_len},)u1",
                        f"({nc},)<u4", f"({packed},)u1", f"({L},)u1"],
            "offsets": [0, 4, 8, 12, 13, 14, 16, 18, 20, 24, 28, 32, 36,
                        36 + name_len, 36 + name_len + 4 * nc,
                        36 + name_len + 4 * nc + packed],
            "itemsize": rec_size})
        sel = np.flatnonzero(n_ops[ch.cls] == nc)
        if sel.size == 0:
            continue
        recs = np.zeros(sel.size, dt)
        recs["block_size"] = rec_size - 4
        recs["ref_id"] = ref_id
        recs["pos"] = ch.pos0[sel]
        recs["l_name"] = name_len
        recs["mapq"] = 60
        recs["bin"] = bins[sel].astype(np.uint16)
        recs["n_cigar"] = nc
        recs["flag"] = flags[sel]
        recs["l_seq"] = L
        recs["next_ref"] = -1
        recs["next_pos"] = -1
        recs["name"] = names[sel]
        for c, cig in enumerate(cigars):
            if len(cig) == nc:
                recs["cigar"][ch.cls[sel] == c] = np.array(
                    [(ln << 4) | op for op, ln in cig], np.uint32)
        recs["seq"] = seq_packed[sel]
        recs["qual"] = qual[sel]
        rows_all[sel, :rec_size] = recs.view(np.uint8).reshape(sel.size,
                                                               rec_size)
    raw = rows_all[np.arange(width)[None, :] < sizes[:, None]]
    return raw, sizes


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


def write_sample(out_dir: str, sample: Sample, threads: int = 8) -> dict:
    """Write genome/, sample.bam, sample.bam.bai and intervals.picard
    (each chromosome's whole span) under out_dir; returns their paths."""
    os.makedirs(out_dir, exist_ok=True)
    gdir = os.path.join(out_dir, "genome")
    _write_genome(gdir, sample.chroms)
    header = _header_bytes(sample.chroms)
    # records in blocks of reads on a thread pool (numpy's copies and
    # gathers release the GIL), joined in order
    jobs, base = [], 0
    for ref_id, ch in enumerate(sample.chroms):
        n = len(ch.pos0)
        jobs += [(ref_id, ch, base, i0, min(i0 + RECORD_BLOCK, n))
                 for i0 in range(0, n, RECORD_BLOCK)]
        base += n
    with ThreadPoolExecutor(max_workers=threads) as ex:
        blocks = list(ex.map(lambda j: _records(sample, j[1], j[0], j[2],
                                                j[3], j[4]), jobs))
    parts, per_ref = [header], []
    at = len(header)
    _l, _d, spans, _c = class_layout(sample.read_len)
    for ref_id, ch in enumerate(sample.chroms):
        sizes = [b[1] for j, b in zip(jobs, blocks) if j[0] == ref_id]
        sizes = np.concatenate(sizes) if sizes else np.zeros(0, np.int64)
        ustart = at + np.concatenate([[0], np.cumsum(sizes)])
        end0 = ch.pos0 + spans[ch.cls]
        per_ref.append((ustart, _bins(ch.pos0, end0), ch.pos0, end0,
                        len(ch.seq)))
        at = int(ustart[-1])
    parts += [b[0].tobytes() for b in blocks]
    del blocks
    data, block_off = bgzf_compress(b"".join(parts), threads)
    del parts
    bam = os.path.join(out_dir, "sample.bam")
    with open(bam, "wb") as f:
        f.write(data)
    index = [b"BAI\x01", struct.pack("<i", len(sample.chroms))]
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
        for ch in sample.chroms:
            f.write(f"@SQ\tSN:{ch.name}\tLN:{len(ch.seq)}\n")
        for ch in sample.chroms:
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


def generate_inputs(config: dict, traffic: dict, seed: int,
                    out_dir: str) -> dict:
    """Write the cell's sample and its warm-up sample under out_dir (run in
    a child process, so that the arrays are not the measured process's
    memory); returns their paths and read counts. A traffic whose
    `warmup` is "sample" warms up on the sample itself."""
    threads = min(8, os.cpu_count() or 1)
    sample = make_sample(sample_spec(config, traffic), seed)
    paths = write_sample(os.path.join(out_dir, "sample"), sample, threads)
    paths["n_reads"] = sample.n_reads
    del sample
    if traffic["warmup"] == "sample":
        return {"sample": paths, "warmup": paths}
    warm = make_sample(sample_spec(config, traffic, traffic["warmup"]),
                       seed + 1)
    wpaths = write_sample(os.path.join(out_dir, "warmup"), warm, threads)
    wpaths["n_reads"] = warm.n_reads
    return {"sample": paths, "warmup": wpaths}
