"""Synthetic BAM + genome workloads, made from a numpy seed.

write_synthetic_workload and generate_wgs_workload are the reference
package's bench workloads (bench._write_synthetic_workload, a panel-like
messy BAM, and bench.generate_wgs_workload, a WGS-scale indexed one) on the
port's own BAM writer and BGZF deflater, so that chip_smoke.py and the tests
need nothing of the reference package to make their inputs: the same
arguments and seed give the same bytes.

The tagged workloads feed the caller options that read BAM tags, each in
the format its reader module parses:
  - write_stitched_workload: stitched read pairs with XD per-base direction
    strings (pileup/directions.py: runs of <n>F, <n>S, <n>R over the
    CIGAR-expanded read) under a Stitcher @PG header line;
  - write_amplicon_workload: an amplicon panel whose reads carry their
    amplicon's name in XN (pileup/amplicons.py);
  - write_collapsed_workload: UMI read-collapsed reads with integer XV/XW
    counts (duplex when both are non-zero) and an optional XR pair
    direction (pileup/collapsed.py) under a collapsing @PG header line.
"""
from __future__ import annotations

import os
import shutil

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
# @PG lines that io/bam.BamHeader reads as the source marks
STITCHED_PG = "@PG\tID:Stitcher\tPN:Stitcher\n"
COLLAPSED_PG = "@PG\tID:UMI-Reco\tPN:reco\n"


def _write_genome(gdir: str, seqs: dict, genome_name: str = "b") -> None:
    """FASTA (70-column lines), .fai and GenomeSize.xml of `seqs`
    (name -> uint8 ASCII sequence) into gdir."""
    os.makedirs(gdir)
    gs = []
    for c, seq in seqs.items():
        n = len(seq)
        with open(os.path.join(gdir, f"{c}.fa"), "wb") as f:
            f.write(f">{c}\n".encode())
            for i in range(0, n, 70):
                f.write(seq[i:i + 70].tobytes() + b"\n")
        with open(os.path.join(gdir, f"{c}.fa.fai"), "w") as f:
            f.write(f"{c}\t{n}\t{len(c) + 2}\t70\t71\n")
        gs.append(f'\t<chromosome fileName="{c}.fa" contigName="{c}" '
                  f'totalBases="{n}" isCircular="false" md5="x" '
                  f'ploidy="2" knownBases="{n}" />')
    with open(os.path.join(gdir, "GenomeSize.xml"), "w") as f:
        f.write(f'<sequenceSizes genomeName="{genome_name}">\n'
                + "\n".join(gs) + "\n</sequenceSizes>")


def write_synthetic_workload(tmp: str, n_chroms: int, chrom_len: int,
                              n_reads: int, read_len: int = 100,
                              variant_rate: float = 0.01,
                              seed: int = 0, messy: bool = True,
                              index: bool = False, chrom_names=None):
    """Synthetic multi-chromosome BAM + genome with planted SNVs so both
    the dense gVCF path and the candidate-scoring path do real work.
    index=True also writes the BAM's .bai (the BAM bytes do not change).
    chrom_names names the chromosomes (default chr1..chrN), e.g. to give
    the workload a sex chromosome.

    messy=True (the default)
    additionally makes the read profile reference-realistic instead of
    uniformly clean 100M/Q30: ~1% of reads carry a 2bp CIGAR insertion or
    deletion, ~10% are 8bp-softclipped at one end, and ~20% have a
    low-quality (Q12) 15bp tail. These exercise the indel/softclip
    branches of the CIGAR walk and the quality-filter path at scale
    (reference hot profile: CandidateVariantFinder.cs:90-168,
    AlleleCountHelper.cs:22-80, CoverageCalculator.cs:162-331)."""
    from pisces_tpu_torch.io.bam_write import BamRecord, BamWriter, parse_cigar_string

    rng = np.random.default_rng(seed)
    shutil.rmtree(tmp, ignore_errors=True)
    bases = _BASES
    chroms = (list(chrom_names) if chrom_names is not None
              else [f"chr{i + 1}" for i in range(n_chroms)])
    seqs = {c: bases[rng.integers(0, 4, chrom_len)] for c in chroms}
    _write_genome(os.path.join(tmp, "genome"), seqs)

    # prebuilt cigar variants (parse once, reuse per read)
    cig_clean = parse_cigar_string(f"{read_len}M")
    half = read_len // 2
    cig_ins = parse_cigar_string(f"{half - 2}M2I{read_len - half}M")
    cig_del = parse_cigar_string(f"{half - 1}M2D{read_len - half + 1}M")
    cig_sc_l = parse_cigar_string(f"8S{read_len - 8}M")
    cig_sc_r = parse_cigar_string(f"{read_len - 8}M8S")
    q30 = [30] * read_len
    q_dip = [30] * (read_len - 15) + [12] * 15

    w = BamWriter(os.path.join(tmp, "b.bam"), chroms, [chrom_len] * n_chroms)
    per_chrom = n_reads // n_chroms
    var_sites = {c: rng.integers(1, chrom_len - read_len,
                                 max(8, int(chrom_len * variant_rate / 10)))
                 for c in chroms}
    for ci, c in enumerate(chroms):
        seq = seqs[c]
        positions = np.sort(rng.integers(1, chrom_len - read_len - 4,
                                         per_chrom))
        sites = np.sort(var_sites[c])
        cls = rng.random(per_chrom) if messy else np.ones(per_chrom)
        dip = rng.random(per_chrom) < 0.2 if messy else np.zeros(per_chrom,
                                                                 bool)
        for i in range(per_chrom):
            p = int(positions[i])
            cigar = cig_clean
            r = cls[i]
            if r < 0.005:        # 2bp insertion mid-read
                rseq = bytearray(seq[p - 1:p - 1 + half - 2].tobytes())
                rseq += bytes(bases[rng.integers(0, 4, 2)])
                rseq += seq[p - 1 + half - 2:p - 1 + read_len - 2].tobytes()
                cigar = cig_ins
            elif r < 0.01:       # 2bp deletion mid-read
                rseq = bytearray(seq[p - 1:p - 1 + half - 1].tobytes())
                rseq += seq[p + half:p + read_len + 1].tobytes()
                cigar = cig_del
            elif r < 0.06:       # leading 8bp softclip (random bases)
                rseq = bytearray(bytes(bases[rng.integers(0, 4, 8)]))
                rseq += seq[p - 1:p - 1 + read_len - 8].tobytes()
                cigar = cig_sc_l
            elif r < 0.11:       # trailing 8bp softclip
                rseq = bytearray(seq[p - 1:p - 1 + read_len - 8].tobytes())
                rseq += bytes(bases[rng.integers(0, 4, 8)])
                cigar = cig_sc_r
            else:
                rseq = bytearray(seq[p - 1:p - 1 + read_len].tobytes())
                # plant a SNV on ~40% of clean reads covering a variant site
                j = np.searchsorted(sites, p)
                if j < len(sites) and sites[j] < p + read_len and i % 5 < 2:
                    off = int(sites[j]) - p
                    rseq[off] = b"ACGT"[(seq[sites[j] - 1] + 1) % 4]
            w.records.append(BamRecord(
                f"r{ci}_{i}", ci, p - 1, 60, 0x10 if i & 1 else 0,
                cigar, rseq.decode(), q_dip if dip[i] else q30))
    w.write(index=index)
    return os.path.join(tmp, "b.bam"), os.path.join(tmp, "genome")


def generate_wgs_workload(tmp: str, n_reads: int = 10_000_000,
                          chrom_len: int = 33_000_000, read_len: int = 100,
                          base_error_rate: float = 0.001,
                          n_var_sites: int = 3000, seed: int = 0,
                          messy: bool = True):
    """WGS-scale single-chromosome indexed workload (~30x depth at the
    defaults), generated fully vectorized: records are assembled as
    structured-dtype arrays (one per CIGAR shape class), BGZF-compressed by
    the native thread pool (io/native.bgzf_compress_parallel), and the .bai
    is built from vectorized bins and virtual offsets. A per-record Python
    encode loop would take minutes at 10M reads. Returns (bam, genome dir).

    messy=True gives the reads a reference-realistic profile instead of
    uniformly clean 100M/Q30: ~1% carry a 2bp CIGAR insertion/deletion,
    ~10% are 8bp-softclipped at one end, and ~20% have a Q12 15bp tail,
    exercising the indel/softclip branches of the CIGAR walk and quality
    filtering at scale (reference profile: CandidateVariantFinder.cs:90-168,
    CoverageCalculator.cs:162-331). Records of different CIGAR lengths have
    different byte sizes, so the classes are assembled separately and
    merged byte-wise in position order."""
    from pisces_tpu_torch.io.bai import (
        LINEAR_SHIFT, BamIndex, RefIndex, write_bai,
    )
    from pisces_tpu_torch.io.bam_write import _NIBBLE_LUT, BamWriter
    from pisces_tpu_torch.io.native import bgzf_compress_parallel

    rng = np.random.default_rng(seed)
    shutil.rmtree(tmp, ignore_errors=True)
    gdir = os.path.join(tmp, "genome")
    os.makedirs(gdir)
    chrom = "chrW"
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    seq = bases[rng.integers(0, 4, chrom_len)]
    # FASTA in 70-col lines, vectorized
    pad = (-chrom_len) % 70
    grid = np.concatenate([seq, np.zeros(pad, np.uint8)]).reshape(-1, 70)
    lines = np.concatenate(
        [grid, np.full((grid.shape[0], 1), ord("\n"), np.uint8)], axis=1)
    body = lines.tobytes()[:chrom_len + chrom_len // 70
                           + (1 if chrom_len % 70 else 0)]
    with open(os.path.join(gdir, f"{chrom}.fa"), "wb") as f:
        f.write(f">{chrom}\n".encode())
        f.write(body if body.endswith(b"\n") else body + b"\n")
    with open(os.path.join(gdir, f"{chrom}.fa.fai"), "w") as f:
        f.write(f"{chrom}\t{chrom_len}\t{len(chrom) + 2}\t70\t71\n")
    with open(os.path.join(gdir, "GenomeSize.xml"), "w") as f:
        f.write('<sequenceSizes genomeName="wgs">\n'
                f'\t<chromosome fileName="{chrom}.fa" contigName="{chrom}" '
                f'totalBases="{chrom_len}" isCircular="false" md5="x" '
                f'ploidy="2" knownBases="{chrom_len}" />\n</sequenceSizes>')

    pos0 = np.sort(rng.integers(0, chrom_len - read_len - 3, n_reads)
                   ).astype(np.int64)
    # CIGAR-shape class per read: 0=clean 100M, 1=8S92M, 2=92M8S,
    # 3=48M2I50M, 4=49M2D51M (messy=False -> all clean)
    if messy:
        u = rng.random(n_reads)
        cls = np.select([u < 0.89, u < 0.94, u < 0.99, u < 0.995],
                        [0, 1, 2, 3], default=4).astype(np.int8)
    else:
        cls = np.zeros(n_reads, np.int8)
    half = read_len // 2
    # per-class: cigar ops, reference span
    cig_ops = [np.array([(read_len << 4) | 0], np.uint32),
               np.array([(8 << 4) | 4, ((read_len - 8) << 4) | 0],
                        np.uint32),
               np.array([((read_len - 8) << 4) | 0, (8 << 4) | 4],
                        np.uint32),
               np.array([((half - 2) << 4) | 0, (2 << 4) | 1,
                         ((read_len - half) << 4) | 0], np.uint32),
               np.array([((half - 1) << 4) | 0, (2 << 4) | 2,
                         ((read_len - half + 1) << 4) | 0], np.uint32)]
    spans = np.array([read_len, read_len - 8, read_len - 8,
                      read_len - 2, read_len + 2], np.int64)
    end0 = pos0 + spans[cls]

    # read sequences: class-specific vectorized gathers
    reads = np.empty((n_reads, read_len), np.uint8)
    ar = np.arange(read_len)
    m0 = cls == 0
    reads[m0] = seq[pos0[m0, None] + ar[None, :]]
    if messy:
        m1 = cls == 1  # 8S92M: 8 random then ref
        reads[m1, :8] = bases[rng.integers(0, 4, (int(m1.sum()), 8))]
        reads[np.flatnonzero(m1)[:, None], ar[None, 8:]] = \
            seq[pos0[m1, None] + ar[None, :read_len - 8]]
        m2 = cls == 2  # 92M8S
        reads[np.flatnonzero(m2)[:, None], ar[None, :read_len - 8]] = \
            seq[pos0[m2, None] + ar[None, :read_len - 8]]
        reads[m2, read_len - 8:] = bases[
            rng.integers(0, 4, (int(m2.sum()), 8))]
        m3 = cls == 3  # 48M 2I 50M
        i3 = np.flatnonzero(m3)
        reads[i3[:, None], ar[None, :half - 2]] = \
            seq[pos0[m3, None] + ar[None, :half - 2]]
        reads[m3, half - 2:half] = bases[rng.integers(0, 4,
                                                      (i3.size, 2))]
        reads[i3[:, None], ar[None, half:]] = \
            seq[pos0[m3, None] + (half - 2) + ar[None, :read_len - half]]
        m4 = cls == 4  # 49M 2D 51M
        i4 = np.flatnonzero(m4)
        reads[i4[:, None], ar[None, :half - 1]] = \
            seq[pos0[m4, None] + ar[None, :half - 1]]
        reads[i4[:, None], ar[None, half - 1:]] = \
            seq[pos0[m4, None] + (half + 1) + ar[None, :read_len - half + 1]]
    # Q30-consistent random error floor (sparse)
    n_err = int(rng.binomial(n_reads * read_len, base_error_rate))
    flat = rng.integers(0, n_reads * read_len, n_err)
    er, ec = flat // read_len, flat % read_len
    reads[er, ec] = bases[(np.searchsorted(bases, reads[er, ec]) + 1) % 4]
    # planted SNV sites at ~30% VF on clean reads (~27% realized overall;
    # the candidate path does real work)
    sites = np.sort(rng.choice(
        np.arange(read_len, chrom_len - read_len, 2 * read_len),
        size=n_var_sites, replace=False))
    for s in sites.tolist():
        lo = int(np.searchsorted(pos0, s - read_len + 1))
        hi = int(np.searchsorted(pos0, s, side="right"))
        if hi <= lo:
            continue
        cover = np.arange(lo, hi)
        cover = cover[cls[cover] == 0]
        carriers = cover[rng.random(cover.size) < 0.3]
        alt = bases[(int(np.searchsorted(bases, seq[s])) + 2) % 4]
        reads[carriers, s - pos0[carriers]] = alt

    # structured-record assembly (layout mirrors BamRecord.encode), one
    # array per cigar-op count; merged byte-wise in position order below
    name_len = 10  # "r%08d" + NUL
    packed = (read_len + 1) // 2
    nib = _NIBBLE_LUT[reads]
    seq_packed = (nib[:, 0::2] << 4) | nib[:, 1::2]
    del reads, nib
    # quality: base 30 with a 15bp Q12 tail on ~20% of reads
    dip = (rng.random(n_reads) < 0.2) if messy else np.zeros(n_reads, bool)
    names = np.char.mod(b"r%08d", np.arange(n_reads))
    flags = np.where(np.arange(n_reads) & 1, 16, 0).astype(np.uint16)
    # vectorized reg2bin, ALL levels (a read crossing a 128kb boundary
    # must land in the coarser bin or indexed queries can miss it —
    # io/bai.reg2bin semantics)
    e = end0 - 1
    bins_all = np.select(
        [pos0 >> 14 == e >> 14, pos0 >> 17 == e >> 17,
         pos0 >> 20 == e >> 20, pos0 >> 23 == e >> 23,
         pos0 >> 26 == e >> 26],
        [4681 + (pos0 >> 14), 585 + (pos0 >> 17), 73 + (pos0 >> 20),
         9 + (pos0 >> 23), 1 + (pos0 >> 26)],
        default=0).astype(np.int64)

    def _rec_dtype(n_cigar):
        rec_size = 4 + 32 + name_len + 4 * n_cigar + packed + read_len
        return rec_size, np.dtype({
            "names": ["block_size", "ref_id", "pos", "l_name", "mapq",
                      "bin", "n_cigar", "flag", "l_seq", "next_ref",
                      "next_pos", "tlen", "name", "cigar", "seq", "qual"],
            "formats": ["<i4", "<i4", "<i4", "u1", "u1", "<u2", "<u2",
                        "<u2", "<i4", "<i4", "<i4", "<i4", f"S{name_len}",
                        f"({n_cigar},)<u4", f"({packed},)u1",
                        f"({read_len},)u1"],
            "offsets": [0, 4, 8, 12, 13, 14, 16, 18, 20, 24, 28, 32, 36,
                        36 + name_len, 36 + name_len + 4 * n_cigar,
                        36 + name_len + 4 * n_cigar + packed],
            "itemsize": rec_size})

    n_ops_of_cls = [1, 2, 2, 3, 3]
    sizes_by_ops = {nc: _rec_dtype(nc)[0] for nc in (1, 2, 3)}
    rec_sizes = np.array([sizes_by_ops[n_ops_of_cls[c]]
                          for c in range(5)], np.int64)[cls]
    w = BamWriter(os.path.join(tmp, "wgs.bam"), [chrom], [chrom_len])
    header = w.header_bytes()
    ustart = np.concatenate([[0], np.cumsum(rec_sizes)]) + len(header)
    n_raw = int(ustart[-1])
    raw = np.empty(n_raw, np.uint8)
    raw[:len(header)] = np.frombuffer(header, np.uint8)
    for nc in (1, 2, 3):
        sel = np.flatnonzero(np.isin(cls, [c for c in range(5)
                                           if n_ops_of_cls[c] == nc]))
        if sel.size == 0:
            continue
        rec_size, rec_dt = _rec_dtype(nc)
        recs = np.zeros(sel.size, rec_dt)
        recs["block_size"] = rec_size - 4
        recs["pos"] = pos0[sel]
        recs["l_name"] = name_len
        recs["mapq"] = 60
        recs["bin"] = bins_all[sel].astype(np.uint16)
        recs["n_cigar"] = nc
        recs["flag"] = flags[sel]
        recs["l_seq"] = read_len
        recs["next_ref"] = -1
        recs["next_pos"] = -1
        recs["name"] = names[sel]
        for c in range(5):
            if n_ops_of_cls[c] != nc:
                continue
            in_sel = cls[sel] == c
            recs["cigar"][in_sel] = cig_ops[c][None, :]
        recs["seq"] = seq_packed[sel]
        recs["qual"] = 30
        if dip.any():
            recs["qual"][dip[sel], read_len - 15:] = 12
        rows = recs.view(np.uint8).reshape(sel.size, rec_size)
        # chunked scatter: a full fancy-index matrix at 10M reads would
        # allocate tens of GB of int64 indices
        offs = ustart[sel]
        CH = 500_000
        for i0 in range(0, sel.size, CH):
            i1 = min(i0 + CH, sel.size)
            idx = offs[i0:i1, None] + np.arange(rec_size)[None, :]
            raw[idx] = rows[i0:i1]
        del recs, rows
    del seq_packed
    out, block_off = bgzf_compress_parallel(raw.tobytes())
    del raw
    with open(w.path, "wb") as f:
        f.write(out)
    del out

    # vectorized .bai: chunk runs per bin + linear index
    blk, within = np.divmod(ustart, 0xFF00)
    voff = (block_off[blk].astype(np.int64) << 16) | within
    ref = RefIndex()
    ref.mapped = n_reads
    cut = np.flatnonzero(np.diff(bins_all)) + 1
    seg_starts = np.concatenate([[0], cut])
    seg_ends = np.concatenate([cut, [n_reads]])
    for s, e in zip(seg_starts.tolist(), seg_ends.tolist()):
        ref.bins.setdefault(int(bins_all[s]), []).append(
            (int(voff[s]), int(voff[e])))
    n_win = int((chrom_len - 1) >> LINEAR_SHIFT) + 1
    linear = np.zeros(n_win, np.int64)
    w_beg = (pos0 >> LINEAR_SHIFT).astype(np.int64)
    first = np.searchsorted(w_beg, np.arange(n_win), side="left")
    have = first < n_reads
    linear[have] = voff[np.minimum(first[have], n_reads - 1)]
    # windows whose first covering read starts earlier (spans into them)
    w_end = ((end0 - 1) >> LINEAR_SHIFT).astype(np.int64)
    for i in np.flatnonzero(w_end > w_beg).tolist():
        wE = int(w_end[i])
        if linear[wE] == 0 or voff[i] < linear[wE]:
            linear[wE] = int(voff[i])
    ref.linear = linear.tolist()
    write_bai(BamIndex([ref], 0), w.path + ".bai")
    return w.path, gdir


def _carry_snvs(rseq: bytearray, p: int, sites: np.ndarray, alts: dict):
    """Write the alt base of every site in `sites` inside the read placed
    at 1-based p (reference-only span len(rseq))."""
    lo = int(np.searchsorted(sites, p))
    hi = int(np.searchsorted(sites, p + len(rseq)))
    for s in sites[lo:hi].tolist():
        rseq[s - p] = alts[s]


def _sites(rng, chrom_len: int, margin: int, n: int, seq: np.ndarray):
    """n sorted SNV sites (1-based) at least `margin` from either end, each
    with an alt base (the next base of ACGT after the reference's)."""
    sites = np.sort(rng.choice(np.arange(margin, chrom_len - margin), n,
                               replace=False))
    alts = {int(s): int(_BASES[(int(np.searchsorted(_BASES, seq[s - 1]))
                                + 1) % 4]) for s in sites.tolist()}
    return sites, alts


def write_stitched_workload(tmp: str, chrom_len: int, n_fragments: int,
                            read_len: int = 100, stitched_fraction: float = 0.85,
                            seed: int = 0, index: bool = False):
    """One chromosome of read pairs, most already stitched (the Stitcher's
    output): a stitched read spans its fragment, carries the XD tag
    "<a><D1><o>S<b><D2>" (its first mate's own bases in that mate's
    direction, the o overlapping bases stitched, then the second mate's)
    over its CIGAR-expanded length, and the header holds a Stitcher @PG
    line. The rest stay unstitched proper pairs without XD. Mates overlap
    by 10 to read_len - 10 bases; 1% of stitched reads carry a 2bp
    deletion and 1% a 2bp insertion mid-read; 15% end in a Q12 10bp tail;
    30% of fragments carry the planted SNVs (one per 500 bp) they cover.
    Returns (bam path, genome dir)."""
    from pisces_tpu_torch.io.bam_write import (
        BamRecord, BamWriter, parse_cigar_string,
    )

    rng = np.random.default_rng(seed)
    shutil.rmtree(tmp, ignore_errors=True)
    seq = _BASES[rng.integers(0, 4, chrom_len)]
    _write_genome(os.path.join(tmp, "genome"), {"chr1": seq})
    sites, alts = _sites(rng, chrom_len, 2 * read_len,
                         max(8, chrom_len // 500), seq)
    starts = np.sort(rng.integers(1, chrom_len - 2 * read_len - 4,
                                  n_fragments))
    overlaps = rng.integers(10, read_len - 10, n_fragments)
    kind = rng.random(n_fragments)
    rev_first = rng.random(n_fragments) < 0.5
    carrier = rng.random(n_fragments) < 0.3
    low_tail = rng.random(n_fragments) < 0.15
    noise = bytes(_BASES[rng.integers(0, 4, 2 * n_fragments)])

    def quals(n, tail):
        return [30] * (n - 10) + [12] * 10 if tail else [30] * n

    w = BamWriter(os.path.join(tmp, "b.bam"), ["chr1"], [chrom_len],
                  extra_header_text=STITCHED_PG)
    for i in range(n_fragments):
        p, ov = int(starts[i]), int(overlaps[i])
        frag = 2 * read_len - ov
        d1, d2 = ("R", "F") if rev_first[i] else ("F", "R")
        ref = seq[p - 1:p - 1 + frag + 2].tobytes()
        if kind[i] < stitched_fraction:
            h = frag // 2
            if kind[i] < 0.01:           # 2bp deletion mid-read
                rseq = bytearray(ref[:h] + ref[h + 2:frag + 2])
                cigar, expanded = f"{h}M2D{frag - h}M", frag + 2
            elif kind[i] < 0.02:         # 2bp insertion mid-read
                rseq = bytearray(ref[:h] + noise[2 * i:2 * i + 2]
                                 + ref[h:frag - 2])
                cigar, expanded = f"{h}M2I{frag - h - 2}M", frag
            else:
                rseq = bytearray(ref[:frag])
                if carrier[i]:
                    _carry_snvs(rseq, p, sites, alts)
                cigar, expanded = f"{frag}M", frag
            a = (expanded - ov) // 2
            xd = f"{a}{d1}{ov}S{expanded - ov - a}{d2}"
            w.records.append(BamRecord(
                f"s{i}", 0, p - 1, 60, 0x10 if rev_first[i] else 0,
                parse_cigar_string(cigar), rseq.decode(),
                quals(len(rseq), low_tail[i]), tags={"XD": xd}))
            continue
        p2 = p + frag - read_len
        for mate, (q, first) in enumerate(((p, True), (p2, False))):
            rseq = bytearray(seq[q - 1:q - 1 + read_len].tobytes())
            if carrier[i]:
                _carry_snvs(rseq, q, sites, alts)
            reverse = rev_first[i] == first
            flag = 0x1 | 0x2 | (0x40 if first else 0x80) | \
                (0x10 if reverse else 0) | (0 if reverse else 0x20)
            w.records.append(BamRecord(
                f"u{i}", 0, q - 1, 60, flag,
                parse_cigar_string(f"{read_len}M"), rseq.decode(),
                quals(read_len, low_tail[i] and mate == 1),
                next_ref_id=0, next_pos=(p2 if first else p) - 1))
    w.write(index=index)
    return w.path, os.path.join(tmp, "genome")


def write_amplicon_workload(tmp: str, n_amplicons: int, depth: int = 1000,
                            amplicon_len: int = 150, overlap: int = 50,
                            read_len: int = 100, seed: int = 0,
                            index: bool = False):
    """An amplicon panel on one chromosome: n_amplicons amplicons tiled
    with `overlap` shared bases, each read starting at its amplicon's start
    (forward) or ending at its end (reverse), trimmed by 0-29 bases at its
    3' end, carrying the amplicon's name in XN. Each amplicon gets
    depth * U(0.7, 1.3) reads. Every fourth amplicon holds a real SNV at
    15% in its middle, on the reads of every amplicon that covers it; every
    fourth (offset by two) an artifact SNV in the zone it shares with the
    next amplicon, on 30% of its own reads only, which the amplicon-bias
    filter should flag. 0.2% base errors. Returns (bam path, genome dir)."""
    from pisces_tpu_torch.io.bam_write import (
        BamRecord, BamWriter, parse_cigar_string,
    )

    rng = np.random.default_rng(seed)
    shutil.rmtree(tmp, ignore_errors=True)
    step = amplicon_len - overlap
    pad = 2 * read_len
    chrom_len = 2 * pad + step * (n_amplicons - 1) + amplicon_len
    seq = _BASES[rng.integers(0, 4, chrom_len)]
    _write_genome(os.path.join(tmp, "genome"), {"chr1": seq})

    def alt(s):
        return int(_BASES[(int(np.searchsorted(_BASES, seq[s - 1])) + 1) % 4])

    real = {pad + k * step + amplicon_len // 2 + 1: alt(
        pad + k * step + amplicon_len // 2 + 1)
        for k in range(0, n_amplicons, 4)}
    real_sites = np.array(sorted(real), np.int64)
    artifact = {k: pad + k * step + step + overlap // 2 + 1
                for k in range(2, n_amplicons - 1, 4)}
    w = BamWriter(os.path.join(tmp, "b.bam"), ["chr1"], [chrom_len])
    cigars = {}
    for k in range(n_amplicons):
        a0 = pad + k * step                     # 0-based amplicon start
        n = int(depth * rng.uniform(0.7, 1.3))
        lens = read_len - rng.integers(0, 30, n)
        reverse = rng.random(n) < 0.5
        real_carrier = rng.random(n) < 0.15
        art_carrier = rng.random(n) < 0.3
        for j in range(n):
            ln = int(lens[j])
            q0 = a0 + amplicon_len - ln if reverse[j] else a0
            rseq = bytearray(seq[q0:q0 + ln].tobytes())
            if real_carrier[j]:
                _carry_snvs(rseq, q0 + 1, real_sites, real)
            s = artifact.get(k)
            if s is not None and art_carrier[j] and q0 < s <= q0 + ln:
                rseq[s - 1 - q0] = alt(s)
            for e in np.flatnonzero(rng.random(ln) < 0.002).tolist():
                rseq[e] = b"ACGT"[(b"ACGT".index(rseq[e]) + 1) % 4]
            if ln not in cigars:
                cigars[ln] = parse_cigar_string(f"{ln}M")
            w.records.append(BamRecord(
                f"a{k}_{j}", 0, q0, 60, 0x10 if reverse[j] else 0,
                cigars[ln], rseq.decode(), [30] * ln,
                tags={"XN": f"chr1_amp{k}"}))
    w.write(index=index)
    return w.path, os.path.join(tmp, "genome")


def write_collapsed_workload(tmp: str, chrom_len: int, n_reads: int,
                             read_len: int = 100, seed: int = 0,
                             index: bool = False):
    """UMI read-collapsed proper pairs on one chromosome, under a
    collapsing @PG header line: 90% of reads carry integer XV (1-4) and XW
    (0-2) family counts (duplex when XW > 0), a third of those also an XR
    pair direction ("FR" or "RF"); the rest are plain reads. 20% of reads
    carry the planted SNVs (one per 400 bp) they cover; 20% end in a Q12
    15bp tail. Returns (bam path, genome dir)."""
    from pisces_tpu_torch.io.bam_write import (
        BamRecord, BamWriter, parse_cigar_string,
    )

    rng = np.random.default_rng(seed)
    shutil.rmtree(tmp, ignore_errors=True)
    seq = _BASES[rng.integers(0, 4, chrom_len)]
    _write_genome(os.path.join(tmp, "genome"), {"chr1": seq})
    sites, alts = _sites(rng, chrom_len, 2 * read_len,
                         max(8, chrom_len // 400), seq)
    starts = np.sort(rng.integers(1, chrom_len - 2 * read_len, n_reads))
    collapsed = rng.random(n_reads) < 0.9
    xv = rng.integers(1, 5, n_reads)
    xw = rng.integers(0, 3, n_reads)
    xr = rng.random(n_reads)
    first = rng.random(n_reads) < 0.5
    reverse = rng.random(n_reads) < 0.5
    carrier = rng.random(n_reads) < 0.2
    dip = rng.random(n_reads) < 0.2
    cigar = parse_cigar_string(f"{read_len}M")
    q30 = [30] * read_len
    q_dip = [30] * (read_len - 15) + [12] * 15
    w = BamWriter(os.path.join(tmp, "b.bam"), ["chr1"], [chrom_len],
                  extra_header_text=COLLAPSED_PG)
    for i in range(n_reads):
        p = int(starts[i])
        rseq = bytearray(seq[p - 1:p - 1 + read_len].tobytes())
        if carrier[i]:
            _carry_snvs(rseq, p, sites, alts)
        tags = {}
        if collapsed[i]:
            tags = {"XV": int(xv[i]), "XW": int(xw[i])}
            if xr[i] < 1 / 3:
                tags["XR"] = "FR" if xr[i] < 1 / 6 else "RF"
        flag = 0x1 | 0x2 | (0x40 if first[i] else 0x80) | \
            (0x10 if reverse[i] else 0x20)
        mate = p + 50 if not reverse[i] else max(1, p - 50)
        w.records.append(BamRecord(
            f"c{i}", 0, p - 1, 60, flag, cigar, rseq.decode(),
            q_dip if dip[i] else q30, next_ref_id=0, next_pos=mate - 1,
            tags=tags))
    w.write(index=index)
    return w.path, os.path.join(tmp, "genome")


def write_sites_vcf(path: str, sites) -> str:
    """A minimal VCF of (chrom, pos, ref, alt) rows, the form that
    -ForcedAlleles and -PriorsPath read (io/vcf_read)."""
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.1\n"
                "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for chrom, pos, ref, alt in sites:
            f.write(f"{chrom}\t{pos}\t.\t{ref}\t{alt}\t.\t.\t.\n")
    return path


def forced_and_prior_sites(vcf_body, seq: np.ndarray, chrom: str, n: int,
                           seed: int = 0):
    """Sites for a forced-allele VCF and a priors VCF from a run's VCF body
    (lines without '#') and its chromosome's sequence (uint8 ASCII):
    forced holds n // 2 called SNVs of `chrom` and n - n // 2 reference
    loci away from any call with a non-reference alt, two of them at one
    locus (several lines a locus); priors holds the same called SNVs plus
    n // 4 padded MNVs (the base before, then two changed bases), the form
    -TrimMnvPriors trims. Returns (forced rows, prior rows)."""
    rng = np.random.default_rng(seed)
    called = []
    for ln in vcf_body:
        f = ln.split("\t")
        if (f[0] == chrom and len(f[3]) == 1 and len(f[4]) == 1
                and f[4] != "."):
            called.append((chrom, int(f[1]), f[3], f[4]))
    called = called[:n // 2]
    near = {p + d for _c, p, _r, _a in called for d in range(-5, 6)}
    free = np.array([p for p in range(200, len(seq) - 200)
                     if p not in near], np.int64)
    picks = np.sort(rng.choice(free, n - len(called), replace=False))
    forced = list(called)
    for k, p in enumerate(picks.tolist()):
        ref = chr(seq[p - 1])
        alts = [b for b in "ACGT" if b != ref]
        forced.append((chrom, p, ref, alts[k % 3]))
        if k == 0:
            forced.append((chrom, p, ref, alts[1]))
    priors = list(called)
    for p in picks[:n // 4].tolist():
        ref = seq[p - 2:p + 1].tobytes().decode()
        alt = ref[0] + "".join("ACGT"[("ACGT".index(b) + 1) % 4]
                               for b in ref[1:])
        priors.append((chrom, p - 1, ref, alt))
    return sorted(forced), sorted(priors)
