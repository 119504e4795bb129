"""Synthetic BAM + genome workloads, made from a numpy seed.

write_synthetic_workload and generate_wgs_workload are the reference
package's bench workloads (bench._write_synthetic_workload, a panel-like
messy BAM, and bench.generate_wgs_workload, a WGS-scale indexed one) on the
port's own BAM writer and BGZF deflater, so that chip_smoke.py and the tests
need nothing of the reference package to make their inputs: the same
arguments and seed give the same bytes.
"""
from __future__ import annotations

import os

import numpy as np


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
    import shutil

    from pisces_tpu_torch.io.bam_write import BamRecord, BamWriter, parse_cigar_string

    rng = np.random.default_rng(seed)
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(os.path.join(tmp, "genome"))
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    chroms = (list(chrom_names) if chrom_names is not None
              else [f"chr{i + 1}" for i in range(n_chroms)])
    seqs = {}
    gs = []
    for c in chroms:
        seq = bases[rng.integers(0, 4, chrom_len)]
        seqs[c] = seq
        with open(os.path.join(tmp, "genome", f"{c}.fa"), "wb") as f:
            f.write(f">{c}\n".encode())
            for i in range(0, chrom_len, 70):
                f.write(seq[i:i + 70].tobytes() + b"\n")
        with open(os.path.join(tmp, "genome", f"{c}.fa.fai"), "w") as f:
            f.write(f"{c}\t{chrom_len}\t{len(c) + 2}\t70\t71\n")
        gs.append(f'\t<chromosome fileName="{c}.fa" contigName="{c}" '
                  f'totalBases="{chrom_len}" isCircular="false" md5="x" '
                  f'ploidy="2" knownBases="{chrom_len}" />')
    with open(os.path.join(tmp, "genome", "GenomeSize.xml"), "w") as f:
        f.write('<sequenceSizes genomeName="b">\n' + "\n".join(gs)
                + "\n</sequenceSizes>")

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
    import shutil

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
