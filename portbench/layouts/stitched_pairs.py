"""Paired 2x101 reads of a hybrid-capture panel as a stitcher leaves them:
the read layout of the stitched_panel configuration.

Templates (fragments) of f bases, f log-normal with the `fragment` block's
median and sigma, drawn again until it lies in [min, max]; the traffic's
reads_per_chrom counts templates, so the number of records follows from
the seed. The mates (mate_len bases, FR orientation) read the fragment's
two ends. A fragment whose mates overlap by at least min_overlap bases
(f <= 2 * mate_len - min_overlap) is one stitched read of its f bases
(flag 0); its XD tag gives each expanded CIGAR position the direction of
the mates that read it: forward where mate 1 alone does, stitched where
both do, reverse where mate 2 alone does, {f-M}F{2M-f}S{f-M}R over an
all-match read of mate length M. A deleted base's entries take the
direction of the mates that span the gap. Every other fragment gives two
mates, flags 99 and 147, with each other's position and the template
length, XD "<n>F" and "<n>R" over their expanded CIGAR. The header carries
the stitcher's @PG line.

The messy profile is single_end's, drawn a template at a time: `indel` of
the templates carry a 2 bp insertion or deletion (half each) at a uniform
offset of the fragment, in every read that covers it; `softclip` of them
an 8 bp soft clip at one end of the template (half each end);
`low_q_tail` of the mates end in a tail of tail_len low_q bases at their
3' end (the right end of mate 1, the left end of the reverse mate 2), and
as many stitched reads have one at both ends; `base_error` of all bases
are substitutions. Somatic SNVs at fixed VFs: a template carries a site's
alt with the site's VF, into every read that covers the site.

counts() is the reference's pileup of these arrays, a base a read: every
aligned base once at its XD direction, N under the minimum base quality,
and each deleted base as a deletion at the direction of the base after
the gap when the bases on both sides pass that minimum.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from portbench import gen
from portbench.reference.scoring import BASE_TO_ALLELE, DEL, N

HEADER = ["@PG\tID:Stitcher\tPN:Stitcher\tVN:5.2.0"]
CLIP = 8
INDEL = 2
# an indel lies this far from a fragment's ends, and (in a pair) this far
# from a mate's inner end, so that no read ends in it
INDEL_MARGIN = 12
MATE_MARGIN = 4
# somatic sites: spacing and margin of their grid, over the longest span
SITE_STEP = 600
# records a block of the base-level work
BLOCK = 200_000
# BAM CIGAR ops
OP_M, OP_I, OP_D, OP_S = 0, 1, 2, 4
# kinds of record
STITCHED, MATE1, MATE2 = 0, 1, 2
FLAGS = np.array([0, 99, 147], np.uint16)


@dataclass
class Chrom:
    """One chromosome's reference and records, in coordinate order. A
    record reads bases [a, a + len) of its template's fragment; its CIGAR
    is lc S, m1 M, then (mid 1) 2 I or (mid 2) 2 D with m2 M, then tc S."""

    name: str
    seq: np.ndarray          # uint8 ASCII reference
    pos0: np.ndarray         # int64 [n] 0-based first aligned base
    kind: np.ndarray         # int8 [n] STITCHED, MATE1, MATE2
    template: np.ndarray     # int64 [n] template number (its name)
    frag: np.ndarray         # int64 [n] its template's fragment length
    a: np.ndarray            # int64 [n] first fragment base it reads
    lc: np.ndarray           # int64 [n] leading soft clip
    m1: np.ndarray           # int64 [n]
    mid: np.ndarray          # int8 [n] 0 none, 1 insertion, 2 deletion
    m2: np.ndarray           # int64 [n]
    tc: np.ndarray           # int64 [n] trailing soft clip
    xd_f: np.ndarray         # int64 [n] XD entries forward,
    xd_s: np.ndarray         # stitched
    xd_r: np.ndarray         # and reverse
    mate_pos0: np.ndarray    # int64 [n], -1 on a stitched read
    tlen: np.ndarray         # int64 [n]
    off: np.ndarray          # int64 [n + 1] into reads and qual
    reads: np.ndarray        # uint8 ASCII bases, flat
    qual: np.ndarray         # uint8, flat

    def ref_span(self) -> np.ndarray:
        return self.m1 + np.where(self.mid == 2, INDEL, 0) + self.m2


@dataclass
class Sample:
    mate_len: int
    chroms: List[Chrom]

    @property
    def n_reads(self) -> int:
        return sum(len(c.pos0) for c in self.chroms)


def _fragments(rng, n: int, fr: dict) -> np.ndarray:
    out = np.empty(n, np.int64)
    todo = np.arange(n)
    while todo.size:
        x = np.rint(fr["median"] * np.exp(
            fr["sigma"] * rng.standard_normal(todo.size))).astype(np.int64)
        ok = (x >= fr["min"]) & (x <= fr["max"])
        out[todo[ok]] = x[ok]
        todo = todo[~ok]
    return out


def _indel_offsets(rng, f, paired, M):
    """Fragment offset k of each template's indel: a deletion lies between
    fragment bases k - 1 and k, an insertion is bases k and k + 1."""
    k = np.empty(len(f), np.int64)
    todo = np.arange(len(f))
    while todo.size:
        ft = f[todo]
        x = INDEL_MARGIN + (rng.random(todo.size)
                            * (ft - 2 * INDEL_MARGIN)).astype(np.int64)
        bad = paired[todo] & ((np.abs(x - M) < MATE_MARGIN)
                              | (np.abs(x - (ft - M)) < MATE_MARGIN))
        k[todo[~bad]] = x[~bad]
        todo = todo[bad]
    return k


def make_sample(spec: dict, seed: int) -> Sample:
    """All of a sample from the seed. spec keys: chroms, chrom_len,
    reads_per_chrom (templates a chromosome), mate_len, min_overlap,
    fragment {median, sigma, min, max}, profile {indel, softclip,
    low_q_tail, tail_len, base_error, low_q, high_q}, somatic {vafs,
    sites_per_vaf}."""
    rng = np.random.default_rng(seed)
    M = int(spec["mate_len"])
    prof = spec["profile"]
    clen, n_t = int(spec["chrom_len"]), int(spec["reads_per_chrom"])
    out, first = [], 0
    for name in spec["chroms"]:
        seq = gen.BASES[rng.integers(0, 4, clen)]
        f = _fragments(rng, n_t, spec["fragment"])
        paired = f > 2 * M - int(spec["min_overlap"])
        u = rng.random(n_t)
        c_sc, c_in = prof["softclip"], prof["indel"]
        cls = np.select([u < 1 - c_sc - c_in, u < 1 - c_sc / 2 - c_in,
                         u < 1 - c_in, u < 1 - c_in / 2],
                        [0, 1, 2, 3], default=4).astype(np.int8)
        k = _indel_offsets(rng, f, paired, M)
        cl = np.where(cls == 1, CLIP, 0)
        span = f - cl - np.where(cls == 2, CLIP, 0) \
            + INDEL * ((cls == 4).astype(np.int64) - (cls == 3))
        p0 = rng.integers(0, clen - span + 1)
        clip_bases = gen.BASES[rng.integers(0, 4, (n_t, CLIP))]
        ins_bases = gen.BASES[rng.integers(0, 4, (n_t, INDEL))]

        # records: a stitched read, or two mates, a template
        st = np.flatnonzero(~paired)
        pr = np.flatnonzero(paired)
        t = np.concatenate([st, pr, pr])
        kind = np.repeat(np.array([STITCHED, MATE1, MATE2], np.int8),
                         [st.size, pr.size, pr.size])
        a = np.where(kind == MATE2, f[t] - M, 0)
        b = np.where(kind == MATE1, M, f[t])
        ct, kt, ft = cls[t], k[t], f[t]
        lc = np.where((ct == 1) & (a == 0), CLIP, 0)
        tc = np.where((ct == 2) & (b == ft), CLIP, 0)
        has_ins = (ct == 3) & (kt > a) & (kt + INDEL < b)
        has_del = (ct == 4) & (kt > a) & (kt < b)
        mid = np.where(has_ins, 1, np.where(has_del, 2, 0)).astype(np.int8)
        m1 = np.where(mid > 0, kt - a, b - a - lc - tc)
        m2 = np.where(has_ins, b - kt - INDEL, np.where(has_del, b - kt, 0))
        pos0 = p0[t] + _ref_offset(a + lc, ct, kt, cl[t])
        # XD: the stitched read's entries by the mates that read them; a
        # mate's all its own
        dk = np.where(kt <= ft - M, 0, np.where(kt >= M, 2, 1))
        gap = INDEL * has_del
        n_exp = lc + m1 + np.where(mid > 0, INDEL, 0) + m2 + tc
        st_read = kind == STITCHED
        xd_f = np.where(st_read, ft - M + gap * (dk == 0),
                        np.where(kind == MATE1, n_exp, 0))
        xd_s = np.where(st_read, 2 * M - ft + gap * (dk == 1), 0)
        xd_r = np.where(st_read, ft - M + gap * (dk == 2),
                        np.where(kind == MATE2, n_exp, 0))
        end0 = pos0 + m1 + np.where(mid == 2, INDEL, 0) + m2
        # mate fields: each mate points at the other
        n_st, n_pr = st.size, pr.size
        mate_pos0 = np.full(t.size, -1, np.int64)
        mate_pos0[n_st:n_st + n_pr] = pos0[n_st + n_pr:]
        mate_pos0[n_st + n_pr:] = pos0[n_st:n_st + n_pr]
        tl = end0[n_st + n_pr:] - pos0[n_st:n_st + n_pr]
        tlen = np.zeros(t.size, np.int64)
        tlen[n_st:n_st + n_pr] = tl
        tlen[n_st + n_pr:] = -tl

        order = np.argsort(pos0, kind="stable")
        cols = [t, kind, a, lc, m1, mid, m2, tc, xd_f, xd_s, xd_r, mate_pos0,
                tlen, pos0]
        (t, kind, a, lc, m1, mid, m2, tc, xd_f, xd_s, xd_r, mate_pos0, tlen,
         pos0) = [c[order] for c in cols]
        lens = lc + m1 + np.where(mid == 1, INDEL, 0) + m2 + tc
        off = np.concatenate([[0], np.cumsum(lens)])
        # every column as if aligned from the read's first column on, then
        # the columns after an indel, and the clipped and inserted ones
        reads = np.empty(int(off[-1]), np.uint8)
        for r0 in range(0, t.size, BLOCK):
            r1 = min(r0 + BLOCK, t.size)
            at = np.repeat(pos0[r0:r1] - lc[r0:r1] - off[r0:r1], lens[r0:r1]) \
                + np.arange(off[r0], off[r1])
            reads[off[r0]:off[r1]] = seq[np.clip(at, 0, clen - 1)]
        rows = np.flatnonzero(mid == 2)
        rr, c, at = _columns(off, rows, m1[rows], lens[rows])
        reads[at] = seq[pos0[rr] + c + INDEL]
        rows = np.flatnonzero(mid == 1)
        rr, c, at = _columns(off, rows, m1[rows], m1[rows] + INDEL)
        reads[at] = ins_bases[t[rr], c - m1[rr]]
        rr, c, at = _columns(off, rows, m1[rows] + INDEL, lens[rows])
        reads[at] = seq[pos0[rr] + c - INDEL]
        rows = np.flatnonzero(lc > 0)
        rr, c, at = _columns(off, rows, np.zeros_like(rows), lc[rows])
        reads[at] = clip_bases[t[rr], c]
        rows = np.flatnonzero(tc > 0)
        rr, c, at = _columns(off, rows, lens[rows] - tc[rows], lens[rows])
        reads[at] = clip_bases[t[rr], c - (lens[rr] - tc[rr])]
        ch = Chrom(name, seq, pos0, kind, first + t, f[t], a, lc, m1, mid, m2,
                   tc, xd_f, xd_s, xd_r, mate_pos0, tlen, off, reads,
                   np.full(int(off[-1]), prof["high_q"], np.uint8))
        _plant(rng, ch, spec.get("somatic"), clen)
        err = rng.integers(0, off[-1], int(rng.binomial(off[-1],
                                                        prof["base_error"])))
        reads[err] = gen.BASES[(np.searchsorted(gen.BASES, reads[err]) + 1)
                               % 4]
        _low_q_tails(rng, ch, prof)
        out.append(ch)
        first += n_t
    return Sample(M, out)


def _columns(off, rows, lo, hi):
    """(record, column, flat index) of columns [lo, hi) of each of rows."""
    n = hi - lo
    rr = np.repeat(rows, n)
    c = np.repeat(lo, n) + np.arange(int(n.sum())) - np.repeat(
        np.cumsum(n) - n, n)
    return rr, c, off[rr] + c


def _ref_offset(j, cls, k, cl):
    """Reference offset, from the template's first aligned base, of
    fragment base j (meaningful where j is aligned)."""
    return (j - cl + INDEL * ((cls == 4) & (j >= k))
            - INDEL * ((cls == 3) & (j >= k + INDEL)))


def columns_of(ch: Chrom, rows: np.ndarray, d: np.ndarray) -> np.ndarray:
    """Read column of reference offset d (site - pos0) in each record of
    rows; -1 where the record has no aligned base there."""
    lc, m1, m2, mid = ch.lc[rows], ch.m1[rows], ch.m2[rows], ch.mid[rows]
    col = np.full(len(rows), -1, np.int64)
    first = (d >= 0) & (d < m1)
    col[first] = (lc + d)[first]
    ins = (mid == 1) & (d >= m1) & (d < m1 + m2)
    col[ins] = (lc + d + INDEL)[ins]
    dele = (mid == 2) & (d >= m1 + INDEL) & (d < m1 + INDEL + m2)
    col[dele] = (lc + d - INDEL)[dele]
    return col


def _plant(rng, ch: Chrom, som, clen: int) -> None:
    """Each template that reads a site carries its alt with the site's VF,
    in every one of its reads."""
    if not som:
        return
    grid = np.arange(SITE_STEP, clen - SITE_STEP, SITE_STEP)
    vafs = np.repeat(np.asarray(som["vafs"], np.float64),
                     int(som["sites_per_vaf"]))
    n = min(vafs.size, grid.size)
    sites = np.sort(rng.choice(grid, n, replace=False))
    vafs = vafs[rng.permutation(vafs.size)][:n]
    longest = int(ch.ref_span().max(initial=0))
    for s, vf in zip(sites.tolist(), vafs.tolist()):
        lo = int(np.searchsorted(ch.pos0, s - longest))
        hi = int(np.searchsorted(ch.pos0, s, side="right"))
        rows = np.arange(lo, hi)
        col = columns_of(ch, rows, s - ch.pos0[rows])
        rows, col = rows[col >= 0], col[col >= 0]
        tmpl, inv = np.unique(ch.template[rows], return_inverse=True)
        carry = (rng.random(tmpl.size) < vf)[inv]
        ref = int(np.searchsorted(gen.BASES, ch.seq[s]))
        alt = gen.BASES[(ref + 1 + int(rng.integers(0, 3))) % 4]
        ch.reads[ch.off[rows[carry]] + col[carry]] = alt


def _low_q_tails(rng, ch: Chrom, prof: dict) -> None:
    tail = int(prof["tail_len"])
    dip = rng.random(len(ch.pos0)) < prof["low_q_tail"]
    left = dip & (ch.kind != MATE1)
    right = dip & (ch.kind != MATE2)
    steps = np.arange(tail)
    for rows, start in ((np.flatnonzero(left), ch.off[:-1]),
                        (np.flatnonzero(right), ch.off[1:] - tail)):
        ch.qual[(start[rows][:, None] + steps[None, :]).ravel()] = \
            prof["low_q"]


def _cigars(ch: Chrom):
    n = len(ch.pos0)
    ops = np.empty((n, 5), np.uint32)
    ops[:] = [OP_S, OP_M, OP_I, OP_M, OP_S]
    ops[ch.mid == 2, 2] = OP_D
    lens = np.stack([ch.lc, ch.m1, np.where(ch.mid > 0, INDEL, 0), ch.m2,
                     ch.tc], axis=1).astype(np.uint32)
    keep = lens > 0
    return ((lens << 4) | ops)[keep], np.concatenate(
        [[0], np.cumsum(keep.sum(axis=1))])


def xd_strings(ch: Chrom):
    """(the distinct XD strings, each record's index into them)."""
    key = (ch.xd_f << 40) | (ch.xd_s << 20) | ch.xd_r
    uniq, which = np.unique(key, return_inverse=True)
    values = []
    for kv in uniq.tolist():
        nf, ns, nr = kv >> 40, (kv >> 20) & 0xFFFFF, kv & 0xFFFFF
        values.append("".join(f"{v}{c}" for v, c in
                              ((nf, "F"), (ns, "S"), (nr, "R")) if v))
    return values, which


def _assemble(rec: gen.Records, bins: np.ndarray, ref_id: int, i0: int,
              i1: int):
    """gen._assemble, with one zero nibble after each read of odd length:
    gen's pads with one a read of the block, which a block that mixes odd
    and even lengths (stitched reads of any length among 101 bp mates)
    cannot take."""
    def cut(data, off):
        return data[off[i0]:off[i1]], np.diff(off[i0:i1 + 1])
    name, l_name = cut(rec.names, rec.name_off)
    cigar, n_cigar = cut(rec.cigar, rec.cigar_off)
    seq, l_seq = cut(rec.seq, rec.seq_off)
    qual, _l = cut(rec.qual, rec.seq_off)
    aux, l_aux = cut(rec.aux, rec.aux_off)
    n = i1 - i0
    nib = gen._NIBBLE_LUT[seq]
    odd = l_seq % 2
    if odd.any():
        nib = gen._interleave([(nib, l_seq),
                               (np.zeros(int(odd.sum()), np.uint8), odd)])[0]
    packed = (l_seq + 1) // 2
    fixed = np.zeros(n, gen._FIXED)
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
    raw, off = gen._interleave([
        (fixed.view(np.uint8), np.full(n, gen._FIXED.itemsize)),
        (name, l_name), (cigar.astype("<u4").view(np.uint8), 4 * n_cigar),
        ((nib[0::2] << 4) | nib[1::2], packed), (qual, l_seq),
        (aux, l_aux)])
    return raw, np.diff(off)


def write_sample(out_dir: str, sample: Sample, threads: int = 8) -> dict:
    """Write the sample through gen.write_reads, its records assembled by
    this module's _assemble."""
    records = []
    for ref_id, ch in enumerate(sample.chroms):
        n = len(ch.pos0)
        paired = ch.kind != STITCHED
        names, name_off = gen.serial_names(ch.template)
        aux, aux_off = gen.z_tags("XD", *xd_strings(ch))
        cigar, cigar_off = _cigars(ch)
        records.append(gen.Records(
            pos0=ch.pos0, flag=FLAGS[ch.kind], mapq=np.full(n, 60, np.uint8),
            next_ref=np.where(paired, ref_id, -1).astype(np.int32),
            next_pos=ch.mate_pos0.astype(np.int32),
            tlen=ch.tlen.astype(np.int32), names=names, name_off=name_off,
            cigar=cigar, cigar_off=cigar_off, seq=ch.reads, qual=ch.qual,
            seq_off=ch.off, aux=aux, aux_off=aux_off))
    real, gen._assemble = gen._assemble, _assemble
    try:
        return gen.write_reads(out_dir, sample.chroms, records, threads,
                               header_lines=HEADER)
    finally:
        gen._assemble = real


def base_directions(sample: Sample, ch: Chrom, rows: np.ndarray,
                    cols: np.ndarray) -> np.ndarray:
    """Direction (0 forward, 1 reverse, 2 stitched) of read column cols of
    records rows: a mate's own; a stitched read's by the fragment base it
    reads, forward before mate 2's first, reverse after mate 1's last."""
    M = sample.mate_len
    j = ch.a[rows] + cols
    by_frag = np.where(j < ch.frag[rows] - M, 0, np.where(j >= M, 1, 2))
    return np.where(ch.kind[rows] == STITCHED, by_frag,
                    np.where(ch.kind[rows] == MATE1, 0, 1))


def counts(sample: Sample, ch: Chrom, min_base_quality: int) -> np.ndarray:
    """int64 [len(seq) + 1, 6, 3] pileup: forward, reverse, stitched."""
    n_pos = len(ch.seq) + 1
    flat = np.zeros(n_pos * 18, np.int64)
    lens = np.diff(ch.off)
    for r0 in range(0, len(ch.pos0), BLOCK):
        r1 = min(r0 + BLOCK, len(ch.pos0))
        rr = np.repeat(np.arange(r0, r1), lens[r0:r1])
        c = np.arange(ch.off[r0], ch.off[r1]) - ch.off[rr]
        # reference offset of each column, -1 where clipped or inserted
        lc, m1, mid = ch.lc[rr], ch.m1[rr], ch.mid[rr]
        m2 = ch.m2[rr]
        d = c - lc
        refoff = np.where((d >= 0) & (d < m1), d, -1)
        refoff = np.where((mid == 1) & (d >= m1 + INDEL)
                          & (d < m1 + INDEL + m2), d - INDEL, refoff)
        refoff = np.where((mid == 2) & (d >= m1) & (d < m1 + m2),
                          d + INDEL, refoff)
        direction = base_directions(sample, ch, rr, c)
        q = ch.qual[ch.off[r0]:ch.off[r1]]
        allele = BASE_TO_ALLELE[ch.reads[ch.off[r0]:ch.off[r1]]].astype(
            np.int64)
        allele[q < min_base_quality] = N
        on = refoff >= 0
        pos1 = ch.pos0[rr] + 1 + refoff
        key = (pos1 * 6 + allele) * 3 + direction
        flat += np.bincount(key[on], minlength=flat.size)
        # deletions: the gap's bases at the direction of the base after it,
        # when it and the base before it pass the minimum
        dl = np.flatnonzero(ch.mid[r0:r1] == 2) + r0
        after = ch.off[dl] + ch.lc[dl] + ch.m1[dl]
        ok = (ch.qual[after] >= min_base_quality) \
            & (ch.qual[after - 1] >= min_base_quality)
        dl, after = dl[ok], after[ok]
        ddir = base_directions(sample, ch, dl, after - ch.off[dl])
        for g in range(INDEL):
            dpos = ch.pos0[dl] + 1 + ch.m1[dl] + g
            flat += np.bincount((dpos * 6 + DEL) * 3 + ddir,
                                minlength=flat.size)
    return flat.reshape(n_pos, 6, 3)
