"""Paired-end reads as a stitcher leaves them, the read layout that the
benchmark's own tests add by files alone.

Templates of 100 bp mates in FR orientation. A template whose mates
overlap by 50 bases is one stitched read of 150 bp (flag 0, XD
50F50S50R: forward, stitched, reverse bases); the others are two mates of
a 300 bp fragment (flags 99 and 147, each with its mate's position and
the template length, XD 100F and 100R). Every read is all match, named
by its template and tagged; the header carries the stitcher's @PG line,
by which the program reads the XD directions. Somatic SNVs at fixed VFs,
base errors and low-quality tails as in the single-end layout.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from portbench import gen
from portbench.reference.scoring import BASE_TO_ALLELE, N

MATE = 100
OVERLAP = 50
FRAGMENT = 300
STITCHED = 2 * MATE - OVERLAP
XD = ["50F50S50R", "100F", "100R"]
HEADER = ["@PG\tID:Stitcher\tPN:Stitcher\tVN:5.2.0"]
# per-base direction codes (0 forward, 1 reverse, 2 stitched) of each XD
_DIRS = [np.repeat([0, 2, 1], [MATE - OVERLAP, OVERLAP, MATE - OVERLAP]),
         np.zeros(MATE, np.int64), np.ones(MATE, np.int64)]


@dataclass
class Chrom:
    name: str
    seq: np.ndarray          # uint8 ASCII reference
    pos0: np.ndarray         # int64 [n] 0-based leftmost base
    kind: np.ndarray         # int64 [n] index into XD
    template: np.ndarray     # int64 [n]
    mate_pos0: np.ndarray    # int64 [n], -1 on a stitched read
    off: np.ndarray          # int64 [n + 1] into reads and qual
    reads: np.ndarray        # uint8 ASCII bases, flat
    qual: np.ndarray         # uint8, flat


@dataclass
class Sample:
    chroms: List[Chrom]

    @property
    def n_reads(self) -> int:
        return sum(len(c.pos0) for c in self.chroms)


def make_sample(spec: dict, seed: int) -> Sample:
    """reads_per_chrom records a chromosome, stitched_share of them
    stitched reads; profile {base_error, low_q_tail, tail_len, low_q,
    high_q}, somatic {vafs, sites_per_vaf}."""
    rng = np.random.default_rng(seed)
    prof = spec["profile"]
    clen, n = int(spec["chrom_len"]), int(spec["reads_per_chrom"])
    out, first = [], 0
    for name in spec["chroms"]:
        seq = gen.BASES[rng.integers(0, 4, clen)]
        n_pairs = int(round(n * (1 - spec["stitched_share"]) / 2))
        n_st = n - 2 * n_pairs
        f0 = rng.integers(0, clen - FRAGMENT, n_st + n_pairs)
        pos0 = np.concatenate([f0[:n_st], f0[n_st:],
                               f0[n_st:] + FRAGMENT - MATE])
        kind = np.repeat([0, 1, 2], [n_st, n_pairs, n_pairs])
        template = first + np.concatenate([np.arange(n_st + n_pairs),
                                           np.arange(n_st, n_st + n_pairs)])
        mate = np.concatenate([np.full(n_st, -1), pos0[n_st + n_pairs:],
                               f0[n_st:]])
        order = np.argsort(pos0, kind="stable")
        pos0, kind, template, mate = (pos0[order], kind[order],
                                      template[order], mate[order])
        lens = np.where(kind == 0, STITCHED, MATE)
        off = np.concatenate([[0], np.cumsum(lens)])
        ref_at = np.repeat(pos0 - off[:-1], lens) + np.arange(off[-1])
        reads = seq[ref_at]
        som = spec["somatic"]
        grid = np.arange(FRAGMENT, clen - FRAGMENT, 2 * FRAGMENT)
        vafs = np.repeat(np.asarray(som["vafs"], np.float64),
                         int(som["sites_per_vaf"]))
        k = min(vafs.size, grid.size)
        for s, vf in zip(np.sort(rng.choice(grid, k, replace=False)).tolist(),
                         vafs[rng.permutation(vafs.size)][:k].tolist()):
            idx = np.flatnonzero((pos0 <= s) & (pos0 + lens > s))
            carry = idx[rng.random(idx.size) < vf]
            ref = int(np.searchsorted(gen.BASES, seq[s]))
            reads[off[carry] + s - pos0[carry]] = \
                gen.BASES[(ref + 1 + int(rng.integers(0, 3))) % 4]
        err = rng.integers(0, off[-1], int(rng.binomial(off[-1],
                                                        prof["base_error"])))
        reads[err] = gen.BASES[(np.searchsorted(gen.BASES, reads[err]) + 1)
                               % 4]
        qual = np.full(off[-1], prof["high_q"], np.uint8)
        dip = np.flatnonzero(rng.random(n) < prof["low_q_tail"])
        tail = np.repeat(off[dip + 1] - prof["tail_len"], prof["tail_len"]) \
            + np.tile(np.arange(prof["tail_len"]), dip.size)
        qual[tail] = prof["low_q"]
        out.append(Chrom(name, seq, pos0, kind, template, mate, off, reads,
                         qual))
        first += n_st + n_pairs
    return Sample(out)


def write_sample(out_dir: str, sample: Sample, threads: int = 8) -> dict:
    records = []
    for ref_id, ch in enumerate(sample.chroms):
        n = len(ch.pos0)
        paired = ch.kind > 0
        lens = np.diff(ch.off)
        names, name_off = gen.serial_names(ch.template)
        aux, aux_off = gen.z_tags("XD", XD, ch.kind)
        records.append(gen.Records(
            pos0=ch.pos0,
            flag=np.array([0, 99, 147], np.uint16)[ch.kind],
            mapq=np.full(n, 60, np.uint8),
            next_ref=np.where(paired, ref_id, -1).astype(np.int32),
            next_pos=ch.mate_pos0.astype(np.int32),
            tlen=np.array([0, FRAGMENT, -FRAGMENT], np.int32)[ch.kind],
            names=names, name_off=name_off,
            cigar=(lens << 4).astype(np.uint32),
            cigar_off=np.arange(n + 1, dtype=np.int64),
            seq=ch.reads, qual=ch.qual, seq_off=ch.off,
            aux=aux, aux_off=aux_off))
    return gen.write_reads(out_dir, sample.chroms, records, threads,
                           header_lines=HEADER)


def counts(sample: Sample, ch: Chrom, min_base_quality: int) -> np.ndarray:
    """int64 [len(seq) + 1, 6, 3]: each base once, at its XD direction, as
    N under the minimum base quality."""
    lens = np.diff(ch.off)
    pos1 = np.repeat(ch.pos0 + 1 - ch.off[:-1], lens) + np.arange(ch.off[-1])
    allele = BASE_TO_ALLELE[ch.reads].astype(np.int64)
    allele[ch.qual < min_base_quality] = N
    direction = np.concatenate([_DIRS[k] for k in range(3)])[
        np.repeat(np.array([0, STITCHED, STITCHED + MATE])[ch.kind]
                  - ch.off[:-1], lens) + np.arange(ch.off[-1])]
    key = (pos1 * 6 + allele) * 3 + direction
    return np.bincount(key, minlength=(len(ch.seq) + 1) * 18).reshape(
        len(ch.seq) + 1, 6, 3)
