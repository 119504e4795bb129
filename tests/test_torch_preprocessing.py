"""Gemini in the port against the reference package (ROADMAP Queue 1
item 9): the read-pair stitcher, the alignment summary and the realigner
core, the indel evidence chain, the pair classifier, the bin signal, the
pair filter, and run_gemini end to end, whole, streamed (-RegionSize) and
over worker processes (run_gemini_multi).

Each case runs the same seeded inputs through the port and through
`pisces_tpu`, whose stitcher and realigner take its own native library as
they do by default. Results must be equal field by field: stitched reads
(position, CIGAR, bases, qualities, XD and counts, or the None result, or
the error raised), realignments, per-pair classes, and Gemini's BAM,
.bai and .indels.csv byte for byte. The port's native code is also held
against its own Python twin (USE_NATIVE, USE_NATIVE_SUMMARY and
USE_NATIVE_REALIGN set to False), which no failure ever reaches.
"""
import dataclasses
import filecmp
import os
import subprocess
import sys

import numpy as np
import pytest

import conftest  # noqa: F401  (keeps JAX on the CPU)

from pisces_tpu_torch import synthetic
from pisces_tpu_torch.io import native as torch_native
from pisces_tpu_torch.io.bam import BamReader
from pisces_tpu_torch.preprocessing import gemini as tg
from pisces_tpu_torch.preprocessing import realigner as tr
from pisces_tpu_torch.preprocessing import stitcher as ts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# counters the port adds to Gemini's stats: which path stitched each pair
PATH_KEYS = ("stitch_batched_pairs", "stitched_batched",
             "stitch_per_pair_pairs", "stitched_per_pair")


@pytest.fixture(scope="module")
def paired(tmp_path_factory):
    """Two 30 kb chromosomes of unstitched pairs with recurrent indels
    (3,000 fragments each, 12,000 reads), indexed."""
    tmp = str(tmp_path_factory.mktemp("paired"))
    bam, genome = synthetic.write_paired_workload(
        os.path.join(tmp, "w"), 30_000, 3_000, chrom_names=("chr1", "chr2"),
        indel_fraction=0.03, seed=3, index=True)
    return tmp, bam, genome


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The realign corpus at its full size (8,000 reads over 15 kb)."""
    tmp = str(tmp_path_factory.mktemp("corpus"))
    bam, genome = synthetic.write_realign_corpus(os.path.join(tmp, "w"))
    return tmp, bam, genome


# ---------------------------------------------------------------------------
# stitcher
# ---------------------------------------------------------------------------

_KINDS = ("plain", "ins", "del", "clip_start", "clip_end", "clip_both",
          "disagree", "homopolymer", "dinucleotide", "fuzz")


def _stitch_cases(n, seed):
    """n seeded read pairs: every overlap from a gap to full, 2 bp
    insertions and deletions, soft clips at either or both ends,
    disagreeing bases, homopolymer and dinucleotide bridges, and random
    CIGARs over random bases. Each case is the positional arguments of
    stitch_reads."""
    rng = np.random.default_rng(seed)
    acgt = np.array(list("ACGT"))
    cases = []
    for k in range(n):
        kind = _KINDS[k % len(_KINDS)]
        ref = "".join(acgt[rng.integers(0, 4, 400)])
        if kind == "homopolymer":
            ref = ref[:150] + "A" * 120 + ref[270:]
        elif kind == "dinucleotide":
            ref = ref[:150] + "CA" * 60 + ref[270:]
        l1, l2 = (int(x) for x in rng.integers(30, 101, 2))
        p1 = int(rng.integers(60, 120))
        overlap = int(rng.integers(-10, l1 + 1))
        p2 = p1 + l1 - overlap
        if kind == "fuzz":
            c1, c2 = _fuzz_cigar(rng, l1), _fuzz_cigar(rng, l2)
            s1 = "".join(acgt[rng.integers(0, 4, l1)])
            s2 = "".join(acgt[rng.integers(0, 4, l2)])
        else:
            hap = ref
            if kind in ("ins", "del"):
                at = int(rng.integers(p1 + 5, p1 + l1 + 5))
                hap = (ref[:at] + "".join(acgt[rng.integers(0, 4, 2)])
                       + ref[at:] if kind == "ins"
                       else ref[:at] + ref[at + 2:])
            s1, c1 = _read_on(hap, ref, kind, at if kind in ("ins", "del")
                              else None, p1, l1)
            s2, c2 = _read_on(hap, ref, kind, at if kind in ("ins", "del")
                              else None, p2, l2)
            if kind.startswith("clip"):
                s1, c1 = _clip(rng, s1, c1, kind)
                s2, c2 = _clip(rng, s2, c2, kind)
            if kind == "disagree":
                s2 = list(s2)
                for i in rng.integers(0, len(s2), 4):
                    s2[int(i)] = acgt[(list("ACGT").index(s2[int(i)]) + 1)
                                      % 4]
                s2 = "".join(s2)
        q1 = [int(q) for q in rng.integers(2, 61, len(s1))]
        q2 = [int(q) for q in rng.integers(2, 61, len(s2))]
        cases.append((p1, c1, s1, q1, p2, c2, s2, q2,
                      bool(rng.random() < 0.5)))
    return cases


def _read_on(hap, ref, kind, at, p, length):
    """Bases and CIGAR of a read of `length` at 1-based reference p on the
    haplotype that holds a 2 bp event at 0-based reference offset `at`."""
    p0 = p - 1
    if at is None or p0 + length <= at:
        return hap[p0:p0 + length], [(0, length)]
    if kind == "del":
        if p0 >= at:
            return ref[p0 + 2:p0 + 2 + length], [(0, length)]
        left = at - p0
        return hap[p0:p0 + length], [(0, left), (2, 2), (0, length - left)]
    if p0 >= at:
        return hap[p0 + 2:p0 + 2 + length], [(0, length)]
    left = at - p0
    ins = min(2, length - left)
    cig = [(0, left), (1, ins)]
    if length - left - ins:
        cig.append((0, length - left - ins))
    return hap[p0:p0 + length], cig


def _clip(rng, seq, cigar, kind):
    """Soft clips of 2-9 random bases at the start, the end or both."""
    acgt = np.array(list("ACGT"))
    seq = list(seq)
    cigar = list(cigar)
    if kind in ("clip_start", "clip_both") and cigar[0][0] == 0 \
            and cigar[0][1] > 12:
        c = int(rng.integers(2, 10))
        seq[:c] = acgt[rng.integers(0, 4, c)]
        cigar = [(4, c), (0, cigar[0][1] - c)] + cigar[1:]
    if kind in ("clip_end", "clip_both") and cigar[-1][0] == 0 \
            and cigar[-1][1] > 12:
        c = int(rng.integers(2, 10))
        seq[len(seq) - c:] = acgt[rng.integers(0, 4, c)]
        cigar = cigar[:-1] + [(0, cigar[-1][1] - c), (4, c)]
    return "".join(seq), cigar


def _fuzz_cigar(rng, read_len):
    """A random CIGAR over M, I, D and S that spans read_len bases."""
    ops, left = [], read_len
    if rng.random() < 0.4:
        c = int(rng.integers(1, max(2, left // 3)))
        ops.append((4, c))
        left -= c
    while left > 0:
        r = rng.random()
        if r < 0.6 or not ops or ops[-1][0] != 0:
            c = int(rng.integers(1, left + 1))
            ops.append((0, c))
            left -= c
        elif r < 0.75:
            ops.append((2, int(rng.integers(1, 4))))
        elif r < 0.9:
            c = int(rng.integers(1, min(3, left) + 1))
            ops.append((1, c))
            left -= c
        else:
            ops.append((4, left))
            left = 0
    return ops


def _stitched(fn, case, **kw):
    """A stitch result as plain fields, or the error's type name."""
    p1, c1, s1, q1, p2, c2, s2, q2, rev = case
    try:
        r = fn(p1, c1, s1, q1, p2, c2, s2, q2, rev, **kw)
    except Exception as e:  # noqa: BLE001  (the error is compared too)
        return ("error", type(e).__name__)
    if r is None:
        return None
    return (r.pos1, tuple(map(tuple, r.cigar)), r.seq, tuple(r.qual), r.xd,
            r.num_agreements, r.num_disagreements, r.num_n_disagreements)


@pytest.mark.parametrize("nify", [False, True])
def test_stitch_reads_matches_reference_and_python_twin(nify, monkeypatch):
    from pisces_tpu.preprocessing.stitcher import stitch_reads as jax_stitch
    cases = _stitch_cases(300, seed=5 + nify)
    kw = dict(nify_disagreements=nify)
    port = [_stitched(ts.stitch_reads, c, **kw) for c in cases]
    ref = [_stitched(jax_stitch, c, **kw) for c in cases]
    monkeypatch.setattr(ts, "USE_NATIVE", False)
    twin = [_stitched(ts.stitch_reads, c, **kw) for c in cases]
    assert port == ref
    assert port == twin
    results = [r for r in port if r is not None and r[0] != "error"]
    # the cases reach every outcome: stitched, refused and merged indels
    assert len(results) > 100 and port.count(None) > 20
    assert any(1 in [op for op, _ in r[1]] for r in results)
    assert any(2 in [op for op, _ in r[1]] for r in results)


def _pair_batch(tmp, cases):
    """The stitch cases as mapped pairs in one BAM (reference sequence of
    random bases), read back by both packages' readers with names."""
    from pisces_tpu.io.bam import BamReader as JReader
    from pisces_tpu_torch.io.bam_write import BamRecord, BamWriter
    w = BamWriter(os.path.join(tmp, "pairs.bam"), ["chrP"], [100_000])
    for k, (p1, c1, s1, q1, p2, c2, s2, q2, rev) in enumerate(cases):
        if sum(ln for op, ln in c1 if op in (0, 1, 4)) != len(s1) or \
                sum(ln for op, ln in c2 if op in (0, 1, 4)) != len(s2):
            continue
        base = 300 * k
        f1 = 0x1 | 0x2 | 0x40 | (0x10 if rev else 0x20)
        f2 = 0x1 | 0x2 | 0x80 | (0x20 if rev else 0x10)
        w.add(BamRecord(f"q{k}", 0, base + p1 - 1, 60, f1, c1, s1, q1,
                        next_ref_id=0, next_pos=base + p2 - 1))
        w.add(BamRecord(f"q{k}", 0, base + p2 - 1, 60, f2, c2, s2, q2,
                        next_ref_id=0, next_pos=base + p1 - 1))
    path = w.write()
    return (BamReader(path).fetch(parse_names=True),
            JReader(path).fetch(parse_names=True))


def _mate_index(batch):
    by = {}
    for i, n in enumerate(batch.names):
        by.setdefault(n, []).append(i)
    i1, i2 = [], []
    for a, b in by.values():
        if batch.pos[b] < batch.pos[a]:
            a, b = b, a
        i1.append(a)
        i2.append(b)
    return np.array(i1, np.int64), np.array(i2, np.int64)


@pytest.mark.parametrize("nify", [False, True])
def test_stitch_pairs_columnar_matches_reference(tmp_path, nify):
    from pisces_tpu.preprocessing.stitcher import (
        stitch_pairs_columnar as jax_columnar,
    )
    batch, jbatch = _pair_batch(str(tmp_path), _stitch_cases(300, seed=9))
    i1, i2 = _mate_index(batch)
    ok, res = ts.stitch_pairs_columnar(batch, i1, i2,
                                       nify_disagreements=nify)
    jok, jres = jax_columnar(jbatch, i1, i2, nify_disagreements=nify)
    assert ok.tolist() == jok.tolist()
    assert set(ok.tolist()) >= {0, 1}

    def fields(r):
        return None if r is None else (r.pos1, r.cigar, r.seq, r.qual,
                                       r.xd, r.num_agreements,
                                       r.num_disagreements,
                                       r.num_n_disagreements)
    assert [fields(r) for r in res] == [fields(r) for r in jres]


def test_no_native_fallback(monkeypatch, tmp_path):
    """A native library that cannot be built raises out of the stitcher,
    the columnar stitcher, the alignment summary and the realigner: none
    of them turns the failure into its Python twin."""
    def broken():
        raise RuntimeError("g++ failed building the native host module")
    case = _stitch_cases(1, seed=1)[0]
    p1, c1, s1, q1, p2, c2, s2, q2, rev = case
    batch, _ = _pair_batch(str(tmp_path), [case])
    monkeypatch.setattr(torch_native, "get_lib", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        ts.stitch_reads(p1, c1, s1, q1, p2, c2, s2, q2, rev)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        ts.stitch_pairs_columnar(batch, *_mate_index(batch))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tr.get_alignment_summary(0, [(0, 10)], "ACGT" * 10, "ACGTACGTAC")
    # only the explicit switches reach the Python twins
    monkeypatch.setattr(ts, "USE_NATIVE", False)
    monkeypatch.setattr(tr, "USE_NATIVE_SUMMARY", False)
    ts.stitch_reads(p1, c1, s1, q1, p2, c2, s2, q2, rev)
    assert tr.get_alignment_summary(0, [(0, 10)], "ACGT" * 10,
                                    "ACGTACGTAC").num_matches == 10


# ---------------------------------------------------------------------------
# alignment summary, realigner core, indel evidence
# ---------------------------------------------------------------------------

def _summary_fields(s):
    if s is None:
        return None
    return (s.num_matches, s.num_mismatches, s.num_mismatches_incl_softclip,
            s.num_indels, s.num_inserted_bases, s.num_deleted_bases,
            s.num_indel_bases, s.num_softclips, s.num_non_n_softclips,
            s.anchor_length)


def test_alignment_summary_matches_reference(monkeypatch):
    from pisces_tpu.preprocessing.realigner import (
        get_alignment_summary as jax_summary,
    )
    rng = np.random.default_rng(17)
    acgt = np.array(list("ACGTN"))
    ref = "".join(acgt[rng.integers(0, 4, 600)])
    cases = []
    for _ in range(400):
        length = int(rng.integers(20, 90))
        cigar = _fuzz_cigar(rng, length)
        start = int(rng.integers(-5, 560))
        seq = list(ref[max(0, start):max(0, start) + length].ljust(length,
                                                                   "A"))
        for i in rng.integers(0, length, int(rng.integers(0, 4))):
            seq[int(i)] = acgt[int(rng.integers(0, 5))]
        cases.append((start, cigar, "".join(seq), bool(rng.random() < 0.5)))
    port = [_summary_fields(tr.get_alignment_summary(s, c, ref, q, chk))
            for s, c, q, chk in cases]
    ref_out = [_summary_fields(jax_summary(s, c, ref, q, chk))
               for s, c, q, chk in cases]
    monkeypatch.setattr(tr, "USE_NATIVE_SUMMARY", False)
    twin = [_summary_fields(tr.get_alignment_summary(s, c, ref, q, chk))
            for s, c, q, chk in cases]
    assert port == ref_out == twin
    assert port.count(None) > 0 and len(port) - port.count(None) > 300


def _indel_pair(rng, ref, pkg_indels):
    """The same seeded indel as one HashableIndel of each package."""
    pos = int(rng.integers(40, len(ref) - 60))
    length = int(rng.integers(1, 7))
    if rng.random() < 0.5:
        ra, aa, is_ins = ref[pos - 1:pos + length], ref[pos - 1], False
    else:
        ra = ref[pos - 1]
        aa = ra + "".join(np.array(list("ACGT"))[rng.integers(0, 4, length)])
        is_ins = True
    is_rep = bool(rng.random() < 0.4)
    fields = dict(
        chromosome="chrF", position=pos, ref_allele=ra, alt_allele=aa,
        is_insertion=is_ins, length=length, score=int(rng.integers(1, 100)),
        in_multi=False, other_indel="", is_repeat=is_rep,
        repeat_unit=("".join(np.array(list("ACGT"))[
            rng.integers(0, 4, int(rng.integers(1, 4)))]) if is_rep else ""),
        is_duplication=bool(rng.random() < 0.2),
        ref_suffix=ref[pos + length:pos + length + 12],
        num_bases_in_ref_suffix_before_unique=int(rng.integers(0, 8)),
        num_approx_dups_left=int(rng.integers(0, 2)),
        num_approx_dups_right=int(rng.integers(0, 2)))
    return tuple(cls(**fields) for cls in pkg_indels)


def _carrier_read(rng, ref, ind):
    """A read over the indel, a carrier 70% of the time, with mismatches,
    N ends and soft clips."""
    acgt = np.array(list("ACGT"))
    rl = int(rng.integers(40, 90))
    start = max(1, ind.position - int(rng.integers(5, rl - 10)))
    seq = list(ref[start - 1:start - 1 + rl])
    cigar = [(0, len(seq))]
    off = ind.position - start
    if rng.random() < 0.7 and 5 <= off < len(seq) - 8:
        if ind.is_insertion:
            ins = list(ind.alt_allele[1:])
            seq = (seq[:off + 1] + ins + seq[off + 1:])[:rl]
            n_ins = min(len(ins), rl - off - 1)
            rest = rl - off - 1 - n_ins
            cigar = [(0, off + 1), (1, n_ins)] + ([(0, rest)] if rest else [])
        else:
            seq = seq[:off + 1] + seq[off + 1 + ind.length:]
            cigar = [(0, off + 1), (2, ind.length),
                     (0, len(seq) - off - 1)]
    for i in rng.integers(0, len(seq), int(rng.integers(0, 4))):
        seq[int(i)] = acgt[int(rng.integers(0, 4))]
    if rng.random() < 0.2:
        seq[:2] = ["N", "N"]
    if rng.random() < 0.4 and cigar[0][0] == 0 and cigar[0][1] > 10:
        c = int(rng.integers(2, 8))
        cigar = [(4, c), (0, cigar[0][1] - c)] + cigar[1:]
        start += c
    quals = [int(q) for q in rng.integers(2, 41, len(seq))]
    return start, cigar, "".join(seq), quals


def _realigned(r):
    if r is None:
        return None
    return (r.position, tuple(map(tuple, r.cigar)), r.num_matches,
            r.num_mismatches, r.num_mismatches_incl_softclip, r.num_indels,
            r.num_inserted_bases, r.num_deleted_bases, r.num_indel_bases,
            r.num_softclips, r.num_non_n_softclips, r.anchor_length,
            r.sum_of_mismatching_qualities, tuple(r.nified_at),
            tuple(r.indels_added_at), r.is_sketchy,
            tuple(r.accepted_indels))


@pytest.mark.parametrize("config", [
    {}, {"mask_partial_insertion": True,
         "minimum_unanchored_insertion_length": 3},
    {"keep_probe_softclips": True}, {"remask_softclips": False}],
    ids=["default", "mask_partial", "keep_probe", "no_remask"])
def test_realigner_matches_reference_and_python_twin(config, monkeypatch):
    from pisces_tpu.preprocessing import realigner as jr
    from pisces_tpu.preprocessing.indels import HashableIndel as JIndel
    from pisces_tpu_torch.preprocessing.indels import HashableIndel as TIndel
    rng = np.random.default_rng(23 + len(config))
    acgt = np.array(list("ACGT"))
    port_r = tr.GeminiReadRealigner(tr.GemBasicAlignmentComparer(), **config)
    ref_r = jr.GeminiReadRealigner(jr.GemBasicAlignmentComparer(), **config)
    trials = []
    for _ in range(250):
        ref = "".join(acgt[rng.integers(0, 4, 400)])
        pairs = [_indel_pair(rng, ref, (TIndel, JIndel))
                 for _ in range(int(rng.integers(1, 4)))]
        read = _carrier_read(rng, ref, pairs[0][0])
        kw = dict(pair_specific=bool(rng.random() < 0.5),
                  is_reverse=bool(rng.random() < 0.5),
                  is_paired=bool(rng.random() < 0.7))
        trials.append((ref, pairs, read, kw))

    def run(realigner, which):
        out = []
        for ref, pairs, (p, c, s, q), kw in trials:
            out.append(_realigned(realigner.realign(
                p, list(c), s, list(q), [pr[which] for pr in pairs], ref,
                **kw)))
        return out
    port = run(port_r, 0)
    assert port == run(ref_r, 1)
    monkeypatch.setattr(tr, "USE_NATIVE_REALIGN", False)
    monkeypatch.setattr(tr, "USE_NATIVE_SUMMARY", False)
    assert port == run(port_r, 0)
    assert sum(r is not None for r in port) > 30


def _chrom_inputs(bam, genome, chrom, pkg):
    """(batch with names, reference sequence, keep, features) of one
    chromosome through package `pkg`'s own modules."""
    import importlib
    bam_mod = importlib.import_module(f"{pkg}.io.bam")
    fasta = importlib.import_module(f"{pkg}.io.fasta")
    gem = importlib.import_module(f"{pkg}.preprocessing.gemini")
    cls = importlib.import_module(f"{pkg}.preprocessing.classify")
    types = importlib.import_module(f"{pkg}.domain.types")
    reader = bam_mod.BamReader(bam)
    batch = reader.fetch(reader.header.ref_index(chrom), parse_names=True)
    seq = fasta.Genome(genome).get_chr_reference(chrom).sequence
    opts = gem.GeminiOptions()
    keep = gem.gemini_keep_mask(batch, opts, batch.names)
    feats = cls.extract_features(batch, types.BASE_TO_ALLELE[seq], keep)
    return batch, seq, keep, feats, opts


@pytest.mark.parametrize("which", ["paired", "corpus"])
def test_indel_evidence_filter_and_source_match_reference(which, request):
    from pisces_tpu.preprocessing import gemini as jg
    _, bam, genome = request.getfixturevalue(which)
    chrom = "chr1" if which == "paired" else "chrR"
    tb, tseq, tkeep, tfeat, topts = _chrom_inputs(bam, genome, chrom,
                                                  "pisces_tpu_torch")
    jb, jseq, jkeep, jfeat, jopts = _chrom_inputs(bam, genome, chrom,
                                                  "pisces_tpu")
    assert np.array_equal(tkeep, jkeep)
    for f in dataclasses.fields(tfeat):
        assert np.array_equal(getattr(tfeat, f.name),
                              getattr(jfeat, f.name)), f.name
    refstr = tseq.tobytes().decode("latin-1")
    tsrc, tlook = tg.build_indel_source(chrom, refstr, tb, tkeep, tfeat,
                                        topts)
    jsrc, jlook = jg.build_indel_source(chrom, refstr, jb, jkeep, jfeat,
                                        jopts)
    assert {k: v.row() for k, v in tlook.items()} == \
        {k: v.row() for k, v in jlook.items()}
    assert [dataclasses.astuple(h) for h in tsrc.indels] == \
        [dataclasses.astuple(h) for h in jsrc.indels]
    assert len(tsrc.indels) > 0
    for p in range(0, len(tseq), 997):
        assert tsrc.any_indels_nearby(p) == jsrc.any_indels_nearby(p)


# ---------------------------------------------------------------------------
# pair classifier, bin signal, pair filter
# ---------------------------------------------------------------------------

def test_classifier_and_bins_match_reference(paired):
    from pisces_tpu.preprocessing import bins as jbins
    from pisces_tpu.preprocessing import classify as jcls
    from pisces_tpu.domain.types import BASE_TO_ALLELE as JB2A
    from pisces_tpu_torch.domain.types import BASE_TO_ALLELE as TB2A
    from pisces_tpu_torch.preprocessing import bins as tbins
    from pisces_tpu_torch.preprocessing import classify as tcls
    _, bam, genome = paired
    tb, tseq, tkeep, _, _ = _chrom_inputs(bam, genome, "chr2",
                                          "pisces_tpu_torch")
    jb, jseq, jkeep, _, _ = _chrom_inputs(bam, genome, "chr2", "pisces_tpu")
    for check_md in (False, True):
        tmap = tcls.classify_batch(tb, TB2A[tseq], tb.names, 10, False,
                                   check_md=check_md)
        jmap = jcls.classify_batch(jb, JB2A[jseq], jb.names, 10, False,
                                   check_md=check_md)
        assert {i: c.name for i, c in tmap.items()} == \
            {i: c.name for i, c in jmap.items()}
    assert len({c.name for c in tmap.values()}) >= 4
    kept = np.nonzero(tkeep)[0]
    codes = np.array([int(tmap[int(i)]) for i in kept], np.int32)
    targets = np.arange(500, len(tseq), 4000, dtype=np.int64)
    for width in (500, 100):
        topt = tbins.BinSignalOptions(messy_site_width=width)
        jopt = jbins.BinSignalOptions(messy_site_width=width)
        tc = tbins.compute_bin_conclusions(len(tseq), tb.pos[kept],
                                           tb.end_pos[kept], codes, targets,
                                           topt)
        jc = jbins.compute_bin_conclusions(len(jseq), jb.pos[kept],
                                           jb.end_pos[kept], codes, targets,
                                           jopt)
        for f in dataclasses.fields(tc):
            a, b = getattr(tc, f.name), getattr(jc, f.name)
            assert np.array_equal(np.asarray(a), np.asarray(b)), f.name
        for lo in range(0, len(tseq) - 300, 1500):
            assert tc.usable_at(lo, lo + 300) == jc.usable_at(lo, lo + 300)
        silenced = [sorted(tbins.reads_to_silence(
            int(tmap[int(i)]), int(i), int(i), lambda k: int(tb.pos[k]), tc,
            True, True)) for i in kept[:400]]
        assert silenced == [sorted(jbins.reads_to_silence(
            int(jmap[int(i)]), int(i), int(i), lambda k: int(jb.pos[k]), jc,
            True, True)) for i in kept[:400]]


def test_pair_filter_matches_reference(paired, tmp_path):
    from pisces_tpu.io import pair_filter as jpf
    from pisces_tpu_torch.io import pair_filter as tpf
    _, bam, _ = paired
    outs = []
    for mod, name in ((tpf, "t"), (jpf, "j")):
        flt = mod.AlignmentPairFilter()
        out = mod.rewrite_bam(bam, str(tmp_path / f"{name}.bam"), flt)
        outs.append(out)
    assert filecmp.cmp(outs[0], outs[1], shallow=False)
    batch = BamReader(bam).fetch(parse_names=True)
    reads = list(tpf._batch_reads(batch))
    flt = tpf.AlignmentPairFilter()
    pairs = [p for p in (flt.try_pair(r) for r in reads) if p is not None]
    assert 2 * len(pairs) == batch.n and not flt.unpaired_reads()


# ---------------------------------------------------------------------------
# run_gemini end to end
# ---------------------------------------------------------------------------

def _options(which, mod):
    return (mod.GeminiOptions() if which == "paired"
            else mod.GeminiOptions(use_bin_signal=False))


def _records(path):
    """(reference id, 0-based position, record bytes) of every record in
    file order: every field and tag (XD, and Gemini's XT and XP)."""
    import struct

    from pisces_tpu_torch.io.bgzf import decompress
    with open(path, "rb") as f:
        d = decompress(f.read())
    p = 8 + struct.unpack_from("<i", d, 4)[0]
    for _ in range(struct.unpack_from("<i", d, p)[0]):
        p += 8 + struct.unpack_from("<i", d, p + 4)[0]
    p += 4
    rows = []
    while p < len(d):
        size = struct.unpack_from("<i", d, p)[0]
        rows.append(struct.unpack_from("<ii", d, p + 4)
                    + (d[p:p + 4 + size],))
        p += 4 + size
    return rows


def _same_outputs(a, b):
    for ext in ("", ".bai", ".indels.csv"):
        assert filecmp.cmp(a + ext, b + ext, shallow=False), ext


@pytest.mark.parametrize("which", ["paired", "corpus"])
def test_gemini_matches_reference(which, request, tmp_path):
    from pisces_tpu.preprocessing import gemini as jg
    _, bam, genome = request.getfixturevalue(which)
    stats = {}
    port = tg.run_gemini(bam, genome, str(tmp_path / "t.bam"),
                         options=_options(which, tg), stats=stats)
    ref = jg.run_gemini(bam, genome, str(tmp_path / "j.bam"),
                        options=_options(which, jg))
    assert _records(port) == _records(ref)
    _same_outputs(port, ref)
    assert stats["indel_targets"] > 0 and stats["realigned"] > 0
    if which == "paired":
        assert stats["stitched_pairs"] > 1000
        assert stats["stitch_batched_pairs"] > stats["stitch_per_pair_pairs"]
        assert stats["stitched_pairs"] == (stats["stitched_batched"]
                                           + stats["stitched_per_pair"])


@pytest.mark.parametrize("which", ["paired", "corpus"])
def test_gemini_native_equals_python_twin(which, request, tmp_path,
                                          monkeypatch):
    _, bam, genome = request.getfixturevalue(which)
    native_stats, twin_stats = {}, {}
    native = tg.run_gemini(bam, genome, str(tmp_path / "n.bam"),
                           options=_options(which, tg), stats=native_stats)
    monkeypatch.setattr(ts, "USE_NATIVE", False)
    monkeypatch.setattr(tr, "USE_NATIVE_SUMMARY", False)
    monkeypatch.setattr(tr, "USE_NATIVE_REALIGN", False)
    twin = tg.run_gemini(bam, genome, str(tmp_path / "p.bam"),
                         options=_options(which, tg), stats=twin_stats)
    _same_outputs(native, twin)
    assert twin_stats.get("stitch_batched_pairs", 0) == 0
    strip = {k: v for k, v in native_stats.items() if k not in PATH_KEYS}
    assert strip == {k: v for k, v in twin_stats.items()
                     if k not in PATH_KEYS}


@pytest.mark.parametrize("region", [4_000, 7_000])
def test_gemini_region_size_matches_reference(paired, tmp_path, region):
    """-RegionSize: blocks come from the .bai and hand boundary pairs
    forward (EdgeState). The streamed output is byte-equal to the
    reference's. Each block finds its own indel targets, in both packages,
    so only pairs within a fragment's span (250 bp) of a block edge may
    differ from the whole run (ROADMAP Queue 3); records at one position
    may come in another order."""
    from collections import Counter

    from pisces_tpu.preprocessing import gemini as jg
    _, bam, genome = paired
    whole = tg.run_gemini(bam, genome, str(tmp_path / "w.bam"))
    streamed = tg.run_gemini(bam, genome, str(tmp_path / "s.bam"),
                             options=tg.GeminiOptions(region_size=region))
    ref = jg.run_gemini(bam, genome, str(tmp_path / "j.bam"),
                        options=jg.GeminiOptions(region_size=region))
    _same_outputs(streamed, ref)
    a, b = Counter(_records(whole)), Counter(_records(streamed))
    diff = list((a - b) + (b - a))
    edges = np.arange(region, 30_000, region)
    assert all(np.abs(edges - r[1]).min() <= 250 for r in diff), diff[:2]
    assert len(diff) < len(a) // 100


def test_gemini_region_size_realigns_each_block_alone(tmp_path):
    """ROADMAP Queue 3: a block finds its indel targets from its own reads,
    in both packages. On four 20 kb chromosomes in 5 kb blocks, records
    of pairs by indels next to block edges differ from the whole run (the
    whole run realigns them, a block may not), none farther than 250 bp
    from an edge; the streamed output is the reference's, byte for byte."""
    from collections import Counter

    from pisces_tpu.preprocessing import gemini as jg
    bam, genome = synthetic.write_paired_workload(
        str(tmp_path / "w"), 20_000, 3_000,
        chrom_names=("chr1", "chr2", "chr3", "chr4"), seed=0, index=True)
    whole = tg.run_gemini(bam, genome, str(tmp_path / "w.bam"))
    streamed = tg.run_gemini(bam, genome, str(tmp_path / "s.bam"),
                             options=tg.GeminiOptions(region_size=5_000))
    ref = jg.run_gemini(bam, genome, str(tmp_path / "j.bam"),
                        options=jg.GeminiOptions(region_size=5_000))
    _same_outputs(streamed, ref)
    a, b = Counter(_records(whole)), Counter(_records(streamed))
    diff = list((a - b) + (b - a))
    edges = np.arange(5_000, 20_000, 5_000)
    assert diff and all(np.abs(edges - r[1]).min() <= 250 for r in diff)


def test_gemini_multi_matches_single(paired, tmp_path):
    _, bam, genome = paired
    stats, multi_stats = {}, {}
    single = tg.run_gemini(bam, genome, str(tmp_path / "s.bam"), stats=stats)
    multi = tg.run_gemini_multi(bam, genome, str(tmp_path / "m.bam"),
                                n_processes=2, stats=multi_stats)
    assert _records(multi) == _records(single)
    assert filecmp.cmp(multi + ".bai", single + ".bai", shallow=False)
    assert multi_stats == stats


def test_gemini_cli_runs_as_module(paired, tmp_path):
    """python -m pisces_tpu_torch.preprocessing.gemini, with -stitchonly
    and a chromosome filter, equals run_gemini with those options, and
    its process never imports torch (the workers of -multiprocess are the
    same host code)."""
    _, bam, genome = paired
    out = str(tmp_path / "cli.bam")
    code = ("import sys, runpy; sys.argv = sys.argv[1:]; "
            "runpy.run_module('pisces_tpu_torch.preprocessing.gemini', "
            "run_name='__main__', alter_sys=True)")
    wrapper = ("import atexit, sys; "
               "atexit.register(lambda: print('TORCH', 'torch' in "
               "sys.modules)); " + code)
    proc = subprocess.run(
        [sys.executable, "-c", wrapper, "gemini", "-bam", bam, "-g", genome,
         "-o", out, "-StitchOnly", "true", "-Chromosomes", "chr2"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "TORCH False" in proc.stdout
    opts = tg.GeminiOptions(realign=False, chromosomes=("chr2",))
    want = tg.run_gemini(bam, genome, str(tmp_path / "api.bam"), opts)
    assert _records(out) == _records(want)
    assert {r[0] for r in _records(out)} == {1}
