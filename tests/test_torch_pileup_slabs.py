"""The native pileup pass split into slabs (io/native.native_pileup, C++
bam_pileup_mm) against the same pass in one slab.

A slab owns a contiguous range of positions and walks the reads that meet
it, so every dense output must equal the one-slab pass byte for byte: the
block keys, counts, f64 quality sums, anchored rows, scoring tuples and the
gVCF dedup. The mismatch events come out slab after slab, so they are held
equal as a sorted multiset, and through aggregate_native_mismatches. The
slab count is forced through native_pileup's `slabs` at 1, 2, 3, 7 and one
slab a touched block, on the native tests' synthetic workload and on a
hand-built batch in blocks of 10 positions that puts reads, deletion gaps,
terminal deletions, N, insertions, soft clips, anchored positions and
low-quality bases on every block edge, with a stitched direction column.
"""
import json
import os
import random
import sys
import threading

import numpy as np
import pytest

import conftest  # noqa: F401  (keeps JAX on the CPU)
from pisces_tpu_torch.apps.pisces import main
from pisces_tpu_torch.domain.types import BASE_TO_ALLELE
from pisces_tpu_torch.io import native
from pisces_tpu_torch.io.bam import filter_batch
from pisces_tpu_torch.io.bam_write import BamRecord, BamWriter
from pisces_tpu_torch.io.fasta import Genome
from pisces_tpu_torch.pileup.candidates_fast import (
    aggregate_native_mismatches, find_indel_candidates,
)
from pisces_tpu_torch.pileup.counts import candidate_anchor_positions
from pisces_tpu_torch.synthetic import write_synthetic_workload

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIN_BQ, ANCHOR = 20, 5
SLABS = [2, 3, 7, "per_block"]
M, I, D, N, S = 0, 1, 2, 3, 4   # BAM CIGAR op codes
EDGE_BLOCK, EDGE_LEN = 10, 400  # the hand-built batch: 40 blocks of 10


def _outputs(pc, mm):
    """Copies of one pass's outputs (its views die with the next pass)."""
    out = {"block_keys": pc.block_keys, "counts_t": pc.counts_t,
           "qual_t": pc.qual_t, "anchored_counts": pc.anchored_counts,
           "anchored_quals": pc.anchored_quals}
    if pc.pos_tuples is not None:
        out["pos_tuples"] = pc.pos_tuples
        for k, a in zip(("sel_positions", "uniq_tuples", "uniq_inv"),
                        pc.gvcf_unique):
            out[k] = a
    out = {k: np.array(a, copy=True) for k, a in out.items()}
    if mm is not None:
        order = np.lexsort(mm[::-1])
        out["mismatches"] = tuple(np.array(a[order]) for a in mm)
        out["mismatch_order"] = np.array(mm[0])
    return out


def _pass(reader, keep, anchors, ref_codes, slabs, **kw):
    """One pass at a forced slab count; its outputs and the slabs it ran
    in, as the handle holds them."""
    pc, mm = native.native_pileup(reader, keep, MIN_BQ, ANCHOR, anchors,
                                  ref_codes=ref_codes, slabs=slabs, **kw)
    return _outputs(pc, mm), int(reader._lib.pileup_n_slabs(reader._h))


def _assert_same(one, many, chrom=None, refseq=None):
    assert set(one) == set(many)
    for k, a in one.items():
        if k == "mismatch_order":
            continue
        if k == "mismatches":
            for x, y in zip(a, many[k]):
                np.testing.assert_array_equal(x, y, err_msg=k)
            continue
        assert a.dtype == many[k].dtype, k
        assert a.shape == many[k].shape, k
        assert a.tobytes() == many[k].tobytes(), k
    if "mismatches" in one and refseq is not None:
        b1 = aggregate_native_mismatches(chrom, refseq, *one["mismatches"])
        bn = aggregate_native_mismatches(chrom, refseq, *many["mismatches"])
        for field, v in vars(b1).items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(v, getattr(bn, field),
                                              err_msg=field)
            else:
                assert v == getattr(bn, field)


def _each_slab_count(reader, keep, anchors, ref_codes, chrom=None,
                     refseq=None, **kw):
    """The pass at every forced slab count against one slab."""
    one, ran = _pass(reader, keep, anchors, ref_codes, 1, **kw)
    assert ran == 1
    nb = len(one["block_keys"])
    for slabs in SLABS:
        want = nb if slabs == "per_block" else slabs
        many, ran = _pass(reader, keep, anchors, ref_codes, want, **kw)
        assert ran == max(1, min(want, nb))
        _assert_same(one, many, chrom, refseq)
    return one


# -- the native tests' synthetic workload -----------------------------------

@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("slabs"))
    bam, genome = write_synthetic_workload(tmp, 2, 20_000, 6_000, seed=1)
    return bam, Genome(genome)


@pytest.mark.parametrize("ref_codes", [True, False])
@pytest.mark.parametrize("ref_id", [0, 1])
def test_slabs_equal_one_slab_on_the_workload(workload, ref_id, ref_codes):
    bam, genome = workload
    reader = native.NativeBamReader(bam)
    name = reader.header.ref_names[ref_id]
    batch = reader.fetch(ref_id=ref_id)
    keep = filter_batch(batch)
    chrom = genome.get_chr_reference(name)
    anchors = candidate_anchor_positions(find_indel_candidates(
        name, chrom.sequence, batch, keep, MIN_BQ, ANCHOR))
    assert len(anchors) > 0
    rc = BASE_TO_ALLELE[chrom.sequence] if ref_codes else None
    one = _each_slab_count(reader, keep, anchors, rc, name, chrom.sequence)
    assert len(one["block_keys"]) == 20
    if ref_codes:
        assert len(one["mismatches"][0]) > 0


def test_slabs_equal_one_slab_on_an_unsorted_batch(workload):
    """The whole file in one batch: positions restart at each chromosome,
    so every slab walks every read (the count-only pass)."""
    bam, _ = workload
    reader = native.NativeBamReader(bam)
    batch = reader.fetch()
    assert (np.diff(batch.pos) < 0).any()
    keep = filter_batch(batch)
    _each_slab_count(reader, keep, np.array([5_000, 15_000]), None)


def test_multi_slab_passes_on_two_handles_at_once(workload):
    """Two Python threads, a handle each, run multi-slab passes at once;
    each pass equals its handle's one-slab pass."""
    bam, genome = workload
    refs, readers = [], []
    for rid in (0, 1):
        r = native.NativeBamReader(bam)
        batch = r.fetch(ref_id=rid)
        keep = filter_batch(batch)
        chrom = genome.get_chr_reference(r.header.ref_names[rid])
        rc = BASE_TO_ALLELE[chrom.sequence]
        one, _ = _pass(r, keep, None, rc, 1)
        refs.append((keep, rc, one))
        readers.append(r)
    errors = []

    def worker(i):
        try:
            keep, rc, one = refs[i]
            for slabs in (3, 7, 5, 2, 20, 4):
                many, ran = _pass(readers[i], keep, None, rc, slabs)
                assert ran == slabs
                _assert_same(one, many)
        except Exception as e:  # reported below, with the thread's index
            errors.append((i, e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors


# -- a hand-built batch with every kind of event on block edges -------------

def _edge_reads(rng):
    """(pos1, cigar, n_bases) of reads that put each kind of event on each
    edge between blocks of EDGE_BLOCK positions, then random reads."""
    reads = []
    for e in range(EDGE_BLOCK, EDGE_LEN - 30, EDGE_BLOCK):
        reads += [
            (e - 3, [(M, 8)]),                         # a read over the edge
            (e - 4, [(M, 3), (D, 4), (M, 5)]),         # a gap over the edge
            (e - 6, [(M, 7), (D, 1), (M, 4)]),         # a gap on the edge
            (e - 5, [(M, 4), (D, 3)]),                 # terminal D over it
            (e - 7, [(M, 7), (D, 2), (S, 3)]),         # D then S
            (e - 2, [(S, 2), (M, 3), (N, 5), (M, 4)]),  # N over the edge
            (e - 3, [(M, 4), (I, 2), (M, 4)]),         # I at the edge
            (e + 1, [(S, 4), (M, 6), (S, 2)]),         # clips at the edge
            (e, [(D, 2), (M, 5)]),                     # a leading D
        ]
    for _ in range(600):
        cig = [(S, rng.randint(1, 4))] if rng.random() < 0.2 else []
        for _ in range(rng.randint(1, 4)):
            cig.append((M, rng.randint(1, 12)))
            r = rng.random()
            if r < 0.15:
                cig.append((D, rng.randint(1, 5)))
            elif r < 0.22:
                cig.append((N, rng.randint(2, 9)))
            elif r < 0.32:
                cig.append((I, rng.randint(1, 3)))
        cig.append((M, rng.randint(1, 12)))
        r = rng.random()
        if r < 0.1:
            cig.append((D, rng.randint(1, 4)))
        elif r < 0.18:
            cig += [(D, rng.randint(1, 4)), (S, rng.randint(1, 4))]
        elif r < 0.3:
            cig.append((S, rng.randint(1, 4)))
        reads.append((rng.randint(1, EDGE_LEN - 80), cig))
    return reads


@pytest.fixture(scope="module")
def edge_batch(tmp_path_factory):
    """A BAM of one EDGE_LEN chromosome, its reference codes, the anchored
    positions (both sides of every edge and some others) and a stitched
    direction column (codes 0, 1, 2) for its bases."""
    rng = random.Random(20)
    tmp = str(tmp_path_factory.mktemp("slab_edges"))
    ref = "".join(rng.choice("ACGT") for _ in range(EDGE_LEN))
    w = BamWriter(os.path.join(tmp, "edges.bam"), ["e1"], [EDGE_LEN])
    for k, (pos1, cig) in enumerate(_edge_reads(rng)):
        n_bases = sum(ln for op, ln in cig if op in (M, I, S))
        seq = "".join(ref[min(pos1 - 1 + j, EDGE_LEN - 1)]
                      if rng.random() < 0.85 else rng.choice("ACGTN")
                      for j in range(n_bases))
        qual = [rng.choice((12, 30, 35, 35, 35)) for _ in range(n_bases)]
        w.add(BamRecord(f"r{k}", 0, pos1 - 1, 60,
                        16 if rng.random() < 0.5 else 0, cig, seq, qual))
    bam = w.write()
    edges = np.arange(EDGE_BLOCK, EDGE_LEN, EDGE_BLOCK)
    anchors = np.unique(np.concatenate([edges, edges + 1, [3, 57, 222]]))
    refseq = np.frombuffer(ref.encode(), dtype=np.uint8)
    reader = native.NativeBamReader(bam)
    reader.fetch(ref_id=0)
    n_bases = int(reader._lib.bam_total_bases(reader._h))
    dirs = np.random.default_rng(20).integers(0, 3, n_bases).astype(np.int8)
    return reader, refseq, anchors, dirs


@pytest.mark.parametrize("base_dirs", [False, True])
@pytest.mark.parametrize("track_open_ended", [True, False])
def test_slabs_equal_one_slab_on_block_edges(edge_batch, base_dirs,
                                             track_open_ended):
    reader, refseq, anchors, dirs = edge_batch
    batch = reader.fetch(ref_id=0)
    keep = filter_batch(batch)
    assert keep.all()
    one = _each_slab_count(
        reader, keep, anchors, BASE_TO_ALLELE[refseq], "e1", refseq,
        block_size=EDGE_BLOCK, track_open_ended=track_open_ended,
        base_dirs=dirs if base_dirs else None)
    assert len(one["block_keys"]) >= 30
    assert len(one["mismatches"][0]) > 0
    assert one["anchored_counts"].sum() > 0
    # deletions were counted, and a low-quality base as N
    assert one["counts_t"][..., 5, :].sum() > 0
    assert one["counts_t"][..., 4, :].sum() > 0


def test_no_kept_read_and_one_block(edge_batch):
    reader, refseq, anchors, _ = edge_batch
    batch = reader.fetch(ref_id=0)
    rc = BASE_TO_ALLELE[refseq]
    none_kept = np.zeros(batch.n, dtype=bool)
    for slabs in (1, 7):
        out, ran = _pass(reader, none_kept, anchors, rc, slabs,
                         block_size=EDGE_BLOCK)
        assert ran == 1
        assert len(out["block_keys"]) == 0 and out["counts_t"].size == 0
        assert out["anchored_counts"].shape[0] == len(anchors)
        assert not out["anchored_counts"].any()
        assert not out["anchored_quals"].any()
        assert len(out["mismatches"][0]) == 0
    # the reads inside the first block alone
    one_block = (batch.pos >= 0) & (batch.end_pos < EDGE_BLOCK - 1)
    assert one_block.any()
    outs = [_pass(reader, one_block, anchors, rc, slabs,
                  block_size=EDGE_BLOCK) for slabs in (1, 7)]
    assert [ran for _, ran in outs] == [1, 1]
    assert len(outs[0][0]["block_keys"]) == 1
    _assert_same(outs[0][0], outs[1][0])


# -- the counters and their per-layer metric --------------------------------

def test_counters_reach_metricsjson_and_the_reader(tmp_path):
    """A native-flow run puts pileup_slabs and pileup_passes in
    -metricsjson, and portbench's reader gives their ratio."""
    import importlib.util
    bam, genome = write_synthetic_workload(str(tmp_path), 1, 40_000, 8_000,
                                           seed=3)
    out = str(tmp_path / "out")
    js = str(tmp_path / "metrics.json")
    assert main(["-bam", bam, "-g", genome, "-o", out, "-device", "cpu",
                 "-backend", "numpy",
                 "-metricsjson", js]) == 0
    with open(js) as f:
        counters = json.load(f)["counters"]
    passes, slabs = counters["pileup_passes"], counters["pileup_slabs"]
    assert passes >= 1 and slabs >= passes
    spec = importlib.util.spec_from_file_location(
        "pileup_slabs_per_pass", os.path.join(
            REPO, "portbench", "layer_metrics", "pileup_slabs_per_pass.py"))
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    assert reader.read({"counters": counters}) == slabs / passes
    assert reader.read({"counters": {"gc_pause_s": 1.0}}) is None
    assert reader.read({"counters": {"pileup_slabs": 0.0,
                                     "pileup_passes": 0.0}}) is None
