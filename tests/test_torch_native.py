"""The port's native host module (pisces_tpu_torch/io/native.py and
io/_native/*.cpp) against the port's own Python read flow and against the
reference package's native module (pisces_tpu/io/native.py).

Inputs are the synthetic messy BAMs of pisces_tpu_torch.synthetic: two
chromosomes of 20 kb, seeds 1 and 2. Decoded columns, counts, tuples and
candidates must be equal. The C++ pass sums each base's quality error
10^(-q/10) in f64; build_counts_host sums the events' f32 errors in f64. So
the sums are held within 1e-9 relative against the host build of the same
events with f64 errors, and within f32 rounding (1.2e-7) against the plain
host build. The unique gVCF tuples come out of the C++ dedup in
first-occurrence order and out of fast_gvcf._unique_tuples sorted, so they
are compared per position, each expanded through its inverse index.
"""
import dataclasses
import io
import os

import numpy as np
import pytest

import conftest  # noqa: F401  (keeps JAX on the CPU)
from pisces_tpu_torch.calling import fast_gvcf
from pisces_tpu_torch.calling.intervals import ChrIntervalSet, Region
from pisces_tpu_torch.calling.repeats import (
    RefSeqStr, compute_component_rmxn_lengths,
)
from pisces_tpu_torch.domain.types import (
    BASE_TO_ALLELE, COVERAGE_CONTRIBUTING_ALLELES, AlleleCategory,
)
from pisces_tpu_torch.io import native
from pisces_tpu_torch.io.bam import BamReader, ReadBatch, filter_batch
from pisces_tpu_torch.io.fasta import Genome
from pisces_tpu_torch.ops.scoring_params import ScoringParams
from pisces_tpu_torch.pileup.candidates import find_candidates_batch
from pisces_tpu_torch.pileup.candidates_fast import (
    aggregate_native_mismatches, find_indel_candidates,
)
from pisces_tpu_torch.pileup.counts import (
    build_counts_host, candidate_anchor_positions,
)
from pisces_tpu_torch.pileup.events import QUAL_TO_ERR, build_base_events
from pisces_tpu_torch.synthetic import write_synthetic_workload

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLUMNS = ("ref_id", "pos", "mapq", "flag", "cigar_off", "cigar_ops",
           "cigar_lens", "seq_off", "seq", "qual", "end_pos", "mate_ref_id",
           "mate_pos")
MIN_BQ, ANCHOR, BLOCK = 20, 5, 1000


@pytest.fixture(scope="module", params=[1, 2])
def workload(request, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp(f"native{request.param}"))
    bam, genome = write_synthetic_workload(tmp, 2, 20_000, 6_000,
                                           seed=request.param)
    return bam, Genome(genome)


@pytest.fixture(scope="module")
def flows(workload):
    """Per chromosome: the Python flow's batch, keep mask, events and
    anchored positions, and the native reader holding the same batch."""
    bam, genome = workload
    reader = native.NativeBamReader(bam)
    py = BamReader(bam)
    out = {}
    for rid, name in enumerate(py.header.ref_names):
        batch = py.fetch(ref_id=rid)
        keep = filter_batch(batch)
        chrom = genome.get_chr_reference(name)
        indels = find_indel_candidates(name, chrom.sequence, batch, keep,
                                       MIN_BQ, ANCHOR)
        out[name] = dict(rid=rid, batch=batch, keep=keep, chrom=chrom,
                         ev=build_base_events(batch, keep, MIN_BQ, ANCHOR),
                         anchors=candidate_anchor_positions(indels))
    return reader, out


def _pileup(reader, f, track_open_ended=True, ref_codes=True):
    """The native pass over chromosome f, fetched on `reader` first."""
    reader.fetch(ref_id=f["rid"], as_views=True)
    rc = BASE_TO_ALLELE[f["chrom"].sequence] if ref_codes else None
    return native.native_pileup(reader, f["keep"], MIN_BQ, ANCHOR,
                                f["anchors"], ref_codes=rc,
                                track_open_ended=track_open_ended)


def _f64_errors(ev):
    """The events with each base's error 10^(-q/10) in f64, as the C++
    pass adds it (BaseEvents keeps it in f32; each f32 value names its q)."""
    q = np.zeros(len(ev.qerr), np.int64)
    hit = ev.qerr > 0
    q[hit] = np.rint(-10.0 * np.log10(ev.qerr[hit].astype(np.float64)))
    assert (QUAL_TO_ERR[q][hit].astype(np.float32) == ev.qerr[hit]).all()
    return dataclasses.replace(ev, qerr=np.where(hit, QUAL_TO_ERR[q], 0.0))


def _assert_batches_equal(a, b):
    assert a.n == b.n
    for c in COLUMNS:
        np.testing.assert_array_equal(getattr(a, c), getattr(b, c),
                                      err_msg=c)
        assert getattr(a, c).dtype == getattr(b, c).dtype, c


@pytest.mark.parametrize("parse_tags", [False, True])
@pytest.mark.parametrize("ref_id", [None, 0, 1])
def test_fetch_matches_python_reader(workload, ref_id, parse_tags):
    from pisces_tpu.io.bam import BamReader as JBamReader
    from pisces_tpu.io.native import NativeBamReader as JNativeBamReader
    bam, _ = workload
    reader = native.NativeBamReader(bam)
    assert reader.header.ref_names == BamReader(bam).header.ref_names
    assert reader.header.ref_lengths == [20_000, 20_000]
    assert reader.n_records == BamReader(bam).n_records
    got = reader.fetch(ref_id=ref_id, parse_tags=parse_tags)
    _assert_batches_equal(got, BamReader(bam).fetch(ref_id=ref_id))
    jn = JNativeBamReader(bam).fetch(ref_id=ref_id, parse_tags=parse_tags)
    _assert_batches_equal(got, jn)
    assert got._from_native_handle
    if parse_tags:
        jp = JBamReader(bam).fetch(ref_id=ref_id, parse_tags=True)
        for k in ("xd_tags", "xn_tags", "extra_tags"):
            assert getattr(got, k) == getattr(jp, k) == getattr(jn, k), k
        assert len(got.extra_tags) == got.n
    else:
        assert got.extra_tags is None and got.xd_tags is None


def test_views_and_region_fetch(workload):
    bam, _ = workload
    reader = native.NativeBamReader(bam)
    want = BamReader(bam).fetch(ref_id=1)
    views = reader.fetch(ref_id=1, as_views=True)
    _assert_batches_equal(views, want)
    assert not views.seq.flags.writeable and not views.qual.flags.writeable
    # the pileup pass checks its read mask against the handle's batch
    with pytest.raises(ValueError, match="decoded"):
        native.native_pileup(reader, np.ones(views.n + 1, bool), MIN_BQ,
                             ANCHOR)
    region = reader.fetch_region(1, 5_000, 9_000)
    mask = (want.pos < 9_000) & (want.end_pos >= 5_000)
    assert 0 < region.n < want.n and region.n == int(mask.sum())
    np.testing.assert_array_equal(region.pos, want.pos[mask])
    np.testing.assert_array_equal(
        region.seq, np.concatenate([want.seq[want.seq_off[i]:
                                             want.seq_off[i + 1]]
                                    for i in np.nonzero(mask)[0]]))


def test_native_pileup_counts_match_host_build(flows):
    from pisces_tpu.io.native import NativeBamReader as JNativeBamReader
    from pisces_tpu.io.native import native_pileup as jnative_pileup
    reader, per = flows
    jreader = JNativeBamReader(reader.path)
    for name, f in per.items():
        pc, _ = _pileup(reader, f)
        host = build_counts_host(f["ev"], BLOCK, ANCHOR, f["anchors"])
        exact = build_counts_host(_f64_errors(f["ev"]), BLOCK, ANCHOR,
                                  f["anchors"])
        assert len(f["anchors"]) > 0
        for k in ("block_keys", "counts_t", "anchored_positions",
                  "anchored_counts"):
            np.testing.assert_array_equal(getattr(pc, k), getattr(host, k),
                                          err_msg=f"{name} {k}")
        for k in ("qual_t", "anchored_quals"):
            np.testing.assert_allclose(getattr(pc, k), getattr(exact, k),
                                       rtol=1e-9, atol=0,
                                       err_msg=f"{name} {k}")
            np.testing.assert_allclose(getattr(pc, k), getattr(host, k),
                                       rtol=1.2e-7, atol=0,
                                       err_msg=f"{name} {k}")
        jreader.fetch(ref_id=f["rid"], as_views=True)
        jpc, _ = jnative_pileup(jreader, f["keep"], MIN_BQ, ANCHOR, BLOCK,
                                f["anchors"])
        np.testing.assert_array_equal(pc.counts_t, jpc.counts_t)
        np.testing.assert_array_equal(pc.qual_t, jpc.qual_t)
        np.testing.assert_array_equal(pc.anchored_quals, jpc.anchored_quals)


def test_pos_tuples_match_per_position_reduction(flows):
    reader, per = flows
    cov = [int(a) for a in COVERAGE_CONTRIBUTING_ALLELES]
    for name, f in per.items():
        pc, _ = _pileup(reader, f)
        nb = len(pc.block_keys)
        counts = pc.counts_t.reshape(nb * BLOCK, 6, 3)
        pos = ((pc.block_keys[:, None] - 1) * BLOCK + 1
               + np.arange(BLOCK)[None, :]).reshape(-1)
        seq = f["chrom"].sequence
        in_ref = pos <= len(seq)
        codes = BASE_TO_ALLELE[seq[np.minimum(pos, len(seq)) - 1]]
        want = np.zeros((len(pos), 8), np.int64)
        rows = np.nonzero(in_ref)[0]
        want[rows, :3] = counts[rows, codes[rows], :]
        want[:, 3:6] = counts[:, cov, :].sum(axis=1)
        want[:, 6] = counts[:, 4, :].sum(axis=1)
        assert pc.pos_tuples.shape == (nb * BLOCK, 8)
        np.testing.assert_array_equal(pc.pos_tuples, want, err_msg=name)
        # without reference codes the pass makes no tuples or mismatches
        pc0, mm0 = _pileup(reader, f, ref_codes=False)
        assert pc0.pos_tuples is None and pc0.gvcf_unique is None
        assert mm0 is None


def test_gvcf_unique_matches_unique_tuples(flows):
    reader, per = flows
    for name, f in per.items():
        host = build_counts_host(f["ev"], BLOCK, ANCHOR)
        nb = len(host.block_keys)
        pos = ((host.block_keys[:, None] - 1) * BLOCK + 1
               + np.arange(BLOCK)[None, :]).reshape(-1)
        counts = host.counts_t.reshape(nb * BLOCK, 6, 3)
        seq = f["chrom"].sequence
        sel = (counts.sum(axis=(1, 2)) > 0) & (pos <= len(seq))
        pos, counts = pos[sel], counts[sel]
        codes = BASE_TO_ALLELE[seq[pos - 1]]
        cov = [int(a) for a in COVERAGE_CONTRIBUTING_ALLELES]
        uniq, inv = fast_gvcf._unique_tuples(
            counts[np.arange(len(pos)), codes, :],
            counts[:, cov, :].sum(axis=1))
        pc, _ = _pileup(reader, f)
        npos, nuniq, ninv = pc.gvcf_unique
        np.testing.assert_array_equal(npos, pos, err_msg=name)
        assert len(nuniq) == len(uniq) > 100
        np.testing.assert_array_equal(nuniq[ninv], uniq[inv], err_msg=name)
        # first-occurrence order, not sorted
        first = np.unique(ninv, return_index=True)[1]
        assert (np.diff(first) > 0).all()


def _table(cands, track_open_ended):
    return {c.key(track_open_ended): (tuple(c.support_by_direction),
                                      tuple(c.well_anchored_by_direction))
            for c in cands}


@pytest.mark.parametrize("track_open_ended", [True, False])
def test_native_mismatches_give_the_python_snv_candidates(flows,
                                                          track_open_ended):
    reader, per = flows
    for name, f in per.items():
        _, mm = _pileup(reader, f, track_open_ended)
        got = aggregate_native_mismatches(name, f["chrom"].sequence,
                                          *mm).to_candidates()
        cands, _ = find_candidates_batch(
            name, f["chrom"].sequence, f["batch"], f["keep"], MIN_BQ,
            anchor_size=ANCHOR, track_open_ended=track_open_ended)
        want = [c for c in cands if c.category == AlleleCategory.SNV]
        assert len(got) == len(want) > 10
        assert _table(got, track_open_ended) == _table(want,
                                                       track_open_ended)
    assert len(aggregate_native_mismatches("chr1", f["chrom"].sequence,
                                           *(a[:0] for a in mm))) == 0


@pytest.mark.parametrize("track_open_ended", [True, False])
def test_indel_candidates_match_reference_package(flows, track_open_ended):
    """The port's find_indel_candidates (no stitched directions) against
    the reference package's with base_dirs=None, on the native batch."""
    from pisces_tpu.pileup.candidates_fast import (
        find_indel_candidates as jfind_indels,
    )
    reader, per = flows
    for name, f in per.items():
        batch = reader.fetch(ref_id=f["rid"], as_views=True)
        seq = f["chrom"].sequence
        got = find_indel_candidates(name, seq, batch, f["keep"], MIN_BQ,
                                    ANCHOR, track_open_ended)
        want = jfind_indels(name, seq, batch, f["keep"], MIN_BQ, ANCHOR,
                            track_open_ended, base_dirs=None)
        assert len(got) == len(want) > 5
        assert _table(got, track_open_ended) == _table(want,
                                                       track_open_ended)


def test_render_reference_lines_matches_python_formatting():
    from pisces_tpu.io.native import (
        render_reference_lines as jrender,
    )
    rng = np.random.default_rng(5)
    n, u = 5_000, 37
    positions = np.sort(rng.choice(10**9, n, replace=False)).astype(np.int64)
    positions[0] = 1
    inv = rng.integers(0, u, n).astype(np.int32)
    bases = rng.choice(np.frombuffer(b"ACGTN", np.uint8), n)
    tails = [f"\t.\t{i}\tPASS\tDP={i * 3}\tGT:GQ\t0/0:{i}" for i in range(u)]
    tails[3] = ""
    blob, off, owner = native.render_reference_lines("chr7\t", positions,
                                                     inv, bases, tails)
    want = [f"chr7\t{p}\t.\t{chr(b)}{tails[v]}"
            for p, b, v in zip(positions.tolist(), bases.tolist(),
                               inv.tolist())]
    assert bytes(blob).decode("latin-1") == "".join(ln + "\n" for ln in want)
    jblob, joff, _ = jrender("chr7\t", positions, inv, bases, tails)
    assert bytes(blob) == bytes(jblob)
    np.testing.assert_array_equal(off, joff)
    block = fast_gvcf.RefLineBlock(blob, off, owner)
    assert len(block) == n and block.line(17) == want[17]
    part = block.slice(100, 250)
    assert [part.line(i) for i in range(len(part))] == want[100:250]

    class Sink:   # a text file without a byte buffer
        def __init__(self):
            self.text = []

        def write(self, s):
            self.text.append(s)

    sink = Sink()
    part.write_range(sink, 10, 20)
    part.write_range(sink, 5, 5)
    assert "".join(sink.text) == "".join(ln + "\n" for ln in want[110:120])


def test_no_reference_positions_render_an_empty_block():
    from pisces_tpu_torch.io.vcf_write import VcfWriterConfig
    from pisces_tpu_torch.options import PiscesApplicationOptions
    block = fast_gvcf.format_reference_lines(
        "chr1", np.empty(0, np.int64), {},
        VcfWriterConfig(PiscesApplicationOptions()), 10, 20)
    assert isinstance(block, fast_gvcf.RefLineBlock) and len(block) == 0
    block.write_range(io.StringIO(), 0, 0)


def test_rmxn_min_component_matches_python_scan():
    rng = np.random.default_rng(11)
    L = 600
    # a reference rich in short repeats, so the scans run long
    units = [b"A", b"CA", b"GGT", b"ACGT", b"TTAGG"]
    parts, size = [], 0
    while size < L:
        u = units[rng.integers(len(units))]
        parts.append(u * int(rng.integers(1, 8)))
        size += len(parts[-1])
    ref = np.frombuffer(b"".join(parts)[:L], np.uint8).copy()
    rs = RefSeqStr(ref)
    text = ref.tobytes().decode()
    cats = (AlleleCategory.SNV, AlleleCategory.MNV, AlleleCategory.INSERTION,
            AlleleCategory.DELETION)
    n = 0
    for _ in range(2_400):
        cat = cats[rng.integers(len(cats))]
        # positions at both chromosome ends as well as inside
        pos = int(rng.choice([1, 2, L - 6, L - 1, L,
                              int(rng.integers(1, L + 1))]))
        k = int(rng.integers(1, 7))
        if cat == AlleleCategory.INSERTION:
            # half insert a copy of the following reference (a repeat)
            ref_a = text[pos - 1]
            added = (text[pos:pos + k] if rng.random() < 0.5 else "")
            alt_a = ref_a + (added or "".join(rng.choice(list("ACGT"), k)))
        elif cat == AlleleCategory.DELETION:
            ref_a = text[pos - 1:pos + k]
            alt_a = ref_a[0]
            if len(ref_a) < 2:
                continue
        else:
            w = 1 if cat == AlleleCategory.SNV else k
            ref_a = text[pos - 1:pos - 1 + w]
            alt_a = "".join(rng.choice(list("ACGT"), len(ref_a)))
        max_unit = int(rng.integers(1, 6))
        got = rs.rmxn_min_component(cat, pos, ref_a, alt_a, max_unit)
        assert got == min(compute_component_rmxn_lengths(
            cat, pos, ref_a, alt_a, text, max_unit)), (cat, pos, ref_a,
                                                         alt_a, max_unit)
        n += 1
    assert n >= 2_000


def test_score_reference_positions_native_equals_python(flows):
    reader, per = flows
    params = ScoringParams()
    for name, f in per.items():
        seq = f["chrom"].sequence
        host = build_counts_host(f["ev"], BLOCK, ANCHOR)
        pc, _ = _pileup(reader, f)
        ivs = ChrIntervalSet([Region(150, 2_400), Region(19_800, 20_500)],
                             name)
        for intervals in (None, ivs):
            pos, out = fast_gvcf.score_reference_positions(
                pc, seq, params, device=None, intervals=intervals)
            wpos, want = fast_gvcf.score_reference_positions(
                host, seq, params, device=None, intervals=intervals)
            np.testing.assert_array_equal(pos, wpos)
            for k in want:
                if k in ("inv", "ref_base"):
                    continue
                np.testing.assert_array_equal(
                    np.asarray(out[k])[out["inv"]],
                    np.asarray(want[k])[want["inv"]], err_msg=f"{name} {k}")
            np.testing.assert_array_equal(out["ref_base"], want["ref_base"])


def test_open_bam_never_falls_back(workload, tmp_path):
    bam, _ = workload
    assert isinstance(native.open_bam(bam), native.NativeBamReader)
    assert type(native.open_bam(bam, prefer_native=False)) is BamReader
    with pytest.raises(IOError, match="failed to open"):
        native.open_bam(str(tmp_path / "missing.bam"))
    # a lazy handle of either reader needs the .bai, which this BAM lacks
    # (a whole-file reader's region fetch does not)
    for prefer_native, kind in ((True, native.NativeBamReader),
                                (False, BamReader)):
        lazy = native.open_bam(bam, prefer_native, lazy=True)
        assert type(lazy) is kind
        with pytest.raises(IOError, match=r"needs .*\.bai"):
            lazy.fetch_region(0, 0, 1_000)
    assert isinstance(native.NativeBamReader(bam).fetch(ref_id=0), ReadBatch)


def test_library_builds_from_the_port_sources():
    lib = native.build_native()
    build = os.path.join(REPO, "pisces_tpu_torch", "build")
    assert os.path.dirname(lib.path) == build
    assert os.path.basename(lib.path).startswith("libpisces_io-")
    assert lib.path == native.library_path()
    srcs = native._sources()
    assert [os.path.basename(s) for s in srcs] == [
        "pisces_io.cpp", "realign.cpp", "rmxn.cpp", "stitch.cpp"]
    # one RMxN scan in the library: stitch.cpp leaves it to rmxn.cpp
    for name in ("rmxn_for_indel", "rmxn_min_component"):
        assert sum(name in open(s).read() for s in srcs) == 1, name
    assert all(os.path.dirname(s) == os.path.join(
        REPO, "pisces_tpu_torch", "io", "_native") for s in srcs)


def test_unusable_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_native", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "CXX", "no-such-compiler-xyz")
    with pytest.raises(RuntimeError, match="no-such-compiler-xyz not found"):
        native.get_lib()
    # a compiler that runs and fails: its output is in the error
    monkeypatch.setattr(native, "CXX", "false")
    with pytest.raises(RuntimeError, match="false failed building"):
        native.get_lib()
    assert os.listdir(tmp_path) == []


def _tsan_usable(tmp) -> bool:
    """Whether g++ here builds and runs any ThreadSanitizer program."""
    import shutil
    import subprocess
    if shutil.which(native.CXX) is None:
        return False
    src, exe = os.path.join(tmp, "probe.cpp"), os.path.join(tmp, "probe")
    with open(src, "w") as f:
        f.write("#include <thread>\nint main() { int x = 0; "
                "std::thread t([&] { x = 1; }); t.join(); return x - 1; }\n")
    if subprocess.run([native.CXX, "-fsanitize=thread", src, "-o", exe,
                       "-lpthread"], capture_output=True).returncode != 0:
        return False
    return subprocess.run([exe], capture_output=True).returncode == 0


def test_tsan_harness_over_the_port_library(workload, tmp_path):
    """The ThreadSanitizer harness (io/_native/tsan/tsan_check.cpp), built
    from the port's sources: 8 threads x 3 iterations, each a handle of its
    own, decoding the whole file and pileup-counting it, then each
    chromosome through bam_pileup_mm with its reference codes and
    pileup_gvcf_unique, as a -MaxThreads job does. TSan exits non-zero on
    a data race; the harness on unequal checksums across threads."""
    import subprocess
    if not _tsan_usable(str(tmp_path)):
        pytest.skip("this toolchain cannot build a ThreadSanitizer program")
    exe = native.build_tsan_check()   # a failed build raises: a failure
    assert os.path.dirname(exe) == native.BUILD_DIR
    assert native.TSAN_SOURCE not in native._sources()
    bam, genome = workload
    names = BamReader(bam).header.ref_names
    codes = str(tmp_path / "ref_codes.bin")
    with open(codes, "wb") as f:
        for name in names:
            f.write(BASE_TO_ALLELE[genome.get_chr_reference(name).sequence]
                    .astype(np.int8).tobytes())
    r = subprocess.run([exe, bam, "8", "3", codes], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "tsan_check ok: 8 threads x 3 iters" in r.stdout
    assert "WARNING: ThreadSanitizer" not in r.stderr
    # the mismatch pass and the gVCF dedup ran on every chromosome
    fields = dict(part.strip().rsplit(" ", 1)
                  for part in r.stdout.strip().split(",")[1:])
    assert int(fields["mismatches"]) > 0
    assert int(fields["unique tuples"]) > 0
