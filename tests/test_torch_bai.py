"""The port's .bai index (pisces_tpu_torch/io/bai.py), its indexed BAM
writer and BGZF offsets, and both lazy region readers against the
reference package (pisces_tpu/io/bai.py, bam_write.cat_bams) and against a
masked whole-chromosome fetch.

Inputs are the synthetic messy BAMs of pisces_tpu_torch.synthetic (two
chromosomes of 20 kb, 6,000 reads, seed 1; one of 300 kb for windows that
cross 16 kb linear-index bins and 128 kb-level bins). Indexes, chunks and
bytes must be equal; region fetches must return exactly the reads a
whole-chromosome decode masked by overlap returns.
"""
import filecmp
import os

import numpy as np
import pytest

import conftest  # noqa: F401  (keeps JAX on the CPU)
from pisces_tpu_torch.io import bai, bgzf, native
from pisces_tpu_torch.io.bam import BamReader
from pisces_tpu_torch.synthetic import (
    generate_wgs_workload, write_synthetic_workload,
)

COLUMNS = ("ref_id", "pos", "mapq", "flag", "cigar_off", "cigar_ops",
           "cigar_lens", "seq_off", "seq", "qual", "end_pos", "mate_ref_id",
           "mate_pos")


@pytest.fixture(scope="module")
def indexed(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("bai"))
    bam, _ = write_synthetic_workload(tmp, 2, 20_000, 6_000, seed=1,
                                      index=True)
    return bam


def test_reg2bin_and_reg2bins_equal_reference():
    from pisces_tpu.io import bai as jbai
    rng = np.random.default_rng(0)
    begs = np.concatenate([rng.integers(0, 1 << 29, 300),
                           np.arange(0, 1 << 18, 4093),
                           [0, (1 << 14) - 1, 1 << 14, (1 << 17) - 1]])
    for beg in begs.tolist():
        for span in (1, 99, 100, 1 << 14, (1 << 17) + 3):
            end = min(beg + span, 1 << 29)
            if end <= beg:
                continue
            assert bai.reg2bin(beg, end) == jbai.reg2bin(beg, end)
            assert bai.reg2bins(beg, end) == jbai.reg2bins(beg, end)
            assert bai.reg2bin(beg, end) in bai.reg2bins(beg, end)


def test_index_is_byte_equal_to_reference(indexed, tmp_path):
    """The reference package's cat_bams recompresses the same records and
    rebuilds their .bai from the decoded batch: same BAM bytes, same
    index bytes."""
    from pisces_tpu.io import bai as jbai
    from pisces_tpu.io.bam_write import cat_bams
    out = str(tmp_path / "ref.bam")
    header = BamReader(indexed).header
    cat_bams([indexed], out, header.ref_names, header.ref_lengths)
    assert filecmp.cmp(out, indexed, shallow=False)
    assert filecmp.cmp(out + ".bai", indexed + ".bai", shallow=False)
    mine, ref = bai.read_bai(indexed + ".bai"), jbai.read_bai(out + ".bai")
    for rid in range(2):
        assert mine.refs[rid].mapped == 3_000
        assert mine.min_offset(rid) == ref.min_offset(rid)
        assert mine.max_offset(rid) == ref.max_offset(rid)
        for beg, end in ((0, 1), (0, 20_000), (4_990, 5_010),
                         (16_383, 16_385), (19_000, 30_000)):
            assert mine.query(rid, beg, end) == ref.query(rid, beg, end)
    # read_bai and write_bai round-trip
    again = str(tmp_path / "again.bai")
    bai.write_bai(mine, again)
    assert filecmp.cmp(again, indexed + ".bai", shallow=False)


def test_wgs_workload_is_byte_equal_to_reference_bench(tmp_path):
    import bench
    kw = dict(n_reads=20_000, chrom_len=200_000, n_var_sites=200, seed=3)
    port = generate_wgs_workload(str(tmp_path / "port"), **kw)
    ref = bench.generate_wgs_workload(str(tmp_path / "ref"), **kw)
    for suffix in ("", ".bai"):
        assert filecmp.cmp(port[0] + suffix, ref[0] + suffix, shallow=False)
    assert filecmp.cmp(os.path.join(port[1], "chrW.fa"),
                       os.path.join(ref[1], "chrW.fa"), shallow=False)


def test_bgzf_offsets_and_native_deflater_agree():
    rng = np.random.default_rng(2)
    data = rng.integers(0, 4, 3 * 0xFF00 + 517, dtype=np.uint8).tobytes()
    out, offs = bgzf.compress_with_offsets(data)
    blocks = list(bgzf.iter_blocks(out))
    assert [b[0] for b in blocks] == offs.tolist()
    assert bgzf.decompress(out) == data and len(blocks) == 5
    nout, noffs = native.bgzf_compress_parallel(data, n_threads=3)
    assert bgzf.decompress(nout) == data
    assert [b[0] for b in bgzf.iter_blocks(nout)] == noffs.tolist()
    # a byte's virtual offset names the block it lands in
    for u in (0, 0xFF00 - 1, 0xFF00, 2 * 0xFF00 + 9, len(data) - 1):
        v = (int(noffs[u // 0xFF00]) << 16) | (u % 0xFF00)
        fo = v >> 16
        chunk = next(c for o, _, c in bgzf.iter_blocks(nout, fo))
        assert chunk[v & 0xFFFF] == data[u]


def test_writer_virtual_offsets_follow_the_blocks(tmp_path):
    path = str(tmp_path / "w.bgz")
    chunks = [bytes([i % 251]) * (7_000 + 3 * i) for i in range(40)]
    starts = []
    with open(path, "wb") as f:
        w = bgzf.BgzfWriter(f)
        for c in chunks:
            starts.append(w.tell_virtual())
            w.write(c)
        w.close()
    with open(path, "rb") as f:
        raw = f.read()
    assert bgzf.decompress(raw) == b"".join(chunks)
    for v, c in zip(starts, chunks):
        block = next(bgzf.iter_blocks(raw, v >> 16))[2]
        assert block[v & 0xFFFF] == c[0]


def _masked(whole, beg0, end0):
    from pisces_tpu_torch.io.bam import subset_batch
    return subset_batch(whole, (whole.pos < end0) & (whole.end_pos >= beg0))


def _assert_batches_equal(a, b):
    assert a.n == b.n
    for c in COLUMNS:
        np.testing.assert_array_equal(getattr(a, c), getattr(b, c),
                                      err_msg=c)


@pytest.fixture(scope="module")
def long_bam(tmp_path_factory):
    """One 300 kb chromosome: windows cross 16 kb and 128 kb bins."""
    tmp = str(tmp_path_factory.mktemp("long"))
    bam, _ = write_synthetic_workload(tmp, 1, 300_000, 9_000, seed=4,
                                      index=True)
    return bam


REGIONS = [(0, 1), (0, 100), (5_000, 9_000), (16_380, 16_390),
           (131_000, 131_100), (100_000, 150_000), (299_000, 300_000),
           (0, 300_000), (150_050, 150_051)]


@pytest.mark.parametrize("flow", ["native", "python"])
def test_lazy_region_fetch_equals_masked_whole_fetch(long_bam, flow):
    from pisces_tpu.io.bam import BamReader as JBamReader
    whole = BamReader(long_bam).fetch(ref_id=0)
    lazy = native.open_bam(long_bam, prefer_native=flow == "native",
                           lazy=True)
    jlazy = JBamReader(long_bam, lazy=True)
    for beg0, end0 in REGIONS:
        want = _masked(whole, beg0, end0)
        got = lazy.fetch_region(0, beg0, end0)
        _assert_batches_equal(got, want)
        assert got._from_native_handle == (flow == "native")
        _assert_batches_equal(got, jlazy.fetch_region(0, beg0, end0))
        if flow == "native":
            assert lazy._n_decoded == want.n   # the handle holds the batch
            views = lazy.fetch_region(0, beg0, end0, as_views=True)
            _assert_batches_equal(views, want)
    assert want.n > 0


def test_native_lazy_fetch_feeds_the_native_pileup(long_bam):
    """The lazy handle's decoded state is the returned window: the C++
    pileup over it equals the pileup over the same reads of a whole-file
    handle whose fetch took the whole chromosome."""
    from pisces_tpu_torch.io.bam import filter_batch
    lazy = native.open_bam(long_bam, lazy=True)
    batch = lazy.fetch_region(0, 100_000, 150_000, as_views=True)
    pc, _ = native.native_pileup(lazy, filter_batch(batch), 20, 5)
    whole = native.open_bam(long_bam)
    wb = whole.fetch(ref_id=0)
    keep = filter_batch(wb) & (wb.pos < 150_000) & (wb.end_pos >= 100_000)
    wpc, _ = native.native_pileup(whole, keep, 20, 5)
    np.testing.assert_array_equal(pc.block_keys, wpc.block_keys)
    np.testing.assert_array_equal(pc.counts_t, wpc.counts_t)


@pytest.mark.parametrize("prefer_native", [True, False])
def test_lazy_fetch_without_bai_raises(tmp_path, prefer_native):
    bam, _ = write_synthetic_workload(str(tmp_path / "w"), 1, 20_000, 2_000,
                                      seed=5)
    reader = native.open_bam(bam, prefer_native=prefer_native, lazy=True)
    assert reader.header.ref_names == ["chr1"]
    with pytest.raises(IOError, match=r"\.bai"):
        reader.fetch_region(0, 0, 1_000)


def test_whole_reader_region_fetch_needs_no_index(indexed):
    """A whole-file reader masks its chromosome, .bai or not, and the
    native one hands back a copy that the native pileup does not take."""
    whole = BamReader(indexed).fetch(ref_id=1)
    for prefer_native in (True, False):
        got = native.open_bam(indexed, prefer_native).fetch_region(
            1, 2_000, 2_500)
        _assert_batches_equal(got, _masked(whole, 2_000, 2_500))
        assert not got._from_native_handle
    for prefer_native in (True, False):
        lazy = native.open_bam(indexed, prefer_native, lazy=True)
        with pytest.raises(ValueError, match="fetch_region"):
            lazy.fetch(ref_id=0)
