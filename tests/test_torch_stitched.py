"""Tagged input in the port against the reference package (ROADMAP Queue 1
item 7.3): stitched reads with XD per-base directions (-UseStitchedXD),
read-collapsed reads with XV/XW/XR (-ReportRcCounts) and the tag decode of
both read flows.

Module parity: the same batch through pileup/directions, pileup/collapsed
and the native pileup with base_dirs and a non-default block size gives the
reference's outputs exactly. End to end, the CLI bodies are held as
tests/test_torch_options.py holds them (assert_port_calls), on both read
flows, and a stitched gVCF run must hand the tuple kernel tuples whose
stitched columns are non-zero.
"""
import os

import numpy as np
import pytest

import conftest  # noqa: F401  (keeps JAX on the CPU)
from test_torch_e2e import device_everywhere, flow  # noqa: F401
from test_torch_options import _four_runs

import pisces_tpu_torch.apps.pisces as torch_app
from pisces_tpu_torch import synthetic
from pisces_tpu_torch.io import native
from pisces_tpu_torch.io.bam import BamReader, filter_batch
from pisces_tpu_torch.io.fasta import Genome
from pisces_tpu_torch.pileup import collapsed, directions

MIN_BQ, ANCHOR = 20, 5


@pytest.fixture(scope="module")
def stitched(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("xd"))
    bam, genome = synthetic.write_stitched_workload(tmp, 12_000, 3_000,
                                                    seed=2, index=True)
    return tmp, bam, genome


@pytest.fixture(scope="module")
def umi(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("rc"))
    bam, genome = synthetic.write_collapsed_workload(tmp, 10_000, 3_000,
                                                     seed=4, index=True)
    return tmp, bam, genome


def _jax_batch(bam):
    from pisces_tpu.io.bam import BamReader as JReader
    return JReader(bam).fetch(0, parse_tags=True)


@pytest.mark.parametrize("kind", ["stitched", "amplicon", "collapsed"])
def test_tag_decode_matches_jax(tmp_path, kind):
    """xd/xn/extra tags of the Python reader and the native reader (whole
    and lazy region fetches) against the reference's Python reader; and
    parse_all_tags on every record."""
    from pisces_tpu.io.bam import BamReader as JReader
    tmp = str(tmp_path)
    bam = {"stitched": lambda: synthetic.write_stitched_workload(
               tmp, 6_000, 800, seed=1, index=True),
           "amplicon": lambda: synthetic.write_amplicon_workload(
               tmp, 6, depth=80, seed=1, index=True),
           "collapsed": lambda: synthetic.write_collapsed_workload(
               tmp, 6_000, 1_500, seed=1, index=True)}[kind]()[0]
    want = _jax_batch(bam)
    batches = [BamReader(bam).fetch(0, parse_tags=True),
               native.open_bam(bam).fetch(0, parse_tags=True),
               native.open_bam(bam, lazy=True).fetch_region(
                   0, 0, 10**6, parse_tags=True),
               BamReader(bam, lazy=True).fetch_region(0, 0, 10**6,
                                                      parse_tags=True)]
    for got in batches:
        assert got.n == want.n
        assert got.xd_tags == want.xd_tags
        assert got.xn_tags == want.xn_tags
        assert got.extra_tags == want.extra_tags
    assert any(t for t in want.extra_tags)
    r, jr = BamReader(bam), JReader(bam)
    offs = r._scan_record_offsets()
    for i in range(0, len(offs) - 1, 7):
        off = int(offs[i])
        size = int.from_bytes(r._data[off:off + 4], "little")
        l_name = r._data[off + 12]
        n_cig = int.from_bytes(r._data[off + 16:off + 18], "little")
        l_seq = int.from_bytes(r._data[off + 20:off + 24], "little")
        p = off + 36 + l_name + 4 * n_cig + (l_seq + 1) // 2 + l_seq
        assert (BamReader.parse_all_tags(r._data, p, off + 4 + size)
                == jr.parse_all_tags(jr._data, p, off + 4 + size))


def test_directions_match_jax(stitched):
    from pisces_tpu.pileup import directions as jdirs
    _tmp, bam, _genome = stitched
    batch = BamReader(bam).fetch(0, parse_tags=True)
    keep = filter_batch(batch)
    got = directions.batch_base_directions(batch, keep)
    np.testing.assert_array_equal(
        got, jdirs.batch_base_directions(_jax_batch(bam), keep))
    assert (got == 2).sum() > 1000
    rng = np.random.default_rng(0)
    n = 0
    for i in np.flatnonzero([bool(x) for x in batch.xd_tags])[::5]:
        xd = batch.xd_tags[i]
        s, e = batch.cigar_off[i], batch.cigar_off[i + 1]
        ops, lens = batch.cigar_ops[s:e], batch.cigar_lens[s:e]
        dm = directions.sequenced_direction_map(xd, ops, lens)
        np.testing.assert_array_equal(
            dm, jdirs.sequenced_direction_map(xd, ops, lens))
        exp = directions.expanded_maps(xd, ops, lens)
        jexp = jdirs.expanded_maps(xd, ops, lens)
        for a, b in zip(exp, jexp):
            np.testing.assert_array_equal(a, b)
        for cat in range(6):
            for alt_len in (1, 2, 3):
                # starts where the allele lies inside the read
                for start in rng.integers(0, len(dm) - alt_len, 4).tolist():
                    for ex in ((None, None), exp):
                        assert (directions.support_direction(
                            cat, dm, start, alt_len, *ex)
                            == jdirs.support_direction(
                                cat, dm, start, alt_len, *ex))
                        n += 1
    assert n > 1000


def test_collapsed_totals_match_jax(umi, stitched):
    from pisces_tpu.pileup import collapsed as jcol
    for tmp, bam, _genome in (umi, stitched):
        batch = BamReader(bam).fetch(0, parse_tags=True)
        keep = filter_batch(batch)
        jbatch = _jax_batch(bam)
        for base_dirs in (None, directions.batch_base_directions(batch,
                                                                  keep)):
            got = collapsed.collapsed_total_counts(batch, keep, MIN_BQ,
                                                   base_dirs)
            want = jcol.collapsed_total_counts(jbatch, keep, MIN_BQ,
                                               base_dirs)
            assert sorted(got) == sorted(want)
            for pos in got:
                np.testing.assert_array_equal(got[pos], want[pos])
        if bam == umi[1]:
            assert len(got) > 5_000
    for flag in (0x1 | 0x2 | 0x40, 0x1 | 0x2 | 0x80 | 0x10, 0x10, 0):
        for xr in (None, "FR", "RF", "FF"):
            assert (collapsed.pair_direction(flag, xr)
                    == jcol.pair_direction(flag, xr))
            for d in range(3):
                for dup in (False, True):
                    np.testing.assert_array_equal(
                        collapsed.candidate_collapsed_counts(
                            d, dup, collapsed.pair_direction(flag, xr)),
                        jcol.candidate_collapsed_counts(
                            d, dup, jcol.pair_direction(flag, xr)))


@pytest.mark.parametrize("block_size", [1000, 333])
def test_native_pileup_with_base_dirs_matches_jax(stitched, block_size):
    """The port's native pass with base_dirs and a block size other than
    REGION_SIZE against the reference's native pass and the port's own
    Python event build on the same batch."""
    from pisces_tpu.io.native import NativeBamReader as JNative
    from pisces_tpu.io.native import native_pileup as jnative_pileup
    from pisces_tpu_torch.pileup.counts import (
        build_counts_host, candidate_anchor_positions,
    )
    from pisces_tpu_torch.pileup.events import build_base_events
    _tmp, bam, genome = stitched
    seq = Genome(genome).get_chr_reference("chr1").sequence
    reader = native.open_bam(bam)
    batch = reader.fetch(0, parse_tags=True, as_views=True)
    keep = filter_batch(batch)
    base_dirs = directions.batch_base_directions(batch, keep)
    cands, _ = torch_app.find_candidates_batch(
        "chr1", seq, batch, keep, MIN_BQ, anchor_size=ANCHOR)
    anchors = candidate_anchor_positions(cands)
    pc, _ = native.native_pileup(reader, keep, MIN_BQ, ANCHOR, anchors,
                                 block_size=block_size, base_dirs=base_dirs)
    jreader = JNative(bam)
    jreader.fetch(0, parse_tags=True, as_views=True)
    jpc, _ = jnative_pileup(jreader, keep, MIN_BQ, ANCHOR, block_size,
                            anchors, base_dirs)
    host = build_counts_host(
        build_base_events(batch, keep, MIN_BQ, ANCHOR, base_dirs=base_dirs),
        block_size, ANCHOR, anchors)
    for k in ("block_keys", "counts_t", "anchored_positions",
              "anchored_counts"):
        np.testing.assert_array_equal(getattr(pc, k), getattr(jpc, k), k)
        np.testing.assert_array_equal(getattr(pc, k), getattr(host, k), k)
    np.testing.assert_array_equal(pc.qual_t, jpc.qual_t)
    assert pc.counts_t.shape[1] == block_size
    assert pc.counts_t[..., 2].sum() > 10_000   # stitched-direction counts
    with pytest.raises(ValueError, match="base_dirs"):
        native.native_pileup(reader, keep, MIN_BQ, ANCHOR, anchors,
                             base_dirs=base_dirs[:-1])


@pytest.fixture
def kernel_tuples(monkeypatch):
    """The tuples each call of the port's tuple-kernel wrapper gets."""
    from pisces_tpu_torch.ops import scoring_kernels
    seen = []
    fn = scoring_kernels.score_reference_tuples

    def spy(tuples, *a, **k):
        seen.append(tuples.cpu().numpy().copy())
        return fn(tuples, *a, **k)

    monkeypatch.setattr(scoring_kernels, "score_reference_tuples", spy)
    return seen


@pytest.mark.parametrize("gvcf", ["true", "false"])
def test_stitched_xd_matches_jax(stitched, device_everywhere, flow, gvcf,
                                 kernel_tuples):
    tmp, bam, genome = stitched
    port = _four_runs(tmp, f"s{gvcf}{flow}", bam, genome, gvcf,
                      ["-UseStitchedXD", "true"])
    assert any("\tPASS\t" in ln and ln.split("\t")[4] != "." for ln in port)
    if gvcf == "true":
        assert len(kernel_tuples) == 1
        t = kernel_tuples[0]
        assert (t[:, 2] > 0).sum() > 100 and (t[:, 5] > 0).sum() > 100


def test_stitched_run_counts_natively_with_base_dirs(stitched, monkeypatch):
    """On the native reader a stitched run counts in the C++ pass with the
    XD directions (the reference's rule: tagged batches find candidates
    per read, then count natively), and equals the Python flow's body."""
    tmp, bam, genome = stitched
    calls = []
    fn = torch_app.native_pileup

    def spy(*a, **k):
        calls.append(k.get("base_dirs") is not None)
        return fn(*a, **k)

    monkeypatch.setattr(torch_app, "native_pileup", spy)
    args = ["-bam", bam, "-g", genome, "-gVCF", "true", "-device", "cpu",
            "-UseStitchedXD", "true"]
    assert torch_app.main([*args, "-o", os.path.join(tmp, "nat")]) == 0
    assert calls == [True]
    monkeypatch.setattr(
        torch_app, "open_bam",
        lambda path: native.open_bam(path, prefer_native=False))
    assert torch_app.main([*args, "-o", os.path.join(tmp, "py")]) == 0
    assert calls == [True]

    def body(d):
        with open(os.path.join(tmp, d, "b.genome.vcf")) as f:
            return [ln for ln in f if not ln.startswith("#")]

    assert body("nat") == body("py")


@pytest.mark.parametrize("gvcf", ["true", "false"])
@pytest.mark.parametrize("rc", ["true", "false"])
def test_read_collapsed_matches_jax(umi, device_everywhere, flow, gvcf, rc):
    tmp, bam, genome = umi
    port = _four_runs(tmp, f"r{gvcf}{rc}{flow}", bam, genome, gvcf,
                      ["-ReportRcCounts", rc])
    variants = [ln for ln in port if ln.split("\t")[4] != "."]
    assert variants
    if rc == "true":
        assert all(ln.split("\t")[8].endswith(":US") for ln in variants)


@pytest.mark.parametrize("kind", ["stitched", "umi"])
def test_tagged_windows_match_jax(stitched, umi, device_everywhere, kind):
    """Tagged input through -WindowSize: each window's lazy region fetch
    decodes the tags (native and Python readers alike)."""
    from pisces_tpu.apps.pisces import main as jax_main
    from test_torch_e2e import _run
    from test_torch_options import assert_port_calls
    tmp, bam, genome = stitched if kind == "stitched" else umi
    flags = (["-UseStitchedXD", "true"] if kind == "stitched"
             else ["-ReportRcCounts", "true", "-gVCF", "false"])
    gvcf = "false" if "-gVCF" in flags else "true"
    flags = [f for f in flags if f not in ("-gVCF", "false")]
    args = (bam, genome)
    whole = _run(torch_app.main, *args, os.path.join(tmp, "ww"), gvcf,
                 ["-device", "cpu", "-backend", "numpy", *flags])
    port = _run(torch_app.main, *args, os.path.join(tmp, "wt"), gvcf,
                ["-device", "cpu", "-WindowSize", "3000", *flags])
    ref = _run(jax_main, *args, os.path.join(tmp, "wj"), gvcf,
               ["-backend", "numpy", "-WindowSize", "3000", *flags])
    assert_port_calls(port, ref, whole)
