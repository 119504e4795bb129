"""Stitched (XD) input on the native flow: the C++ decode's direction
column and deletion directions, and the columnar route (indel CIGAR walk,
native pileup with the directions, SNVs from the pass's mismatches, the
columnar caller) against the per-read candidate state machine that tagged
input took before.

Inputs: synthetic.write_stitched_workload (stitched reads over D and I
CIGARs, unstitched pairs without XD), the stitched_pairs read layout of
the benchmark (2x101 templates, stitched reads and mates, soft clips,
indels at any fragment offset, low-quality tails at both ends) and a
hand-built BAM whose XD strings put deletions at each edge of a stitched
segment, give a deletion's entries another direction than its flanks, run
short of the expanded CIGAR, and sit beside reads without XD and reads
that the keep mask drops. Candidates are held field by field, VCF and
gVCF bodies byte for byte (whole runs, both readers, -WindowSize,
-MaxThreads 2), and the port against pisces_tpu (-backend jax and numpy).
"""
import os
import re

import numpy as np
import pytest

import conftest  # noqa: F401  (keeps JAX on the CPU)
from test_torch_e2e import _run, device_everywhere  # noqa: F401
from test_torch_options import _four_runs, assert_port_calls

import pisces_tpu_torch.apps.pisces as torch_app
from pisces_tpu_torch import synthetic
from pisces_tpu_torch.domain.types import AlleleCategory
from pisces_tpu_torch.io import native
from pisces_tpu_torch.io.bam import BamReader, filter_batch
from pisces_tpu_torch.io.bam_write import BamWriter
from pisces_tpu_torch.io.fasta import Genome
from pisces_tpu_torch.pileup import directions
from pisces_tpu_torch.pileup.candidates import find_candidates_batch
from pisces_tpu_torch.pileup.candidates_fast import (
    aggregate_native_mismatches, find_indel_candidates,
)
from pisces_tpu_torch.utils.metrics import metrics

MIN_BQ, ANCHOR = 20, 5
XD_FLAGS = ["-UseStitchedXD", "true"]
BASES = np.frombuffer(b"ACGT", np.uint8)

# (CIGAR, XD) of the hand-built stitched reads; None: no XD tag
SHAPES = [
    ("30M2D30M", "30F2S30R"),      # deletion entries stitched, flanks F, R
    ("30M2D30M", "28F4S30R"),      # gap inside a stitched run
    ("30M2D30M", "30F32R"),        # entries reverse, left flank forward
    ("30M2D30M", "32F30R"),        # entries forward
    ("30M2D30M", "31F1S30R"),      # first entry forward, last stitched
    ("30M2D30M", "30F1S1R30R"),    # first stitched, last reverse
    ("30M2D30M", "29F1S2S30R"),    # left flank stitched: S-segment edge
    ("30M2D30M", "30F2S1S29R"),    # right flank stitched
    ("30M2D30M", "20F20S"),        # XD short of the read: last padded
    ("5S25M2D30M", "10F22S30R"),   # soft clip before the gap
    ("30M2D25M5S", "30F2S30R"),    # soft clip after it
    ("30M2I30M", "31F1S30R"),
    ("30M2I30M", "30F4S28R"),
    ("20M2D10M2I30M", "20F14S30R"),
    ("62M", "20F22S20R"),
    ("62M", "62F"),
    ("62M", None),
    ("30M2D30M", None),
]


def _handmade(tmp: str, n_reads: int = 2400, chrom_len: int = 3000,
              seed: int = 7):
    """Hand-built stitched BAM (Stitcher @PG line) and its genome."""
    rng = np.random.default_rng(seed)
    seq = BASES[rng.integers(0, 4, chrom_len)]
    synthetic._write_genome(os.path.join(tmp, "genome"), {"chr1": seq})
    sites = {int(s): BASES[(np.searchsorted(BASES, seq[s]) + 1) % 4]
             for s in rng.choice(np.arange(100, chrom_len - 100), 12,
                                 replace=False)}
    w = BamWriter(os.path.join(tmp, "h.bam"), ["chr1"], [chrom_len],
                  extra_header_text=synthetic.STITCHED_PG)
    for i in range(n_reads):
        cigar, xd = SHAPES[i % len(SHAPES)]
        ops = [(int(n), op) for n, op in re.findall(r"(\d+)([MIDS])", cigar)]
        span = sum(n for n, op in ops if op in "MD")
        p0 = int(rng.integers(1, chrom_len - span - 1))
        read, q0 = [], p0
        for n, op in ops:
            if op == "M":
                chunk = bytearray(seq[q0:q0 + n].tobytes())
                for k in range(n):
                    if q0 + k in sites and rng.random() < 0.1:
                        chunk[k] = sites[q0 + k]
                read.append(bytes(chunk))
                q0 += n
            elif op == "D":
                q0 += n
            else:
                read.append(BASES[rng.integers(0, 4, n)].tobytes())
        read = bytearray(b"".join(read))
        err = rng.random(len(read)) < 0.002
        for k in np.flatnonzero(err):
            read[k] = BASES[(np.searchsorted(BASES, read[k]) + 1) % 4]
        qual = [30] * len(read)
        if rng.random() < 0.2:
            qual[-8:] = [12] * 8
        if rng.random() < 0.1:
            qual[:6] = [12] * 6
        flag = int(rng.random() < 0.5) * 0x10
        mapq = 60
        if i % 97 == 0:
            mapq = 0          # dropped by the keep mask
        elif i % 89 == 0:
            flag |= 0x400     # a duplicate, dropped too
        w.add_read(f"h{i}", "chr1", p0 + 1, cigar, read.decode(), qual=qual,
                   flag=flag, mapq=mapq, tags={"XD": xd} if xd else None)
    w.write(index=True)
    return w.path, os.path.join(tmp, "genome")


def _layout_sample(tmp: str):
    """The benchmark's stitched_pairs layout at a small size, with more
    indels and clips than the cell's profile."""
    from portbench import gen
    layout = gen.load_layout({"reads": {"layout": "stitched_pairs"}})
    spec = {"chroms": ["c1", "c2"], "chrom_len": 5000,
            "reads_per_chrom": 5000, "mate_len": 101, "min_overlap": 10,
            "fragment": {"median": 180, "sigma": 0.3, "min": 111,
                         "max": 500},
            "profile": {"indel": 0.08, "softclip": 0.2, "low_q_tail": 0.2,
                        "tail_len": 15, "base_error": 0.002, "low_q": 12,
                        "high_q": 30},
            "somatic": {"vafs": [0.05, 0.1], "sites_per_vaf": 3}}
    p = layout.write_sample(tmp, layout.make_sample(spec, 2**31 + 5),
                            threads=2)
    return p["bam"], p["genome"]


_BUILT = {}


def _input(kind, tmp_path_factory):
    """(kind, folder, BAM, genome) of one stitched input, built once."""
    if kind not in _BUILT:
        tmp = str(tmp_path_factory.mktemp(f"xd_{kind}"))
        if kind == "synthetic":
            bam, genome = synthetic.write_stitched_workload(
                tmp, 9_000, 2_500, seed=11, index=True)
        elif kind == "layout":
            bam, genome = _layout_sample(tmp)
        else:
            bam, genome = _handmade(tmp)
        _BUILT[kind] = (kind, tmp, bam, genome)
    return _BUILT[kind]


@pytest.fixture(scope="module", params=["synthetic", "layout", "handmade"])
def stitched_input(request, tmp_path_factory):
    return _input(request.param, tmp_path_factory)


@pytest.fixture(scope="module", params=["layout", "handmade"])
def jax_input(request, tmp_path_factory):
    """The inputs that tests/test_torch_stitched.py does not already hold
    to pisces_tpu."""
    return _input(request.param, tmp_path_factory)


def _deletion_directions(batch, xd_tags):
    """support_direction(DELETION, ...) with the expanded maps, per D op of
    each read with an XD (-1 elsewhere): the state machine's rule."""
    out = np.full(len(batch.cigar_ops), -1, np.int8)
    for i in range(batch.n):
        xd = xd_tags[i]
        if not xd:
            continue
        s, e = batch.cigar_off[i], batch.cigar_off[i + 1]
        ops, lens = batch.cigar_ops[s:e], batch.cigar_lens[s:e]
        dm = directions.sequenced_direction_map(xd, ops, lens)
        exp = directions.expanded_maps(xd, ops, lens)
        start = 0
        for k, (op, ln) in enumerate(zip(ops, lens)):
            if op == 2:
                out[s + k] = directions.support_direction(
                    int(AlleleCategory.DELETION), dm, start, 1, *exp)
            if op in (0, 1, 4, 7, 8):
                start += int(ln)
    return out


def test_xd_column_matches_python(stitched_input):
    """The C++ decode's direction column and deletion directions against
    pileup/directions on the same batch, and the stitched-read count."""
    _kind, _tmp, bam, _genome = stitched_input
    reader = native.open_bam(bam)
    n_refs = len(reader.header.ref_names)
    n_del = n_edge = 0
    for ref_id in range(n_refs):
        batch = reader.fetch(ref_id, parse_tags=True, as_views=True)
        base_dirs, del_dirs, n_stitched = reader.xd_directions()
        pb = BamReader(bam).fetch(ref_id, parse_tags=True)
        assert batch.xd_tags == pb.xd_tags
        np.testing.assert_array_equal(
            base_dirs, directions.batch_base_directions(
                pb, np.ones(pb.n, bool)))
        keep = filter_batch(pb)
        want = directions.batch_base_directions(pb, keep)
        kept = np.repeat(keep, np.diff(pb.seq_off))
        np.testing.assert_array_equal(base_dirs[kept], want[kept])
        want_del = _deletion_directions(pb, pb.xd_tags)
        np.testing.assert_array_equal(del_dirs, want_del)
        assert n_stitched == sum(map(directions.has_stitched_segment,
                                     pb.xd_tags))
        n_del += int((want_del >= 0).sum())
        # deletions whose expanded entries give another direction than the
        # flanking bases' rule would
        for i in range(pb.n):
            xd = pb.xd_tags[i]
            s, e = pb.cigar_off[i], pb.cigar_off[i + 1]
            if not xd or 2 not in pb.cigar_ops[s:e]:
                continue
            ops, lens = pb.cigar_ops[s:e], pb.cigar_lens[s:e]
            dm = directions.sequenced_direction_map(xd, ops, lens)
            start = 0
            for k, (op, ln) in enumerate(zip(ops, lens)):
                if op == 2:
                    flank = directions.support_direction(
                        int(AlleleCategory.DELETION), dm, start, 1)
                    n_edge += int(flank != want_del[s + k])
                if op in (0, 1, 4, 7, 8):
                    start += int(ln)
    assert n_del > 20
    if _kind == "handmade":
        assert n_edge > 50


def _snapshot():
    snap = metrics.snapshot()
    return snap["counters"], snap["stages"]


def _candidates_by_key(cands, track):
    return {c.key(track): c for c in cands}


def test_native_route_candidates_match_state_machine(stitched_input):
    """Field by field: the columnar route's indels (with the C++ deletion
    directions) and SNVs (the native pass's mismatches with the C++
    direction column) against the per-read state machine's candidates."""
    _kind, _tmp, bam, genome = stitched_input
    reader = native.open_bam(bam)
    g = Genome(genome)
    for ref_id, name in enumerate(reader.header.ref_names):
        seq = g.get_chr_reference(name).sequence
        for track in (True, False):
            batch = reader.fetch(ref_id, parse_tags=True, as_views=True)
            keep = filter_batch(batch)
            base_dirs, del_dirs, _n = reader.xd_directions()
            indels = find_indel_candidates(
                name, seq, batch, keep, MIN_BQ, ANCHOR,
                track_open_ended=track, base_dirs=base_dirs,
                del_dirs=del_dirs)
            from pisces_tpu_torch.domain.types import BASE_TO_ALLELE
            from pisces_tpu_torch.pileup.counts import (
                candidate_anchor_positions,
            )
            _pc, mm = native.native_pileup(
                reader, keep, MIN_BQ, ANCHOR,
                candidate_anchor_positions(indels),
                ref_codes=BASE_TO_ALLELE[seq], track_open_ended=track,
                base_dirs=base_dirs)
            snvs = aggregate_native_mismatches(name, seq, *mm)
            got = indels + snvs.to_candidates()
            pb = BamReader(bam).fetch(ref_id, parse_tags=True)
            before, _ = _snapshot()
            want, _ = find_candidates_batch(name, seq, pb, filter_batch(pb),
                                            MIN_BQ, anchor_size=ANCHOR,
                                            track_open_ended=track)
            after, _ = _snapshot()
            assert (after["reads_state_machine"]
                    - before.get("reads_state_machine", 0)) == keep.sum()
            got_k = _candidates_by_key(got, track)
            want_k = _candidates_by_key(want, track)
            assert len(got) == len(got_k) and len(want) == len(want_k)
            assert set(got_k) == set(want_k)
            for k, w in want_k.items():
                c = got_k[k]
                assert c.category == w.category, k
                np.testing.assert_array_equal(
                    c.support_by_direction, w.support_by_direction,
                    err_msg=str(k))
                np.testing.assert_array_equal(
                    c.well_anchored_by_direction,
                    w.well_anchored_by_direction, err_msg=str(k))
                # untracked, the state machine keeps the open ends its first
                # read saw; the key leaves them out
                if track:
                    assert (c.open_on_left, c.open_on_right) == \
                        (w.open_on_left, w.open_on_right), k
            stitched_support = sum(int(c.support_by_direction[2])
                                   for c in got)
            assert stitched_support > 0
            assert any(c.category == AlleleCategory.DELETION
                       and c.support_by_direction[2] > 0 for c in got)


def _state_machine(monkeypatch):
    """Route tagged batches to the per-read state machine, as before the
    columnar route took them: every batch counts as read-collapsed."""
    monkeypatch.setattr(torch_app, "has_collapsed_tags", lambda tags: True)


def _python_reader(monkeypatch):
    monkeypatch.setattr(
        torch_app, "open_bam",
        lambda path, lazy=False: native.open_bam(path, prefer_native=False,
                                                 lazy=lazy))


def _vcf_files(out):
    """Every output VCF's bytes, headers but the date and command line."""
    got = {}
    for name in sorted(os.listdir(out)):
        if name.endswith(".vcf"):
            with open(os.path.join(out, name)) as f:
                got[name] = [ln for ln in f.read().splitlines()
                             if not ln.startswith(("##fileDate",
                                                   "##source",
                                                   "##reference",
                                                   "##cmdline",
                                                   "##Pisces_cmdline"))]
    return got


@pytest.mark.parametrize("gvcf", ["true", "false"])
@pytest.mark.parametrize("mode", ["whole", "python_reader", "window",
                                  "threads"])
def test_native_route_bytes_match_state_machine(stitched_input, monkeypatch,
                                                gvcf, mode):
    """VCF / gVCF bytes of the columnar route against the state machine's
    (native decode and counts, per-read candidates) in whole, windowed and
    threaded runs, and against the Python reader's flow; the counters say
    which route each run took."""
    kind, tmp, bam, genome = stitched_input
    extra = ["-device", "cpu", "-gVCF", gvcf, *XD_FLAGS]
    if mode == "window":
        extra += ["-WindowSize", "2000"]
    elif mode == "threads":
        extra += ["-MaxThreads", "2"]
    tag = f"{kind}_{mode}_{gvcf}"

    def run(out):
        c0, s0 = _snapshot()
        assert torch_app.main(["-bam", bam, "-g", genome,
                               "-o", os.path.join(tmp, out), *extra]) == 0
        c1, s1 = _snapshot()
        walked = c1.get("reads_state_machine", 0) - c0.get(
            "reads_state_machine", 0)
        stitched = c1.get("reads_stitched", 0) - c0.get("reads_stitched", 0)
        xd_s = s1.get("xd_directions", {"seconds": 0})["seconds"] - s0.get(
            "xd_directions", {"seconds": 0})["seconds"]
        return _vcf_files(os.path.join(tmp, out)), walked, stitched, xd_s

    if mode == "python_reader":
        _python_reader(monkeypatch)
        python_flow, walked, stitched, _s = run(f"p_{tag}")
        assert walked > 0 and stitched > 0   # the Python flow walks reads
        monkeypatch.undo()
        columnar, walked, _st, _s = run(f"c_{tag}")
        assert walked == 0
        assert columnar == python_flow
        return
    columnar, walked, stitched, xd_s = run(f"c_{tag}")
    assert walked == 0 and stitched > 0 and xd_s >= 0
    _state_machine(monkeypatch)
    per_read, walked, stitched2, _s = run(f"s_{tag}")
    assert walked > 0 and stitched2 == stitched
    assert columnar == per_read
    assert any(len(v) > 10 for v in columnar.values())


@pytest.mark.parametrize("gvcf", ["true", "false"])
def test_native_route_matches_jax(jax_input, device_everywhere, gvcf):
    """The port's columnar route against pisces_tpu (-backend jax and
    numpy), which walks stitched reads one by one."""
    _kind, tmp, bam, genome = jax_input
    port = _four_runs(tmp, f"jx{gvcf}", bam, genome, gvcf, XD_FLAGS)
    assert any(ln.split("\t")[4] != "." for ln in port)


def test_windowed_columnar_route_matches_whole(stitched_input):
    """A windowed run of the columnar route against the whole run (the
    reference-line SB held as the port's other windowed runs hold it)."""
    kind, tmp, bam, genome = stitched_input
    whole = _run(torch_app.main, bam, genome, os.path.join(tmp, "ww"),
                 "true", ["-device", "cpu", "-backend", "numpy", *XD_FLAGS])
    port = _run(torch_app.main, bam, genome, os.path.join(tmp, "wt"), "true",
                ["-device", "cpu", "-WindowSize", "2000", *XD_FLAGS])
    host = _run(torch_app.main, bam, genome, os.path.join(tmp, "wn"), "true",
                ["-device", "cpu", "-backend", "numpy", "-WindowSize",
                 "2000", *XD_FLAGS])
    assert_port_calls(port, host, whole)


@pytest.mark.parametrize("kind", ["collapsed", "amplicon"])
def test_collapsed_and_amplicon_input_keep_the_state_machine(tmp_path, kind):
    """Read-collapsed (XV/XW) and amplicon (-abfilter, XN) input still
    finds its candidates read by read: the counter shows it."""
    tmp = str(tmp_path)
    if kind == "collapsed":
        bam, genome = synthetic.write_collapsed_workload(tmp, 4_000, 1_200,
                                                         seed=3)
        flags = ["-ReportRcCounts", "true"]
    else:
        bam, genome = synthetic.write_amplicon_workload(tmp, 6, depth=80,
                                                        seed=3)
        flags = ["-abfilter", "0.01"]
    batch = native.open_bam(bam).fetch(0, parse_tags=True)
    assert native.has_collapsed_tags(batch.extra_tags) == (kind ==
                                                           "collapsed")
    c0, _ = _snapshot()
    assert torch_app.main(["-bam", bam, "-g", genome, "-o",
                           os.path.join(tmp, "o"), "-device", "cpu",
                           *flags]) == 0
    c1, _ = _snapshot()
    assert c1["reads_state_machine"] - c0.get("reads_state_machine", 0) > 0


def test_tag_columns_build_no_dict_until_read(stitched_input):
    """A native tagged batch holds its tags as columns: equal to the Python
    reader's lists, read a read at a time, with no read-collapsed tag."""
    _kind, _tmp, bam, _genome = stitched_input
    batch = native.open_bam(bam).fetch(0, parse_tags=True)
    want = BamReader(bam).fetch(0, parse_tags=True)
    assert isinstance(batch.extra_tags, native.TagDicts)
    assert not native.has_collapsed_tags(batch.extra_tags)
    assert not any(k in t for t in want.extra_tags
                   for k in ("XR", "XU", "XV", "XW"))
    assert batch.extra_tags == want.extra_tags
    assert batch.xd_tags == want.xd_tags and batch.xn_tags == want.xn_tags
    assert batch.xd_tags[-1] == want.xd_tags[-1]
    assert batch.xd_tags[2:9] == want.xd_tags[2:9]
    assert list(batch.xd_tags) + [] == batch.xd_tags + []
    with pytest.raises(IndexError):
        batch.xd_tags[batch.n]
