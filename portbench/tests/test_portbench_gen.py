"""The generator: determinism, sizes against the traffic files, and a BAM
and .bai that the program's readers decode to the generated arrays."""
import json
import os

import numpy as np
import pytest

from portbench import gen
from portbench.reference import compare, scoring
from portbench.run import load_cell
from portbench.tests.conftest import (PAIRED_READS, PAIRED_TRAFFIC,
                                      SMALL_CELLS, add_paired_layout,
                                      make_root)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


def _scaled(spec, k):
    s = dict(spec)
    s["chrom_len"] = spec["chrom_len"] // k
    s["reads_per_chrom"] = spec["reads_per_chrom"] // k
    return s


@pytest.mark.parametrize("cell", _cells())
def test_traffic_sizes_match(cell):
    c = load_cell(cell, ROOT)
    t, conf = c["traffic"], c["config"]
    spec = gen.sample_spec(conf, t)
    n = len(spec["chroms"]) * spec["reads_per_chrom"]
    assert n == t["reads"]
    depth = spec["reads_per_chrom"] * spec["read_len"] / spec["chrom_len"]
    assert abs(depth - t["depth"]) / t["depth"] < 0.01
    # a hundredth of the cell: exact read counts a chromosome, same depth
    small = gen.make_sample(_scaled(spec, 100), 11)
    assert [len(ch.pos0) for ch in small.chroms] == \
        [spec["reads_per_chrom"] // 100] * len(spec["chroms"])
    assert small.read_len == spec["read_len"]


def test_same_seed_same_sample(tmp_path):
    c = load_cell("somatic_panel.one_chr", ROOT)
    spec = _scaled(gen.sample_spec(c["config"], c["traffic"]), 50)
    a = gen.make_sample(spec, 2**31 + 5)
    b = gen.make_sample(spec, 2**31 + 5)
    d = gen.make_sample(spec, 2**31 + 6)
    for x, y, z in zip(a.chroms, b.chroms, d.chroms):
        for k in ("seq", "pos0", "cls", "rev", "dip", "reads"):
            assert np.array_equal(getattr(x, k), getattr(y, k))
        assert not np.array_equal(x.reads, z.reads)
    pa = gen.write_sample(str(tmp_path / "a"), a, threads=4)
    pb = gen.write_sample(str(tmp_path / "b"), b, threads=2)
    for key in ("bam",):
        with open(pa[key], "rb") as f1, open(pb[key], "rb") as f2:
            assert f1.read() == f2.read()
    with open(pa["bam"] + ".bai", "rb") as f1, \
            open(pb["bam"] + ".bai", "rb") as f2:
        assert f1.read() == f2.read()


@pytest.mark.parametrize("native", [False, True])
def test_bam_decodes_to_the_arrays(tmp_path, small_root, native):
    """The program's Python and native readers decode each layout's BAM to
    its arrays: the single-end layout's, and the paired layout's flags,
    mate fields, CIGARs and XD tags."""
    from pisces_tpu_torch.io.native import open_bam
    spec = {"chroms": ["c1", "c2"], "chrom_len": 40000,
            "reads_per_chrom": 20000, "read_len": 150,
            "profile": {"indel": 0.05, "softclip": 0.10, "low_q_tail": 0.2,
                        "tail_len": 15, "base_error": 0.001, "low_q": 12,
                        "high_q": 30},
            "germline": {"sites_per_kb": 1.0, "hom_share": 0.3}}
    s = gen.make_sample(spec, 99)
    p = gen.write_sample(str(tmp_path / "s"), s, threads=2)
    bam = open_bam(p["bam"], prefer_native=native)
    for ref_id, ch in enumerate(s.chroms):
        batch = bam.fetch(ref_id=ref_id)
        assert batch.n == len(ch.pos0)
        assert np.array_equal(batch.pos.astype(np.int64), ch.pos0)
        assert np.array_equal((batch.flag & 16) != 0, ch.rev)
        seq = batch.seq.reshape(batch.n, s.read_len)
        codes = np.frombuffer(b"AGCT", np.uint8)
        assert np.array_equal(codes[seq], ch.reads)
        q = batch.qual.reshape(batch.n, s.read_len)
        assert np.array_equal(q, gen.qualities(s, ch))
    # the .bai serves a window's reads: every read overlapping it
    lazy = open_bam(p["bam"], lazy=True, prefer_native=native)
    ch = s.chroms[1]
    beg, end = 20000, 21000
    _l, _d, spans, _c = gen.class_layout(s.read_len)
    want = np.flatnonzero((ch.pos0 < end) & (ch.pos0 + spans[ch.cls] > beg))
    got = lazy.fetch_region(1, beg, end)
    assert np.array_equal(np.sort(got.pos.astype(np.int64)),
                          np.sort(ch.pos0[want]))

    layout = gen.load_layout({"reads": {"layout": add_paired_layout(
        small_root)}}, small_root)
    spec = dict(PAIRED_READS, **{k: PAIRED_TRAFFIC[k] for k in (
        "chroms", "chrom_len", "reads_per_chrom")})
    s = layout.make_sample(spec, 2**31 + 77)
    p = layout.write_sample(str(tmp_path / "paired"), s, threads=2)
    bam = open_bam(p["bam"], prefer_native=native)
    assert "Stitcher" in bam.header.text and bam.header.source_is_stitched
    for ref_id, ch in enumerate(s.chroms):
        batch = bam.fetch(ref_id=ref_id, parse_tags=True)
        lens = np.diff(ch.off)
        assert batch.n == len(ch.pos0) and set(lens.tolist()) == {100, 150}
        assert np.array_equal(batch.pos.astype(np.int64), ch.pos0)
        assert batch.flag.tolist() == [(0, 99, 147)[k] for k in ch.kind]
        paired = ch.kind > 0
        assert np.array_equal(batch.mate_ref_id,
                              np.where(paired, ref_id, -1))
        assert np.array_equal(batch.mate_pos.astype(np.int64), ch.mate_pos0)
        assert np.array_equal(np.diff(batch.cigar_off), np.ones(batch.n))
        assert np.array_equal(batch.cigar_ops, np.zeros(batch.n))
        assert np.array_equal(batch.cigar_lens, lens)
        assert batch.xd_tags == [layout.XD[k] for k in ch.kind]
        assert np.array_equal(np.frombuffer(b"AGCT", np.uint8)[batch.seq],
                              ch.reads)
        assert np.array_equal(batch.qual, ch.qual)


def test_intervals_cover_each_chromosome(tmp_path):
    spec = {"chroms": ["a", "b"], "chrom_len": 3000, "reads_per_chrom": 500,
            "read_len": 100,
            "profile": {"indel": 0.01, "softclip": 0.1, "low_q_tail": 0.2,
                        "tail_len": 15, "base_error": 0.001, "low_q": 12,
                        "high_q": 30}}
    p = gen.write_sample(str(tmp_path / "s"), gen.make_sample(spec, 1))
    with open(p["intervals"]) as f:
        rows = [line.split("\t")[:3] for line in f if not line.startswith("@")]
    assert rows == [["a", "1", "3000"], ["b", "1", "3000"]]


# sha256 over the files that generate_inputs writes (sample/ and warm-up/:
# the BAM, its .bai, genome/ and intervals.picard) and the rendered body
# the reference expects, as the single-end generator wrote them before
# read layouts existed; the cells' own traffic cut to a fiftieth, the small
# cells whole
DIGESTS = {
    ("somatic_panel.two_chr", 1):
        "042e9b94b699e228bfdfa019e47a200a94bd5f079ee79cefe8613978124ef455",
    ("somatic_panel.two_chr", 2147483655):
        "5b92d76cb579b4f9d651e0ea699a93f2558cceda9b5203e68f9a060ed104b5bc",
    ("somatic_panel.two_chr", 3000000001):
        "f2c038bff086f7a30b044ea8d1a7416d60c0ac55b469f334007a3a67df827420",
    ("germline_wgs.35x", 1):
        "3185f6ccd7b4b2b777b1404ecb9ecab27cd2c40c26f443573510791c09464f64",
    ("germline_wgs.35x", 2147483655):
        "12f168d79677ffdf51b6fc423e0201aa4897f58c328681eb2ba9552e586b3806",
    ("germline_wgs.35x", 3000000001):
        "06f0c9aacfedc642c223c5b90d5d6d8f364aba210e8ec4bce55ca8e2469de955",
    ("somatic_panel.one_chr", 1):
        "c7ba0501604240cfde7d580d917f2eebe2e3d24d703d8045c58f914bdcfaee06",
    ("somatic_panel.one_chr", 2147483655):
        "ba0e64e2a079c513f0b3744662328cab9403dc11cf19504956e31c486ef3d254",
    ("somatic_panel.one_chr", 3000000001):
        "74d7ff54c7ce996addb171b29c40c3728ba9ebd5fbb79a0bd53309d9ca6cac80",
    ("small.panel", 1):
        "0a65cd2feeec3b4682f995f069e094508d4747f7fa30509fa7ce6577ff843704",
    ("small.panel", 2147483655):
        "ef4ade012680491053c9ac6c8adc5badfa7d97458e2d348d5bf10ff32bbcf545",
    ("small.panel", 3000000001):
        "87f9096ca78e6defad2f5a7cbba4d92a7e20cadbc0d4638ffd727305c77199eb",
    ("small.wgs", 1):
        "e055759caf7007e76574fab4a89fb5a082095803f3f460a0480ff86de99e1bca",
    ("small.wgs", 2147483655):
        "51c3ed53bb5f15cb80ceeac38a3d03538ba0b7d1ed50f5ad49c2a17823df31a8",
    ("small.wgs", 3000000001):
        "12090210a4eb2ef403462db859a55cb1f51ac73564511f3c3db4e715d35613bf",
}


def _traffic_cut(traffic: dict, k: int) -> dict:
    t = _scaled(traffic, k)
    if isinstance(t["warmup"], dict):
        t["warmup"] = _scaled(t["warmup"], k)
    return t


@pytest.mark.parametrize("cell,seed", list(DIGESTS))
def test_default_layout_writes_what_it_wrote(tmp_path, cell, seed):
    """The single-end layout, taken where a configuration names none,
    writes byte for byte the inputs and expects the body that the
    generator did before layouts."""
    import hashlib
    small = cell in SMALL_CELLS
    root = make_root(str(tmp_path / "root")) if small else ROOT
    c = load_cell(cell, root)
    traffic = c["traffic"] if small else _traffic_cut(c["traffic"], 50)
    out = str(tmp_path / "inputs")
    gen.generate_inputs(c["config"], traffic, seed, out, root)
    h = hashlib.sha256()
    for dirpath, _dirs, files in sorted(os.walk(out)):
        for name in sorted(files):
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                h.update(os.path.relpath(path, out).encode() + b"\0"
                         + hashlib.sha256(f.read()).digest())
    layout = gen.load_layout(c["config"], root)
    assert layout.__name__ == "portbench_layout_single_end"
    cal = c["config"]["calling"]
    sample = layout.make_sample(gen.sample_spec(c["config"], traffic), seed)
    body = compare.render(compare.expected_body(sample, layout.counts, cal,
                                                scoring.F64), cal["q_filter"])
    h.update(b"body\0" + hashlib.sha256(body.encode()).digest())
    assert h.hexdigest() == DIGESTS[(cell, seed)]
