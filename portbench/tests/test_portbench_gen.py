"""The generator: determinism, sizes against the traffic files, and a BAM
and .bai that the program's readers decode to the generated arrays."""
import json
import os

import numpy as np
import pytest

from portbench import gen
from portbench.run import load_cell

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


def test_bam_decodes_to_the_arrays(tmp_path):
    from pisces_tpu_torch.io.native import open_bam
    spec = {"chroms": ["c1", "c2"], "chrom_len": 40000,
            "reads_per_chrom": 20000, "read_len": 150,
            "profile": {"indel": 0.05, "softclip": 0.10, "low_q_tail": 0.2,
                        "tail_len": 15, "base_error": 0.001, "low_q": 12,
                        "high_q": 30},
            "germline": {"sites_per_kb": 1.0, "hom_share": 0.3}}
    s = gen.make_sample(spec, 99)
    p = gen.write_sample(str(tmp_path / "s"), s, threads=2)
    bam = open_bam(p["bam"], prefer_native=False)
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
    lazy = open_bam(p["bam"], lazy=True, prefer_native=False)
    ch = s.chroms[1]
    beg, end = 20000, 21000
    _l, _d, spans, _c = gen.class_layout(s.read_len)
    want = np.flatnonzero((ch.pos0 < end) & (ch.pos0 + spans[ch.cls] > beg))
    got = lazy.fetch_region(1, beg, end)
    assert np.array_equal(np.sort(got.pos.astype(np.int64)),
                          np.sort(ch.pos0[want]))


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
