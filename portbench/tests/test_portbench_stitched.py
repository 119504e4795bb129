"""The stitched_pairs read layout and a small copy of the
stitched_panel.one_chr cell: the layout's counts against a per-read walk
of the BAM it writes, a run through run.py that reads correct on the CPU,
and the control, which must not at that size."""
import json
import os
import re

import numpy as np
import pytest

from portbench import control, gen, run

SEED = 2**31 + 321
CELL = "stitched_panel.one_chr"
# one 10 kb chromosome at about 750x, the cell's depth, with its own
# smaller warm-up sample
SMALL_STITCHED = {"why": "one 10 kb chromosome at about 750x", "depth": 750,
                  "reads": 61500, "chroms": ["s1"], "chrom_len": 10000,
                  "reads_per_chrom": 43000,
                  "warmup": {"chroms": ["sw"], "chrom_len": 4000,
                             "reads_per_chrom": 17200}}
ALLELE = {ord("A"): 0, ord("G"): 1, ord("C"): 2, ord("T"): 3}
XD_DIR = {"F": 0, "R": 1, "S": 2}


def _config():
    with open(os.path.join(run.ROOT, "portbench", "configs",
                           "stitched_panel.json")) as f:
        return json.load(f)


def _walk_counts(bam, seq_len, min_bq):
    """[seq_len + 1, 6, 3] counts from the BAM a read at a time: the XD
    expanded and laid over the CIGAR (D entries skipped, a short XD
    padded with its last direction), each aligned base at its direction,
    N under min_bq, each deleted base at the next base's direction when
    the bases on both sides pass min_bq."""
    from pisces_tpu_torch.io.bam import BamReader
    b = BamReader(bam).fetch(0, parse_tags=True)
    out = np.zeros((seq_len + 1, 6, 3), np.int64)
    letters = np.frombuffer(b"AGCTN", np.uint8)
    for i in range(b.n):
        ops = b.cigar_ops[b.cigar_off[i]:b.cigar_off[i + 1]].tolist()
        lens = b.cigar_lens[b.cigar_off[i]:b.cigar_off[i + 1]].tolist()
        bases = letters[b.seq[b.seq_off[i]:b.seq_off[i + 1]]]
        qual = b.qual[b.seq_off[i]:b.seq_off[i + 1]]
        expanded = [XD_DIR[d] for n, d in re.findall(r"(\d+)([FRS])",
                                                     b.xd_tags[i])
                    for _ in range(int(n))]
        dirs, e = [], 0
        for op, ln in zip(ops, lens):
            if op in (0, 1, 4):
                for k in range(ln):
                    dirs.append(expanded[min(e + k, len(expanded) - 1)])
                e += ln
            elif op == 2:
                e += ln
        pos, col = int(b.pos[i]) + 1, 0
        for op, ln in zip(ops, lens):
            if op == 0:
                for k in range(ln):
                    a = ALLELE.get(int(bases[col + k]), 4)
                    if qual[col + k] < min_bq:
                        a = 4
                    out[pos + k, a, dirs[col + k]] += 1
                pos += ln
                col += ln
            elif op == 2:
                if qual[col] >= min_bq and qual[col - 1] >= min_bq:
                    out[pos:pos + ln, 5, dirs[col]] += 1
                pos += ln
            else:
                col += ln
    return out, b


def test_counts_match_a_per_read_walk(tmp_path):
    layout = gen.load_layout(_config())
    spec = gen.sample_spec(_config(), {"chroms": ["w1"], "chrom_len": 4000,
                                       "reads_per_chrom": 6000})
    spec["profile"] = dict(spec["profile"], indel=0.1, softclip=0.2)
    s = layout.make_sample(spec, SEED)
    p = layout.write_sample(str(tmp_path / "w"), s, threads=2)
    ch = s.chroms[0]
    for min_bq in (20, 10):
        want, batch = _walk_counts(p["bam"], len(ch.seq), min_bq)
        np.testing.assert_array_equal(layout.counts(s, ch, min_bq), want)
    assert batch.n == len(ch.pos0)
    kinds = np.bincount(ch.kind, minlength=3)
    assert kinds[0] > 0 and kinds[1] == kinds[2] > 0
    assert want[..., 2].sum() > 0 and want[:, 5, :].sum() > 0
    for op in (1, 2, 4):
        assert (batch.cigar_ops == op).any(), op
    # the aligned bases are the reference's but for sites and errors
    lut = np.zeros(256, np.int64)
    for c, a in ALLELE.items():
        lut[c] = a
    cov = want[1:, :4, :].sum(axis=2)
    agree = cov[np.arange(len(ch.seq)), lut[ch.seq]].sum()
    assert agree > 0.98 * cov.sum()


def test_fragment_lengths_and_stitch_rule():
    layout = gen.load_layout(_config())
    cfg = _config()
    spec = gen.sample_spec(cfg, {"chroms": ["f1"], "chrom_len": 60000,
                                 "reads_per_chrom": 40000})
    ch = layout.make_sample(spec, 7).chroms[0]
    frag = ch.frag[ch.kind != 2]          # one a template
    assert frag.min() >= 111 and frag.max() <= 500
    # the log-normal's median 180, kept to 111-500: the lengths' own median
    # is 184, their 5-95 % range 123-297
    q5, q50, q95 = np.percentile(frag, [5, 50, 95])
    assert abs(q50 - 184) <= 3 and abs(q5 - 123) <= 4 and abs(q95 - 297) <= 6
    stitched = ch.kind == 0
    assert (ch.frag[stitched] <= 192).all()
    assert (ch.frag[~stitched] > 192).all()
    share = stitched.sum() / (ch.kind != 2).sum()
    assert 0.53 < share < 0.61
    values, which = layout.xd_strings(ch)
    plain = stitched & (ch.mid == 0)
    f = ch.frag[plain]
    want = [f"{x - 101}F{202 - x}S{x - 101}R" for x in f.tolist()]
    assert [values[w] for w in which[plain]] == want


def _small_root(small_root):
    """The small root with the stitched cell: its traffic, and the real
    cell's metrics listing it."""
    with open(os.path.join(small_root, "portbench", "traffic",
                           "small_stitched.json"), "w") as f:
        json.dump(SMALL_STITCHED, f)
    with open(os.path.join(small_root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        real = json.load(f)
    bench["workloads"].append({"name": "small.stitched",
                               "config": "stitched_panel",
                               "traffic": "small_stitched", "chips": 1,
                               "why": "small"})
    for section in ("end_to_end", "per_layer"):
        listed = {m["name"] for m in real[section]
                  if CELL in m.get("workloads", [])}
        for m in bench[section]:
            if m["name"] in listed:
                m["workloads"].append("small.stitched")
    with open(os.path.join(small_root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return small_root


def test_small_stitched_cell_is_correct(small_root):
    root = _small_root(small_root)
    r = run.run_cell("small.stitched", SEED, 1.0, True, device="cpu",
                     root=root)
    assert r["correct"] is True, r["checks"]
    assert r["checks"]["lines_compared"]["value"] == 10000
    assert r["checks"]["line_mismatches"]["value"] == 0
    m = r["metrics"]
    assert m["state_machine_read_pct"]["value"] == 0.0
    assert m["xd_directions_s_per_Mread"]["value"] > 0
    assert m["reads_per_s.one_job"]["value"] > 0
    assert m["pileup_s_per_Mread.one_job"]["value"] > 0
    # the reference's pileup holds stitched bases
    c = run.load_cell("small.stitched", root)
    layout = gen.load_layout(c["config"], root)
    s = layout.make_sample(gen.sample_spec(c["config"], c["traffic"]), SEED)
    assert layout.counts(s, s.chroms[0], 20)[..., 2].sum() > 0


def test_control_fails_at_the_small_size(small_root):
    root = _small_root(small_root)
    c = run.load_cell("small.stitched", root)
    r = control.control_numbers(c["config"], c["traffic"], SEED, root)
    assert r["lines_compared"] > 0
    limits = c["config"]["limits"]
    assert r["line_mismatches"] > limits["line_mismatches"], r
    assert r["sb_gap"] > limits["sb_gap"], r


@pytest.mark.parametrize("fault", ["forward", "half"])
def test_faults_come_out_not_correct(small_root, monkeypatch, fault):
    """The check sees stitched bases counted as forward ones, and half the
    reads dropped."""
    root = _small_root(small_root)
    if fault == "forward":
        from pisces_tpu_torch.io import native
        real = native.NativeBamReader.xd_directions

        def forward(self):
            base_dirs, del_dirs, n = real(self)
            return (np.where(base_dirs == 2, 0, base_dirs).astype(np.int8),
                    np.where(del_dirs == 2, 0, del_dirs).astype(np.int8), n)
        monkeypatch.setattr(native.NativeBamReader, "xd_directions", forward)
    else:
        from pisces_tpu_torch.apps import pisces as app
        keep_of = app.filter_batch

        def half(*a, **k):
            keep = np.array(keep_of(*a, **k), copy=True)
            keep[::2] = False
            return keep
        monkeypatch.setattr(app, "filter_batch", half)
    r = run.run_cell("small.stitched", SEED, 1.0, False, device="cpu",
                     root=root)
    assert r["correct"] is False
