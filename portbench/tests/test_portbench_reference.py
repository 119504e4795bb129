"""The plain reference's arithmetic on small hand cases."""
import math

import numpy as np
import pytest

from portbench import gen
from portbench.reference import scoring as S
from portbench.reference.pileup import chrom_counts


def _one_read_sample(cls, read_len=20, dip=False, rev=False):
    seq = np.frombuffer(b"ACGT" * 15, np.uint8).copy()
    layouts = gen.class_layout(read_len)[0]
    m = layouts[cls]
    pos0 = 5
    reads = np.full((1, read_len), ord("N"), np.uint8)
    reads[0, m >= 0] = seq[pos0 + m[m >= 0]]
    reads[0, m < 0] = ord("T")
    ch = gen.ChromReads("c", seq, np.array([pos0]), np.array([cls], np.int8),
                        np.array([rev]), np.array([dip]), reads)
    return gen.Sample(read_len, 5, 12, 30, [ch]), ch


def test_pileup_of_each_read_class():
    L = 20
    for cls, span in enumerate((L, L - 8, L - 8, L - 2, L + 2)):
        s, ch = _one_read_sample(cls)
        c = chrom_counts(s, ch, 20)
        cov = c[:, list(S.COVERAGE_ALLELES), :].sum(axis=(1, 2))
        covered = np.flatnonzero(cov)
        # 1-based positions 6 .. 6 + span - 1, every one once
        assert covered.tolist() == list(range(6, 6 + span)), cls
        assert cov[covered].tolist() == [1] * span
        dels = np.flatnonzero(c[:, S.DEL, :].sum(axis=1))
        assert dels.tolist() == ([6 + L // 2 - 1, 6 + L // 2]
                                 if cls == 4 else [])
        # the reference base where a base is mapped
        codes = S.BASE_TO_ALLELE[ch.seq]
        for p in covered:
            if p not in dels:
                assert c[p, codes[p - 1], 0] == 1


def test_low_quality_tail_counts_as_n_and_strand():
    s, ch = _one_read_sample(0, dip=True, rev=True)
    c = chrom_counts(s, ch, 20)
    n_pos = np.flatnonzero(c[:, S.N, 1])
    assert n_pos.tolist() == list(range(6 + 20 - 5, 6 + 20))
    assert c[:, :, 0].sum() == 0


def test_variant_qscore_hand_values():
    # P(X >= 3), X ~ Poisson(100 * 0.01) = 1 - e^-1 (1 + 1 + 1/2)
    p = 1 - math.exp(-1) * 2.5
    want = round(-10 * math.log10(p))
    q = S.variant_qscores(np.array([3, 0, 5]), np.array([100, 100, 0]), 20,
                          100, S.F64)
    assert q.tolist() == [want, 0, 0]
    # deep tails cap at the maximum
    assert S.variant_qscores(np.array([60]), np.array([100]), 20, 100,
                             S.F64).tolist() == [100]


def test_somatic_genotypes_and_gq():
    freq = S.frequency(np.array([50, 99, 3, 5]), np.array([100, 100, 100, 8]))
    ref_freq = S.frequency(np.array([50, 0, 97, 3]),
                           np.array([100, 100, 100, 8]))
    gt = S.somatic_genotypes(np.zeros(4, bool), freq, ref_freq,
                             np.array([100, 100, 100, 8]), 0.01, 10)
    assert [S.GT_STRINGS[g] for g in gt] == ["0/1", "1/1", "0/1", "./."]
    gq = S.somatic_gq(gt, np.array([100, 100, 40, 30]), freq,
                      np.array([100, 100, 100, 8]), 0.01, 0, 100, S.F64)
    assert gq.tolist()[0] == 100 and gq.tolist()[3] == 0


def test_diploid_genotypes():
    def allele(freq, total=40, alt="C"):
        return {"pos": 10, "ref": "A", "alt": alt, "freq": freq,
                "ref_freq": 1 - freq, "total": total}
    assert S.diploid_genotype([allele(0.5)], 0.2, 0.7, 0.8, 10)[0] == S.GT_HET
    assert S.diploid_genotype([allele(0.95)], 0.2, 0.7, 0.8, 10)[0] == \
        S.GT_HOM_ALT
    gt, kept = S.diploid_genotype([allele(0.1)], 0.2, 0.7, 0.8, 10)
    assert kept == []
    gt, kept = S.diploid_genotype([allele(0.5, total=6)], 0.2, 0.7, 0.8, 10)
    assert gt == S.GT_ALT_NOCALL and len(kept) == 1
    assert S.diploid_gq(S.GT_HET, 40, 20, 0.5, 0, 100, S.F64) > 30


def test_rmxn_on_adjacent_homopolymers():
    ref = "GT" + "A" * 10 + "C" * 10 + "GT"
    pos = 2 + 10  # the last A, 1-based
    assert S.rmxn_filtered(pos, "A", "C", 0.05, ref, 5, 9, 0.35)
    assert not S.rmxn_filtered(pos, "A", "C", 0.40, ref, 5, 9, 0.35)
    assert not S.rmxn_filtered(3, "A", "G", 0.05, ref, 5, 9, 0.35)


@pytest.mark.parametrize("pr", [S.F64, S.F32])
def test_strand_bias_balanced_support_is_acceptable(pr):
    gatk, ok = S.strand_bias(np.array([[20, 20, 0]]), np.array([[200, 200, 0]]),
                             20, 0.5, pr)
    assert ok.tolist() == [True] and gatk[0] < 0
    gatk, ok = S.strand_bias(np.array([[40, 0, 0]]), np.array([[200, 200, 0]]),
                             20, 0.5, pr)
    assert ok.tolist() == [False]


def test_shallow_snv_is_called_only_with_gvcf():
    from portbench.reference import calls
    seq = np.frombuffer(b"ACGTACGTAC", np.uint8).copy()
    counts = np.zeros((len(seq) + 1, 6, 2), np.int64)
    counts[5, S.A, 0] = 1          # position 5 (ref A): one read, alt below
    counts[5, S.G, 0] = 0
    counts[6, S.A, 1] = 1          # position 6 (ref C): one alt A read
    cfg = {"noise_q": 20, "max_q": 100, "sb_accept": 0.5, "min_freq": 0.01,
           "min_q": 20, "min_dp": 10}
    for gvcf, want in ((True, [True]), (False, [False])):
        snv = calls.score_snvs(counts, seq, dict(cfg, gvcf=gvcf), S.F64)
        assert snv["pos"].tolist() == [6] and snv["q"].tolist() == [20]
        assert snv["callable"].tolist() == want


def _random_counts(seed, length, directions):
    """Seeded pileup counts [length + 1, 6, directions] over a random
    reference: a depth a position and direction (some directions empty),
    alt alleles from none to half of it, a few N and deletions."""
    rng = np.random.default_rng(seed)
    seq = gen.BASES[rng.integers(0, 4, length)]
    depth = rng.integers(0, 400, (length, directions)) \
        * (rng.random((length, directions)) < 0.85)
    share = rng.choice([0.0, 0.003, 0.02, 0.08, 0.5], (length, 6, 1))
    counts = np.zeros((length + 1, 6, directions), np.int64)
    counts[1:] = rng.binomial(depth[:, None, :], share * np.array(
        [1, 1, 1, 1, 0.1, 0.1])[None, :, None])
    ref = S.BASE_TO_ALLELE[seq]
    counts[1 + np.arange(length), ref, :] = depth
    return seq, counts


def _bits(a):
    a = np.asarray(a)
    return a.dtype.str, a.shape, a.tobytes()


@pytest.mark.parametrize("seed", [1, 2**31 + 9])
def test_zero_stitched_column_gives_the_same_scores(seed):
    """Two-direction counts and the same counts with a zero stitched
    column score bit for bit alike: candidates and reference lines."""
    from portbench.reference import calls
    cfg = _calling()
    seq, c2 = _random_counts(seed, 3000, 2)
    c3 = np.concatenate([c2, np.zeros(c2.shape[:2] + (1,), np.int64)], 2)
    assert calls.three_directions(c3) is c3
    for fn in (calls.score_snvs, calls.reference_lines):
        a, b = fn(c2, seq, cfg, S.F64), fn(c3, seq, cfg, S.F64)
        assert list(a) == list(b)
        for k in a:
            assert _bits(a[k]) == _bits(b[k]), (fn.__name__, k)


@pytest.mark.parametrize("seed", [3, 2**31 + 11, 3000000007])
def test_three_direction_scores_match_the_ports_host_f64(seed):
    """On counts with stitched bases, the reference's Q, strand bias, GT
    and GQ of every SNV candidate and reference position equal those of
    the program's host float64 scoring (pisces_tpu_torch.ops.stats) on
    the same support and coverage by direction."""
    from pisces_tpu_torch.ops import stats

    from portbench.reference import calls
    cfg = _calling()
    seq, counts = _random_counts(seed, 3000, 3)
    assert counts[..., 2].sum() > 0
    noise, max_q = cfg["noise_q"], cfg["max_q"]
    cov_all = counts[:, list(S.COVERAGE_ALLELES), :].sum(axis=1)

    def port(sup, cov, is_ref, ref_sup):
        total = cov.sum(axis=1)
        q = stats.compute_variant_qscores(sup.sum(axis=1), total, max_q,
                                          noise)
        sb = stats.compute_strand_bias(sup, cov, noise, cfg["min_freq"],
                                       cfg["sb_accept"])
        freq = S.frequency(sup.sum(axis=1), total)
        gt = stats.somatic_genotypes(is_ref, freq,
                                     S.frequency(ref_sup, total), total,
                                     cfg["min_freq"], cfg["min_dp"])
        gq = stats.somatic_genotype_qscores(gt, q, freq, total,
                                            cfg["min_freq"], 0,
                                            cfg["max_gq"])
        return q, sb, gt, gq

    snv = calls.score_snvs(counts, seq, cfg, S.F64)
    pos = snv["pos"]
    sup = counts[pos, snv["alt"], :]
    ref_sup = counts[pos, S.BASE_TO_ALLELE[seq[pos - 1]], :].sum(axis=1)
    q, sb, gt, gq = port(sup, cov_all[pos], np.zeros(len(pos), bool),
                         ref_sup)
    assert len(pos) > 1000 and (sup[:, 2] > 0).sum() > 100
    assert np.array_equal(snv["q"], q)
    assert _bits(snv["gatk"]) == _bits(sb["gatk_bias_score"])
    assert np.array_equal(snv["sb_ok"], sb["bias_acceptable"])
    lines = calls.somatic_variant_lines(snv, seq.tobytes().decode(), cfg,
                                        S.F64)
    called = np.flatnonzero(snv["callable"])
    assert called.size > 100
    for i in called.tolist():
        line = next(d for d in lines[int(pos[i])]
                    if d["alt"] == S.ALLELE_CHARS[int(snv["alt"][i])])
        assert line["gt"] == S.GT_STRINGS[int(gt[i])]
        assert line["gq"] == gq[i]

    ref = calls.reference_lines(counts, seq, cfg, S.F64)
    at = np.arange(1, len(seq) + 1)
    rsup = counts[at, S.BASE_TO_ALLELE[seq], :]
    q, sb, gt, gq = port(rsup, cov_all[1:], np.ones(len(seq), bool),
                         rsup.sum(axis=1))
    q = np.where(rsup.sum(axis=1) > 0, q, 0)
    gatk = np.where(rsup.sum(axis=1) > 0, sb["gatk_bias_score"], 0.0)
    assert np.array_equal(ref["qual"], q)
    assert _bits(ref["sb"]) == _bits(np.clip(gatk, -100.0, 0.0))
    assert np.array_equal(ref["gt"], gt)
    assert np.array_equal(ref["gq"], gq)
    assert np.array_equal(ref["tuples"], np.concatenate(
        [rsup, cov_all[1:]], axis=1))


def _calling():
    import json
    import os
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    with open(os.path.join(root, "portbench", "configs",
                           "somatic_panel.json")) as f:
        return json.load(f)["calling"]
