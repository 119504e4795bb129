"""MNV calling in the port against the reference package (ROADMAP Queue 1
item 7.2): the per-read candidate state machine of pileup/candidates, the
caller's MNV triage (failed-MNV reallocation and gapped-MNV reference
counts), -CallMNVs end to end on both read flows, and the MNV accuracy arm
of apps/accuracy.

The end-to-end cases hold the port's bodies as tests/test_torch_options.py
does (assert_port_calls). The accuracy arm runs at the reference bench's
defaults (40 haplotypes, 300x over 30 kb, seed 13; about 90,000 reads) and
must reach the bench's target, recall = precision = 1.00, with a VCF body
equal to the reference's.
"""
import os

import numpy as np
import pytest

import conftest  # noqa: F401  (keeps JAX on the CPU)
from test_torch_e2e import device_everywhere, flow  # noqa: F401
from test_torch_options import _four_runs

from pisces_tpu_torch import synthetic
from pisces_tpu_torch.apps import accuracy as torch_accuracy


@pytest.fixture(scope="module")
def phased(tmp_path_factory):
    """The MNV accuracy workload cut to 12 haplotypes at 80x over 8 kb."""
    tmp = str(tmp_path_factory.mktemp("mnv"))
    bam, genome, truth = torch_accuracy.generate_mnv_workload(
        tmp, n_haplotypes=12, depth=80, chrom_len=8_000)
    return tmp, bam, genome, truth


def _candidate_rows(cands):
    """Every field of each candidate, in list order."""
    rows = []
    for c in cands:
        rows.append((c.chromosome, c.position, c.ref_allele, c.alt_allele,
                     int(c.category), c.open_on_left, c.open_on_right,
                     c.is_known, c.is_forced,
                     tuple(int(x) for x in c.support_by_direction),
                     tuple(int(x) for x in c.well_anchored_by_direction),
                     None if c.support_by_amplicon is None
                     else sorted(c.support_by_amplicon.items()),
                     None if c.read_collapsed_counts is None
                     else tuple(int(x) for x in c.read_collapsed_counts)))
    return rows


def _batches(bam, parse_tags):
    """(port batch, reference batch, keep, reference sequence) of chr 0."""
    from pisces_tpu.io.bam import BamReader as JReader
    from pisces_tpu_torch.io.bam import BamReader, filter_batch
    from pisces_tpu_torch.io.fasta import Genome
    genome = os.path.join(os.path.dirname(bam), "genome")
    g = Genome(genome)
    batch = BamReader(bam).fetch(0, parse_tags=parse_tags)
    jbatch = JReader(bam).fetch(0, parse_tags=parse_tags)
    seq = g.get_chr_reference(g.chromosome_names[0]).sequence
    return batch, jbatch, filter_batch(batch), seq


@pytest.mark.parametrize("max_len,max_gap", [(3, 1), (100, 10), (2, 0)])
@pytest.mark.parametrize("open_ended", [True, False])
def test_mnv_candidates_match_jax(phased, max_len, max_gap, open_ended):
    from pisces_tpu.pileup.candidates import find_candidates_batch as jfind
    from pisces_tpu_torch.pileup.candidates import find_candidates_batch
    batch, jbatch, keep, seq = _batches(phased[1], False)
    args = (keep, 20, True, max_len, max_gap, 5)
    got, agg = find_candidates_batch("chrM2", seq, batch, *args,
                                     track_open_ended=open_ended)
    want, _ = jfind("chrM2", seq, jbatch, *args, track_open_ended=open_ended)
    assert _candidate_rows(got) == _candidate_rows(want)
    assert agg is not None
    assert sum(len(c.ref_allele) > 1 for c in got) >= 5


@pytest.mark.parametrize("kind", ["messy", "stitched", "amplicon",
                                  "collapsed"])
def test_state_machine_matches_jax_on_every_input(tmp_path, kind):
    """The per-read state machine (call_mnvs=True), the vectorized path
    (call_mnvs=False, untagged batch) and the amplicon / read-collapsed
    arms, field by field against the reference package."""
    from pisces_tpu.pileup.candidates import find_candidates_batch as jfind
    from pisces_tpu_torch.pileup.candidates import find_candidates_batch
    tmp = str(tmp_path)
    bam = {
        "messy": lambda: synthetic.write_synthetic_workload(
            tmp, 1, 8_000, 2_500, seed=4)[0],
        "stitched": lambda: synthetic.write_stitched_workload(
            tmp, 8_000, 1_500, seed=4)[0],
        "amplicon": lambda: synthetic.write_amplicon_workload(
            tmp, 10, depth=120, seed=4)[0],
        "collapsed": lambda: synthetic.write_collapsed_workload(
            tmp, 8_000, 2_500, seed=4)[0],
    }[kind]()
    tagged = kind != "messy"
    batch, jbatch, keep, seq = _batches(bam, tagged)
    for mnvs in (True, False):
        for amps in ((True, False) if kind == "amplicon" else (False,)):
            args = (keep, 20, mnvs, 3, 1, 5)
            got, _ = find_candidates_batch("chr1", seq, batch, *args,
                                           track_amplicons=amps)
            want, _ = jfind("chr1", seq, jbatch, *args, track_amplicons=amps)
            assert _candidate_rows(got) == _candidate_rows(want), (mnvs, amps)
            assert got
    if kind == "amplicon":
        assert any(c.support_by_amplicon for c in got) is False
        got, _ = find_candidates_batch("chr1", seq, batch, keep, 20,
                                       track_amplicons=True)
        assert any(c.support_by_amplicon for c in got)
    if kind == "collapsed":
        assert any(c.read_collapsed_counts is not None for c in got)


def test_vectorized_path_equals_the_state_machine(tmp_path):
    """Without MNVs the port's vectorized candidates equal its own per-read
    state machine's, as the reference package holds for its copies."""
    from pisces_tpu_torch.domain.types import BASE_TO_ALLELE
    from pisces_tpu_torch.pileup import candidates as C
    bam, _g = synthetic.write_synthetic_workload(str(tmp_path), 1, 8_000,
                                                 2_500, seed=6)
    batch, _jbatch, keep, seq = _batches(bam, False)
    fast, _ = C.find_candidates_batch("chr1", seq, batch, keep, 20)
    exact = C.CandidateAggregator(True)
    dirs = C.read_directions(batch)
    codes = BASE_TO_ALLELE[seq]
    for i in np.nonzero(keep)[0]:
        s, e = batch.cigar_off[i], batch.cigar_off[i + 1]
        qs, qe = batch.seq_off[i], batch.seq_off[i + 1]
        for c in C.find_candidates_read(
                "chr1", seq, codes, int(batch.pos[i]) + 1,
                int(batch.end_pos[i]) + 1, batch.cigar_ops[s:e],
                batch.cigar_lens[s:e], batch.seq[qs:qe], batch.qual[qs:qe],
                int(dirs[i]), 20, False, 3, 1, 5):
            exact.add(c)
    assert (sorted(_candidate_rows(fast))
            == sorted(_candidate_rows(exact.candidates())))


@pytest.mark.parametrize("gvcf", ["false", "true"])
def test_call_mnvs_matches_jax(phased, device_everywhere, flow, gvcf):
    tmp, bam, genome, truth = phased
    port = _four_runs(tmp, f"m{gvcf}{flow}", bam, genome, gvcf,
                      ["-CallMNVs", "true", "-MaxMNVLength", "100",
                       "-MaxGapBetweenMNV", "10"])
    called = {tuple(ln.split("\t")[i] for i in (1, 3, 4)) for ln in port
              if "\tPASS\t" in ln}
    assert {(str(t.position), t.ref, t.alt) for t in truth} <= called


def test_mnv_triage_matches_jax(phased, monkeypatch):
    """The caller's failed-MNV reallocation and gapped-MNV reference counts
    (calling/caller.py, calling/mnv_realloc.py) see the same alleles in
    both packages and do real work."""
    import pisces_tpu.calling.caller as jax_caller
    import pisces_tpu_torch.calling.caller as torch_caller
    from pisces_tpu.apps.pisces import main as jax_main
    from pisces_tpu_torch.apps.pisces import main as torch_main

    tmp, bam, genome, _truth = phased
    seen = {}
    for name, mod in (("port", torch_caller), ("ref", jax_caller)):
        log = seen.setdefault(name, [])
        realloc = mod.reallocate_failed_mnvs
        gapped = mod.get_ref_support_from_gapped_mnvs

        def spy_realloc(failed, *args, _f=realloc, _log=log):
            _log.append(("failed", sorted((a.position, a.ref_allele,
                                           a.alt_allele) for a in failed)))
            return _f(failed, *args)

        def spy_gapped(alleles, _f=gapped, _log=log):
            out = _f(alleles)
            _log.append(("gapped", sorted(out.items())))
            return out

        monkeypatch.setattr(mod, "reallocate_failed_mnvs", spy_realloc)
        monkeypatch.setattr(mod, "get_ref_support_from_gapped_mnvs",
                            spy_gapped)
    flags = ["-gVCF", "false", "-CallMNVs", "true", "-MaxMNVLength", "100",
             "-MaxGapBetweenMNV", "10", "-backend", "numpy"]
    assert torch_main(["-bam", bam, "-g", genome, "-o",
                       os.path.join(tmp, "tri_t"), "-device", "cpu",
                       *flags]) == 0
    assert jax_main(["-bam", bam, "-g", genome, "-o",
                     os.path.join(tmp, "tri_j"), *flags]) == 0
    assert seen["port"] == seen["ref"]
    log = dict(seen["port"])
    assert log["failed"] and log["gapped"]


def test_mnv_accuracy_arm_matches_jax(tmp_path):
    from pisces_tpu.apps.accuracy import run_mnv_accuracy as jax_run
    port = torch_accuracy.run_mnv_accuracy(str(tmp_path / "t"),
                                           device="cpu")
    assert (port.n_truth, port.recall, port.precision) == (40, 1.0, 1.0)
    ref = jax_run(str(tmp_path / "j"), use_device=True)
    assert (port.tp, port.fp, port.fn) == (ref.tp, ref.fp, ref.fn)

    def body(d):
        with open(tmp_path / d / "mnv.vcf") as f:
            return [ln for ln in f if not ln.startswith("#")]

    assert body("t") == body("j")
