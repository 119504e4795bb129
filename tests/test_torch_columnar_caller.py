"""The caller's SNV candidates as columns against the same candidates as
objects (pisces_tpu_torch/calling/caller.AlleleCaller.call).

The native flow hands the caller its SNV candidates as one columnar batch
(pileup/candidates_fast.SnvCandidateBatch) beside the indels, forced and
reference candidates as objects. Each case runs the caller twice on the
same native-flow candidates: once with the batch's rows as Candidate
objects ahead of the object list, once with the batch itself. Every field
of every returned allele, the strand-bias tables behind -OutputBiasFiles,
the counts of called and collapsed alleles and the suppressed reference
positions must be equal. In one case gapped MNVs hold reference support at
some loci, and the supports they reduce are held to the rule.

The workload is pisces_tpu_torch.synthetic's messy genome generator cut to
one chromosome of 20 kb at 40,000 reads of 100 bp (200x), 40 planted SNVs
and a base-error floor of 0.2 % (seed 3): thousands of SNV rows, most of
them too weak to call, as at panel depth.

The caller's indels and MNVs take their spanning coverage in one column
pass (ops/coverage.spanning_coverage_columns). On read pairs whose
recurrent 2 bp insertions and deletions are called
(synthetic.write_paired_workload), a whole run with that pass must leave
every field of every spanning allele as the frozen per-allele oracle of
tests/test_torch_spanning_coverage.py leaves it, on both read flows, and
its VCF and gVCF bodies must be byte-equal to the reference package's.
"""
import collections
import copy
import dataclasses
import os

import numpy as np
import pytest
import torch

import pisces_tpu_torch.apps.pisces as torch_app
from pisces_tpu_torch.apps._pisces_main import (
    _normalize, build_parser, options_from_args,
)
from pisces_tpu_torch.apps.pisces import main as torch_main
from pisces_tpu_torch.calling.caller import (
    AlleleCaller, CallerConfig, _point_coverage_columns,
    make_reference_candidates,
)
from pisces_tpu_torch.calling.collapser import VariantCollapser
from pisces_tpu_torch.calling.intervals import ChrIntervalSet, Region
from pisces_tpu_torch.calling.source import AlleleSource
from pisces_tpu_torch.domain.types import BASE_TO_ALLELE, AlleleCategory
from pisces_tpu_torch.io import native
from pisces_tpu_torch.io.bam import filter_batch
from pisces_tpu_torch.io.fasta import Genome
from pisces_tpu_torch.ops import stats
from pisces_tpu_torch.pileup.candidates import Candidate
from pisces_tpu_torch.pileup.candidates_fast import (
    aggregate_native_mismatches, find_indel_candidates,
)
from pisces_tpu_torch.pileup.counts import candidate_anchor_positions
from pisces_tpu_torch.synthetic import (
    generate_wgs_workload, write_paired_workload,
)
from pisces_tpu_torch.utils.metrics import metrics
from test_torch_spanning_coverage import frozen_spanning_coverage

CHROM = "chrW"
CASES = {
    "collapse": dict(),
    "no_collapse": dict(flags=["-collapse", "false"]),
    "forced": dict(forced=True, reference_rows=True),
    "intervals": dict(intervals=[(2_001, 6_000), (11_001, 15_000)],
                      reference_rows=True),
    "bias_files": dict(flags=["-OutputBiasFiles", "true"]),
    "zero_coverage": dict(zero_coverage=True, flags=["-gVCF", "false"]),
    "thresholds_on_rows": dict(thresholds=True),
    "device_above_threshold": dict(device_threshold=1),
    "device_below_threshold": dict(device_threshold=10 ** 9),
    "diploid": dict(flags=["-ploidy", "diploid", "-gVCF", "false"]),
    "diploid_forced": dict(flags=["-ploidy", "diploid"], forced=True,
                           reference_rows=True),
    "gapped_mnv_counts": dict(gapped=True, reference_rows=True),
}


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("columnar"))
    bam, genome = generate_wgs_workload(tmp, n_reads=40_000, chrom_len=20_000,
                                        base_error_rate=0.002,
                                        n_var_sites=40, seed=3)
    return bam, Genome(genome)


def _options(flags):
    argv = _normalize(["-bam", "x.bam", "-g", "g", "-o", "o", *flags])
    return options_from_args(build_parser().parse_args(argv), argv)


def _native_candidates(bam, chrom, options, zero_coverage):
    """call_chromosome's native flow: the indels, the SNV batch and the
    counts. With zero_coverage the counts hold only the reads that start
    in the chromosome's first half, so rows past it have no coverage."""
    bf = options.bam_filter_parameters
    min_bq, anchor = bf.minimum_base_call_quality, options.tracked_anchor_size
    reader = native.NativeBamReader(bam)
    batch = reader.fetch(ref_id=0, as_views=True)
    keep = filter_batch(batch, bf.minimum_map_quality, bf.remove_duplicates,
                        bf.only_use_proper_pairs)
    indels = find_indel_candidates(CHROM, chrom.sequence, batch, keep,
                                   min_bq, anchor,
                                   track_open_ended=options.collapse)
    anchors = candidate_anchor_positions(indels)
    ref_codes = BASE_TO_ALLELE[chrom.sequence]
    pc, mm = native.native_pileup(reader, keep, min_bq, anchor, anchors,
                                  ref_codes=ref_codes,
                                  track_open_ended=options.collapse)
    snvs = aggregate_native_mismatches(CHROM, chrom.sequence, *mm)
    if zero_coverage:
        half = keep & (batch.pos < len(chrom.sequence) // 2)
        pc, _ = native.native_pileup(reader, half, min_bq, anchor, anchors,
                                     ref_codes=ref_codes,
                                     track_open_ended=options.collapse)
    return reader, indels, snvs, pc


def _call(options, chrom, pc, snvs, objects, intervals, forced, columnar,
          device_threshold, gapped):
    cfg = CallerConfig.from_options(options)
    if device_threshold is not None:
        cfg.device = torch.device("cpu")
        cfg.device_batch_threshold = device_threshold
    collapser = None
    if options.collapse:
        collapser = VariantCollapser(
            None, options.exclude_mnvs_from_collapsing,
            cfg.consider_anchor_information, options.collapse_freq_threshold,
            options.collapse_freq_ratio_threshold)
    caller = AlleleCaller(cfg, chrom.sequence, collapser, intervals)
    caller.forced_alleles = set(forced)
    objects = copy.deepcopy(objects)
    source = AlleleSource(pc)
    source.add_gapped_mnv_ref_counts(gapped)
    before = metrics.snapshot()["counters"]
    if columnar:
        by_position = caller.call(objects, source, snvs=snvs)
    else:
        by_position = caller.call(snvs.to_candidates() + objects, source)
    after = metrics.snapshot()["counters"]
    rows = {k: after.get(k, 0) - before.get(k, 0)
            for k in ("caller_rows_columnar", "caller_rows_materialized")}
    return by_position, caller, rows, source


def _fields(a):
    out = {}
    for f in dataclasses.fields(a):
        v = getattr(a, f.name)
        out[f.name] = (v.tolist() if isinstance(v, np.ndarray) else
                       list(v) if isinstance(v, list) else v)
    sb = getattr(a, "sb_detail", None)
    if sb is not None:
        out["sb_detail"] = {g: {k: sb[g][k].tolist() for k in sb[g]}
                            for g in ("overall", "forward", "reverse")}
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_columns_give_the_object_path_alleles(workload, case):
    spec = CASES[case]
    bam, genome = workload
    chrom = genome.get_chr_reference(CHROM)
    options = _options(spec.get("flags", []))
    reader, indels, snvs, pc = _native_candidates(
        bam, chrom, options, spec.get("zero_coverage", False))
    if spec.get("thresholds"):
        # -minvf 1/n, n a coverage at which single-read rows sit, and -minvq
        # their q: each limit is met exactly, the frequency in f32 (the
        # f64 ratio lies below the f32 limit)
        cov = _point_coverage_columns(AlleleSource(pc), snvs.position,
                                      BASE_TO_ALLELE[snvs.ref_base])[1]
        single = cov[(snvs.support_by_direction.sum(axis=1) == 1)
                     & (cov > 0)]
        f32_above = [int(n) for n in np.unique(single)
                     if float(np.float32(1) / np.float32(n)) > 1 / n]
        assert f32_above
        n = f32_above[0]
        v = options.variant_calling_parameters
        q = stats.compute_variant_qscores(
            np.array([1]), np.array([n]), v.maximum_variant_qscore,
            v.noise_level_used_for_q_scoring)[0]
        options = _options(["-minvq", str(int(q)), "-minvf", repr(1 / n)])
    intervals = None
    if "intervals" in spec:
        intervals = ChrIntervalSet([Region(s, e) for s, e in
                                    spec["intervals"]], CHROM)
    objects = list(indels)
    forced = []
    if spec.get("forced"):
        # one row that is called, one that is not (the error floor), and
        # one forced SNV that no read holds, as call_chromosome adds it
        sup = snvs.support_by_direction.sum(axis=1)
        for i in (int(np.argmax(sup)), int(np.argmin(sup))):
            forced.append((CHROM, int(snvs.position[i]),
                           chr(snvs.ref_base[i]), chr(snvs.alt_base[i])))
        pos = int(snvs.position[0]) + 1
        ref = chr(chrom.sequence[pos - 1])
        alt = "T" if ref != "T" else "A"
        assert not snvs.rows_in([(pos, ref, alt)]).any()
        forced.append((CHROM, pos, ref, alt))
        fc = Candidate(CHROM, pos, ref, alt, AlleleCategory.SNV)
        fc.is_forced = True
        objects.append(fc)
    if spec.get("reference_rows"):
        objects += make_reference_candidates(CHROM, chrom.sequence, pc,
                                             intervals)
    gapped = {}
    if spec.get("gapped"):
        # reference support held by gapped MNVs (as the MNV triage counts
        # it) at the strongest SNV rows and at reference loci with no row
        sup = snvs.support_by_direction.sum(axis=1)
        for i in np.argsort(-sup, kind="stable")[:20]:
            gapped[int(snvs.position[i])] = 7
        ref_only = sorted({o.position for o in objects
                           if o.category == AlleleCategory.REFERENCE}
                          - set(snvs.position.tolist()))
        for p in ref_only[::400][:20]:
            gapped[p] = 7
    runs = [_call(options, chrom, pc, snvs, objects, intervals, forced,
                  columnar, spec.get("device_threshold"), gapped)
            for columnar in (False, True)]
    (want, wcaller, wrows, _), (got, gcaller, grows, gsource) = runs
    del reader

    assert list(got) == list(want)
    assert sum(map(len, want.values())) > 10
    for pos in want:
        assert [_fields(a) for a in got[pos]] == \
            [_fields(a) for a in want[pos]], pos
    assert gcaller.total_num_called == wcaller.total_num_called > 0
    assert gcaller.total_num_collapsed == wcaller.total_num_collapsed
    assert gcaller.ref_suppressed_positions == \
        wcaller.ref_suppressed_positions

    # the columnar path ran, and built objects only for reported or forced
    # SNV rows
    assert wrows == {"caller_rows_columnar": 0,
                     "caller_rows_materialized": 0}
    assert grows["caller_rows_columnar"] <= len(snvs)
    forced_objects = [o for o in objects if o.is_forced]
    reported_rows = sum(a.category == AlleleCategory.SNV
                        and not any(o.equals_allele(a)
                                    for o in forced_objects)
                        for lst in got.values() for a in lst)
    assert 0 < reported_rows <= grows["caller_rows_materialized"] \
        < grows["caller_rows_columnar"]
    if options.variant_calling_parameters.ploidy_model.name == "SOMATIC":
        # the somatic genotyper prunes nothing: every row made an object
        # is in the output
        assert grows["caller_rows_materialized"] == reported_rows
    if options.collapse:
        assert wcaller.total_num_collapsed > 0
    if forced:
        assert all(any((CHROM, a.position, a.ref_allele, a.alt_allele) == f
                       for a in got.get(f[1], ())) for f in forced)
    if spec.get("zero_coverage"):
        total = _point_coverage_columns(
            gsource, snvs.position, BASE_TO_ALLELE[snvs.ref_base])[1]
        assert (total == 0).sum() > 10
    if gapped:
        # what gapped MNVs hold comes off an SNV's reference support
        # (floored at 0) and off a reference allele's own support
        seen = collections.Counter()
        for pos, g in gapped.items():
            raw = int(_point_coverage_columns(
                gsource, np.array([pos]),
                BASE_TO_ALLELE[chrom.sequence[[pos - 1]]])[-1][0])
            for a in got.get(pos, ()):
                seen[a.category] += 1
                if a.category == AlleleCategory.SNV:
                    assert a.reference_support == max(0, raw - g), pos
                else:
                    assert a.category == AlleleCategory.REFERENCE
                    assert (a.reference_support, a.allele_support) == \
                        (raw, raw - min(g, raw)), pos
        assert seen[AlleleCategory.SNV] >= 10
        assert seen[AlleleCategory.REFERENCE] >= 10


# -- spanning coverage as columns, on called indels ---------------------------

_SPANNING = (AlleleCategory.INSERTION, AlleleCategory.DELETION,
             AlleleCategory.MNV)


@pytest.fixture(scope="module")
def paired(tmp_path_factory):
    """20 kb of read pairs at about 240x, 3 % of them carrying one of four
    recurrent 2 bp indels: two insertions and two deletions are called."""
    tmp = str(tmp_path_factory.mktemp("paired"))
    bam, genome = write_paired_workload(os.path.join(tmp, "w"), 20_000,
                                        12_000, indel_fraction=0.03, seed=7)
    return tmp, bam, genome


def _body(main, bam, genome, out, flags):
    assert main(["-bam", bam, "-g", genome, "-o", out, *flags]) == 0
    stem = os.path.basename(bam)[:-len(".bam")]
    gvcf = flags[flags.index("-gVCF") + 1] == "true"
    name = f"{stem}.genome.vcf" if gvcf else f"{stem}.vcf"
    with open(os.path.join(out, name), "rb") as f:
        return [ln for ln in f.read().splitlines() if not ln.startswith(b"#")]


def _called_indels(body):
    rows = [ln.split(b"\t") for ln in body]
    return [r for r in rows if r[4] != b"." and len(r[3]) != len(r[4])
            and r[6] == b"PASS"]


def _per_allele_coverage(self, source, alleles):
    """AlleleCaller._coverage with each spanning allele through the frozen
    per-allele oracle, fields set as the per-allele path set them."""
    point = [a for a in alleles if a.category not in _SPANNING]
    if point:
        self._batch_point_coverage(source, point)
    for a in alleles:
        if a.category not in _SPANNING:
            continue
        cov = frozen_spanning_coverage(
            source, a.category, a.position, a.ref_allele, a.alt_allele,
            a.allele_support, a.well_anchored_support,
            self.config.consider_anchor_information)
        a.total_coverage = cov.total_coverage
        a.coverage_by_direction = cov.coverage_by_direction
        a.reference_support = cov.reference_support
        a.num_no_calls = cov.num_no_calls
        a.sum_of_base_quality = cov.sum_of_base_quality
        a.confident_coverage_start = cov.confident_coverage_start
        a.confident_coverage_end = cov.confident_coverage_end
        a.suspicious_coverage_start = cov.suspicious_coverage_start
        a.suspicious_coverage_end = cov.suspicious_coverage_end
        a.unanchored_coverage_weight = cov.unanchored_coverage_weight
        if cov.allele_support_adjustment:
            a.allele_support += cov.allele_support_adjustment


def _python_flow(m):
    m.setattr(torch_app, "open_bam",
              lambda path: native.open_bam(path, prefer_native=False))


SPANNING_CASES = {
    "paired_native": dict(flags=["-gVCF", "false"]),
    "paired_python": dict(python=True, flags=["-gVCF", "false"]),
    "paired_native_gvcf": dict(flags=["-gVCF", "true"]),
    "paired_python_gvcf_no_anchor_information": dict(
        python=True, flags=["-gVCF", "true", "-TrackedAnchorSize", "0"]),
    # the messy workload above: hundreds of 2 bp indels, few called
    "messy_native": dict(messy=True, flags=["-gVCF", "false"]),
    "messy_python_no_anchor_information": dict(
        messy=True, python=True,
        flags=["-gVCF", "false", "-TrackedAnchorSize", "0"]),
}


@pytest.mark.parametrize("case", list(SPANNING_CASES))
def test_spanning_columns_give_the_per_allele_alleles(request, monkeypatch,
                                                      case):
    """A whole run, column pass against the per-allele oracle: every field
    of every spanning allele the caller scored (as the run leaves it:
    coverage, scores, filters, genotype) and the output bodies."""
    spec = SPANNING_CASES[case]
    tmp, bam, genome = request.getfixturevalue("paired")
    if spec.get("messy"):
        bam, g = request.getfixturevalue("workload")
        genome = g.directory
    runs = []
    for per_allele in (True, False):
        scored = []
        coverage = (_per_allele_coverage if per_allele
                    else AlleleCaller._coverage)

        def spy(self, source, alleles, _coverage=coverage):
            scored.extend(a for a in alleles if a.category in _SPANNING)
            return _coverage(self, source, alleles)

        with monkeypatch.context() as m:
            m.setattr(AlleleCaller, "_coverage", spy)
            if spec.get("python"):
                _python_flow(m)
            body = _body(torch_main, bam, genome,
                         os.path.join(tmp, f"{case}{int(per_allele)}"),
                         ["-device", "cpu", *spec["flags"]])
        runs.append((body, [_fields(a) for a in scored]))
    (want_body, want), (got_body, got) = runs
    assert len(got) == len(want) >= 4
    for g, w in zip(got, want):
        assert g == w, w["position"]
    assert got_body == want_body
    cats = {f["category"] for f in got}
    assert {AlleleCategory.INSERTION, AlleleCategory.DELETION} <= cats
    if spec.get("messy"):
        assert len(got) > 100
    else:
        assert len(_called_indels(got_body)) == 4


@pytest.mark.parametrize("gvcf", ["false", "true"])
@pytest.mark.parametrize("flow", ["native", "python"])
def test_called_indels_byte_equal_to_the_reference_package(
        paired, monkeypatch, flow, gvcf):
    """The port's VCF or gVCF body on the paired workload, byte-equal to
    pisces_tpu -backend jax's on the same read flow."""
    import conftest  # noqa: F401  (keeps JAX on the CPU)
    import pisces_tpu.io.native as jax_native
    from pisces_tpu.apps.pisces import main as jax_main
    tmp, bam, genome = paired
    flags = ["-gVCF", gvcf]
    with monkeypatch.context() as m:
        if flow == "python":
            _python_flow(m)
            jax_open = jax_native.open_bam
            m.setattr(jax_native, "open_bam",
                      lambda path, prefer_native=True, lazy=False:
                      jax_open(path, prefer_native=False, lazy=lazy))
        port = _body(torch_main, bam, genome,
                     os.path.join(tmp, f"t{flow}{gvcf}"),
                     ["-device", "cpu", *flags])
        ref = _body(jax_main, bam, genome,
                    os.path.join(tmp, f"j{flow}{gvcf}"),
                    ["-backend", "jax", *flags])
    assert port == ref
    assert len(_called_indels(port)) == 4
    if gvcf == "true":
        assert len(port) > 19_000
