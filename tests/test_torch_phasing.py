"""Scylla in the port against the reference package (ROADMAP Queue 1
item 11), and the whole Gemini -> Pisces -> Scylla chain.

Scylla phases the SNV calls of one VCF with the reads of the BAM they came
from. The cases take the MNV accuracy workload (apps/accuracy
.generate_mnv_workload, seed 13) cut to 12 haplotypes at 80x over 8 kb
(about 6,400 reads), whose SNVs the port calls with -backend numpy: the
port's and the reference's run_scylla on that one VCF must write equal
.phased.vcf files, and so must the port's Scylla with 1 and 4 threads and
with and without the BAM's .bai. The neighborhoods, their read groups and
their clusters are compared too. The accuracy arm runs at the reference
bench's defaults and must reach its target, recall = precision = 1.00.

The chain runs the port's Gemini, the port's caller (-device cpu
-UseStitchedXD true -gVCF true, -backend torch and -backend numpy) and the
port's Scylla, and the same chain in the reference package (-backend jax
and numpy). Gemini's outputs must be byte-equal; the callers' bodies are
held as tests/test_torch_options.py holds them (integers bit-equal,
reference-line SB and GQ against the f64 run, where XLA's f32 tail moves
them: ROADMAP Queue 3); the phased files of the -backend numpy runs must
be equal, and the others are held as the bodies are.
"""
import os
import shutil
import subprocess
import sys

import pytest

import conftest  # noqa: F401  (keeps JAX on the CPU)
from test_torch_e2e import _run, device_everywhere  # noqa: F401
from test_torch_options import _four_runs, assert_port_calls

from pisces_tpu_torch import synthetic
from pisces_tpu_torch.apps import accuracy as torch_accuracy
from pisces_tpu_torch.apps.pisces import main as torch_main
from pisces_tpu_torch.phasing import scylla as tsc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINVF_FLAGS = ("-MinVF", "0.02", "-MinBQ", "22", "-MinDepth", "12")


@pytest.fixture(scope="module")
def mnv(tmp_path_factory):
    """The MNV workload cut to 12 haplotypes at 80x over 8 kb, its SNV
    calls (the port, -backend numpy, with a few calling flags that Scylla
    reads back from the VCF header) and the same calls by the reference."""
    from pisces_tpu.apps.pisces import main as jax_main
    tmp = str(tmp_path_factory.mktemp("scylla"))
    bam, genome, truth = torch_accuracy.generate_mnv_workload(
        tmp, n_haplotypes=12, depth=80, chrom_len=8_000)
    body = _run(torch_main, bam, genome, os.path.join(tmp, "t"), "false",
                ["-device", "cpu", "-backend", "numpy", *MINVF_FLAGS])
    ref = _run(jax_main, bam, genome, os.path.join(tmp, "j"), "false",
               ["-backend", "numpy", *MINVF_FLAGS])
    assert body == ref
    return dict(tmp=tmp, bam=bam, genome=genome, truth=truth,
                vcf=os.path.join(tmp, "t", "mnv.vcf"),
                jvcf=os.path.join(tmp, "j", "mnv.vcf"))


def _phase(mod, vcf, bam, genome, out, threads=1):
    opts = mod.ScyllaOptions()
    opts.max_num_threads = threads
    return mod.run_scylla(vcf, bam, genome, out, opts)


def _read(path):
    with open(path) as f:
        return f.read()


def _body(path):
    return [ln for ln in _read(path).splitlines() if not ln.startswith("#")]


def test_scylla_matches_reference(mnv):
    from pisces_tpu.phasing import scylla as jsc
    port = _phase(tsc, mnv["vcf"], mnv["bam"], mnv["genome"],
                  os.path.join(mnv["tmp"], "pt"))
    ref = _phase(jsc, mnv["vcf"], mnv["bam"], mnv["genome"],
                 os.path.join(mnv["tmp"], "pj"))
    assert _read(port) == _read(ref)
    assert "##phasing=Scylla" in _read(port)
    assert len(_body(port)) > len(_body(mnv["vcf"])) > 0


def test_scylla_threads_and_index_byte_equal(mnv):
    """-maxnumthreads 4 (neighborhoods on the JobManager's threads, each
    borrowing a lazy native reader) and a BAM without its .bai (one whole
    chromosome batch, shared) write the serial run's file."""
    d = mnv["tmp"]
    serial = _read(_phase(tsc, mnv["vcf"], mnv["bam"], mnv["genome"],
                          os.path.join(d, "s1")))
    assert _read(_phase(tsc, mnv["vcf"], mnv["bam"], mnv["genome"],
                        os.path.join(d, "s4"), threads=4)) == serial
    assert not os.path.exists(mnv["bam"] + ".bai")
    indexed = os.path.join(d, "indexed")
    os.makedirs(indexed, exist_ok=True)
    bam = os.path.join(indexed, "mnv.bam")
    shutil.copy(mnv["bam"], bam)
    _write_bai(bam)
    for threads in (1, 4):
        out = _phase(tsc, mnv["vcf"], bam, mnv["genome"],
                     os.path.join(d, f"i{threads}"), threads=threads)
        assert _read(out) == serial


def _write_bai(bam):
    """A .bai for an existing sorted BAM (the port's writer indexes the
    records it writes; this rewrites the same records with index=True,
    which leaves the bytes as they were)."""
    from pisces_tpu_torch.io.bam import BamReader
    from pisces_tpu_torch.io.bam_write import BamRecord, BamWriter
    r = BamReader(bam)
    b = r.fetch(parse_names=True)
    w = BamWriter(bam + ".tmp", r.header.ref_names, r.header.ref_lengths)
    acgtn = "AGCTN-"
    for i in range(b.n):
        cs, ce = b.cigar_off[i], b.cigar_off[i + 1]
        ss, se = b.seq_off[i], b.seq_off[i + 1]
        w.add(BamRecord(b.names[i], int(b.ref_id[i]), int(b.pos[i]),
                        int(b.mapq[i]), int(b.flag[i]),
                        list(zip(b.cigar_ops[cs:ce].tolist(),
                                 b.cigar_lens[cs:ce].tolist())),
                        "".join(acgtn[c] for c in b.seq[ss:se].tolist()),
                        b.qual[ss:se].tolist(),
                        next_ref_id=int(b.mate_ref_id[i]),
                        next_pos=int(b.mate_pos[i])))
    w.write(sort=False, index=True)
    assert _read_bytes(bam + ".tmp") == _read_bytes(bam)
    os.replace(bam + ".tmp", bam)
    os.replace(bam + ".tmp.bai", bam + ".bai")


def _read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_neighborhoods_veads_and_clusters_match_reference(mnv):
    """models.py and clustering.py: each neighborhood's sites, read groups
    (VeadFinder) and clusters (NeighborhoodClusterer) equal the
    reference's."""
    from pisces_tpu.io.bam import BamReader as JReader, filter_batch as jflt
    from pisces_tpu.io.fasta import Genome as JGenome
    from pisces_tpu.io.vcf_read import (
        read_header_and_variants as jread, to_called_alleles as jalleles,
    )
    from pisces_tpu.phasing import clustering as jcl
    from pisces_tpu.phasing import scylla as jsc
    from pisces_tpu_torch.io.bam import BamReader, filter_batch
    from pisces_tpu_torch.io.fasta import Genome
    from pisces_tpu_torch.io.vcf_read import (
        read_header_and_variants, to_called_alleles,
    )
    from pisces_tpu_torch.phasing import clustering as tcl

    def nbhds(mod, read, alleles):
        _, variants = read(mnv["vcf"])
        return mod.build_neighborhoods(
            (a for v in variants for a in alleles(v)),
            mod.PhasableVariantCriteria())

    tn = nbhds(tsc, read_header_and_variants, to_called_alleles)
    jn = nbhds(jsc, jread, jalleles)
    assert [(n.id, [(s.position, s.ref, s.alt) for s in n.sites])
            for n in tn] == [(n.id, [(s.position, s.ref, s.alt)
                                     for s in n.sites]) for n in jn]
    assert len(tn) >= 10
    tb = BamReader(mnv["bam"]).fetch(0)
    jb = JReader(mnv["bam"]).fetch(0)
    tk, jk = filter_batch(tb), jflt(jb)
    tseq = Genome(mnv["genome"]).get_chr_reference("chrM2").sequence
    jseq = JGenome(mnv["genome"]).get_chr_reference("chrM2").sequence
    topt, jopt = tsc.ScyllaOptions(), jsc.ScyllaOptions()
    for t, j in zip(tn, jn):
        t.set_range_of_interest(tseq)
        j.set_range_of_interest(jseq)
        tg = tsc.collect_vead_groups(t, tb, tk, topt)
        jg = jsc.collect_vead_groups(j, jb, jk, jopt)
        assert [(g.representative.key(), g.num_veads) for g in tg] == \
            [(g.representative.key(), g.num_veads) for g in jg]
        tc = tcl.NeighborhoodClusterer(topt.clustering).cluster_vead_groups(
            list(tg)).clusters
        jc = jcl.NeighborhoodClusterer(jopt.clustering).cluster_vead_groups(
            list(jg)).clusters
        assert [(c.name, c.num_veads,
                 [s.state_key() for s in c.consensus_sites()]) for c in tc] \
            == [(c.name, c.num_veads,
                 [s.state_key() for s in c.consensus_sites()]) for c in jc]


def test_scylla_reads_port_headers_to_reference_defaults(mnv):
    """The caller's flags written into ##Pisces_cmdline= set Scylla's
    defaults: the port's header, which also carries -device and -backend,
    gives the defaults that the reference reads from its own header."""
    from pisces_tpu.phasing.scylla import (
        pisces_defaults_from_vcf_header as jax_defaults,
    )
    port = tsc.pisces_defaults_from_vcf_header(mnv["vcf"])
    assert "-device cpu" in _read(mnv["vcf"])
    assert port == jax_defaults(mnv["jvcf"]) == \
        {"minvf": 0.02, "minbq": 22, "mindp": 12}


def test_scylla_cli_runs_as_module(mnv, tmp_path):
    """python -m pisces_tpu_torch.phasing.scylla writes the file that
    run_scylla writes with the header's defaults."""
    out = str(tmp_path / "cli")
    code = ("import sys, runpy; sys.argv = sys.argv[1:]; "
            "runpy.run_module('pisces_tpu_torch.phasing.scylla', "
            "run_name='__main__', alter_sys=True)")
    proc = subprocess.run(
        [sys.executable, "-c", code, "scylla", "-vcf", mnv["vcf"], "-bam",
         mnv["bam"], "-g", mnv["genome"], "-o", out, "-MaxNumThreads", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    from pisces_tpu.phasing.scylla import main as jax_scylla
    assert jax_scylla(["-vcf", mnv["vcf"], "-bam", mnv["bam"], "-g",
                       mnv["genome"], "-o", str(tmp_path / "j")]) == 0
    assert _read(os.path.join(out, "mnv.phased.vcf")) == \
        _read(str(tmp_path / "j" / "mnv.phased.vcf"))


def test_scylla_accuracy_arm_recall_precision(tmp_path):
    """The accuracy harness's scylla arm through its CLI at the reference
    bench's defaults (40 haplotypes, 300x over 30 kb, seed 13): recall =
    precision = 1.00, and the phased body equals the reference arm's."""
    from pisces_tpu.apps.accuracy import run_mnv_accuracy as jax_run
    out = str(tmp_path / "t")
    assert torch_accuracy.main(["scylla", "-o", out, "-device", "cpu",
                                "--seed", "13"]) == 0
    with open(os.path.join(out, "mnv_summary_scylla.csv")) as f:
        row = f.read().splitlines()[1].split(",")
    assert row[:5] == ["scylla", "40", "40", "0", "0"]
    assert float(row[5]) == float(row[6]) == 1.0
    ref = jax_run(str(tmp_path / "j"), mode="scylla", use_device=True)
    assert (ref.tp, ref.fp, ref.fn) == (40, 0, 0)
    assert _body(os.path.join(out, "mnv.phased.vcf")) == \
        _body(str(tmp_path / "j" / "mnv.phased.vcf"))


@pytest.fixture(scope="module")
def gemini_out(tmp_path_factory):
    """Unstitched pairs over 40 kb (4,000 fragments, 3% carrying recurrent
    indels) through the port's Gemini and the reference's, which must
    write the same bytes."""
    import filecmp

    from pisces_tpu.preprocessing import gemini as jg
    from pisces_tpu_torch.preprocessing import gemini as tg
    tmp = str(tmp_path_factory.mktemp("chain"))
    bam, genome = synthetic.write_paired_workload(
        os.path.join(tmp, "w"), 40_000, 4_000, indel_fraction=0.03, seed=7)
    stats = {}
    port = tg.run_gemini(bam, genome, os.path.join(tmp, "g.bam"),
                         stats=stats)
    ref = jg.run_gemini(bam, genome, os.path.join(tmp, "jg.bam"))
    for ext in ("", ".bai", ".indels.csv"):
        assert filecmp.cmp(port + ext, ref + ext, shallow=False), ext
    assert stats["stitched_pairs"] > 2000 and stats["realigned"] > 0
    return tmp, port, genome


def test_gemini_output_through_the_caller(gemini_out, device_everywhere):
    """The port's caller with -UseStitchedXD true reads Gemini's XD tags
    (its @PG line is gemini-tpu, not the Stitcher's) on the gVCF path:
    bodies held against the reference package's -backend jax and numpy."""
    tmp, bam, genome = gemini_out
    for gvcf in ("true", "false"):
        body = _four_runs(tmp, f"x{gvcf}", bam, genome, gvcf,
                          ["-UseStitchedXD", "true"])
        assert len(body) > 0
    plain = _run(torch_main, bam, genome, os.path.join(tmp, "noxd"), "true",
                 ["-device", "cpu"])
    assert plain != body


def test_chain_gemini_pisces_scylla(gemini_out, device_everywhere):
    """Gemini -> Pisces (-gVCF true -UseStitchedXD true) -> Scylla in both
    packages: the -backend numpy chains write equal phased files; the
    port's -backend torch chain is held against the reference's -backend
    jax chain as the bodies are."""
    from pisces_tpu.apps.pisces import main as jax_main
    from pisces_tpu.phasing import scylla as jsc
    tmp, bam, genome = gemini_out
    flags = ["-UseStitchedXD", "true"]
    runs = {
        "t": (torch_main, ["-device", "cpu", *flags], tsc),
        "tn": (torch_main, ["-device", "cpu", "-backend", "numpy", *flags],
               tsc),
        "j": (jax_main, ["-backend", "jax", *flags], jsc),
        "jn": (jax_main, ["-backend", "numpy", *flags], jsc),
    }
    phased = {}
    for tag, (main, extra, mod) in runs.items():
        _run(main, bam, genome, os.path.join(tmp, f"c{tag}"), "true", extra)
        vcf = os.path.join(tmp, f"c{tag}", "g.genome.vcf")
        out = _phase(mod, vcf, bam, genome, os.path.join(tmp, f"p{tag}"))
        assert out.endswith("g.phased.genome.vcf")
        phased[tag] = _body(out)
    assert phased["tn"] == phased["jn"]
    assert_port_calls(phased["t"], phased["j"], phased["tn"])
    n_var = sum(ln.split("\t")[4] != "." for ln in phased["t"])
    assert n_var > 20
