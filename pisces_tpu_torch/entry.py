"""Entry points of the port for a one-card check and a mesh dry run: the
dense locus tile and the sharded step (the counterparts of the reference
package's __graft_entry__.py).

    python -m pisces_tpu_torch.entry            # on the CUDA cards
"""
from __future__ import annotations

import itertools
import os
import shutil
import tempfile
from typing import List

import numpy as np
import torch

from pisces_tpu_torch.device import resolve_device
from pisces_tpu_torch.ops.scoring_kernels import score_reference_loci
from pisces_tpu_torch.ops.scoring_params import ScoringParams


def entry(device="cuda"):
    """Return (fn, example_args): the dense per-locus scoring step (the
    counts kernel, ops/scoring_kernels.score_reference_loci) on an
    8192-locus tile of [L, 6, 3, 11] anchor-resolved counts on `device`;
    fn sums the anchor axis and scores."""
    dev = resolve_device(device)
    params = ScoringParams()

    def fn(counts, ref_code):
        return score_reference_loci(counts.sum(dim=-1, dtype=torch.int32),
                                    ref_code, params)

    rng = np.random.default_rng(0)
    L = 8192
    counts = rng.integers(0, 30, size=(L, 6, 3, 11)).astype(np.int32)
    ref_code = rng.integers(0, 4, size=(L,)).astype(np.int32)
    return fn, (torch.from_numpy(counts).to(dev),
                torch.from_numpy(ref_code).to(dev))


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Run ONE step of the mesh-sharded scoring path on an n-device mesh of
    `device`'s type (with CUDA, n cards; raises when there are fewer): read
    routing to position shards, per-shard partial count buffers, the halo
    ring shift, the counts kernel on every shard and the summed summaries
    (parallel/sharding.sharded_score_reference_positions, the function
    -MeshDevices calls); then a candidate batch through the sharded SNV
    scoring, and a synthetic BAM through the CLI's process_bam with and
    without the mesh. Raises if any stage fails."""
    from pisces_tpu_torch.parallel.sharding import (
        get_mesh, plan_shards, sharded_score_reference_positions,
        sharded_score_snv_tuples,
    )
    from pisces_tpu_torch.pileup.events import BaseEvents

    mesh = get_mesh(n_devices, resolve_device(device))
    rng = np.random.default_rng(0)
    n_reads, rl = 400, 48
    starts = np.sort(rng.integers(1, 4000, n_reads)).astype(np.int64)
    gpos = (starts[:, None] + np.arange(rl)[None, :]).reshape(-1)
    read_start = np.repeat(starts, rl)
    ne = gpos.size
    ev = BaseEvents(
        gpos=gpos,
        allele=rng.integers(0, 4, ne).astype(np.int8),
        direction=rng.integers(0, 2, ne).astype(np.int8),
        anchor=np.full(ne, 5, np.int8),
        qerr=np.full(ne, 1e-3, np.float32),
        is_deletion_gap=np.zeros(ne, bool),
        read_start=read_start,
    )
    refseq = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), 8192)
    geo = plan_shards(ev, mesh.size)
    positions, out, stats = sharded_score_reference_positions(
        ev, refseq, ScoringParams(), mesh)
    if positions.size == 0 or out is None:
        raise AssertionError("the sharded step scored no loci")

    # variant-bearing stage: candidate tuples (SNV-like, 20% VF) scored
    # through the mesh-sharded score_snv_loci — the -MeshDevices candidate
    # path (calling/caller.py _qscore_batch_device mesh branch)
    nc_cands = 3000
    cov = rng.integers(40, 300, size=(nc_cands, 3)).astype(np.int32)
    sup = (cov * 0.2).astype(np.int32)
    total = cov.sum(axis=1).astype(np.int32)
    ref_sup = (total - sup.sum(axis=1)).astype(np.int32)
    nc = rng.integers(0, 3, nc_cands).astype(np.int32)
    cand_out = sharded_score_snv_tuples(sup, cov, ref_sup, nc, total,
                                        ScoringParams(), mesh)
    n_variants = int((cand_out["variant_qscore"] >= 20).sum())
    if n_variants == 0:
        raise AssertionError("variant-bearing dryrun must call variants")
    print(f"dryrun_multichip: mesh={mesh.shape} devices="
          f"{[str(d) for d in mesh.devices]} l_local={geo.l_local} "
          f"halo={geo.halo} loci={positions.size} "
          f"variants_called={n_variants} stats={stats}", flush=True)
    _dryrun_pipeline(n_devices, device)


def _dryrun_pipeline(n_devices: int, device) -> None:
    """A synthetic BAM (1 x 20 kb, 8,000 reads) through process_bam without
    and with -MeshDevices n_devices; the gVCF bodies must agree
    (compare_vcf_bodies)."""
    from pisces_tpu_torch.apps.pisces import process_bam
    from pisces_tpu_torch.io.fasta import Genome
    from pisces_tpu_torch.options import PiscesApplicationOptions
    from pisces_tpu_torch.synthetic import write_synthetic_workload

    tmp = tempfile.mkdtemp(prefix="pisces_dryrun_")
    try:
        bam, gdir = write_synthetic_workload(os.path.join(tmp, "wl"), 1,
                                             20_000, 8_000, seed=0)
        genome = Genome(gdir)
        bodies = {}
        for label, mesh_devices in (("single", 0), ("mesh", n_devices)):
            o = PiscesApplicationOptions()
            o.output_directory = os.path.join(tmp, label)
            o.vcf_writing_parameters.output_gvcf_file = True
            o.mesh_devices = mesh_devices
            path = process_bam(o, bam, genome, device=device)
            bodies[label] = vcf_body(path)
        n = compare_vcf_bodies(bodies["mesh"], bodies["single"])
        print(f"dryrun_multichip pipeline: synthetic 20 kb BAM, "
              f"mesh_devices={n_devices} vcf_lines={n} equal=True",
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def vcf_body(path: str) -> List[str]:
    """The lines of a VCF without its header."""
    with open(path) as f:
        return [ln for ln in f.read().splitlines() if not ln.startswith("#")]


def _split_sb(line: str):
    """(line without the reference-line SB value, that SB or None)."""
    f = line.split("\t")
    if f[4] != "." or not f[8].endswith(":SB"):
        return line, None
    head, _, sb = line.rpartition(":")
    return head, float(sb)


def _compare_lines(a: str, b: str) -> None:
    (ha, sa), (hb, sb) = _split_sb(a), _split_sb(b)
    if ha != hb:
        raise AssertionError(f"VCF lines differ:\n{a}\n{b}")
    if sa is not None:
        tol = 1e-3 if sb > -40.0 else 0.05 * abs(sb)
        if abs(sa - sb) > tol:
            raise AssertionError(f"reference-line SB differs:\n{a}\n{b}")


def compare_vcf_bodies(got: List[str], want: List[str]) -> int:
    """Raise unless every field of `got` equals `want`'s, the
    reference-line SB within 1e-3 dB above -40 dB and 5% below (the
    tolerance between the f32 kernels and the f64 host path). Returns the
    number of lines."""
    if len(got) != len(want) or not got:
        raise AssertionError(f"VCF bodies differ in length: {len(got)} vs "
                             f"{len(want)}")
    for a, b in zip(got, want):
        _compare_lines(a, b)
    return len(got)


def compare_vcf_files(got_path: str, want_path: str,
                      lines_per_step: int = 1 << 18) -> int:
    """compare_vcf_bodies over two VCF files, read a step of lines at a
    time (a genome's gVCF does not fit in a list); steps whose lines are
    equal skip the per-line check. Returns the number of body lines."""
    def body(f):
        for line in f:
            if not line.startswith("#"):
                return itertools.chain([line], f)
        return iter(())

    n = 0
    with open(got_path) as fg, open(want_path) as fw:
        got, want = body(fg), body(fw)
        while True:
            a = list(itertools.islice(got, lines_per_step))
            b = list(itertools.islice(want, lines_per_step))
            if len(a) != len(b):
                raise AssertionError(f"VCF bodies differ in length: "
                                     f"{n + len(a)} vs {n + len(b)} lines")
            if not a:
                break
            if a != b:
                for x, y in zip(a, b):
                    _compare_lines(x.rstrip("\n"), y.rstrip("\n"))
            n += len(a)
    if n == 0:
        raise AssertionError(f"{got_path} has no VCF body")
    return n


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry ok:", {k: tuple(v.shape) for k, v in out.items()})
    dryrun_multichip(torch.cuda.device_count())
