"""The port's multi-host runner (pisces_tpu_torch/parallel/multihost.py)
against the reference package's.

Workers are real processes joined through torch.distributed (gloo, a TCP
rendezvous on 127.0.0.1), each on the CPU here. Every merged VCF must be
byte-equal to the port's single-process run and to the reference
package's in-process multi-host run (both on the host f64 path: no batch
reaches a dispatch threshold at these sizes). The SIGKILL arm kills a
worker after its first shard; host 0 must steal the rest and every
survivor must exit 0. JAX is imported only inside the tests that run the
reference package.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (keeps JAX on the CPU)
from pisces_tpu.parallel import multihost as jax_multihost

from pisces_tpu_torch.apps.pisces import main as torch_main
from pisces_tpu_torch.entry import vcf_body
from pisces_tpu_torch.options import PiscesApplicationOptions
from pisces_tpu_torch.parallel import multihost
from pisces_tpu_torch.synthetic import write_synthetic_workload

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n_hosts", [1, 2, 3, 5])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_chromosome_assignment_matches_reference(seed, n_hosts):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 30))
    lengths = [(f"chr{i}", int(rng.integers(1, 5) * 1000)) for i in range(n)]
    assert multihost.host_chromosome_assignment(lengths, n_hosts) == \
        jax_multihost.host_chromosome_assignment(lengths, n_hosts)


def _shard(path, chrom, n):
    with open(path, "w") as f:
        f.write(f"##fileformat=VCFv4.1\n##shard={chrom}\n#CHROM\tPOS\n")
        for i in range(n):
            f.write(f"{chrom}\t{i + 1}\n")


def test_wait_and_merge_shards_in_genome_order(tmp_path):
    order = ["chr2", "chr10", "chr1"]
    shard_of = {c: str(tmp_path / f"b.vcf_{c}") for c in order}
    for c, n in zip(reversed(order), (1, 3, 2)):
        _shard(shard_of[c], c, n)
    final = multihost.wait_and_merge_shards(str(tmp_path / "b.vcf"),
                                            shard_of, order, poll_s=0.01)
    with open(final) as f:
        lines = f.read().splitlines()
    # the first shard's header, then every shard's data lines in order
    assert lines == ["##fileformat=VCFv4.1", "##shard=chr2", "#CHROM\tPOS",
                     "chr2\t1", "chr2\t2", "chr10\t1", "chr10\t2",
                     "chr10\t3", "chr1\t1"]
    assert not any(os.path.exists(p) for p in shard_of.values())


def test_wait_and_merge_shards_recovers_a_stalled_shard(tmp_path):
    order = ["chr1", "chr2"]
    shard_of = {c: str(tmp_path / f"b.vcf_{c}") for c in order}
    _shard(shard_of["chr1"], "chr1", 2)
    stolen = []

    def recover(chrom):
        stolen.append(chrom)
        _shard(shard_of[chrom], chrom, 1)

    final = multihost.wait_and_merge_shards(
        str(tmp_path / "b.vcf"), shard_of, order, poll_s=0.01,
        recover=recover, stall_s=0.05)
    assert stolen == ["chr2"]
    assert vcf_body(final) == ["chr1\t1", "chr1\t2", "chr2\t1"]


def test_init_distributed_single_process_is_a_no_op(monkeypatch):
    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.init_distributed() == (0, 1)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
    monkeypatch.setenv("JAX_PROCESS_ID", "0")
    assert multihost.init_distributed() == (0, 1)
    assert multihost.process_count() == 1


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("multihost"))
    bam, genome = write_synthetic_workload(os.path.join(tmp, "w"), 2,
                                           40_000, 4_000, seed=0)
    return tmp, bam, genome


def _options(out_dir, cls=PiscesApplicationOptions):
    o = cls()
    o.output_directory = str(out_dir)
    o.vcf_writing_parameters.output_gvcf_file = True
    return o


@pytest.fixture(scope="module")
def single(workload, tmp_path_factory):
    """The port's and the reference package's single-process multi-host
    bodies (no coordinator: one host calls every chromosome)."""
    from pisces_tpu.options import PiscesApplicationOptions as JOptions
    tmp, bam, genome = workload
    env = {k: os.environ.pop(k) for k in
           ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")
           if k in os.environ}
    try:
        port = multihost.process_bam_multihost(
            _options(os.path.join(tmp, "single")), bam, genome, device="cpu")
        ref = jax_multihost.process_bam_multihost(
            _options(os.path.join(tmp, "jsingle"), JOptions), bam, genome,
            use_device=False)
    finally:
        os.environ.update(env)
    return vcf_body(port), vcf_body(ref)


def test_single_process_matches_reference(single):
    port, ref = single
    assert port == ref and len(port) > 70_000


def test_two_processes_match_single_and_reference(workload, single):
    tmp, bam, genome = workload
    merged = multihost.run_local_multihost(
        bam, genome, os.path.join(tmp, "two"), n_procs=2, device="cpu",
        timeout_s=300)
    body = vcf_body(merged)
    assert body == single[0] == single[1]


def test_sigkill_arm_recovers_byte_equal(tmp_path):
    """A worker SIGKILLed after its first shard: host 0 steals its other
    chromosome after recover_stall_s and the merged VCF equals the
    single-process run's; the surviving worker exits 0 (run_local_multihost
    raises otherwise)."""
    bam, genome = write_synthetic_workload(str(tmp_path / "w"), 4, 30_000,
                                           6_000, seed=0)
    merged = multihost.run_local_multihost(
        bam, genome, str(tmp_path / "kill"), n_procs=2, device="cpu",
        timeout_s=300, kill_worker=1, recover_stall_s=4, delay_per_chr=3)
    single = multihost.process_bam_multihost(
        _options(tmp_path / "one"), bam, genome, device="cpu")
    assert vcf_body(merged) == vcf_body(single)
    assert len(vcf_body(merged)) > 100_000


_EARLY_EXIT = """
import sys, time
sys.path.insert(0, {repo!r})
from pisces_tpu_torch.parallel.multihost import init_distributed, process_count
rank = int(sys.argv[2])
assert init_distributed(sys.argv[1], 2, rank) == (rank, 2)
if rank == 1:
    time.sleep(3)   # rank 0, the rendezvous store's server, is gone by now
print(f"rank {{rank}} process_count={{process_count()}}", flush=True)
"""


def test_a_worker_outlives_the_store_serving_rank(tmp_path):
    """Rank 0 serves the rendezvous store and leaves first; rank 1 still
    finishes and exits 0: no worker waits on a peer after the join."""
    script = tmp_path / "early.py"
    script.write_text(_EARLY_EXIT.format(repo=REPO))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, str(script), f"127.0.0.1:{port}", str(i)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out
        assert f"rank {i} process_count=2" in out


def test_multihost_cli_without_coordinator_equals_serial(workload,
                                                         monkeypatch):
    tmp, bam, genome = workload
    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    bodies = []
    for name, flags in (("cli_mh", ["-MultiHost", "true"]), ("cli_one", [])):
        out = os.path.join(tmp, name)
        assert torch_main(["-bam", bam, "-g", genome, "-o", out, "-gVCF",
                           "true", "-device", "cpu", *flags]) == 0
        bodies.append(vcf_body(os.path.join(out, "b.genome.vcf")))
    assert bodies[0] == bodies[1] and len(bodies[0]) > 0


def test_multihost_cli_joins_from_the_environment(workload, single):
    """Two CLI processes with -MultiHost true and the JAX_* variables (the
    launch the reference package takes) join one group; host 0 writes the
    merged VCF, byte-equal to the one-process run."""
    tmp, bam, genome = workload
    out = os.path.join(tmp, "cli_env")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for i in range(2):
        env = dict(os.environ, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(i),
                   PYTHONPATH=os.pathsep.join(
                       [REPO] + ([os.environ["PYTHONPATH"]]
                                 if os.environ.get("PYTHONPATH") else [])))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "pisces_tpu_torch.apps.pisces", "-bam",
             bam, "-g", genome, "-o", out, "-gVCF", "true", "-device", "cpu",
             "-MultiHost", "true"], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, outs):
        assert p.returncode == 0, log[-2000:]
    assert "host 0/2" in outs[0] and "host 1/2" in outs[1]
    assert vcf_body(os.path.join(out, "b.genome.vcf")) == single[0]


def test_multihost_needs_cuda_unless_cpu(workload, monkeypatch):
    tmp, bam, genome = workload
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        multihost.process_bam_multihost(_options(os.path.join(tmp, "nc")),
                                        bam, genome)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        multihost.main(["-bam", bam, "-g", genome, "-o",
                        os.path.join(tmp, "nc"), "--coordinator",
                        "127.0.0.1:1", "--nprocs", "2", "--pid", "0"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        multihost.run_local_multihost(bam, genome, os.path.join(tmp, "nc"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_main(["-bam", bam, "-g", genome, "-o", os.path.join(tmp, "nc"),
                    "-MultiHost", "true"])
