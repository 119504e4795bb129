"""The port's mesh-sharded gVCF scoring (pisces_tpu_torch/parallel/sharding.py)
against the reference package's (pisces_tpu/parallel/sharding.py, its
shard_map step on conftest's 8 virtual XLA CPU devices) and against the
port's own single-device path.

The same seeded events go through both packages. The host geometry and the
partial count buffers are numpy in both and must be equal. The scored
positions and every integer output must equal the JAX mesh's; reference-line
SB is held against it within the kernels' tolerance (1e-3 dB above -40 dB,
5% below, loci where XLA's igamma underflows to -inf left out, as in
tests/test_torch_kernels.py). Against the port's single-device
score_reference_positions (tuple kernel, dispatch threshold forced to 1)
every per-position output must be equal, SB included: both run the same f32
math on the same integer sums. The reference sequence carries N bases, whose
support both packages' mesh steps take from the N row.

The `cuda`-marked twin runs the mesh on one card with 1 and 4 shards:
    python -m pytest tests/test_torch_sharding.py -m cuda -q
"""
import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (keeps JAX on the CPU)
import pisces_tpu_torch.calling.fast_gvcf as torch_fast_gvcf
from pisces_tpu_torch.calling.intervals import ChrIntervalSet, Region
from pisces_tpu_torch.ops import scoring_kernels as K
from pisces_tpu_torch.ops.scoring_params import ScoringParams
from pisces_tpu_torch.parallel import sharding as S
from pisces_tpu_torch.pileup.counts import build_counts_host
from pisces_tpu_torch.pileup.events import BaseEvents

INT_KEYS = ("total_coverage", "support", "variant_qscore", "genotype", "gq")
INTERVALS = [(100, 400), (900, 1100), (1800, 1830), (3000, 3050)]


def _event_arrays(seed=7, n_reads=160, read_len=40, span=1800):
    """Reads tiled over a small domain so many cross the 256-aligned shard
    edges; alleles include N and deletions, directions include stitched."""
    rng = np.random.default_rng(seed)
    starts = np.sort(rng.integers(1, span, n_reads)).astype(np.int64)
    gpos = (starts[:, None] + np.arange(read_len)[None, :]).reshape(-1)
    ne = gpos.size
    return dict(
        gpos=gpos,
        allele=rng.choice(np.array([0, 1, 2, 3, 4, 5], np.int8), ne,
                          p=[.3, .2, .2, .2, .05, .05]),
        direction=rng.choice(np.array([0, 1, 2], np.int8), ne,
                             p=[.45, .45, .1]),
        anchor=rng.integers(0, 11, ne).astype(np.int8),
        qerr=np.full(ne, 1e-3, np.float32),
        is_deletion_gap=np.zeros(ne, bool),
        read_start=np.repeat(starts, read_len),
    )


def _both_events(**kw):
    from pisces_tpu.pileup.events import BaseEvents as JaxBaseEvents
    arrays = _event_arrays(**kw)
    return BaseEvents(**arrays), JaxBaseEvents(**arrays)


def _refseq(length, seed=3):
    rng = np.random.default_rng(seed)
    seq = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), length)
    seq[rng.integers(0, length, length // 20)] = ord("N")
    return seq


def _per_position(out):
    """Expand unique-tuple outputs back to per-position arrays."""
    inv = out["inv"]
    return {k: np.asarray(v)[inv] for k, v in out.items()
            if k not in ("inv", "ref_base")}


def _assert_sb_close(got, want):
    keep = np.isfinite(want)
    got = np.clip(got[keep], -100.0, 0.0)
    want = np.clip(want[keep], -100.0, 0.0)
    shallow = want > -40.0
    np.testing.assert_allclose(got[shallow], want[shallow], atol=1e-3)
    np.testing.assert_allclose(got[~shallow], want[~shallow], rtol=0.05)


@pytest.mark.parametrize("n", list(range(1, 17)))
def test_factor_mesh_matches_jax(n):
    from pisces_tpu.parallel.sharding import factor_mesh
    assert S.factor_mesh(n) == factor_mesh(n)
    mesh = S.Mesh(["cpu"] * n)
    assert (mesh.shape["dp"], mesh.shape["sp"]) == factor_mesh(n)
    assert mesh.size == n


@pytest.mark.parametrize("shards,geometry", [
    (1, "tiled"), (2, "tiled"), (8, "tiled"), (8, "grown"), (3, "tiled")])
def test_geometry_and_partial_counts_match_jax(shards, geometry):
    from pisces_tpu.parallel.sharding import (
        build_partial_counts, plan_shards,
    )
    # "grown": 150 bp reads over 600 bp force halo >= l_local, so
    # plan_shards grows the shards and the trailing ones stay empty
    kw = dict(read_len=150, span=600) if geometry == "grown" else {}
    ev, jev = _both_events(**kw)
    geo, jgeo = S.plan_shards(ev, shards), plan_shards(jev, shards)
    for k in ("domain_start", "l_local", "halo", "n_shards", "l_pad"):
        assert getattr(geo, k) == getattr(jgeo, k), k
    np.testing.assert_array_equal(S.build_partial_counts(ev, geo),
                                  build_partial_counts(jev, jgeo))
    if geometry == "grown":
        assert geo.halo < geo.l_local and geo.l_pad > 2 * 600


def test_halo_carries_real_data():
    ev, _ = _both_events()
    geo = S.plan_shards(ev, 8)
    assert geo is not None and geo.n_shards == 8
    partial = S.build_partial_counts(ev, geo)
    width = geo.l_local + geo.halo
    tails = partial.reshape(8, width, 6, 3)[:, geo.l_local:]
    # most shards pass boundary-crossing counts to their right neighbour
    assert (tails[:7].sum(axis=(1, 2, 3)) > 0).sum() >= 5
    # and the sharded sum after the ring shift is the unsharded scatter
    owned = partial.reshape(8, width, 6, 3)[:, :geo.l_local].copy()
    owned[1:, :geo.halo] += tails[:-1]
    dense = np.zeros((geo.l_pad, 6, 3), np.int64)
    np.add.at(dense, (ev.gpos - geo.domain_start, ev.allele, ev.direction),
              1)
    np.testing.assert_array_equal(owned.reshape(geo.l_pad, 6, 3), dense)


def _intervals(cls_set, cls_region):
    return cls_set([cls_region(a, b) for a, b in INTERVALS], "chr1")


def _case(mode):
    """(refseq, port intervals, JAX intervals) for a mode: every touched
    position; a sequence shorter than the events' span (positions past its
    end are clamped for their code and masked out); an interval set with a
    range past the events and one in an untouched 1000-bp block."""
    from pisces_tpu.calling.intervals import ChrIntervalSet as JSet
    from pisces_tpu.calling.intervals import Region as JRegion
    if mode == "short_ref":
        return _refseq(1700), None, None
    if mode == "intervals":
        return (_refseq(3500), _intervals(ChrIntervalSet, Region),
                _intervals(JSet, JRegion))
    return _refseq(3500), None, None


def _single_device(ev, refseq, intervals, device, monkeypatch):
    monkeypatch.setattr(torch_fast_gvcf, "DEVICE_TUPLE_THRESHOLD", 1)
    pc = build_counts_host(ev, anchor_size=5)
    return torch_fast_gvcf.score_reference_positions(
        pc, refseq, ScoringParams(), device=device, intervals=intervals)


@pytest.mark.parametrize("mode", ["all", "short_ref", "intervals"])
@pytest.mark.parametrize("shards", [1, 2, 8])
def test_sharded_matches_jax_mesh_and_single_device(shards, mode,
                                                     monkeypatch):
    import jax
    from pisces_tpu.ops.jax_scoring import ScoringParams as JParams
    from pisces_tpu.parallel.sharding import make_mesh as jax_make_mesh
    from pisces_tpu.parallel.sharding import (
        sharded_score_reference_positions as jax_sharded,
    )
    ev, jev = _both_events()
    refseq, ivs, jivs = _case(mode)
    pos, out, stats = S.sharded_score_reference_positions(
        ev, refseq, ScoringParams(), S.Mesh(["cpu"] * shards), ivs)
    jpos, jout, jstats = jax_sharded(
        jev, refseq, JParams(), jax_make_mesh(jax.devices()[:shards]), jivs)

    np.testing.assert_array_equal(pos, jpos)
    assert stats == jstats
    a, j = _per_position(out), _per_position(jout)
    for k in INT_KEYS:
        np.testing.assert_array_equal(a[k], j[k], err_msg=k)
    _assert_sb_close(a["sb_gatk"], j["sb_gatk"])
    np.testing.assert_array_equal(out["ref_base"], jout["ref_base"])
    if mode == "intervals":
        np.testing.assert_array_equal(a["is_padding"], j["is_padding"])
        assert a["is_padding"].any() and not a["is_padding"].all()
    else:
        assert pos.max() <= len(refseq)

    pos1, out1 = _single_device(ev, refseq, ivs, torch.device("cpu"),
                                monkeypatch)
    np.testing.assert_array_equal(pos, pos1)
    b = _per_position(out1)
    for k in a:           # the mesh's outputs: all but frequency
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(out["ref_base"], out1["ref_base"])
    # reference N positions were scored, with the N count as support
    assert (out["ref_base"] == ord("N")).any()


def test_empty_event_stream_scores_nothing():
    arrays = {k: v[:0] for k, v in _event_arrays().items()}
    pos, out, stats = S.sharded_score_reference_positions(
        BaseEvents(**arrays), _refseq(100), ScoringParams(),
        S.Mesh(["cpu"] * 2))
    assert len(pos) == 0 and out is None and stats == {}


@pytest.mark.parametrize("n", [1000, 5])
def test_sharded_snv_tuples_match_jax_and_unsharded(n):
    import jax
    from pisces_tpu.ops.jax_scoring import ScoringParams as JParams
    from pisces_tpu.parallel.sharding import make_mesh as jax_make_mesh
    from pisces_tpu.parallel.sharding import (
        sharded_score_snv_tuples as jax_sharded_snv,
    )
    from pisces_tpu_torch.ops.torch_scoring import score_snv_loci

    rng = np.random.default_rng(3)
    cov = rng.integers(0, 300, size=(n, 3)).astype(np.int32)
    sup = (cov * rng.random((n, 3)) * 0.3).astype(np.int32)
    total = cov.sum(axis=1).astype(np.int32)
    ref_sup = (total - sup.sum(axis=1)).clip(0).astype(np.int32)
    nc = rng.integers(0, 4, size=n).astype(np.int32)
    args = (sup, cov, ref_sup, nc, total)
    # n = 1000 is not a multiple of 8; n = 5 leaves three shards empty
    got = S.sharded_score_snv_tuples(*args, ScoringParams(),
                                     S.Mesh(["cpu"] * 8))
    ref = jax_sharded_snv(*args, JParams(), jax_make_mesh(jax.devices()[:8]))
    single = score_snv_loci(*(torch.from_numpy(a) for a in args),
                            ScoringParams())
    for k in ("variant_qscore", "genotype", "gq", "filter_bits"):
        assert got[k].shape == (n,)
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        np.testing.assert_array_equal(got[k], single[k].numpy(), err_msg=k)


def test_get_mesh(monkeypatch):
    mesh = S.get_mesh(8, "cpu")
    assert mesh.size == 8 and all(d.type == "cpu" for d in mesh.devices)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="available 1 CUDA devices"):
        S.get_mesh(2, "cuda")
    assert S.get_mesh(1, "cuda").devices == [torch.device("cuda", 0)]
    with pytest.raises(ValueError, match="no mesh"):
        S.get_mesh(2, "meta")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["all", "short_ref"])
@pytest.mark.parametrize("shards", [1, 4, "every card"])
def test_sharded_on_card_matches_single_device(shards, mode, monkeypatch):
    """Shards on the first card, or one shard on every card (-MeshDevices
    with all of them: the halo crosses cards)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda", 0)
    if shards == "every card":
        mesh = S.get_mesh(torch.cuda.device_count(), "cuda")
    else:
        mesh = S.Mesh([dev] * shards)
    ev = BaseEvents(**_event_arrays())
    refseq = _refseq(1700 if mode == "short_ref" else 3500)
    K.reset_launch_counts()
    pos, out, _stats = S.sharded_score_reference_positions(
        ev, refseq, ScoringParams(), mesh)
    for d in mesh.devices:
        torch.cuda.synchronize(d)
    assert K.launch_counts["score_loci"] == mesh.size
    pos1, out1 = _single_device(ev, refseq, None, dev, monkeypatch)
    np.testing.assert_array_equal(pos, pos1)
    a, b = _per_position(out), _per_position(out1)
    for k in INT_KEYS:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    _assert_sb_close(a["sb_gatk"], b["sb_gatk"])
