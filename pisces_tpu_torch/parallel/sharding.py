"""Multi-device region sharding: the mesh-sharded gVCF scoring step.

The port of the reference package's parallel/sharding.py. The genome
position axis is row-sharded over a mesh of devices in one process, the
counterpart of `shard_map` over a host's local devices (-MultiHost,
parallel/multihost.py, runs no collective across processes, as in the
reference package). Reads are routed to the
shard owning their START position (the ownership rule of the reference's
read-to-block ingestion, RegionStateManager.AddAlleleCounts, cs:118-220);
each shard's PARTIAL count buffer covers [shard_start, shard_end + halo).
Events of a read that extend past the shard's right edge land in the halo
tail, which goes to the right neighbour before scoring: the ring shift by
one in flattened (dp, sp) shard order that the reference package's two
ppermutes make, with shard 0 receiving zeros. Then each shard scores its own
positions with the counts kernel (ops/scoring_kernels.score_reference_loci)
on its device, and the global summaries are summed over the shards (the
psum).

A mesh is a list of torch devices and may repeat one: the CPU tests build
multi-shard meshes on the one torch CPU device, and chip_smoke.py on one
card. `-MeshDevices N` (apps/pisces.py) takes the first N devices of
`-device`'s type (get_mesh).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from pisces_tpu_torch.domain.types import (
    BASE_TO_ALLELE, NUM_ALLELE_TYPES, NUM_DIRECTION_TYPES,
)
from pisces_tpu_torch.ops.scoring_kernels import score_reference_loci
from pisces_tpu_torch.ops.scoring_params import ScoringParams
from pisces_tpu_torch.pileup.events import BaseEvents
from pisces_tpu_torch.utils.metrics import metrics

_AD = NUM_ALLELE_TYPES * NUM_DIRECTION_TYPES  # 18


def factor_mesh(n: int) -> Tuple[int, int]:
    """Factor n devices into (dp, sp), preferring a balanced 2D mesh."""
    best = (1, n)
    for dp in range(1, int(n ** 0.5) + 1):
        if n % dp == 0:
            best = (dp, n // dp)
    return best


class Mesh:
    """An in-process device mesh: one torch device per shard, in flattened
    (dp, sp) order (shard g = dp_idx * sp + sp_idx)."""

    def __init__(self, devices: Sequence):
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        dp, sp = factor_mesh(len(self.devices))
        self.shape = {"dp": dp, "sp": sp}

    @property
    def size(self) -> int:
        return len(self.devices)


def get_mesh(n_devices: int, device="cuda") -> Mesh:
    """The mesh of `-MeshDevices n_devices` on `device`'s type: the first
    n_devices cards for CUDA, which raises when there are fewer; n_devices
    shards on the one CPU device for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        have = torch.cuda.device_count()
        if n_devices > have:
            raise ValueError(f"-MeshDevices {n_devices} > available {have} "
                             "CUDA devices")
        return Mesh([torch.device("cuda", i) for i in range(n_devices)])
    if dev.type == "cpu":
        return Mesh([dev] * n_devices)
    raise ValueError(f"no mesh on device type {dev.type}")


# ---------------------------------------------------------------------------
# Geometry + host-side read routing
# ---------------------------------------------------------------------------

class ShardGeometry:
    """Position-axis shard layout for one chromosome domain.

    domain_start: 1-based genomic position of local index 0
    l_local: positions owned per shard; l_pad = n_shards * l_local
    halo: positions past each shard's right edge its partial buffer covers
    """

    def __init__(self, domain_start: int, l_local: int, halo: int,
                 n_shards: int):
        self.domain_start = domain_start
        self.l_local = l_local
        self.halo = halo
        self.n_shards = n_shards
        self.l_pad = n_shards * l_local


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def plan_shards(ev: BaseEvents, n_shards: int,
                min_halo: int = 128) -> Optional[ShardGeometry]:
    """Choose the shard geometry for an event stream.

    Reads own the shard containing their start; the halo must cover the
    furthest any read's events reach past its owner's right edge. Returns
    None when the domain is too small to shard safely (halo would exceed
    l_local — a read could span more than one neighbor, which the
    single-ring-shift halo cannot represent)."""
    if len(ev.gpos) == 0 or n_shards < 1:
        return None
    lo = int(ev.read_start.min())
    hi = int(ev.gpos.max())
    span = hi - lo + 1
    l_local = _round_up(max(1, -(-span // n_shards)), 256)
    # how far events reach past their read's start
    reach = int((ev.gpos - ev.read_start).max()) + 1
    halo = max(min_halo, 1 << (reach - 1).bit_length())
    if halo >= l_local:
        # grow shards until the halo fits (may underfill trailing shards)
        l_local = _round_up(halo + 256, 256)
    return ShardGeometry(lo, l_local, halo, n_shards)


def build_partial_counts(ev: BaseEvents, geo: ShardGeometry) -> np.ndarray:
    """Scatter events into per-owner-shard PARTIAL count buffers.

    Returns int32 [n_shards * (l_local + halo), 6, 3]. Events whose position
    falls past their owner's right edge land in the owner's halo tail rows
    (indices >= l_local); the device step ships those to the right neighbor.
    The scatter is a pure commutative integer sum, so the sharded total
    after the halo add is bit-identical to the single-buffer scatter.
    """
    width = geo.l_local + geo.halo
    owner = (ev.read_start - geo.domain_start) // geo.l_local
    local = ev.gpos - geo.domain_start - owner * geo.l_local
    if len(local) and (int(local.max()) >= width or int(local.min()) < 0):
        raise AssertionError("event outside its owner shard's halo window")
    lin = ((owner * width + local) * NUM_ALLELE_TYPES
           + ev.allele.astype(np.int64)) * NUM_DIRECTION_TYPES \
        + ev.direction.astype(np.int64)
    size = geo.n_shards * width * _AD
    order = np.argsort(lin, kind="stable")
    lin_s = lin[order]
    uniq, start = np.unique(lin_s, return_index=True)
    counts_u = np.diff(np.append(start, len(lin_s)))
    flat = np.zeros(size, np.int32)
    flat[uniq] = counts_u
    return flat.reshape(geo.n_shards * width, NUM_ALLELE_TYPES,
                        NUM_DIRECTION_TYPES)


# ---------------------------------------------------------------------------
# The sharded device step
# ---------------------------------------------------------------------------

_STEP_KEYS = ("touched", "total_coverage", "support", "support_by_dir",
              "coverage_by_dir", "variant_qscore", "genotype", "gq",
              "sb_gatk")


def _sharded_step(mesh: Mesh, partial: np.ndarray, ref_codes: np.ndarray,
                  params: ScoringParams, l_local: int, halo: int):
    """Halo exchange + the counts kernel on every shard + summed summaries
    (the reference package's shard_map'd `_build_step`, sharding.py:159-206).

    partial: int32 [n_shards * (l_local + halo), 6, 3]; ref_codes: int32
    [n_shards * l_local]. Returns the per-position outputs of all shards,
    concatenated in shard order on the host, and (called, covered)."""
    width = l_local + halo
    parts = [torch.from_numpy(partial[g * width:(g + 1) * width]).to(dev)
             for g, dev in enumerate(mesh.devices)]
    outs = []
    for g, dev in enumerate(mesh.devices):
        counts = parts[g][:l_local]           # contiguous [l_local, 6, 3]
        if g > 0:
            # the ring shift: shard g receives shard g-1's tail (halo <
            # l_local, so no shard's tail is a row another shard adds to)
            counts[:halo] += parts[g - 1][l_local:].to(dev)
        ref = torch.from_numpy(ref_codes[g * l_local:(g + 1) * l_local]).to(dev)
        out = score_reference_loci(counts, ref, params)
        out["touched"] = counts.sum(dim=(1, 2), dtype=torch.int32)
        outs.append(out)
    host = {k: np.concatenate([o[k].cpu().numpy() for o in outs])
            for k in _STEP_KEYS}
    called = int(np.sum((host["variant_qscore"] >= params.min_variant_qscore)
                        & (host["touched"] > 0)))
    covered = int(np.sum(host["total_coverage"] > 0))
    return host, called, covered


def sharded_score_snv_tuples(sup_by_dir, cov_by_dir, ref_support,
                             num_no_calls, total_coverage,
                             params: ScoringParams, mesh: Mesh):
    """Score a candidate batch over the mesh: contiguous chunks, one per
    shard, through torch_scoring.score_snv_loci on the shard's device
    (`_build_snv_step` + `sharded_score_snv_tuples`, sharding.py:209-254).
    Returns the score_snv_loci output dict as numpy arrays of the input's
    length; nothing is padded."""
    from pisces_tpu_torch.ops.torch_scoring import score_snv_loci

    n = len(total_coverage)
    cols = [np.ascontiguousarray(a, dtype=np.int32) for a in
            (sup_by_dir, cov_by_dir, ref_support, num_no_calls,
             total_coverage)]
    bounds = [g * n // mesh.size for g in range(mesh.size + 1)]
    outs = []
    for g, dev in enumerate(mesh.devices):
        lo, hi = bounds[g], bounds[g + 1]
        args = [torch.from_numpy(c[lo:hi]).to(dev) for c in cols]
        outs.append(score_snv_loci(*args, params))
    return {k: np.concatenate([o[k].cpu().numpy() for o in outs])
            for k in outs[0]}


def sharded_score_reference_positions(ev: BaseEvents, refseq: np.ndarray,
                                      params: ScoringParams, mesh: Mesh,
                                      intervals=None):
    """Mesh execution of the dense gVCF reference-locus scoring.

    Routes reads to position shards, builds partial count buffers, runs the
    halo-exchange + counts-kernel step over the mesh, and returns
    (positions, out, stats) in the exact shape
    fast_gvcf.format_reference_lines consumes (unique-tuple outputs +
    inverse index), the same as the single-device path's; `out` is None
    when there is nothing to score. stats carries the summed global
    summaries (loci_called, loci_covered).
    """
    n_shards = mesh.size
    with metrics.stage("mesh_partial_counts"):
        geo = plan_shards(ev, n_shards)
        if geo is None:
            return np.empty(0, np.int64), None, {}
        partial = build_partial_counts(ev, geo)

    # reference codes for every owned position (clamped into the sequence;
    # out-of-sequence padding rows are untouched and masked out below)
    positions = geo.domain_start + np.arange(geo.l_pad, dtype=np.int64)
    safe_pos = np.clip(positions, 1, len(refseq))
    ref_codes = BASE_TO_ALLELE[refseq[safe_pos - 1]].astype(np.int32)

    with metrics.stage("mesh_step"):
        step, called, covered = _sharded_step(mesh, partial, ref_codes,
                                              params, geo.l_local, geo.halo)
    touched = step["touched"]
    stats = {"loci_called": called, "loci_covered": covered}

    with metrics.stage("mesh_collapse"):
        return _collapse(step, touched, positions, geo, refseq, params,
                         intervals, stats)


def _collapse(step, touched, positions, geo, refseq, params, intervals,
              stats):
    """Select the emitted positions and collapse them to unique tuples
    (sharding.py:292-382)."""
    pad_flag = None
    if intervals is None:
        in_ref = positions <= len(refseq)
        sel = (touched > 0) & in_ref
        positions = positions[sel]
        if len(positions) == 0:
            return positions, None, stats
        sup3 = step["support_by_dir"][sel]
        cov3 = step["coverage_by_dir"][sel]
        vals = {k: step[k][sel] for k in
                ("total_coverage", "support", "variant_qscore", "genotype",
                 "gq", "sb_gatk")}
    else:
        # interval mode: EVERY interval position is emitted, padded rows
        # (outside any touched 1000-bp block) carry the RegionMapper
        # semantics (distinct NL) exactly like the single-device fast path
        from pisces_tpu_torch.domain.types import Genotype
        from pisces_tpu_torch.options import REGION_SIZE
        ranges = intervals.clipped_ranges(1, len(refseq))
        if not ranges:
            return np.empty(0, np.int64), None, stats
        int_pos = np.concatenate(
            [np.arange(rs, re_ + 1, dtype=np.int64) for rs, re_ in ranges])
        in_domain = (int_pos >= geo.domain_start) \
            & (int_pos < geo.domain_start + geo.l_pad)
        idx = np.where(in_domain, int_pos - geo.domain_start, 0)

        def gather(a, zero):
            out_a = a[idx]
            if out_a.ndim == 1:
                return np.where(in_domain, out_a, zero)
            return np.where(in_domain[:, None], out_a, zero)

        sup3 = gather(step["support_by_dir"], 0)
        cov3 = gather(step["coverage_by_dir"], 0)
        # zero-tuple outputs are forced by explicit masks in the kernel
        # (total==0 => q 0, gq min_gq, REF_LIKE_NOCALL, sb 0.0), so the
        # out-of-domain substitutes are exact
        vals = {
            "total_coverage": gather(step["total_coverage"], 0),
            "support": gather(step["support"], 0),
            "variant_qscore": gather(step["variant_qscore"], 0),
            "genotype": gather(step["genotype"],
                               int(Genotype.REF_LIKE_NOCALL)),
            "gq": gather(step["gq"], params.min_gq),
            "sb_gatk": gather(step["sb_gatk"], np.float32(0.0)),
        }
        # padding = outside any TOUCHED genome-aligned 1000-bp block
        # (matches pc.pos_index(pos) < 0 in the single-device path)
        block_keys = (positions + REGION_SIZE - 1) // REGION_SIZE
        touched_blocks = np.unique(block_keys[touched > 0])
        int_blocks = (int_pos + REGION_SIZE - 1) // REGION_SIZE
        bi = np.searchsorted(touched_blocks, int_blocks)
        bi = np.minimum(bi, max(len(touched_blocks) - 1, 0))
        in_touched = (len(touched_blocks) > 0) \
            & (touched_blocks[bi] == int_blocks)
        pad_flag = (~in_touched).astype(np.int64)
        positions = int_pos

    # Collapse to unique (sup_by_dir, cov_by_dir[, padding]) tuples so line
    # formatting memoizes per tuple exactly like the single-device fast
    # path; every scored value is a pure function of the tuple, so the
    # representative (first-occurrence) row carries the unique value.
    cols = [sup3, cov3]
    if pad_flag is not None:
        cols.append(pad_flag.reshape(-1, 1))
    key = np.concatenate(cols, axis=1)
    k = key.shape[1]
    hi = int(key[:, :6].max(initial=0))
    if 0 <= int(key.min(initial=0)) and hi < (1 << 10):
        packed = np.zeros(len(key), dtype=np.int64)
        for j in range(6):
            packed = (packed << 10) | key[:, j].astype(np.int64)
        if k > 6:
            packed = (packed << 1) | key[:, 6].astype(np.int64)
        _, first, inv = np.unique(packed, return_index=True,
                                  return_inverse=True)
    else:
        _, first, inv = np.unique(key, axis=0, return_index=True,
                                  return_inverse=True)
    out = {k2: v[first] for k2, v in vals.items()}
    if pad_flag is not None:
        out["is_padding"] = pad_flag[first].astype(bool)
    out["inv"] = inv
    out["ref_base"] = refseq[positions - 1]
    return positions, out, stats
