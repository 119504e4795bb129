"""Bin-level evidence signal for Gemini realignment gating and read
silencing.

Vectorized counterpart of the reference's BinSignalCollection subsystem
(Gemini/BinSignalCollection/BinEvidence.cs, BinConclusions.cs incl.
UsableBins) and the silencing decision of
AggregateRegionProcessor.ReadsToSilence (AggregateRegionProcessor.cs:
347-408).  The chromosome is divided into MessySiteWidth-bp bins
(GeminiOptions.cs: MessySiteWidth=500); every read increments depth /
messy / indel / directional-mess / mapq-mess counters for each bin it
spans (BinEvidence.AddMessEvidence).  Conclusions (ProcessRegions,
BinConclusions.cs:153-240 with CollectDepth=true default):

    isMessy(bin) = (messy+indel)/all >= ImperfectFreqThreshold (0.03)
                 & indel/all >= IndelRegionFreqThreshold (0.01)
                 & all >= RegionDepthThreshold (5)

dilated one bin each side ("binsToExtendTo=2, treated as <" —
AggregateRegionProcessor.cs:90); indel-region bins come from the
finalized realignment targets (BinConclusions.AddIndelEvidence); a bin
is *usable* for realignment iff messy-enough AND indel-region
(UsableBins.FinalizeConclusions, BinConclusions.cs:27-35), again
dilated +-1.  Pairs in realignable categories are only realigned when
either endpoint falls in a usable bin (AggregateRegionProcessor.cs:
473-478); the reference's probable-SNV veto is hard-disabled there
(isProbableSnv=false, BinConclusions.cs:187) so it is omitted here.

Instead of per-read loops over SparseGroupedIntBins, evidence is a
handful of dense int32 arrays built with np.add.at over (firstBin,
lastBin) spans — chromosomes are <=500k bins at 500 bp, so dense is
cheap and the conclusions are pure array ops.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from pisces_tpu_torch.preprocessing.classify import PairClassification as PC

_N_CLS = max(PC) + 1

# TypeClassifier.MessyTypes (Gemini/TypeClassifier.cs:8-23)
_MESSY_LUT = np.zeros(_N_CLS, bool)
for _c in (PC.FAIL_STITCH, PC.MESSY_STITCHED, PC.MESSY_SPLIT,
           PC.UNSTITCH_MESSY, PC.UNSTITCH_FORWARD_MESSY,
           PC.UNSTITCH_REVERSE_MESSY, PC.UNSTITCH_MESSY_SUSPICIOUS_READ,
           PC.UNSTITCH_MESSY_INDEL_SUSPICIOUS_READ,
           PC.UNSTITCH_FORWARD_MESSY_INDEL,
           PC.UNSTITCH_REVERSE_MESSY_INDEL,
           PC.UNSTITCH_MESSY_SUSPICIOUS_MD):
    _MESSY_LUT[_c] = True

# TypeClassifier._indelTypes (TypeClassifier.cs:48-58)
_INDEL_LUT = np.zeros(_N_CLS, bool)
for _c in (PC.UNSTITCH_INDEL, PC.DISAGREE, PC.INDEL_UNSTITCHABLE,
           PC.INDEL_SINGLETON, PC.UNSTITCH_MESSY_INDEL,
           PC.UNSTITCH_MESSY_INDEL_SUSPICIOUS_READ,
           PC.UNSTITCH_FORWARD_MESSY_INDEL,
           PC.UNSTITCH_REVERSE_MESSY_INDEL):
    _INDEL_LUT[_c] = True

# AggregateRegionProcessor.IsForwardMessy / IsReverseMessy /
# IsSuspiciousMapping (AggregateRegionProcessor.cs:327-345)
_FWD_MESSY_LUT = np.zeros(_N_CLS, bool)
_FWD_MESSY_LUT[PC.UNSTITCH_FORWARD_MESSY] = True
_FWD_MESSY_LUT[PC.UNSTITCH_FORWARD_MESSY_INDEL] = True
_REV_MESSY_LUT = np.zeros(_N_CLS, bool)
_REV_MESSY_LUT[PC.UNSTITCH_REVERSE_MESSY] = True
_REV_MESSY_LUT[PC.UNSTITCH_REVERSE_MESSY_INDEL] = True
_SUSPICIOUS_MAP_LUT = np.zeros(_N_CLS, bool)
_SUSPICIOUS_MAP_LUT[PC.UNSTITCH_MESSY_SUSPICIOUS_READ] = True
_SUSPICIOUS_MAP_LUT[PC.UNSTITCH_MESSY_INDEL_SUSPICIOUS_READ] = True

# ForceHighLikelihoodRealigners category set
# (AggregateRegionProcessor.cs:420-431)
HIGH_LIKELIHOOD_REALIGN = frozenset({
    PC.DISAGREE, PC.MESSY_STITCHED, PC.MESSY_SPLIT, PC.UNSTITCH_MESSY,
    PC.UNSTITCH_INDEL,
})


@dataclass
class BinSignalOptions:
    """Defaults = GeminiOptions.cs:29-42."""
    messy_site_width: int = 500
    messy_site_threshold: int = 1
    collect_depth: bool = True
    imperfect_freq_threshold: float = 0.03
    indel_region_freq_threshold: float = 0.01
    region_depth_threshold: int = 5
    directional_mess_threshold: float = 0.2


@dataclass
class BinConclusions:
    """Per-bin boolean conclusions over a chromosome."""
    width: int
    usable: np.ndarray       # realignment allowed here
    fwd_messy: np.ndarray    # forward-mate silencing signal
    rev_messy: np.ndarray
    mapq_messy: np.ndarray
    is_messy_enough: np.ndarray
    indel_region: np.ndarray

    def bin_of(self, pos0) -> np.ndarray:
        return np.clip(np.asarray(pos0) // self.width, 0,
                       len(self.usable) - 1)

    def usable_at(self, pos0_a: int, pos0_b: int) -> bool:
        return bool(self.usable[self.bin_of(pos0_a)]
                    or self.usable[self.bin_of(pos0_b)])


def _dilate1(x: np.ndarray) -> np.ndarray:
    out = x.copy()
    out[1:] |= x[:-1]
    out[:-1] |= x[1:]
    return out


def compute_bin_conclusions(chrom_len: int,
                            starts0: np.ndarray, ends0: np.ndarray,
                            cls_codes: np.ndarray,
                            target_positions1: np.ndarray,
                            options: BinSignalOptions = BinSignalOptions(),
                            ) -> BinConclusions:
    """Evidence collection + conclusions in one pass.

    starts0/ends0: 0-based inclusive read spans; cls_codes: the pair
    classification of each read (both mates carry the pair's class, the
    exact evidence the reference collects per pair alignment —
    BinEvidence.AddMessEvidence loops pairResult.Alignments);
    target_positions1: 1-based positions of finalized indel targets.
    """
    width = options.messy_site_width
    nbins = max(1, -(-int(chrom_len) // width))
    starts0 = np.asarray(starts0, np.int64)
    ends0 = np.asarray(ends0, np.int64)
    cls_codes = np.asarray(cls_codes, np.int32)

    first = np.clip(starts0 // width, 0, nbins - 1)
    last = np.clip(ends0 // width, 0, nbins - 1)
    last = np.maximum(first, last)

    all_hits = np.zeros(nbins, np.int32)
    messy = np.zeros(nbins, np.int32)
    indel = np.zeros(nbins, np.int32)
    fwd = np.zeros(nbins, np.int32)
    rev = np.zeros(nbins, np.int32)
    mapq = np.zeros(nbins, np.int32)

    is_messy_r = _MESSY_LUT[cls_codes]
    is_indel_r = _INDEL_LUT[cls_codes]
    is_fwd_r = _FWD_MESSY_LUT[cls_codes]
    is_rev_r = _REV_MESSY_LUT[cls_codes]
    is_mapq_r = _SUSPICIOUS_MAP_LUT[cls_codes]

    span = last - first
    for k in range(int(span.max()) + 1 if len(span) else 0):
        m = span >= k
        b = first[m] + k
        np.add.at(all_hits, b, 1)
        for arr, sel in ((messy, is_messy_r), (indel, is_indel_r),
                         (fwd, is_fwd_r), (rev, is_rev_r),
                         (mapq, is_mapq_r)):
            bm = b[sel[m]]
            if len(bm):
                np.add.at(arr, bm, 1)

    # conclusions (BinConclusions.ProcessRegions)
    if options.collect_depth:
        with np.errstate(divide="ignore", invalid="ignore"):
            af = all_hits.astype(np.float32)
            pct_messy = np.where(all_hits > 0, messy / af, 0.0)
            pct_indel = np.where(all_hits > 0, indel / af, 0.0)
        is_messy = ((pct_messy + pct_indel >= options.imperfect_freq_threshold)
                    & (pct_indel >= options.indel_region_freq_threshold)
                    & (all_hits >= options.region_depth_threshold))
    else:
        is_messy = messy >= options.messy_site_threshold
    is_messy_enough = _dilate1(is_messy)

    # directional / mapq mess status (UpdateDirectionalMessStatus /
    # UpdateMapqMessStatus, BinConclusions.cs:359-419): fraction of the
    # bin's messy hits, only where messy depth > 3, dilated +-1
    with np.errstate(divide="ignore", invalid="ignore"):
        mf = messy.astype(np.float32)
        fwd_frac = np.where(messy > 0, fwd / mf, 0.0)
        rev_frac = np.where(messy > 0, rev / mf, 0.0)
        mapq_frac = np.where(messy > 0, mapq / mf, 0.0)
    deep = messy > 3
    thr = options.directional_mess_threshold
    fwd_status = _dilate1(deep & (fwd_frac > thr))
    rev_status = _dilate1(deep & (rev_frac > thr))
    # mapq status has no depth gate in the reference (cs:359-365)
    mapq_status = _dilate1(mapq_frac > thr)

    indel_region = np.zeros(nbins, bool)
    tp = np.asarray(target_positions1, np.int64)
    if len(tp):
        indel_region[np.clip((tp - 1) // width, 0, nbins - 1)] = True
        indel_region = _dilate1(indel_region)

    usable = _dilate1(is_messy_enough & indel_region)
    return BinConclusions(width=width, usable=usable, fwd_messy=fwd_status,
                          rev_messy=rev_status, mapq_messy=mapq_status,
                          is_messy_enough=is_messy_enough,
                          indel_region=indel_region)


def reads_to_silence(cls: int, fwd_idx, rev_idx, pos0_by_idx,
                     conclusions: BinConclusions,
                     silence_directional: bool, silence_mapq: bool,
                     ) -> set:
    """Which reads of a pair to quality-silence
    (AggregateRegionProcessor.ReadsToSilence, cs:347-408).  Returns the
    set of read indices whose base qualities should be zeroed (applied
    only if the read was not realigned — SilenceReads,
    ReadPairRealignerAndCombiner.cs:235-252)."""
    out = set()
    is_fwd_messy = _FWD_MESSY_LUT[cls] and silence_directional
    is_rev_messy = _REV_MESSY_LUT[cls] and silence_directional
    is_susp = _SUSPICIOUS_MAP_LUT[cls] and silence_mapq
    if is_fwd_messy and fwd_idx is not None:
        b = conclusions.bin_of(pos0_by_idx(fwd_idx))
        if conclusions.fwd_messy[b] or conclusions.mapq_messy[b]:
            out.add(fwd_idx)
    elif is_rev_messy and rev_idx is not None:
        b = conclusions.bin_of(pos0_by_idx(rev_idx))
        if conclusions.rev_messy[b] or conclusions.mapq_messy[b]:
            out.add(rev_idx)
    elif is_susp:
        anchor = rev_idx if rev_idx is not None else fwd_idx
        if anchor is not None:
            b = conclusions.bin_of(pos0_by_idx(anchor))
            if conclusions.mapq_messy[b]:
                out.update(i for i in (fwd_idx, rev_idx) if i is not None)
    return out
