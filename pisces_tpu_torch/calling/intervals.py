"""Interval sets (ROI targeting) + gVCF region padding.

Reference: Pisces.Domain/Models/IntervalSet.cs (ChrIntervalSet),
Pisces.IO/RegionMapper.cs (gVCF no-call padding for uncovered interval
positions), and picard-interval/BED parsing from CommandLine option utils.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class Region:
    start: int  # 1-based inclusive
    end: int    # 1-based inclusive

    def contains(self, position: int) -> bool:
        return self.start <= position <= self.end


class ChrIntervalSet:
    def __init__(self, regions: List[Region], chr_name: str):
        self.chr_name = chr_name
        self.regions = regions
        self.sort_and_collapse()

    def sort_and_collapse(self) -> None:
        if not self.regions:
            return
        regions = sorted(self.regions, key=lambda r: (r.start, r.end))
        merged = [regions[0]]
        for r in regions[1:]:
            if r.start <= merged[-1].end + 0:
                if r.end > merged[-1].end:
                    merged[-1] = Region(merged[-1].start, r.end)
            else:
                merged.append(r)
        self.regions = merged
        self._starts = np.array([r.start for r in merged])
        self._ends = np.array([r.end for r in merged])

    def contains(self, position: int) -> bool:
        if not self.regions:
            return False
        i = int(np.searchsorted(self._starts, position, side="right")) - 1
        return i >= 0 and position <= self._ends[i]

    def expand_interval(self, lookup_position: int, new_start: int) -> bool:
        """ExpandInterval (IntervalSet.cs:189-204): move the start of the
        interval containing lookup_position left to new_start, so later
        loci between new_start and the old start test as inside."""
        for i, r in enumerate(self.regions):
            if r.start > lookup_position:
                return False
            if r.start <= lookup_position <= r.end:
                self.regions[i] = Region(new_start, r.end)
                self._starts[i] = new_start
                return True
        return False

    def contains_mask(self, positions: np.ndarray) -> np.ndarray:
        if not self.regions:
            return np.zeros(len(positions), dtype=bool)
        i = np.searchsorted(self._starts, positions, side="right") - 1
        ok = i >= 0
        idx = np.maximum(i, 0)
        return ok & (positions <= self._ends[idx])

    def clipped_ranges(self, start: int, end: int) -> List[Tuple[int, int]]:
        """GetClipped: intervals intersected with [start, end]."""
        out = []
        for r in self.regions:
            if r.end < start or r.start > end:
                continue
            out.append((max(r.start, start), min(r.end, end)))
        return out


def read_picard_intervals(path: str) -> Dict[str, List[Region]]:
    """Parse picard-style interval files (chr\\tstart\\tend...; 1-based)."""
    out: Dict[str, List[Region]] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("@") or line.startswith("#"):
                continue
            parts = line.split("\t")
            if len(parts) < 3:
                parts = line.split()
            if len(parts) < 3:
                continue
            chrom, start, end = parts[0], int(parts[1]), int(parts[2])
            out.setdefault(chrom, []).append(Region(start, end))
    return out


def read_bed(path: str) -> Dict[str, List[Region]]:
    """BED is 0-based half-open; convert to 1-based inclusive."""
    out: Dict[str, List[Region]] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(("#", "track", "browser")):
                continue
            parts = line.split("\t")
            if len(parts) < 3:
                continue
            out.setdefault(parts[0], []).append(
                Region(int(parts[1]) + 1, int(parts[2])))
    return out


class RegionMapper:
    """gVCF padding over intervals (Pisces.IO/RegionMapper.cs:31-85): emits
    reference no-calls for interval positions never covered by any allele."""

    def __init__(self, chr_reference, interval_set: ChrIntervalSet,
                 min_basecall_quality: int):
        self._chr = chr_reference
        self._intervals = interval_set
        self._nl = min_basecall_quality
        self._region_index = 0
        self._position = -1  # next position to consider inside current region

    def get_next_empty_call(self, start_position: int,
                            max_upto: Optional[int]):
        from pisces_tpu_torch.calling.alleles import CalledAllele
        from pisces_tpu_torch.domain.types import AlleleCategory, FilterType, Genotype
        while self._region_index < len(self._intervals.regions):
            region = self._intervals.regions[self._region_index]
            pos = max(region.start, start_position, self._position)
            while pos <= region.end:
                if max_upto is not None and pos > max_upto:
                    self._position = pos
                    return None
                if pos > len(self._chr.sequence):
                    self._position = region.end + 1
                    break
                self._position = pos + 1
                ref_base = chr(self._chr.sequence[pos - 1])
                a = CalledAllele(self._chr.name, pos, ref_base, ref_base,
                                 AlleleCategory.REFERENCE)
                a.genotype = Genotype.REF_LIKE_NOCALL
                a.noise_level_applied = self._nl
                a.add_filter(FilterType.LOW_DEPTH)
                return a
            self._region_index += 1
            self._position = -1
        return None


def make_region_mapper(options, chrom, intervals: Optional[ChrIntervalSet]):
    """Factory.CreateRegionPadder: padder only when intervals + gVCF."""
    if intervals is None or not options.vcf_writing_parameters.output_gvcf_file:
        return None
    return RegionMapper(chrom, intervals,
                        options.bam_filter_parameters.minimum_base_call_quality)
