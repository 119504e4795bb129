"""Psara: VCF interval (geometric) filter.

Port of exe/Psara/GeometricFilter.cs:23-135 + VcfFilter.cs: streams a VCF,
keeps loci whose start position falls inside a region-of-interest set; the
"expanded" mode also keeps loci whose reference span reaches into an
interval, growing the interval to cover them.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List, Optional

from pisces_tpu_torch.calling.intervals import (
    ChrIntervalSet, Region, read_bed, read_picard_intervals,
)
from pisces_tpu_torch.io.vcf_read import (
    VcfVariant, update_vcf_loci_by_loci,
)


class GeometricFilter:
    def __init__(self, roi_path: str, inclusion_model: str = "start"):
        if roi_path.endswith(".bed"):
            self.regions_by_chr = read_bed(roi_path)
        else:
            self.regions_by_chr = read_picard_intervals(roi_path)
        self.mode = inclusion_model
        self._current_chr: Optional[str] = None
        self._current_set: Optional[ChrIntervalSet] = None
        self._expansions: Dict[str, List[Region]] = {}

    def _interval_set(self, chrom: str) -> ChrIntervalSet:
        if chrom != self._current_chr:
            regions = self.regions_by_chr.get(chrom, [])
            self._current_set = ChrIntervalSet(list(regions), chrom)
            self._current_chr = chrom
        return self._current_set

    def keep_locus(self, group: List[VcfVariant]) -> bool:
        first = group[0]
        iset = self._interval_set(first.chrom)
        if not iset.regions:
            return False
        if iset.contains(first.position):
            return True
        if self.mode == "expanded":
            for v in group:
                end = v.position + len(v.ref_allele) - 1
                for p in range(v.position + 1, end + 1):
                    if iset.contains(p):
                        # grow the interval leftward to this locus so the
                        # positions in between are kept too
                        # (GeometricFilter.cs:118 ExpandInterval)
                        iset.expand_interval(p, first.position)
                        return True
        return False


def filter_vcf(in_path: str, out_path: str, roi_path: str,
               inclusion_model: str = "start") -> str:
    gf = GeometricFilter(roi_path, inclusion_model)

    def update(group):
        return None if gf.keep_locus(group) else []

    def header_fn(line: str):
        if line.startswith("##psara_cmdline"):
            return line
        return line

    update_vcf_loci_by_loci(in_path, out_path, update, header_fn)
    return out_path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="psara",
                                description="VCF geometric (ROI) filter")
    p.add_argument("-vcf", required=True)
    p.add_argument("-log", default=None, help="log file name base")
    p.add_argument("-roi", "--RegionOfInterestPath", required=True, dest="roi")
    p.add_argument("-inclusionmodel", default="start",
                   choices=["start", "expanded"])
    p.add_argument("-o", "--out", "-outfolder", dest="out", default=None)
    args = p.parse_args(argv)
    stem = os.path.basename(args.vcf).replace(".vcf", "")
    out_dir = args.out or os.path.dirname(args.vcf)
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, stem + ".filtered.vcf")
    filter_vcf(args.vcf, out, args.roi, args.inclusionmodel)
    return 0


if __name__ == "__main__":
    sys.exit(main())
