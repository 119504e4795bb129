"""Single-end reads of one length in five CIGAR classes, unpaired and
untagged (gen.py's read model): the layout of a configuration whose reads
block names none."""
from __future__ import annotations

import numpy as np

from portbench import gen
from portbench.reference.calls import three_directions
from portbench.reference.pileup import chrom_counts

make_sample = gen.make_sample
write_sample = gen.write_sample


def counts(sample: gen.Sample, ch: gen.ChromReads,
           min_base_quality: int) -> np.ndarray:
    """int64 [len(seq) + 1, 6, 3] pileup: forward, reverse and an empty
    stitched direction."""
    return three_directions(chrom_counts(sample, ch, min_base_quality))
