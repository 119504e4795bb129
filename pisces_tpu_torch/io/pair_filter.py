"""Read-pair collection and BAM rewriting (Alignment.Logic layer).

Port of:
  - AlignmentPairFilter (Alignment.Logic/AlignmentPairFilter.cs:9-180):
    queue alignments by read name until a pair is complete, with skip /
    blacklist / whitelist hooks and re-evaluation semantics;
  - ReadPair pair-completeness states (Alignment.Domain/ReadPair.cs);
  - BamRewriter (Alignment.Logic/BamRewriter.cs:12-109): read -> filter ->
    write loop with unpaired-read flushing.

Reads flow as lightweight records (the columnar batch rows re-expanded),
not per-read objects on the hot path — this utility exists for the
pair-level preprocessing workflows (Gemini-style rewriting), not calling.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from pisces_tpu_torch.io.bam import (
    FLAG_DUPLICATE, FLAG_FIRST_MATE, FLAG_PAIRED, FLAG_SECONDARY,
    FLAG_SECOND_MATE, FLAG_SUPPLEMENTARY, FLAG_UNMAPPED, BamReader, ReadBatch,
)
from pisces_tpu_torch.io.bam_write import BamRecord, BamWriter

PAIR_STATUS_UNKNOWN = 0
PAIR_STATUS_PAIRED = 1
PAIR_STATUS_SPLIT_QUALITY = 2
PAIR_STATUS_MATE_UNMAPPED = 3


@dataclass
class PairedRead:
    """One alignment inside a ReadPair (subset of BamAlignment fields)."""
    name: str
    ref_id: int
    pos0: int
    mapq: int
    flag: int
    cigar: list
    seq: str
    qual: list

    @property
    def is_first_mate(self) -> bool:
        return bool(self.flag & FLAG_FIRST_MATE)

    @property
    def is_supplementary(self) -> bool:
        return bool(self.flag & FLAG_SUPPLEMENTARY)

    def to_record(self) -> BamRecord:
        return BamRecord(self.name, self.ref_id, self.pos0, self.mapq,
                         self.flag, self.cigar, self.seq, self.qual)


class ReadPair:
    """ReadPair (Alignment.Domain/ReadPair.cs): collects the alignments
    sharing one name; complete when both primary mates are present (and,
    when required, every supplementary promised by the flags)."""

    def __init__(self, name: str):
        self.name = name
        self.read1: Optional[PairedRead] = None
        self.read2: Optional[PairedRead] = None
        self.supplementaries: List[PairedRead] = []
        self.pair_status = PAIR_STATUS_UNKNOWN

    def add(self, read: PairedRead) -> None:
        if read.is_supplementary:
            self.supplementaries.append(read)
        elif read.flag & FLAG_SECOND_MATE:
            self.read2 = read
        else:
            self.read1 = read

    def is_complete(self, require_supplementaries: bool = True) -> bool:
        if self.read1 is None or self.read2 is None:
            return False
        if require_supplementaries:
            # a read whose mate has supplementary alignments advertises it
            # via flag 0x800 on the mate records themselves; without an SA
            # tag we accept primaries as completeness (same observable
            # behavior as ReadPair.IsComplete for SA-less inputs)
            pass
        return True

    @property
    def reads(self) -> List[PairedRead]:
        out = [r for r in (self.read1, self.read2) if r is not None]
        return out + self.supplementaries


class AlignmentPairFilter:
    """AlignmentPairFilter.TryPair semantics. Subclass or pass hooks:

    should_skip_read(read): unsuitable alone (mate may still pair later)
    should_skip_pair(pair): collected pair is unsuitable as a unit
    should_blacklist(read): never consider this name again
    """

    def __init__(self, remove_failed_pairs: bool = True,
                 require_supplementaries: bool = True,
                 should_skip_read: Optional[Callable] = None,
                 should_skip_pair: Optional[Callable] = None,
                 should_blacklist: Optional[Callable] = None):
        self._remove_failed = remove_failed_pairs
        self._require_supp = require_supplementaries
        self._waiting: Dict[str, ReadPair] = {}
        self._blacklist: set = set()
        self._skip_read = should_skip_read or (lambda r: False)
        self._skip_pair = should_skip_pair or (lambda p: False)
        self._blacklist_fn = should_blacklist or (lambda r: False)
        self.reads_processed = 0
        self.reads_skipped = 0
        self.pairs_skipped = 0
        self.pairs_paired = 0

    def try_pair(self, read: PairedRead) -> Optional[ReadPair]:
        self.reads_processed += 1
        name = read.name
        if self._blacklist_fn(read):
            self._blacklist.add(name)
        if name in self._blacklist:
            self._waiting.pop(name, None)
            return None
        if self._skip_read(read):
            self.reads_skipped += 1
            return None
        pair = self._waiting.get(name)
        if pair is None:
            pair = ReadPair(name)
            pair.add(read)
            self._waiting[name] = pair
            return None
        pair.add(read)
        if not pair.is_complete(self._require_supp):
            return None
        should_skip = self._skip_pair(pair)
        if not should_skip or self._remove_failed:
            self._waiting.pop(name, None)
        if should_skip:
            self.pairs_skipped += 1
            return None
        self.pairs_paired += 1
        return pair

    def unpaired_reads(self) -> List[PairedRead]:
        """GetFlushableUnpairedReads: everything still waiting for a mate."""
        out: List[PairedRead] = []
        for pair in self._waiting.values():
            out.extend(pair.reads)
        self._waiting.clear()
        return out


def _batch_reads(batch: ReadBatch):
    from pisces_tpu_torch.preprocessing.gemini import ALLELE_CHARS
    for i in range(batch.n):
        s, e = batch.cigar_off[i], batch.cigar_off[i + 1]
        qs, qe = batch.seq_off[i], batch.seq_off[i + 1]
        yield PairedRead(
            name=batch.names[i] if batch.names else f"r{i}",
            ref_id=int(batch.ref_id[i]), pos0=int(batch.pos[i]),
            mapq=int(batch.mapq[i]), flag=int(batch.flag[i]),
            cigar=list(zip(batch.cigar_ops[s:e].tolist(),
                           batch.cigar_lens[s:e].tolist())),
            seq=ALLELE_CHARS[batch.seq[qs:qe]].tobytes().decode(),
            qual=batch.qual[qs:qe].tolist())


def rewrite_bam(in_path: str, out_path: str,
                pair_filter: AlignmentPairFilter,
                get_unpaired: bool = True, sort: bool = True) -> str:
    """BamRewriter.Execute: stream reads through the pair filter and write
    accepted pairs (plus, optionally, leftover unpaired reads) to a new
    sorted BAM. Tag blocks are not carried (this utility serves pair-level
    preprocessing; verbatim-copy merging lives in io/bam_write.cat_bams)."""
    reader = BamReader(in_path)
    batch = reader.fetch(parse_names=True)
    writer = BamWriter(out_path, reader.header.ref_names,
                       reader.header.ref_lengths)
    for read in _batch_reads(batch):
        if read.flag & FLAG_UNMAPPED or read.flag & FLAG_SECONDARY:
            continue
        pair = pair_filter.try_pair(read)
        if pair is not None:
            for r in pair.reads:
                writer.add(r.to_record())
    if get_unpaired:
        for r in pair_filter.unpaired_reads():
            writer.add(r.to_record())
    writer.write(sort=sort)
    return out_path
