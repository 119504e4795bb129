"""Reference-context repeat scans: indel-repeat filter and RMxN.

Ports of AlleleProcessor.ComputeIndelRepeatLength (exe/Pisces/Logic/
VariantCalling/AlleleProcessor.cs:80-215) and RMxNCalculator
(src/lib/Pisces.Calculators/RMxNCalculator.cs:1-136). Host-side string work
over the reference sequence; results feed the filter bitmask.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from pisces_tpu_torch.domain.types import AlleleCategory

FLANKING_BASE_COUNT = 50


def _simplify_repeat_unit(unit: str) -> str:
    if not unit:
        return ""
    sb = unit[0]
    for i in range(1, len(unit)):
        parts = unit.split(sb)
        if len(unit) == (len(parts) - 1) * len(sb):
            break
        sb += unit[i]
    return sb


def _get_repeat_length(bases: str, current_pos: int, unit: str) -> int:
    n = len(unit)
    if n == 0:
        return 0
    last_position = len(bases) - n - 1
    required = current_pos + n + 1
    if required > len(bases):
        return 1
    prev = current_pos
    while current_pos > 0:
        if bases[current_pos:current_pos + n] != unit:
            break
        prev = current_pos
        current_pos -= n
    current_pos = prev
    count = 0
    while current_pos <= last_position:
        if bases[current_pos:current_pos + n] != unit:
            break
        current_pos += n
        count += 1
    return count


def compute_indel_repeat_length(category: AlleleCategory, position: int,
                                ref_allele: str, alt_allele: str,
                                refseq: np.ndarray) -> int:
    """AlleleProcessor.ComputeIndelRepeatLength."""
    if len(refseq) == 0:
        return 0
    if category not in (AlleleCategory.INSERTION, AlleleCategory.DELETION,
                        AlleleCategory.SNV):
        return 0
    string_pos = position - 1
    up_begin = max(string_pos - FLANKING_BASE_COUNT, 0)
    up_end = string_pos - 1
    down_begin = max(string_pos, 0)
    down_end = min(string_pos + FLANKING_BASE_COUNT - 1, len(refseq) - 1)
    up_end = min(up_end, len(refseq) - 1)
    upstream = refseq[up_begin:up_end + 1].tobytes().decode().upper() if up_end >= 0 else ""
    downstream = refseq[down_begin:down_end + 1].tobytes().decode().upper()

    current_position = len(upstream) if upstream else 0
    variant_bases = ""
    if category == AlleleCategory.INSERTION:
        variant_bases = alt_allele[1:]
        current_position += 1
    elif category == AlleleCategory.DELETION:
        variant_bases = ref_allele[1:]
        current_position += 1
    bases = upstream + downstream
    unit = _simplify_repeat_unit(variant_bases)
    return _get_repeat_length(bases, current_position, unit)


def _compute_rmxn_for_indel(variant_position: int, variant_bases: str,
                            refseq_str, max_unit_len: int) -> int:
    """RMxNCalculator.ComputeRMxNLengthForIndel; refseq_str supports slicing."""
    max_found = 0
    length = len(variant_bases)
    bookends = []
    for i in range(length - min(max_unit_len, length), length):
        bookends.append(variant_bases[:length - i])
        bookends.append(variant_bases[i:])
    ref_len = len(refseq_str)
    for unit in bookends:
        n = len(unit)
        back = variant_position
        while True:
            nb = back - n
            if nb < 0:
                break
            if refseq_str[nb:nb + n] != unit:
                break
            back = nb
        count = 0
        cur = back
        while True:
            if cur + n > ref_len:
                break
            if refseq_str[cur:cur + n] != unit:
                break
            count += 1
            cur += n
        if count > max_found:
            max_found = count
    return max_found


def compute_component_rmxn_lengths(category: AlleleCategory, position: int,
                                   ref_allele: str, alt_allele: str,
                                   refseq_str, max_unit_len: int) -> Tuple[int, int]:
    """RMxNCalculator.ComputeComponentRMxNLengths."""
    component1 = 0
    component2 = 2 ** 31 - 1
    if category in (AlleleCategory.MNV, AlleleCategory.SNV):
        variant_bases = alt_allele
    elif category == AlleleCategory.INSERTION:
        variant_bases = alt_allele[1:]
    else:
        variant_bases = ref_allele[1:]

    if category in (AlleleCategory.INSERTION, AlleleCategory.DELETION):
        component1 = _compute_rmxn_for_indel(position, variant_bases, refseq_str,
                                             max_unit_len)
    else:
        component1 = _compute_rmxn_for_indel(position - 1, ref_allele, refseq_str,
                                             max_unit_len)
        c1 = _compute_rmxn_for_indel(position + len(ref_allele) - 1, variant_bases,
                                     refseq_str, max_unit_len)
        c2 = _compute_rmxn_for_indel(position - 1, variant_bases, refseq_str,
                                     max_unit_len)
        component2 = max(c1, c2)
    return component1, component2


def rmxn_should_filter(category: AlleleCategory, position: int, ref_allele: str,
                       alt_allele: str, frequency: float,
                       refseq_str: "RefSeqStr",
                       max_len_repeat: Optional[int], min_repetitions: Optional[int],
                       frequency_limit: Optional[float]) -> bool:
    """RMxNCalculator.ShouldFilter, by the native scan."""
    if max_len_repeat is None or min_repetitions is None:
        return False
    if frequency_limit is not None and np.float32(frequency) >= np.float32(frequency_limit):
        return False
    if category == AlleleCategory.REFERENCE:
        return False
    return refseq_str.rmxn_min_component(
        category, position, ref_allele, alt_allele,
        max_len_repeat) >= min_repetitions


class RefSeqStr:
    """Lazy string view over a uint8 reference array (slices decode on
    demand), plus the native RMxN scan (io/_native/rmxn.cpp
    rmxn_min_component) with the array pointer bound once."""

    def __init__(self, refseq: np.ndarray):
        self._a = np.ascontiguousarray(refseq)
        self._ptr = None  # lazily bound (native function, reference pointer)

    def __len__(self):
        return len(self._a)

    def __getitem__(self, item):
        if isinstance(item, slice):
            return self._a[item].tobytes().decode()
        return chr(self._a[item])

    def rmxn_min_component(self, category: AlleleCategory, position: int,
                           ref_allele: str, alt_allele: str,
                           max_unit_len: int) -> int:
        """min(component1, component2) of compute_component_rmxn_lengths,
        by the native scan."""
        if position < 1 or position + len(ref_allele) - 1 > len(self._a):
            raise ValueError(f"allele at {position} ({ref_allele}) lies "
                             f"outside the {len(self._a)}-base reference")
        if self._ptr is None:
            import ctypes
            from pisces_tpu_torch.io.native import get_lib
            self._ptr = (get_lib().rmxn_min_component,
                         ctypes.c_void_p(self._a.ctypes.data))
        fn, ptr = self._ptr
        if category == AlleleCategory.INSERTION:
            cat = 1
        elif category == AlleleCategory.DELETION:
            cat = 2
        else:
            cat = 0
        return fn(ptr, len(self._a), position, ref_allele.encode(),
                  len(ref_allele), alt_allele.encode(), len(alt_allele), cat,
                  max_unit_len)
