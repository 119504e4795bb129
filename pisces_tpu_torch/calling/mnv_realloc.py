"""Failed-MNV reallocation (MnvReallocator port).

Reference: exe/Pisces/Logic/VariantCalling/MnvReallocator.cs:12-513. Failed
MNVs donate support to overlapping callable sub-alleles; remainders break
down to SNVs. The caller runs one block a chromosome or window, so no piece
spills past a block edge into the next block.
"""
from __future__ import annotations

from typing import List

import numpy as np

from pisces_tpu_torch.domain.types import AlleleCategory, Genotype
from pisces_tpu_torch.calling.alleles import CalledAllele


def _create_variant(chrom: str, position: int, support: int, alternate: str,
                    reference: str, support_by_dir) -> CalledAllele:
    if alternate.upper() == reference.upper():
        cat = AlleleCategory.REFERENCE
    else:
        cat = AlleleCategory.MNV if len(alternate) > 1 else AlleleCategory.SNV
    a = CalledAllele(chrom, position, reference, alternate, cat)
    a.allele_support = support
    a.genotype = (Genotype.HOMOZYGOUS_REF if cat == AlleleCategory.REFERENCE
                  else Genotype.HETEROZYGOUS_ALT_REF)
    a.support_by_direction = np.array(support_by_dir, dtype=np.int64).copy()
    return a


def break_off_edge_references(allele: CalledAllele) -> List[CalledAllele]:
    if allele.category != AlleleCategory.MNV:
        return [allele]
    left = 0
    right = 0
    n = len(allele.ref_allele)
    for i in range(n):
        if allele.ref_allele[i] != allele.alt_allele[i]:
            break
        left += 1
    for i in range(n):
        j = n - 1 - i
        if allele.ref_allele[j] != allele.alt_allele[j]:
            break
        right += 1
    rest = _create_variant(allele.chromosome, allele.position + left,
                           allele.allele_support,
                           allele.alt_allele[left:len(allele.alt_allele) - right],
                           allele.ref_allele[left:n - right],
                           allele.support_by_direction)
    return [rest]


def _is_potential_overlap(callable_a: CalledAllele, failed: CalledAllele) -> bool:
    return (callable_a.position >= failed.position
            and callable_a.chromosome == failed.chromosome
            and callable_a.position <= failed.position + len(failed.alt_allele)
            and len(callable_a.alt_allele) <= len(failed.alt_allele)
            and (callable_a.position + len(callable_a.alt_allele)
                 <= failed.position + len(failed.alt_allele))
            and callable_a.category in (AlleleCategory.MNV, AlleleCategory.SNV,
                                        AlleleCategory.REFERENCE))


def _overlap_matches(overlap: CalledAllele, failed: CalledAllele) -> bool:
    i = overlap.position - failed.position
    n = len(overlap.alt_allele)
    return overlap.alt_allele == failed.alt_allele[i:i + n]


def _breakdown_to_snvs(allele: CalledAllele) -> List[CalledAllele]:
    out = []
    for i in range(len(allele.alt_allele)):
        alt = allele.alt_allele[i]
        ref = allele.ref_allele[i]
        v = _create_variant(allele.chromosome, allele.position + i,
                            allele.allele_support, alt, ref,
                            allele.support_by_direction)
        if v.category != AlleleCategory.REFERENCE:
            out.append(v)
    return out


def _alleles_from_remainder(overlap: CalledAllele,
                            failed: CalledAllele) -> List[CalledAllele]:
    remainders: List[CalledAllele] = []
    idx = overlap.position - failed.position
    olen = len(overlap.alt_allele)
    right_side = idx + olen
    flen = len(failed.alt_allele)

    if flen - right_side > 0 and right_side <= failed.position + flen:
        r = _create_variant(failed.chromosome, failed.position + right_side,
                            failed.allele_support,
                            failed.alt_allele[right_side:flen],
                            failed.ref_allele[right_side:flen],
                            failed.support_by_direction)
        if r.category != AlleleCategory.REFERENCE:
            remainders.append(r)
    if idx > 0:
        l = _create_variant(failed.chromosome, failed.position,
                            failed.allele_support,
                            failed.alt_allele[:idx], failed.ref_allele[:idx],
                            failed.support_by_direction)
        if l.category != AlleleCategory.REFERENCE:
            remainders.append(l)
    out: List[CalledAllele] = []
    for r in remainders:
        out.extend(break_off_edge_references(r))
    return out


def _process_overlap(overlap: CalledAllele, failed: CalledAllele,
                     remainder_alleles: List[CalledAllele]) -> None:
    overlap.allele_support += failed.allele_support
    overlap.support_by_direction = (overlap.support_by_direction
                                    + failed.support_by_direction)
    remainder_alleles.remove(failed)
    remainder_alleles.extend(_alleles_from_remainder(overlap, failed))


def reallocate_failed_mnvs(failed_mnvs: List[CalledAllele],
                           callable_alleles: List[CalledAllele]) -> None:
    """MnvReallocator.ReallocateFailedMnvs: each failed MNV gives its
    support to the longest matching callable allele it overlaps, and what
    is left of it breaks down into SNVs appended to callable_alleles."""
    ordered_failed = sorted(
        failed_mnvs,
        key=lambda a: (a.position, -len(a.alt_allele), -a.allele_support,
                       a.alt_allele, a.ref_allele))
    for failed in ordered_failed:
        remainder_alleles = [failed]
        while remainder_alleles:
            allele = remainder_alleles[0]
            potential = [a for a in callable_alleles
                         if _is_potential_overlap(a, allele)]
            ordered = sorted(potential,
                             key=lambda a: (-len(a.alt_allele), -a.allele_support,
                                            a.alt_allele, a.ref_allele))
            matching = [o for o in ordered if _overlap_matches(o, allele)]
            if matching:
                _process_overlap(matching[0], allele, remainder_alleles)
            else:
                callable_alleles.extend(_breakdown_to_snvs(allele))
                remainder_alleles.remove(allele)


def get_ref_support_from_gapped_mnvs(callable_alleles: List[CalledAllele]):
    """AlleleCaller.GetRefSupportFromGappedMnvs."""
    taken = {}
    for a in callable_alleles:
        if a.category != AlleleCategory.MNV:
            continue
        for i in range(len(a.ref_allele)):
            if a.ref_allele[i] != a.alt_allele[i]:
                continue
            pos = a.position + i
            taken[pos] = taken.get(pos, 0) + a.allele_support
    return taken
