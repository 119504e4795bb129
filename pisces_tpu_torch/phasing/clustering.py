"""Neighborhood clustering (NeighborhoodClusterer.cs, SetOfClusters.cs,
Cluster.cs, VeadGroupMerger.cs): greedy agreement-based clustering with
worst-fit reassignment and optional cluster merging."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from pisces_tpu_torch.phasing.models import (
    Vead, VeadGroup, VariantSite, agreement, agreement_score,
)


@dataclass
class ClusteringParameters:
    allow_cluster_merging: bool = True
    allow_worst_fit_removal: bool = True
    min_number_agreements: int = 1
    max_number_disagreements: int = 0
    max_num_new_clusters_per_site: int = 100
    cluster_constraint: int = -1


class Cluster:
    def __init__(self, name: str, vead_groups: List[VeadGroup]):
        self.name = name
        self._vead_groups = list(vead_groups)
        self._consensus: Optional[VeadGroup] = None
        self.reset_consensus()

    @property
    def vead_groups(self) -> List[VeadGroup]:
        return self._vead_groups

    @property
    def num_vead_groups(self) -> int:
        return len(self._vead_groups)

    @property
    def num_veads(self) -> int:
        return sum(vg.num_veads for vg in self._vead_groups)

    @property
    def counts_at_sites(self) -> np.ndarray:
        n = len(self.consensus_sites())
        counts = np.zeros(n, np.int64)
        for vg in self._vead_groups:
            counts += vg.to_depths()
        return counts

    def consensus_sites(self) -> List[VariantSite]:
        if self._consensus is None:
            return []
        return self._consensus.site_results

    def reset_consensus(self) -> None:
        self._consensus = None
        if not self._vead_groups:
            return
        sites = [s.copy() for s in self._vead_groups[0].site_results]
        self._consensus = VeadGroup(Vead(self.name, sites))
        for vg in self._vead_groups:
            self._merge_into_consensus(vg)

    def _merge_into_consensus(self, vg: VeadGroup) -> None:
        if self._consensus is None:
            return
        for new, upd in zip(vg.site_results, self._consensus.site_results):
            if new.has_ref_data:
                upd.ref = new.ref
            if new.has_alt_data:
                upd.alt = new.alt

    def add(self, vg: VeadGroup) -> None:
        self._vead_groups.append(vg)
        self._merge_into_consensus(vg)

    def remove(self, vg: VeadGroup) -> None:
        self._vead_groups.remove(vg)
        self.reset_consensus()

    def get_best_agreement(self, new_vg: VeadGroup,
                           max_disagreements: int) -> Optional[Tuple[int, int]]:
        best = (0, 0)
        for vg in self._vead_groups:
            if vg.representative.name == new_vg.representative.name:
                continue
            a = agreement(new_vg, vg)
            if a[1] > max_disagreements:
                return None
            if agreement_score(a) > agreement_score(best):
                best = a
        return best

    def get_worst_agreement(self) -> Optional[VeadGroup]:
        worst_vg = None
        worst = (2 ** 31, 0)
        for vg in self._vead_groups:
            total = (0, 0)
            for other in self._vead_groups:
                if other is vg:
                    continue
                a = agreement(vg, other)
                total = (total[0] + a[0], total[1] + a[1])
            if agreement_score(total) < agreement_score(worst):
                worst = total
                worst_vg = vg
        return worst_vg

    def get_cluster_reference_support(self, clusters: List["Cluster"]) -> int:
        """Cluster.GetClusterReferenceSupport."""
        sites = [s.copy() for s in self.consensus_sites()]
        num_ref = 0
        for vs in sites:
            if vs.is_reference or vs.alt == vs.ref:
                was_ref = vs.is_reference
                vs.ref = "N"
                vs.alt = "N"
                if was_ref:
                    num_ref += 1
            else:
                vs.ref = vs.ref[:1] if vs.ref else "N"
                vs.alt = vs.ref
        if num_ref == len(sites):
            sites = [s.copy() for s in self.consensus_sites()]
        ref_vg = VeadGroup(Vead("test", sites))
        num_variants = ref_vg.num_sites_per_vead
        support = 0
        for cls in clusters:
            for vg in cls.vead_groups:
                a = agreement(vg, ref_vg)
                if a[1] == 0 and a[0] >= num_variants:
                    support += vg.num_veads
        return support


class SetOfClusters:
    def __init__(self, params: ClusteringParameters):
        self.params = params
        self._clusters: Dict[str, Cluster] = {}

    @property
    def clusters(self) -> List[Cluster]:
        return list(self._clusters.values())

    @property
    def num_clusters(self) -> int:
        return len(self._clusters)

    def create_and_add_cluster(self, vg: VeadGroup) -> None:
        name = f"#{self.num_clusters + 1}"
        self._clusters[name] = Cluster(name, [vg])

    def remove_cluster(self, name: str) -> None:
        self._clusters.pop(name, None)

    def get_cluster_fits(self, vg: VeadGroup) -> Dict[int, List[Cluster]]:
        fits: Dict[int, List[Cluster]] = {}
        for cluster in self.clusters:
            best = cluster.get_best_agreement(
                vg, self.params.max_number_disagreements)
            if best is None:
                continue
            if best[1] > self.params.max_number_disagreements:
                continue
            if best[0] < self.params.min_number_agreements:
                continue
            fits.setdefault(agreement_score(best), []).append(cluster)
        return dict(sorted(fits.items()))

    def reassign_worst_fit(self) -> None:
        if self.num_clusters < 2:
            return
        empties = []
        for cluster in sorted(self.clusters, key=lambda c: c.num_veads):
            while True:
                if cluster.num_vead_groups == 0:
                    break
                worst = cluster.get_worst_agreement()
                if worst is None:
                    break
                fits = self.get_cluster_fits(worst)
                if not fits:
                    break
                first_score = next(iter(fits))
                best_fit = fits[first_score][0]
                if best_fit is not cluster:
                    cluster.remove(worst)
                    best_fit.add(worst)
                    if cluster.num_vead_groups == 0:
                        empties.append(cluster)
                else:
                    break
        for c in empties:
            self._clusters.pop(c.name, None)

    def get_relative_weights(self) -> Dict[str, float]:
        total = sum(c.num_veads for c in self.clusters)
        return {c.name: c.num_veads / total for c in self.clusters}

    def remove_worst_clusters(self, max_to_remove: int) -> int:
        weights = self.get_relative_weights()
        if not weights:
            return 0
        lowest = min(weights.values())
        light = [n for n, w in weights.items() if w == lowest]
        if len(light) <= max_to_remove:
            for name in light:
                self.remove_cluster(name)
        return len(light)


class NeighborhoodClusterer:
    def __init__(self, params: Optional[ClusteringParameters] = None):
        self.params = params or ClusteringParameters()

    def cluster_vead_groups(self, vead_groups: List[VeadGroup]) -> SetOfClusters:
        vead_groups = sorted(vead_groups, key=lambda vg: -vg.num_sites_in_group)
        clusters = SetOfClusters(self.params)
        if not vead_groups:
            return clusters
        max_new = (len(vead_groups[0].site_results)
                   * self.params.max_num_new_clusters_per_site)
        while vead_groups:
            clusters.create_and_add_cluster(vead_groups.pop(0))
            if self.params.allow_worst_fit_removal:
                clusters.reassign_worst_fit()
            iteration = 1
            while vead_groups:
                before = len(vead_groups)
                vead_groups = self._allocate(vead_groups, clusters)
                if len(vead_groups) == before:
                    break
                iteration += 1
                if iteration > 10:
                    break
            if clusters.num_clusters > max_new:
                break
        if self.params.cluster_constraint > 0:
            while clusters.num_clusters > self.params.cluster_constraint:
                max_remove = clusters.num_clusters - self.params.cluster_constraint
                removed = clusters.remove_worst_clusters(max_remove)
                if removed > max_remove:
                    break
        return clusters

    def _allocate(self, vead_groups: List[VeadGroup],
                  clusters: SetOfClusters) -> List[VeadGroup]:
        remaining = []
        for vg in vead_groups:
            fits = clusters.get_cluster_fits(vg)
            if not fits:
                remaining.append(vg)
            else:
                best_score = list(fits)[-1]
                candidates = fits[best_score]
                best = candidates[0]
                if self.params.allow_cluster_merging and len(candidates) > 1:
                    best = self._merge_best_candidates(clusters, candidates, vg)
                best.add(vg)
        return remaining

    def _merge_best_candidates(self, clusters: SetOfClusters,
                               candidates: List[Cluster],
                               vg: VeadGroup) -> Cluster:
        """ClusterMerger.MergeAllBestCandidates: merge equally-good clusters
        when their consensus profiles agree."""
        target = candidates[0]
        for other in candidates[1:]:
            if other is target:
                continue
            c1 = VeadGroup(Vead(target.name,
                                [s.copy() for s in target.consensus_sites()]))
            c2 = VeadGroup(Vead(other.name,
                                [s.copy() for s in other.consensus_sites()]))
            a = agreement(c1, c2)
            if a[1] <= self.params.max_number_disagreements:
                for g in list(other.vead_groups):
                    target.add(g)
                clusters.remove_cluster(other.name)
        return target
