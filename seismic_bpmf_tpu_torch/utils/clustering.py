"""Hierarchical event/template clustering.

Copy of `seismic_bpmf_tpu.utils.clustering` (reference parity:
BPMF/utils.py:1111-1226: scipy linkage over combined distance and
waveform-similarity metrics, used to group templates into families for
stacking).  The port's `TemplateGroup` keeps its inter-template tables as
numpy arrays in `tids` order; a DataFrame (the JAX package's tables) is
read the same way.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def cluster_events(
    distance_matrix: np.ndarray,
    similarity_matrix: Optional[np.ndarray] = None,
    distance_criterion_km: float = 5.0,
    similarity_criterion: float = 0.33,
    method: str = "single",
) -> np.ndarray:
    """Agglomerative clustering on a combined distance/similarity criterion.

    Two events join the same cluster when distance <= criterion AND (if a
    similarity matrix is given) similarity >= criterion.  Returns integer
    cluster labels (n_events,).
    """
    from scipy.cluster.hierarchy import fcluster, linkage
    from scipy.spatial.distance import squareform

    d = np.asarray(distance_matrix, np.float64).copy()
    n = d.shape[0]
    if n == 1:
        return np.zeros(1, dtype=np.int64)
    # combine: pairs failing the similarity gate get an infinite distance
    if similarity_matrix is not None:
        sim = np.asarray(similarity_matrix, np.float64)
        d[sim < similarity_criterion] = 10.0 * max(
            distance_criterion_km, d[np.isfinite(d)].max() + 1.0
        )
    np.fill_diagonal(d, 0.0)
    d = 0.5 * (d + d.T)
    z = linkage(squareform(d, checks=False), method=method)
    labels = fcluster(z, t=distance_criterion_km, criterion="distance")
    return labels.astype(np.int64) - 1


def build_families(template_group, distance_criterion_km: float = 5.0,
                   similarity_criterion: float = 0.33):
    """Group a TemplateGroup into families of co-located, similar templates.

    Returns a list of lists of template indexes (reference workflow:
    family/stack construction feeding `EventGroup.SVDWF_stack`,
    BPMF/dataset.py:4082-4373).
    """
    d = np.asarray(template_group.intertemplate_distances)
    sim = np.asarray(template_group.intertemplate_cc)
    labels = cluster_events(
        d, sim, distance_criterion_km=distance_criterion_km,
        similarity_criterion=similarity_criterion,
    )
    families = []
    for lbl in np.unique(labels):
        families.append(list(np.flatnonzero(labels == lbl)))
    return families


def cluster_templates(
    template_group,
    clustering_threshold: float = 0.33,
    method: str = "single",
    criterion: str = "distance",
):
    """Non-overlapping groups of similar templates from the inter-template
    CC matrix alone.

    Modernized `find_template_clusters` (BPMF/utils.py:1175-1244; marked
    deprecated there but the only CC-space template grouping entry point):
    hierarchical clustering on the correlation distance 1 - CC, cut at
    `clustering_threshold`.  Returns (labels, clusters) where `labels` maps
    each template index to a 0-based cluster id and `clusters` lists member
    indexes per cluster, largest first.
    """
    from scipy.cluster.hierarchy import fcluster, linkage
    from scipy.spatial.distance import squareform

    cc = np.array(np.asarray(template_group.intertemplate_cc), np.float64)
    np.fill_diagonal(cc, 1.0)
    d = 1.0 - 0.5 * (cc + cc.T)
    # numerical noise can leave tiny negatives; exact squareform needs 0s
    d[d < 0.0] = 0.0
    np.fill_diagonal(d, 0.0)
    z = linkage(squareform(d, checks=False), method=method)
    labels = fcluster(z, t=clustering_threshold, criterion=criterion)
    labels = labels.astype(np.int64) - 1
    order = np.argsort([-np.sum(labels == k) for k in np.unique(labels)])
    remap = {int(old): new for new, old in enumerate(np.unique(labels)[order])}
    labels = np.array([remap[int(k)] for k in labels], np.int64)
    clusters = [list(np.flatnonzero(labels == k))
                for k in range(labels.max() + 1)]
    return labels, clusters
