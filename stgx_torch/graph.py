"""Skeleton graph builder: hop distances, partitioning, degree normalization.

The port's own copy of ``stgx/graph.py`` (numpy only, so it carries over as
it is); the port imports nothing of ``stgx``. It produces the stacked
partitioned adjacency ``A`` of shape ``(P, V, V)``, indexed ``A[p, v, w]``
so that ``y[..., w] = sum_v x[..., v] * A[p, v, w]``:

* hop distances by all-pairs shortest path over the edge list;
* partition strategies ``uniform`` / ``distance`` / ``spatial`` (``spatial``
  splits each hop ring into root/close/far w.r.t. the skeleton's center
  joint, Yan et al. 2018);
* per-partition degree normalization, ``symmetric`` (D^-1/2 A D^-1/2) or
  ``nonsymmetric`` (A D^-1), with an ``alpha`` added to the degree so rows
  emptied by partitioning stay finite.

``uniform`` returns the whole binary adjacency in a single partition.
"""


from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np

__all__ = ["Graph", "load_skeleton", "SKELETONS"]


def _hop_distance(num_node: int, edges: list[tuple[int, int]]) -> np.ndarray:
    """All-pairs shortest hop count; ``inf`` where disconnected."""
    dist = np.full((num_node, num_node), np.inf)
    for i, j in edges:
        if i == j:
            dist[i, i] = 0.0
        else:
            dist[i, j] = 1.0
            dist[j, i] = 1.0
    # Floyd–Warshall (V <= 25 for all bundled skeletons; cost is negligible
    # and this runs once at model build time on the host).
    for k in range(num_node):
        dist = np.minimum(dist, dist[:, k : k + 1] + dist[k : k + 1, :])
    return dist


@dataclass
class Graph:
    """Partitioned, normalized skeleton adjacency.

    Attributes:
        A: ``(P, V, V)`` float64 — normalized partitioned adjacency, transposed
            so ``y[..., w] = sum_v x[..., v] * A[p, v, w]`` aggregates the
            neighborhood of node ``w``.
        A_spatial_raw: ``(3, V, V)`` — unnormalized spatial partitions
            (self / close / far); the ``far`` slice defines bone vectors for
            the two-stream AAGCN.
        num_node: number of joints ``V``.
    """

    num_node: int
    edge: list
    center: int
    strategy: str = "spatial"
    normalization: str = "symmetric"
    max_hop: int = 1
    dilation: int = 1
    alpha: float = 1e-3

    A: np.ndarray = field(init=False)
    A_spatial_raw: np.ndarray = field(init=False)
    hop_dis: np.ndarray = field(init=False)

    def __post_init__(self):
        self.edge = [tuple(e) for e in self.edge]
        self.hop_dis = _hop_distance(self.num_node, self.edge)
        self.A_spatial_raw = self._partition("spatial")
        self.A = self._normalize(self._partition(self.strategy))

    # -- partitioning --------------------------------------------------------

    def _partition(self, strategy: str) -> np.ndarray:
        valid_hops = range(0, self.max_hop + 1, self.dilation)
        adjacency = np.zeros((self.num_node, self.num_node))
        for hop in valid_hops:
            adjacency[self.hop_dis == hop] = 1.0

        if strategy == "uniform":
            return adjacency[None]

        if strategy == "distance":
            parts = np.zeros((len(valid_hops), self.num_node, self.num_node))
            for i, hop in enumerate(valid_hops):
                parts[i][self.hop_dis == hop] = 1.0
            return parts

        if strategy == "spatial":
            # Split each hop ring into three groups by comparing each
            # neighbor's distance-to-center with the root node's: equal →
            # root partition, closer → centripetal, farther → centrifugal.
            to_center = self.hop_dis[:, self.center]
            parts = []
            for hop in valid_hops:
                on_ring = (self.hop_dis == hop) & (adjacency > 0)
                # rows i = target node, cols j = neighbor
                same = on_ring & (to_center[None, :] == to_center[:, None])
                closer = on_ring & (to_center[None, :] < to_center[:, None])
                farther = on_ring & (to_center[None, :] > to_center[:, None])
                if hop == 0:
                    parts.append(same.astype(np.float64))
                else:
                    parts.append(closer.astype(np.float64))
                    parts.append(farther.astype(np.float64))
            return np.stack(parts)

        raise ValueError(f"unknown partition strategy: {strategy!r}")

    # -- normalization -------------------------------------------------------

    def _normalize(self, parts: np.ndarray) -> np.ndarray:
        out = np.empty_like(parts)
        for p in range(parts.shape[0]):
            a = parts[p]
            deg = a.sum(axis=1) + self.alpha
            if self.normalization == "symmetric":
                d = deg**-0.5
                out[p] = (d[:, None] * a) * d[None, :]
            elif self.normalization == "nonsymmetric":
                out[p] = a * (1.0 / deg)[None, :]
            else:
                raise ValueError(
                    f"unknown normalization: {self.normalization!r}"
                )
        # rows→columns so the data-tensor contraction `x @ A` (node dim last)
        # sums each output node's neighborhood
        return out.transpose(0, 2, 1)


# -- bundled skeleton topologies ---------------------------------------------
# Joint indices and parent links for the supported capture rigs. Mirrors the
# graph-spec coverage of the upstream skeleton JSON files (same joint
# numbering conventions as the respective public datasets).


def _with_self_loops(num_node: int, links: list[tuple[int, int]]):
    return [(i, i) for i in range(num_node)] + list(links)


# Kinect-v2 25-joint rig (PKU-MMD, NTU RGB+D): center = joint 20 (spine-shoulder)
_KINECT25_LINKS = [
    (0, 1), (1, 20), (2, 20), (3, 2), (4, 20), (5, 4), (6, 5), (7, 6),
    (8, 20), (9, 8), (10, 9), (11, 10), (12, 0), (13, 12), (14, 13), (15, 14),
    (16, 0), (17, 16), (18, 17), (19, 18), (21, 7), (22, 7), (23, 11), (24, 11),
]

# NTU 24-joint "edge" variant: wrist-merged rig, center = joint 2
_NTU_EDGE_LINKS = [
    (0, 1), (2, 1), (3, 2), (4, 1), (5, 4), (6, 5), (7, 6), (8, 1), (9, 8),
    (10, 9), (11, 10), (12, 0), (13, 12), (14, 13), (15, 14), (16, 0),
    (17, 16), (18, 17), (19, 18), (20, 21), (21, 7), (22, 23), (23, 11),
]

# OpenPose BODY_18, center = joint 1 (neck)
_OPENPOSE18_LINKS = [
    (4, 3), (3, 2), (7, 6), (6, 5), (13, 12), (12, 11), (10, 9), (9, 8),
    (11, 5), (8, 2), (5, 1), (2, 1), (0, 1), (15, 0), (14, 0), (17, 15),
    (16, 14),
]

# COCO 17-keypoint rig, center = joint 0 (nose)
_COCO17_LINKS = [
    (15, 13), (13, 11), (16, 14), (14, 12), (11, 12), (5, 11), (6, 12),
    (5, 6), (7, 5), (8, 6), (9, 7), (10, 8), (1, 2), (1, 0), (2, 0),
    (3, 1), (4, 2), (3, 5), (4, 6),
]

# LARA 19-marker mocap rig, center = joint 0
_LARA19_LINKS = [
    (1, 0), (2, 1), (3, 2), (4, 3), (5, 0), (6, 5), (7, 6), (8, 7), (9, 0),
    (10, 9), (11, 9), (12, 10), (13, 12), (14, 13), (15, 9), (16, 15),
    (17, 16), (18, 17),
]

# HuGaDB 6-IMU lower-body rig, center = joint 0
_HUGADB6_LINKS = [(1, 0), (2, 1), (3, 0), (4, 3), (5, 0)]

# FOG-IT 7-IMU rig (two leg chains off the pelvis), center = joint 0
_FOGIT7_LINKS = [(0, 1), (1, 2), (2, 3), (0, 4), (4, 5), (5, 6)]

# Treadmill Vicon 9-marker chain rig, center = joint 0
_TPVICON9_LINKS = [
    (1, 0), (2, 1), (3, 2), (4, 3), (5, 0), (6, 5), (7, 6), (8, 7),
]

SKELETONS: dict[str, dict] = {
    "pku-mmd": dict(num_node=25, edge=_with_self_loops(25, _KINECT25_LINKS), center=20),
    "ntu-rgb+d": dict(num_node=25, edge=_with_self_loops(25, _KINECT25_LINKS), center=20),
    "ntu-edge": dict(num_node=24, edge=_with_self_loops(24, _NTU_EDGE_LINKS), center=2),
    "openpose": dict(num_node=18, edge=_with_self_loops(18, _OPENPOSE18_LINKS), center=1),
    "coco": dict(num_node=17, edge=_with_self_loops(17, _COCO17_LINKS), center=0),
    "lara": dict(num_node=19, edge=_with_self_loops(19, _LARA19_LINKS), center=0),
    "hugadb": dict(num_node=6, edge=_with_self_loops(6, _HUGADB6_LINKS), center=0),
    "imu_fogit_ABCD": dict(num_node=7, edge=_with_self_loops(7, _FOGIT7_LINKS), center=0),
    "tp-vicon": dict(num_node=9, edge=_with_self_loops(9, _TPVICON9_LINKS), center=0),
}


def load_skeleton(name_or_path: str) -> dict:
    """Resolve a skeleton spec by bundled name or JSON file path.

    JSON files use the same schema as the bundled specs:
    ``{"num_node": int, "edge": [[i, j], ...], "center": int}``.
    """
    if name_or_path in SKELETONS:
        return dict(SKELETONS[name_or_path])
    with open(name_or_path) as f:
        spec = json.load(f)
    return {
        "num_node": spec["num_node"],
        "edge": [tuple(e) for e in spec["edge"]],
        "center": spec["center"],
    }
