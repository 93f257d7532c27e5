"""The reference's bounding-volume hierarchy: a binary tree over primitive
boxes by the surface-area heuristic, shared by the work count (work.py,
leaves of 4 over spheres and faces) and the face culling of the reference
tracer (tracer.py, leaves of a few faces).

Every node is split by a full sweep of the primitives' centroids along
each axis, at the split of least (left area x left count + right area x
right count), until a node holds at most `leaf_size` primitives.  Nodes
are numbered in preorder, left before right, so a node's leaves are
consecutive in node order.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Tree:
    lo: np.ndarray  # (M, 3) node boxes
    hi: np.ndarray
    left: np.ndarray  # (M,) child ids, -1 at a leaf
    right: np.ndarray
    prims: list  # per node: the primitive ids of a leaf, [] inside


def _area(lo, hi):
    e = np.maximum(hi - lo, 0.0)
    return 2.0 * (e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] + e[..., 2] * e[..., 0])


def _split(ids: np.ndarray, lo: np.ndarray, hi: np.ndarray, cent: np.ndarray):
    """The SAH split of `ids`: (left ids, right ids)."""
    best = (np.inf, None)
    for ax in range(3):
        order = ids[np.argsort(cent[ids, ax], kind="stable")]
        l_lo = np.minimum.accumulate(lo[order], 0)
        l_hi = np.maximum.accumulate(hi[order], 0)
        r_lo = np.minimum.accumulate(lo[order][::-1], 0)[::-1]
        r_hi = np.maximum.accumulate(hi[order][::-1], 0)[::-1]
        n = np.arange(1, len(order))
        cost = (_area(l_lo[:-1], l_hi[:-1]) * n
                + _area(r_lo[1:], r_hi[1:]) * (len(order) - n))
        j = int(np.argmin(cost))
        if cost[j] < best[0]:
            best = (cost[j], (order[:j + 1], order[j + 1:]))
    return best[1]


def build(lo: np.ndarray, hi: np.ndarray, leaf_size: int) -> Tree:
    """The SAH tree over primitives with boxes (lo, hi), (N, 3) each."""
    nodes_lo, nodes_hi, left, right, prims = [], [], [], [], []
    cent = 0.5 * (lo + hi)
    # (ids, parent, side): a node is numbered when it is popped, and its
    # left child is pushed last, so the numbering is the recursive preorder.
    stack = [(np.arange(len(lo)), -1, None)]
    while stack:
        ids, parent, side = stack.pop()
        k = len(nodes_lo)
        if parent >= 0:
            (left if side == 0 else right)[parent] = k
        nodes_lo.append(lo[ids].min(0))
        nodes_hi.append(hi[ids].max(0))
        left.append(-1)
        right.append(-1)
        prims.append([])
        if len(ids) <= leaf_size:
            prims[k] = [int(i) for i in ids]
            continue
        a, b = _split(ids, lo, hi, cent)
        stack.append((b, k, 1))
        stack.append((a, k, 0))
    return Tree(np.asarray(nodes_lo), np.asarray(nodes_hi), np.asarray(left),
                np.asarray(right), prims)
