"""BVH build (host) + threaded layout for stackless TPU traversal.

Build parity with ``Scene::buildBVH`` / ``buildBVHRecursive``
(``src/scene.cpp:445-525``): recursive top-down midpoint split on the longest
centroid-extent axis, node AABB over member triangle vertices, leaf at
<= ``leaf_size`` (4) triangles, median split fallback when the midpoint
partition degenerates.  Node records {aabb, left, right, start, tri_count}
with children by index and pre-order (DFS) numbering, exactly like the
reference (``src/sceneStructs.h:95-101``).

TPU-native addition: because a per-lane traversal stack (reference:
``int stack[64]``, ``src/intersections.cu:166``) is hostile to a vector unit,
we *thread* the tree: every node gets a ``miss_link`` (next node in DFS order
after its subtree) so traversal is a single monotonically-increasing node
cursor per ray -- hit an internal node -> descend to ``i+1`` (its left child in
pre-order); miss, or finish a leaf -> jump to ``miss_link[i]``.  Each node is
visited at most once, so traversal terminates in <= num_nodes steps with one
``int32`` of state per ray.

The JAX package can also delegate the build to native C++ code
(``native/bvh_builder.cpp``) that replicates the reference's in-place swap
partition ordering bit-for-bit.  That code is not ported yet (ROADMAP.md,
Queue 1: ``native/``), so this copy builds with the NumPy stable partition
only (same triangle *sets* per node, possibly different intra-node order --
renders are identical since closest-hit is order independent).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class BVH:
    """SoA BVH. Parity arrays + threaded traversal arrays.

    All arrays have length ``num_nodes`` except ``tri_indices`` ([T]).
    ``left/right`` are -1 for leaves; ``start >= 0 && tri_count > 0`` flags a
    leaf (same convention as the reference).
    """

    aabb_min: np.ndarray  # [M, 3] f32
    aabb_max: np.ndarray  # [M, 3] f32
    left: np.ndarray  # [M] i32
    right: np.ndarray  # [M] i32
    start: np.ndarray  # [M] i32 (into tri_indices)
    tri_count: np.ndarray  # [M] i32
    tri_indices: np.ndarray  # [T] i32 permutation
    miss_link: np.ndarray  # [M] i32: next DFS node after this subtree (M = end)
    leaf_size: int

    @property
    def num_nodes(self) -> int:
        return int(self.left.shape[0])

    def split_axes(self) -> np.ndarray:
        """Per-node split axis, inferred from child AABB centers (valid for
        internal nodes; 0 for leaves).  Used for ordered traversal only, so
        an approximate axis is fine."""
        m = self.num_nodes
        axes = np.zeros(m, np.int32)
        internal = self.left >= 0
        l = self.left[internal]
        r = self.right[internal]
        cl = (self.aabb_min[l] + self.aabb_max[l]) * 0.5
        cr = (self.aabb_min[r] + self.aabb_max[r]) * 0.5
        axes[internal] = np.argmax(np.abs(cr - cl), axis=1)
        return axes


def build_bvh(
    tri_vertices: np.ndarray,
    centroids: np.ndarray,
    leaf_size: int = 4,
    use_native: bool = False,
) -> BVH:
    """Build the BVH. ``tri_vertices``: [T, 3, 3], ``centroids``: [T, 3]."""
    if use_native:
        raise NotImplementedError(
            "the native C++ BVH build is not ported yet (ROADMAP.md, "
            "Queue 1: native/); build with use_native=False"
        )
    return _build_numpy(tri_vertices, centroids, leaf_size)


def _build_numpy(tri_vertices: np.ndarray, centroids: np.ndarray, leaf_size: int) -> BVH:
    T = tri_vertices.shape[0]
    tri_indices = np.arange(T, dtype=np.int64)
    verts = tri_vertices.astype(np.float64)
    cents = centroids.astype(np.float64)

    aabb_min: list = []
    aabb_max: list = []
    left: list = []
    right: list = []
    start_arr: list = []
    count_arr: list = []

    # Iterative pre-order build. Each frame: (start, end, slot) where slot is
    # the parent field to patch ('L'/'R'/None). Children are emitted so that
    # left child == parent_index + 1 (pre-order), matching the recursive
    # reference build order (src/scene.cpp:518-519).
    def new_node(s: int, e: int) -> int:
        idx = len(left)
        sel = tri_indices[s:e]
        v = verts[sel]  # [n, 3, 3]
        aabb_min.append(v.reshape(-1, 3).min(axis=0))
        aabb_max.append(v.reshape(-1, 3).max(axis=0))
        left.append(-1)
        right.append(-1)
        start_arr.append(-1)
        count_arr.append(0)
        return idx

    # Explicit stack of work items: (start, end, parent_idx, is_right_child)
    stack = [(0, T, -1, False)]
    while stack:
        s, e, parent, is_right = stack.pop()
        idx = new_node(s, e)
        if parent >= 0:
            if is_right:
                right[parent] = idx
            else:
                left[parent] = idx

        n = e - s
        if n <= leaf_size:
            start_arr[idx] = s
            count_arr[idx] = n
            continue

        sel = tri_indices[s:e]
        c = cents[sel]
        cmin = c.min(axis=0)
        cmax = c.max(axis=0)
        extent = cmax - cmin
        # Longest-axis selection replicating the reference's two ifs
        # (src/scene.cpp:490-498): note the second test compares z only
        # against x, a reference quirk kept verbatim.
        axis = 0
        if extent[1] > extent[0] and extent[1] > extent[2]:
            axis = 1
        if extent[2] > extent[0]:
            axis = 2

        split_pos = 0.5 * (cmin[axis] + cmax[axis])
        pred = c[:, axis] < split_pos
        mid = s + int(pred.sum())
        if mid == s or mid == e:
            # Pathological split -> median (src/scene.cpp:513-515). The
            # reference splits positionally without reordering.
            mid = (s + e) // 2
        else:
            # Stable partition (see module docstring re: ordering parity).
            tri_indices[s:e] = np.concatenate([sel[pred], sel[~pred]])

        # Push right first so left pops first -> pre-order, left == idx + 1.
        stack.append((mid, e, idx, True))
        stack.append((s, mid, idx, False))

    out = dict(
        aabb_min=np.asarray(aabb_min, np.float32),
        aabb_max=np.asarray(aabb_max, np.float32),
        left=np.asarray(left, np.int32),
        right=np.asarray(right, np.int32),
        start=np.asarray(start_arr, np.int32),
        tri_count=np.asarray(count_arr, np.int32),
        tri_indices=tri_indices.astype(np.int32),
    )
    return _finish(out, leaf_size)


@dataclass
class OctantBVH:
    """Eight direction-ordered threaded layouts of one BVH.

    For rays whose direction sign along a node's split axis is positive, the
    lower-side child should be visited first (near-to-far) so the first hit
    prunes the far subtree.  A single pre-order threading fixes ONE child
    order, so we materialize all 8 orderings (one per direction octant) and
    each ray walks the layout matching its octant: octant bit a set
    (direction negative along axis a) -> upper child first.

    All arrays are [8, M]; layout o's node j carries ``node[o, j]`` data and
    jumps to ``miss[o, j]`` on miss / ``j + 1`` on internal hit.  Leaf
    start/count index the (shared) leaf-ordered triangle arrays.
    """

    aabb_min: np.ndarray  # [8, M, 3] f32
    aabb_max: np.ndarray
    miss: np.ndarray  # [8, M] i32
    start: np.ndarray  # [8, M] i32
    count: np.ndarray  # [8, M] i32


def build_octant_layouts(bvh: BVH) -> OctantBVH:
    """All 8 octant pre-orders at once, vectorized by tree level.

    For octant ``o`` the near child of a node split on axis ``a`` is the
    right child iff bit ``a`` of ``o`` is set; the new pre-order rank obeys
    rank(first) = rank(node)+1 and rank(second) = rank(node)+1+|first's
    subtree| (subtree sizes are layout-invariant: the original pre-order is
    contiguous, so size = miss_link - index).  Propagating ranks level by
    level replaces the 8 Python DFS walks (7 s at 500k tris) with ~depth
    NumPy passes (<0.3 s); ``_build_octant_layouts_walk`` is the oracle."""
    m = bvh.num_nodes
    axes = bvh.split_axes().astype(np.int64)
    subtree = (bvh.miss_link - np.arange(m)).astype(np.int64)
    left = bvh.left.astype(np.int64)
    right = bvh.right.astype(np.int64)
    is_leaf = left < 0
    oo = np.arange(8, dtype=np.int64)[:, None]

    rank = np.zeros((8, m), np.int64)
    miss_new = np.zeros((8, m), np.int64)
    miss_new[:, 0] = m
    frontier = np.array([0], np.int64)
    while frontier.size:
        inner = frontier[~is_leaf[frontier]]
        if inner.size == 0:
            break
        l, r = left[inner], right[inner]
        flip = (oo >> axes[inner][None, :]) & 1  # [8, K]
        first = np.where(flip == 1, r[None, :], l[None, :])
        second = np.where(flip == 1, l[None, :], r[None, :])
        base = rank[:, inner] + 1
        rank[oo, first] = base
        miss_new[oo, first] = base + subtree[first]
        rank[oo, second] = base + subtree[first]
        miss_new[oo, second] = miss_new[:, inner]
        frontier = np.concatenate([l, r])

    order = np.empty((8, m), np.int64)
    order[oo, rank] = np.arange(m)[None, :]
    miss = np.empty((8, m), np.int32)
    start = np.empty((8, m), np.int32)
    count = np.empty((8, m), np.int32)
    miss[oo, rank] = miss_new.astype(np.int32)
    start[oo, rank] = np.where(is_leaf, bvh.start, -1).astype(np.int32)[None, :]
    count[oo, rank] = np.where(is_leaf, bvh.tri_count, 0).astype(np.int32)[None, :]
    return OctantBVH(
        aabb_min=bvh.aabb_min[order],
        aabb_max=bvh.aabb_max[order],
        miss=miss,
        start=start,
        count=count,
    )


def _build_octant_layouts_walk(bvh: BVH) -> OctantBVH:
    """Reference implementation: one explicit DFS per octant (the oracle
    for the vectorized builder above)."""
    m = bvh.num_nodes
    axes = bvh.split_axes()
    subtree = (bvh.miss_link - np.arange(m)).astype(np.int64)

    amin = np.zeros((8, m, 3), np.float32)
    amax = np.zeros((8, m, 3), np.float32)
    miss = np.zeros((8, m), np.int32)
    start = np.zeros((8, m), np.int32)
    count = np.zeros((8, m), np.int32)

    for o in range(8):
        neg = ((o >> 0) & 1, (o >> 1) & 1, (o >> 2) & 1)  # bit a: dir[a] < 0
        order = np.empty(m, np.int64)
        pos = 0
        stack = [(0, m)]  # (original node, miss slot in NEW numbering)
        while stack:
            node, miss_after = stack.pop()
            new_idx = pos
            pos += 1
            order[new_idx] = node
            miss[o, new_idx] = miss_after
            l, r = bvh.left[node], bvh.right[node]
            if l < 0:  # leaf
                start[o, new_idx] = bvh.start[node]
                count[o, new_idx] = bvh.tri_count[node]
                continue
            start[o, new_idx] = -1
            count[o, new_idx] = 0
            first, second = (l, r) if not neg[axes[node]] else (r, l)
            # first child occupies [new_idx+1, new_idx+1+subtree[first]);
            # second child follows it and exits to this node's miss slot.
            stack.append((second, miss_after))
            stack.append((first, int(new_idx + 1 + subtree[first])))
        amin[o] = bvh.aabb_min[order]
        amax[o] = bvh.aabb_max[order]
    return OctantBVH(aabb_min=amin, aabb_max=amax, miss=miss, start=start, count=count)


def _compute_miss_links(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """miss_link[i] = first pre-order node after i's subtree (num_nodes at
    the end). Computed top-down: root's is M; left child's is the right
    sibling; right child's is the parent's."""
    m = left.shape[0]
    miss = np.full(m, m, dtype=np.int32)
    stack = [0]
    while stack:
        i = stack.pop()
        l, r = left[i], right[i]
        if l >= 0:
            miss[l] = r if r >= 0 else miss[i]
            stack.append(l)
        if r >= 0:
            miss[r] = miss[i]
            stack.append(r)
    return miss


def _finish(arrs: dict, leaf_size: int) -> BVH:
    miss = _compute_miss_links(arrs["left"], arrs["right"])
    return BVH(
        aabb_min=arrs["aabb_min"],
        aabb_max=arrs["aabb_max"],
        left=arrs["left"],
        right=arrs["right"],
        start=arrs["start"],
        tri_count=arrs["tri_count"],
        tri_indices=arrs["tri_indices"],
        miss_link=miss,
        leaf_size=leaf_size,
    )
