"""Morton-ordered LBVH: the acceleration structure.

Replaces the reference's entire GPU HLBVH pipeline —
minmax reduction (``hlbvh/minmax.comp``), Morton emit
(``hlbvh/aabbmaker.comp``), 8-pass radix sort (``radix/*``, ``Radix.hpp``),
Karras LBVH emit with a ≤256-iteration host loop
(``hlbvh/build-new.comp``, ``TriangleHierarchy.inl:304-314``), leaf link
(``child-link.comp``) and atomic-flag refit (``refit.comp``) — with
fully-vectorized XLA steps and **zero host synchronization**:

1. scene bounds: one ``jnp.min/max`` (vs 32-workgroup shared-memory tree
   reduction + CPU union);
2. Morton codes + ``lax.sort`` of (code, index) (vs hand-rolled radix);
3. leaf AABBs by reshape-reduction over K-triangle leaves;
4. internal topology: a **Karras binary radix tree** over the leaf
   clusters' Morton codes — every internal node finds its range/split
   independently via vectorized prefix binary searches (the single-pass
   formulation of ``hlbvh/build-new.comp:33-56``'s findSplit, without
   the reference's ≤256-dispatch host frontier loop);
5. escape links by pointer-jumping over parent chains (log passes);
6. internal AABBs by a bottom-up fix-point union (depth ≤ key bits, so
   ~48 masked passes replace refit.comp's atomicCompSwap visit flags).

Leaves are the sorted triangle order chopped into K-sized runs; leaf j
covers reordered slots [jK, (j+1)K) at node index ``first_leaf + j``.
``topology="median"`` keeps the r1 complete-tree median split (heap
children, static skip links) for A/B comparison — its box quality is
much worse on non-uniform scenes (no adaptation to Morton prefix
structure), which tests/test_bvh.py quantifies with a traversal
step-count metric.

Traversal needs no per-ray stack either way: ``left`` + ``skip``
(preorder escape) links make the walk stackless, the right shape for
vector lanes (the reference instead spills an 8-entry shared-memory
stack to a global buffer, ``directTraverse.comp:40-70``).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from prismarine_core_tpu.models.geometry import TriangleSoup
from prismarine_core_tpu.ops.morton import morton30, quantize_unit

#: padding AABB placed "at infinity" — always misses the slab test.
EMPTY_BOX = 1.0e30

#: effective key length: 30 Morton bits + index tie-break bits; bounds
#: radix-tree depth and the refit fix-point pass count.
_MAX_DEPTH = 52


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class BVH:
    """Binary radix-tree BVH over Morton-sorted triangles.

    N = 2L-1 nodes for L leaves of ``leaf_size`` triangles.  Internal
    nodes occupy [0, L-1) (root = 0), leaves [L-1, 2L-1); leaf j covers
    reordered triangle slots [j*K, (j+1)*K).
    """

    lo: jax.Array       # f32[N,3] node AABB min
    hi: jax.Array       # f32[N,3] node AABB max
    left: jax.Array     # i32[N] left-child node (undefined for leaves)
    skip: jax.Array     # i32[N] preorder escape link; N == "done"
    tv0: jax.Array      # f32[L*K,3] reordered triangle vertices
    tv1: jax.Array
    tv2: jax.Array
    orig: jax.Array     # i32[L*K] slot -> original triangle id (-1 pad)

    @property
    def n_nodes(self) -> int:
        return self.lo.shape[0]

    @property
    def n_leaves(self) -> int:
        return (self.n_nodes + 1) // 2

    @property
    def leaf_size(self) -> int:
        return self.tv0.shape[0] // self.n_leaves

    @property
    def first_leaf(self) -> int:
        return self.n_leaves - 1


@lru_cache(maxsize=None)
def _heap_links(depth: int):
    """Static left-child + escape links for the heap-indexed complete
    tree (topology="median").

    skip(left child)  = its right sibling
    skip(right child) = skip(parent)
    skip(root)        = N  (the done sentinel)
    """
    n = 2 ** (depth + 1) - 1
    skip = np.full(n, n, np.int32)
    left = np.full(n, -1, np.int32)
    for d in range(depth):
        idx = np.arange(2 ** d - 1, 2 ** (d + 1) - 1)
        left[idx] = (2 * idx + 1).astype(np.int32)
        skip[2 * idx + 1] = (2 * idx + 2).astype(np.int32)
        skip[2 * idx + 2] = skip[idx]
    return left, skip


def _tree_depth(n_tris: int, leaf_size: int) -> int:
    n_leaves_needed = max(-(-n_tris // leaf_size), 1)
    depth = max(int(np.ceil(np.log2(n_leaves_needed))), 0)
    # Keep total slots (n_leaves * leaf_size) a multiple of 512 so the
    # packet/Pallas block view (accel/packet.py: BLOCK=128, superblocks
    # of 8 blocks) aligns with the slot arrays without re-padding.
    min_depth = max(int(np.ceil(np.log2(512 / leaf_size))), 0)
    return max(depth, min_depth)


def _clz32(x):
    """Count leading zeros of a uint32 vector (32 where x == 0)."""
    x = x.astype(jnp.uint32)
    x = x | (x >> 1)
    x = x | (x >> 2)
    x = x | (x >> 4)
    x = x | (x >> 8)
    x = x | (x >> 16)
    return jnp.bitwise_count(~x).astype(jnp.int32)


def _karras_topology(codes):
    """Vectorized Karras 2012 binary radix tree over ``codes`` (u32[C],
    sorted).  Returns (left, right) node ids per internal node i in
    [0, C-2]: child ids < C-1 are internal, ids >= C-1 are leaves
    (leaf j = C-1 + j) — matching the reference's findSplit prefix
    search (``hlbvh/build-new.comp:33-56``) without its host loop.
    """
    c = codes.shape[0]
    first_leaf = c - 1
    i = jnp.arange(c - 1, dtype=jnp.int32)
    n_steps = int(np.ceil(np.log2(max(c, 2)))) + 1

    def delta(a, b):
        """Common-prefix length of keys (code ++ index); -1 out of range."""
        valid = (b >= 0) & (b < c)
        bc = jnp.clip(b, 0, c - 1)
        x = codes[a] ^ codes[bc]
        ix = (a.astype(jnp.uint32) ^ bc.astype(jnp.uint32))
        pref = jnp.where(x == 0, 32 + _clz32(ix), _clz32(x))
        return jnp.where(valid, pref, -1)

    # direction: toward the longer common prefix
    d = jnp.sign(delta(i, i + 1) - delta(i, i - 1)).astype(jnp.int32)
    d = jnp.where(d == 0, 1, d)
    dmin = delta(i, i - d)

    # range length upper bound by doubling (freeze on first failure)
    lmax = jnp.full_like(i, 2)
    grow = jnp.ones_like(i, dtype=bool)
    for _ in range(n_steps):
        grow = grow & (delta(i, i + lmax * d) > dmin)
        lmax = jnp.where(grow, lmax * 2, lmax)

    # binary search the exact other end j = i + l*d
    l = jnp.zeros_like(i)
    t = lmax // 2
    for _ in range(n_steps + 1):
        cond = (t >= 1) & (delta(i, i + (l + t) * d) > dmin)
        l = jnp.where(cond, l + t, l)
        t = t // 2
    j = i + l * d

    # split position (do-while over halving t, frozen once t hits 1)
    dnode = delta(i, j)
    s = jnp.zeros_like(i)
    t = l
    done = jnp.zeros_like(i, dtype=bool)
    for _ in range(n_steps + 1):
        t = (t + 1) // 2
        cond = (~done) & (delta(i, i + (s + t) * d) > dnode)
        s = jnp.where(cond, s + t, s)
        done = done | (t <= 1)
    gamma = i + s * d + jnp.minimum(d, 0)

    lo_end = jnp.minimum(i, j)
    hi_end = jnp.maximum(i, j)
    left = jnp.where(lo_end == gamma, first_leaf + gamma, gamma)
    right = jnp.where(hi_end == gamma + 1, first_leaf + gamma + 1,
                      gamma + 1)
    return left, right


def _escape_links(left, right, n_nodes):
    """Preorder escape links from child arrays by pointer jumping.

    esc(x) = right sibling of the first ancestor-or-self that is a left
    child; N (done) if none — the data-dependent generalization of the
    complete tree's static skip links.
    """
    c1 = left.shape[0]  # number of internal nodes
    parent = jnp.zeros((n_nodes,), jnp.int32)
    is_left = jnp.zeros((n_nodes,), bool)
    idx = jnp.arange(c1, dtype=jnp.int32)
    parent = parent.at[left].set(idx)
    parent = parent.at[right].set(idx)
    is_left = is_left.at[left].set(True)

    # f(x): first ancestor-or-self that is a left child (or the root)
    stop = is_left | (jnp.arange(n_nodes) == 0)
    f = jnp.where(stop, jnp.arange(n_nodes), parent)
    n_jumps = int(np.ceil(np.log2(_MAX_DEPTH))) + 2
    for _ in range(n_jumps):
        f = f[f]

    sibling = right[jnp.clip(parent, 0, c1 - 1)]
    esc = jnp.where(is_left[f], sibling[f], n_nodes)
    return esc.astype(jnp.int32)


def _fixpoint_boxes(kleft, kright, leaf_lo, leaf_hi, n_nodes,
                    first_leaf):
    """Bottom-up fix-point AABB union over the radix-tree topology,
    with EARLY EXIT: a while_loop stops one pass after nothing changes
    (true tree depth ~log2(leaves), vs the conservative ``_MAX_DEPTH``
    = key-length bound — measured ~2.5x fewer passes at bench scale).
    Boxes are detached (``stop_gradient``): they are culling
    structures, every consumer re-detaches them anyway, and the
    detachment keeps the while_loop off the reverse-mode path of the
    in-loss rebuild."""
    big = jnp.float32(EMPTY_BOX)
    sg = jax.lax.stop_gradient
    lo = jnp.full((n_nodes, 3), big, jnp.float32)
    hi = jnp.full((n_nodes, 3), -big, jnp.float32)
    lo = lo.at[first_leaf:].set(sg(leaf_lo))
    hi = hi.at[first_leaf:].set(sg(leaf_hi))

    def cond(st):
        i, changed, _, _ = st
        return changed & (i < _MAX_DEPTH)

    def body(st):
        i, _, lo, hi = st
        nlo = jnp.minimum(lo[kleft], lo[kright])
        nhi = jnp.maximum(hi[kleft], hi[kright])
        changed = jnp.any((nlo != lo[:first_leaf])
                          | (nhi != hi[:first_leaf]))
        return (i + 1, changed, lo.at[:first_leaf].set(nlo),
                hi.at[:first_leaf].set(nhi))

    _, _, lo, hi = jax.lax.while_loop(
        cond, body, (jnp.int32(0), jnp.array(True), lo, hi))
    return lo, hi


@partial(jax.jit, static_argnames=("leaf_size", "topology"))
def build_bvh(soup: TriangleSoup, leaf_size: int = 4,
              topology: str = "karras") -> BVH:
    """Build the BVH from a (padded) triangle soup. Fully jittable: one
    XLA program, no host round-trips (the reference needs 4+ CPU syncs
    per rebuild, ``TriangleHierarchy.inl:209-314``)."""
    assert leaf_size & (leaf_size - 1) == 0, \
        "leaf_size must be a power of two (slot/block alignment)"
    t = soup.capacity
    depth = _tree_depth(t, leaf_size)
    n_leaves = 2 ** depth
    n_slots = n_leaves * leaf_size
    n_nodes = 2 * n_leaves - 1
    first_leaf = n_leaves - 1

    # 1. scene bounds over valid triangle centroids.
    centroid = (soup.v0 + soup.v1 + soup.v2) / 3.0
    big = jnp.float32(EMPTY_BOX)
    vmask = soup.valid[:, None]
    cmin = jnp.min(jnp.where(vmask, centroid, big), axis=0)
    cmax = jnp.max(jnp.where(vmask, centroid, -big), axis=0)
    extent = jnp.maximum(cmax - cmin, 1e-6)

    # 2. Morton codes (invalid tris get the max key so they sort last),
    #    then a single stable lax.sort of (code, index) replaces the
    #    reference's 8x256-way radix sort (Radix.hpp:57-69).
    unit = (centroid - cmin) / extent
    codes = morton30(quantize_unit(unit))
    codes = jnp.where(soup.valid, codes, jnp.uint32(0xFFFFFFFF))
    order = jnp.arange(t, dtype=jnp.int32)
    codes_sorted, order = jax.lax.sort((codes, order), num_keys=1,
                                       is_stable=True)

    # 3. reorder triangles into leaf slots (pad with degenerate zeros).
    def scatter_pad(src):
        out = jnp.zeros((n_slots, 3), src.dtype)
        return out.at[: min(t, n_slots)].set(src[order][:n_slots])

    tv0 = scatter_pad(soup.v0)
    tv1 = scatter_pad(soup.v1)
    tv2 = scatter_pad(soup.v2)
    orig = jnp.full((n_slots,), -1, jnp.int32)
    sorted_valid = soup.valid[order][:n_slots]
    orig = orig.at[: min(t, n_slots)].set(
        jnp.where(sorted_valid, order[:n_slots], -1))

    # Degenerate-at-origin padding would produce huge leaf boxes; mask
    # invalid slots to the *inverted* box (lo=+big, hi=-big), the neutral
    # element of AABB union, so empty slots vanish from reductions.
    slot_valid = orig >= 0
    svm = slot_valid[:, None]
    slo = jnp.where(svm, jnp.minimum(jnp.minimum(tv0, tv1), tv2), big)
    shi = jnp.where(svm, jnp.maximum(jnp.maximum(tv0, tv1), tv2), -big)

    # leaf AABBs: reshape-reduction over K slots per leaf.
    leaf_lo = slo.reshape(n_leaves, leaf_size, 3).min(axis=1)
    leaf_hi = shi.reshape(n_leaves, leaf_size, 3).max(axis=1)

    if topology == "median":
        # complete tree, median splits: level-order reshape reductions
        left_np, skip_np = _heap_links(depth)
        left = jnp.asarray(left_np)
        skip = jnp.asarray(skip_np)
        lo = jnp.full((n_nodes, 3), big, jnp.float32)
        hi = jnp.full((n_nodes, 3), -big, jnp.float32)
        lo = lo.at[first_leaf:].set(leaf_lo)
        hi = hi.at[first_leaf:].set(leaf_hi)
        for dd in range(depth - 1, -1, -1):
            lo_c = lo[2 ** (dd + 1) - 1: 2 ** (dd + 2) - 1]
            hi_c = hi[2 ** (dd + 1) - 1: 2 ** (dd + 2) - 1]
            lo = lo.at[2 ** dd - 1: 2 ** (dd + 1) - 1].set(
                lo_c.reshape(-1, 2, 3).min(axis=1))
            hi = hi.at[2 ** dd - 1: 2 ** (dd + 1) - 1].set(
                hi_c.reshape(-1, 2, 3).max(axis=1))
    elif topology == "karras":
        # per-leaf-cluster representative key: the first slot's code
        # (padded with the max key so empty clusters chain at the end);
        # ranges/splits adapt to the Morton prefix structure.
        padk = jnp.full((n_slots - min(t, n_slots),), 0xFFFFFFFF,
                        jnp.uint32)
        slot_codes = jnp.concatenate(
            [codes_sorted[:n_slots], padk])[:n_slots]
        cluster_codes = slot_codes.reshape(n_leaves, leaf_size)[:, 0]
        kleft, kright = _karras_topology(cluster_codes)
        skip = _escape_links(kleft, kright, n_nodes)
        left = jnp.concatenate(
            [kleft, jnp.full((n_leaves,), -1, jnp.int32)])
        lo, hi = _fixpoint_boxes(kleft, kright, leaf_lo, leaf_hi,
                                 n_nodes, first_leaf)
    else:
        raise ValueError(f"unknown topology {topology!r}")

    # Inverted (empty) boxes would *pass* the slab test; convert them to
    # a point box at +big, which always fails it.
    empty = (lo > hi).any(axis=-1, keepdims=True)
    lo = jnp.where(empty, big, lo)
    hi = jnp.where(empty, big, hi)

    return BVH(
        lo=lo, hi=hi, left=left, skip=skip,
        tv0=tv0, tv1=tv1, tv2=tv2, orig=orig,
    )


@jax.jit
def refit_bvh(bvh: BVH, soup: TriangleSoup) -> BVH:
    """Topology-reusing refit: re-union every AABB over FROZEN topology
    after the soup's vertices moved (the analog of the reference's
    per-frame ``refit.comp:21-114``, which re-walks the tree bottom-up
    under atomic visit flags; here it is the same masked fix-point
    reduction the build uses, with the Morton sort / radix-tree
    topology passes skipped).

    Valid whenever triangle COUNT and identity are unchanged (deforming
    geometry, per-frame animation, inverse-rendering vertex updates);
    box quality degrades only as far as the frozen Morton order does.
    Works for both topologies: the right child of internal node ``i``
    is recovered as ``skip[left[i]]`` (a left child's escape link is by
    construction its right sibling).
    """
    first_leaf = bvh.first_leaf
    n_nodes = bvh.n_nodes
    leaf_size = bvh.leaf_size
    big = jnp.float32(EMPTY_BOX)

    trix = jnp.maximum(bvh.orig, 0)
    valid = (bvh.orig >= 0)[:, None]
    tv0 = jnp.where(valid, soup.v0[trix], 0.0)
    tv1 = jnp.where(valid, soup.v1[trix], 0.0)
    tv2 = jnp.where(valid, soup.v2[trix], 0.0)

    slo = jnp.where(valid, jnp.minimum(jnp.minimum(tv0, tv1), tv2), big)
    shi = jnp.where(valid, jnp.maximum(jnp.maximum(tv0, tv1), tv2), -big)
    leaf_lo = slo.reshape(-1, leaf_size, 3).min(axis=1)
    leaf_hi = shi.reshape(-1, leaf_size, 3).max(axis=1)

    if first_leaf > 0:
        kleft = bvh.left[:first_leaf]
        kright = bvh.skip[kleft]
        lo, hi = _fixpoint_boxes(kleft, kright, leaf_lo, leaf_hi,
                                 n_nodes, first_leaf)
    else:
        lo = jnp.full((n_nodes, 3), big, jnp.float32)
        hi = jnp.full((n_nodes, 3), -big, jnp.float32)
        lo = lo.at[first_leaf:].set(leaf_lo)
        hi = hi.at[first_leaf:].set(leaf_hi)

    empty = (lo > hi).any(axis=-1, keepdims=True)
    lo = jnp.where(empty, big, lo)
    hi = jnp.where(empty, big, hi)
    return BVH(lo=lo, hi=hi, left=bvh.left, skip=bvh.skip,
               tv0=tv0, tv1=tv1, tv2=tv2, orig=bvh.orig)
