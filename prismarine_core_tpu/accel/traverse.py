"""Stackless BVH traversal on vector lanes.

Replaces ``ShadersSDK/raytracing/directTraverse.comp`` (511 LoC: per-ray
state machine, 8-entry shared-memory stack + global spill, baked-hit
sort/dedup).  The array formulation: every ray holds one ``node`` pointer;
one bulk `lax.while_loop` steps all rays together (masked lanes), each
step doing a gathered AABB slab test plus — for rays parked at a leaf —
a K-wide Möller–Trumbore test against the leaf's reordered triangles.
The skip-link layout (accel/lbvh.py) removes the stack entirely, which is
what the reference's own `esc` escape-index logic approximates
(``directTraverse.comp:377,429``).

Differentiability (SURVEY.md §7 stage 6, "detached visibility"): reverse
mode cannot pass through `lax.while_loop`, so the traversal runs entirely
on `stop_gradient` inputs and yields only the *discrete* hit triangle id;
(t, u, v) are then re-evaluated differentiably for that one triangle from
the live soup vertices.  Gradients flow to vertex positions / ray origin
/ direction through the re-evaluation; the BVH structure itself is
detached (its boxes are built from the same vertices but only gate
visibility, which has zero a.e. derivative anyway).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from prismarine_core_tpu.accel.lbvh import BVH
from prismarine_core_tpu.models.geometry import TriangleSoup
from prismarine_core_tpu.ops.intersect import Hit, moller_trumbore
from prismarine_core_tpu.utils.config import INF_DIST, PZERO


def _traverse(bvh: BVH, o, d, t_cap, any_hit: bool):
    """Single-phase skip-link walk (non-differentiable).

    Every while-loop step pays both the box test and the K-wide leaf
    test on all lanes; see ``_traverse2`` for the two-phase variant that
    skips leaf work during descent.  Kept as the reference-simple
    implementation (and for A/B benchmarks).

    Returns (t, slot, u, v): ``slot`` indexes the BVH's reordered
    triangle arrays (-1 = miss).  ``t_cap``: f32[R] far limit (e.g.
    shadow-ray light distance) — doubles as the pruning bound.
    ``any_hit``: lanes retire at the first accepted hit (shadow query).
    """
    r = o.shape[0]
    n = bvh.n_nodes
    first_leaf = bvh.first_leaf
    k = bvh.leaf_size

    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-12,
                            jnp.where(d < 0, -1e-12, 1e-12), d)

    def cond(state):
        node = state[0]
        return jnp.any(node < n)

    def body(state):
        node, bt, bslot, bu, bv = state
        active = node < n
        ni = jnp.minimum(node, n - 1)

        lo = bvh.lo[ni]
        hi = bvh.hi[ni]
        t0 = (lo - o) * inv_d
        t1 = (hi - o) * inv_d
        tn = jnp.max(jnp.minimum(t0, t1), axis=-1)
        tf = jnp.min(jnp.maximum(t0, t1), axis=-1)
        box_hit = (tf >= jnp.maximum(tn, PZERO)) & (tn < bt) & active

        is_leaf = ni >= first_leaf
        leaf = jnp.maximum(ni - first_leaf, 0)

        # K-wide triangle test for lanes parked at an intersected leaf.
        slot = leaf[:, None] * k + jnp.arange(k, dtype=jnp.int32)[None, :]
        tt, tu, tv, ok = moller_trumbore(
            o[:, None, :], d[:, None, :],
            bvh.tv0[slot], bvh.tv1[slot], bvh.tv2[slot])
        ok = ok & (bvh.orig[slot] >= 0) & (is_leaf & box_hit)[:, None]
        tt = jnp.where(ok & (tt < bt[:, None]), tt, INF_DIST)
        j = jnp.argmin(tt, axis=1)
        rows = jnp.arange(r)
        tj = tt[rows, j]
        better = tj < bt
        bt = jnp.where(better, tj, bt)
        bslot = jnp.where(better, slot[rows, j], bslot)
        bu = jnp.where(better, tu[rows, j], bu)
        bv = jnp.where(better, tv[rows, j], bv)

        descend = box_hit & ~is_leaf
        nxt = jnp.where(descend, bvh.left[ni], bvh.skip[ni])
        if any_hit:
            nxt = jnp.where(bslot >= 0, n, nxt)  # early out on first hit
        node = jnp.where(active, nxt, node)
        return node, bt, bslot, bu, bv

    init = (
        jnp.zeros((r,), jnp.int32),
        t_cap.astype(jnp.float32),
        jnp.full((r,), -1, jnp.int32),
        jnp.zeros((r,), jnp.float32),
        jnp.zeros((r,), jnp.float32),
    )
    _, bt, bslot, bu, bv = jax.lax.while_loop(cond, body, init)
    return bt, bslot, bu, bv


def _traverse2(bvh: BVH, o, d, t_cap, any_hit: bool):
    """Two-phase skip-link walk: an inner while advances lanes through
    box tests only until each is parked at an intersected leaf (or done);
    the outer step then runs one K-wide triangle test for all parked
    lanes.  Internal-node steps thus cost a box test alone — the
    vectorized analog of the reference's separate node/leaf branches in
    ``directTraverse.comp:383-464``."""
    r = o.shape[0]
    n = bvh.n_nodes
    first_leaf = bvh.first_leaf
    k = bvh.leaf_size

    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-12,
                            jnp.where(d < 0, -1e-12, 1e-12), d)
    rows = jnp.arange(r)

    def walk_cond(state):
        node, parked, bt = state
        return jnp.any((node < n) & (parked < 0))

    def _walk_step(node, parked, bt):
        walking = (node < n) & (parked < 0)
        ni = jnp.minimum(node, n - 1)
        lo = bvh.lo[ni]
        hi = bvh.hi[ni]
        t0 = (lo - o) * inv_d
        t1 = (hi - o) * inv_d
        tn = jnp.max(jnp.minimum(t0, t1), axis=-1)
        tf = jnp.min(jnp.maximum(t0, t1), axis=-1)
        box_hit = (tf >= jnp.maximum(tn, PZERO)) & (tn < bt)

        is_leaf = ni >= first_leaf
        park_here = walking & box_hit & is_leaf
        parked = jnp.where(park_here, ni, parked)
        nxt = jnp.where(box_hit & ~is_leaf, bvh.left[ni],
                        bvh.skip[ni])
        node = jnp.where(walking, nxt, node)  # parked lanes pre-advance
        return node, parked, bt

    def walk_body(state):
        # Unrolled x8: amortizes the cond reduction over eight steps and
        # keeps the while_loop body from being a tiny single gather.
        # Extra steps after a lane parks are no-ops (its `walking` mask
        # goes false).
        node, parked, bt = state
        for _ in range(8):
            node, parked, bt = _walk_step(node, parked, bt)
        return node, parked, bt

    def outer_cond(state):
        node, parked, bt, bslot, bu, bv = state
        return jnp.any((node < n) | (parked >= 0))

    def outer_body(state):
        node, parked, bt, bslot, bu, bv = state
        node, parked, _ = jax.lax.while_loop(
            walk_cond, walk_body, (node, parked, bt))

        has_leaf = parked >= 0
        leaf = jnp.where(has_leaf, parked - first_leaf, 0)
        slot = leaf[:, None] * k + jnp.arange(k, dtype=jnp.int32)[None, :]
        tt, tu, tv, ok = moller_trumbore(
            o[:, None, :], d[:, None, :],
            bvh.tv0[slot], bvh.tv1[slot], bvh.tv2[slot])
        ok = ok & (bvh.orig[slot] >= 0) & has_leaf[:, None]
        tt = jnp.where(ok & (tt < bt[:, None]), tt, INF_DIST)
        j = jnp.argmin(tt, axis=1)
        tj = tt[rows, j]
        better = tj < bt
        bt = jnp.where(better, tj, bt)
        bslot = jnp.where(better, slot[rows, j], bslot)
        bu = jnp.where(better, tu[rows, j], bu)
        bv = jnp.where(better, tv[rows, j], bv)
        parked = jnp.full_like(parked, -1)
        if any_hit:
            node = jnp.where(bslot >= 0, n, node)
        return node, parked, bt, bslot, bu, bv

    init = (
        jnp.zeros((r,), jnp.int32),
        jnp.full((r,), -1, jnp.int32),
        t_cap.astype(jnp.float32),
        jnp.full((r,), -1, jnp.int32),
        jnp.zeros((r,), jnp.float32),
        jnp.zeros((r,), jnp.float32),
    )
    _, _, bt, bslot, bu, bv = jax.lax.while_loop(
        outer_cond, outer_body, init)
    return bt, bslot, bu, bv


def _ray_sort_keys(bvh: BVH, o, d):
    """Coherence key: 3-bit direction octant ++ 27-bit origin Morton in
    the scene (root) box."""
    from prismarine_core_tpu.ops.morton import morton30
    root_lo = bvh.lo[0]
    root_hi = bvh.hi[0]
    unit = jnp.clip((o - root_lo)
                    / jnp.maximum(root_hi - root_lo, 1e-6), 0.0, 1.0)
    q = (unit * 511.0).astype(jnp.uint32)  # 9 bits/axis -> 27 bits
    m = morton30(q)
    octant = ((d[:, 0] >= 0).astype(jnp.uint32)
              | ((d[:, 1] >= 0).astype(jnp.uint32) << 1)
              | ((d[:, 2] >= 0).astype(jnp.uint32) << 2))
    return (octant << 27) | m


def _run_traversal(bvh: BVH, o, d, t_cap, any_hit: bool,
                   chunk: int = 0, sort: bool = False):
    """Dispatch: optional coherence sort + optional chunked execution."""
    r = o.shape[0]
    if sort:
        keys = _ray_sort_keys(bvh, o, d)
        iota = jnp.arange(r, dtype=jnp.int32)
        _, perm = jax.lax.sort((keys, iota), num_keys=1)
        inv = jnp.zeros((r,), jnp.int32).at[perm].set(iota)
        o, d, t_cap = o[perm], d[perm], t_cap[perm]

    if chunk and r > chunk and r % chunk == 0:
        def one(args):
            oo, dd, tc = args
            return _traverse2(bvh, oo, dd, tc, any_hit)

        res = jax.lax.map(one, (o.reshape(-1, chunk, 3),
                                d.reshape(-1, chunk, 3),
                                t_cap.reshape(-1, chunk)))
        t, slot, u, v = (x.reshape(r) for x in res)
    else:
        t, slot, u, v = _traverse2(bvh, o, d, t_cap, any_hit)

    if sort:
        t, slot, u, v = t[inv], slot[inv], u[inv], v[inv]
    return t, slot, u, v


def intersect_closest_bvh(bvh: BVH, soup: TriangleSoup, o, d,
                          chunk: int = 0, sort: bool = False) -> Hit:
    """Closest hit via BVH; differentiable w.r.t. soup vertices, o, d."""
    sg = jax.lax.stop_gradient
    _, slot, _, _ = _run_traversal(
        sg(bvh), sg(o), sg(d),
        jnp.full((o.shape[0],), INF_DIST), any_hit=False,
        chunk=chunk, sort=sort)
    tri = jnp.where(slot >= 0, bvh.orig[jnp.maximum(slot, 0)], -1)
    tri = sg(tri)

    # Differentiable re-evaluation of the chosen triangle (detached id).
    trix = jnp.maximum(tri, 0)
    t, u, v, _ = moller_trumbore(
        o, d, soup.v0[trix], soup.v1[trix], soup.v2[trix])
    hitm = tri >= 0
    return Hit(
        t=jnp.where(hitm, t, INF_DIST),
        tri=tri,
        u=jnp.where(hitm, u, 0.0),
        v=jnp.where(hitm, v, 0.0),
    )


def occluded_bvh(bvh: BVH, soup: TriangleSoup, o, d, t_max,
                 chunk: int = 0, sort: bool = False):
    """Any-hit query with early lane termination (binary visibility is
    detached, matching the reference's hard shadows)."""
    sg = jax.lax.stop_gradient
    _, slot, _, _ = _run_traversal(sg(bvh), sg(o), sg(d), sg(t_max),
                                   any_hit=True, chunk=chunk, sort=sort)
    return slot >= 0


def traversal_stats(bvh: BVH, o, d, t_cap=None):
    """Tree-quality metric: per-query counts of (node steps, box tests
    passed, leaf visits) for the closest-hit walk — the observable the
    reference never measures (VERDICT r1: "BVH quality unmeasured").

    Returns dict of python ints (totals over all rays).
    """
    r = o.shape[0]
    n = bvh.n_nodes
    first_leaf = bvh.first_leaf
    if t_cap is None:
        t_cap = jnp.full((r,), INF_DIST)

    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-12,
                            jnp.where(d < 0, -1e-12, 1e-12), d)
    k = bvh.leaf_size

    def cond(state):
        return jnp.any(state[0] < n)

    def body(state):
        node, bt, steps, box_pass, leaf_visits = state
        active = node < n
        ni = jnp.minimum(node, n - 1)
        lo = bvh.lo[ni]
        hi = bvh.hi[ni]
        t0 = (lo - o) * inv_d
        t1 = (hi - o) * inv_d
        tn = jnp.max(jnp.minimum(t0, t1), axis=-1)
        tf = jnp.min(jnp.maximum(t0, t1), axis=-1)
        box_hit = (tf >= jnp.maximum(tn, PZERO)) & (tn < bt) & active

        is_leaf = ni >= first_leaf
        leaf = jnp.maximum(ni - first_leaf, 0)
        slot = leaf[:, None] * k + jnp.arange(k, dtype=jnp.int32)[None, :]
        tt, _, _, ok = moller_trumbore(
            o[:, None, :], d[:, None, :],
            bvh.tv0[slot], bvh.tv1[slot], bvh.tv2[slot])
        ok = ok & (bvh.orig[slot] >= 0) & (is_leaf & box_hit)[:, None]
        tt = jnp.where(ok & (tt < bt[:, None]), tt, INF_DIST)
        bt = jnp.minimum(bt, jnp.min(tt, axis=1))

        steps = steps + jnp.sum(active.astype(jnp.int32))
        box_pass = box_pass + jnp.sum(box_hit.astype(jnp.int32))
        leaf_visits = leaf_visits + jnp.sum(
            (box_hit & is_leaf).astype(jnp.int32))

        nxt = jnp.where(box_hit & ~is_leaf, bvh.left[ni], bvh.skip[ni])
        node = jnp.where(active, nxt, node)
        return node, bt, steps, box_pass, leaf_visits

    init = (jnp.zeros((r,), jnp.int32), t_cap.astype(jnp.float32),
            jnp.int32(0), jnp.int32(0), jnp.int32(0))
    _, _, steps, box_pass, leaf_visits = jax.lax.while_loop(
        cond, body, init)
    return {"steps": int(steps), "box_pass": int(box_pass),
            "leaf_visits": int(leaf_visits)}
