"""Intersection kernels: ray-triangle, ray-AABB, ray-sphere.

Replacements for the reference's GLSL intersection library
(Möller–Trumbore ×1/×2 ``ShadersSDK/include/vertex.glsl:51-189``; slab AABB
tests ``mathlib.glsl:107-193``; sphere ``shadinglib.glsl:32-48``).  All
kernels are shape-polymorphic over leading batch dims, branch-free, and
differentiable.

The brute-force closest-hit intersector streams triangle *blocks* through a
`lax.scan` with a running-best combine — the array-program version of a
wavefront intersection dispatch: fixed memory footprint (R x TB intermediates),
compiler-fused elementwise chains, and a reduction instead of atomics.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from prismarine_core_tpu.models.geometry import TriangleSoup
from prismarine_core_tpu.utils.config import INF_DIST, PZERO

_DET_EPS = 1e-10


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Hit:
    """Closest-hit record (SoA over rays) — the analog of ``HitRework``
    (``structs.glsl:53-69``) minus the linked-list chain: fixed fields only.
    ``tri == -1`` means miss; ``t`` is then INF_DIST."""

    t: jax.Array    # f32[R]
    tri: jax.Array  # i32[R]
    u: jax.Array    # f32[R] barycentric
    v: jax.Array    # f32[R]

    @property
    def missed(self) -> jax.Array:
        return self.tri < 0


def moller_trumbore(o, d, v0, v1, v2, eps: float = PZERO):
    """Double-sided Möller–Trumbore. Broadcasts over leading dims.

    Returns (t, u, v, hit_mask); ``t`` is INF_DIST where invalid.
    Mirrors ``vertex.glsl:51-114`` (which also uses a ray-origin epsilon and
    no backface culling).
    """
    e1 = v1 - v0
    e2 = v2 - v0
    p = jnp.cross(d, e2)
    det = jnp.sum(e1 * p, axis=-1)
    inv = 1.0 / jnp.where(jnp.abs(det) < _DET_EPS, _DET_EPS, det)
    s = o - v0
    u = jnp.sum(s * p, axis=-1) * inv
    q = jnp.cross(s, e1)
    v = jnp.sum(d * q, axis=-1) * inv
    t = jnp.sum(e2 * q, axis=-1) * inv
    ok = (
        (jnp.abs(det) >= _DET_EPS)
        & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t > eps)
    )
    return jnp.where(ok, t, INF_DIST), u, v, ok


def _pad_blocks(soup: TriangleSoup, block: int) -> TriangleSoup:
    cap = soup.capacity
    pad = (-cap) % block
    if pad == 0:
        return soup

    def p(a):
        widths = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
        return jnp.pad(a, widths)

    return jax.tree.map(p, soup)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class _Blk:
    """Per-block scan payload: triangle vertices + validity + base index."""

    v0: jax.Array
    v1: jax.Array
    v2: jax.Array
    valid: jax.Array
    tri_base: jax.Array


@partial(jax.jit, static_argnames=("block",))
def intersect_closest_brute(
    soup: TriangleSoup, o, d, block: int = 512,
) -> Hit:
    """Closest hit over all triangles, streamed in blocks of ``block``.

    o, d: f32[R,3].  The scan keeps the best (t, tri) with deterministic
    tie-breaking (lowest triangle index wins at equal t) so the numpy
    oracle can match bit-for-bit.
    """
    soup = _pad_blocks(soup, block)
    nb = soup.capacity // block

    def reshape(a):
        return a.reshape((nb, block) + a.shape[1:])

    blocks = jax.tree.map(reshape, soup)
    r = o.shape[0]

    def step(carry, blk):
        bt, btri, bu, bv = carry
        t, u, v, ok = moller_trumbore(
            o[:, None, :], d[:, None, :],
            blk.v0[None, :, :], blk.v1[None, :, :], blk.v2[None, :, :])
        t = jnp.where(ok & blk.valid[None, :], t, INF_DIST)
        j = jnp.argmin(t, axis=1)                      # first-min tie-break
        rows = jnp.arange(r)
        tn = t[rows, j]
        trin = blk.tri_base + j.astype(jnp.int32)
        better = (tn < bt) | ((tn == bt) & (trin < btri) & (tn < INF_DIST))
        carry = (
            jnp.where(better, tn, bt),
            jnp.where(better, trin, btri),
            jnp.where(better, u[rows, j], bu),
            jnp.where(better, v[rows, j], bv),
        )
        return carry, None

    xs = _Blk(blocks.v0, blocks.v1, blocks.v2, blocks.valid,
              jnp.arange(nb, dtype=jnp.int32) * block)
    init = (
        jnp.full((r,), INF_DIST, jnp.float32),
        jnp.full((r,), -1, jnp.int32),
        jnp.zeros((r,), jnp.float32),
        jnp.zeros((r,), jnp.float32),
    )
    bt, btri, bu, bv = jax.lax.scan(step, init, xs)[0]
    btri = jnp.where(bt < INF_DIST, btri, -1)
    return Hit(t=bt, tri=btri, u=bu, v=bv)


@partial(jax.jit, static_argnames=("block",))
def occluded_brute(soup: TriangleSoup, o, d, t_max, block: int = 512):
    """Any-hit query: True where some triangle lies in (PZERO, t_max).

    The shadow-ray analog of the reference's type-2 rays dying at any
    surface before the light (``rayshading.comp:121-138``).
    """
    soup = _pad_blocks(soup, block)
    nb = soup.capacity // block

    def reshape(a):
        return a.reshape((nb, block) + a.shape[1:])

    blocks = jax.tree.map(reshape, soup)

    def step(carry, blk):
        t, _, _, ok = moller_trumbore(
            o[:, None, :], d[:, None, :],
            blk.v0[None, :, :], blk.v1[None, :, :], blk.v2[None, :, :])
        any_hit = jnp.any(
            ok & blk.valid[None, :] & (t < t_max[:, None]), axis=1)
        return carry | any_hit, None

    init = jnp.zeros((o.shape[0],), bool)
    return jax.lax.scan(step, init, blocks)[0]


def intersect_aabb(o, inv_d, lo, hi, t_min=PZERO, t_max=INF_DIST):
    """Slab test (broadcasting). Returns (t_near, hit_mask).

    Single-box form of ``intersectCubeSingle`` (``mathlib.glsl:107-140``);
    the traversal streams two children per step for the dual form.
    """
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    tn = jnp.max(jnp.minimum(t0, t1), axis=-1)
    tf = jnp.min(jnp.maximum(t0, t1), axis=-1)
    hit = (tf >= jnp.maximum(tn, t_min)) & (tn <= t_max)
    return jnp.maximum(tn, t_min), hit


def intersect_sphere(o, d, center, radius):
    """Quadratic sphere test matching ``shadinglib.glsl:32-48``:
    returns nearest positive t or INF_DIST."""
    to = o - center
    b = 2.0 * jnp.sum(to * d, axis=-1)
    c = jnp.sum(to * to, axis=-1) - radius * radius
    disc = b * b - 4.0 * c
    # select-before-sqrt: sqrt'(0) = inf, and the final where's zero
    # cotangent times inf would NaN upstream gradients on every lane
    # whose ray misses the sphere (disc <= 0).
    sq = jnp.sqrt(jnp.where(disc > 0.0, disc, 1.0))
    t1 = 0.5 * (-b - sq)
    t2 = 0.5 * (-b + sq)
    mn = jnp.minimum(t1, t2)
    mx = jnp.maximum(t1, t2)
    t = jnp.where(mx >= 0.0, jnp.where(mn >= 0.0, mn, mx), INF_DIST)
    return jnp.where(disc > 0.0, t, INF_DIST)
