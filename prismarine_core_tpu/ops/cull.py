"""Ray-tile culling against block and superblock boxes (plain XLA).

Two passes feed the packet scheduler (accel/packet.py):

* ``box_entry`` — a dense slab test of every ray of every tile against a
  list of boxes, reduced to the per-(tile, box) ENTRY DISTANCE (the min
  over the tile's passing rays; ``INF_DIST`` where none passes).  Run at
  block granularity (``cull_impl="pallas"``) everything the scheduler
  needs derives from it in one pass (``derive_pair_tables``); run at
  superblock granularity (``"pallas2"``/``"xla"``) it yields candidate
  superblocks and their front-to-back lower bounds.  It is a
  broadcast-compare-reduce with no loop-carried state, which XLA's
  reduction fusion runs without writing the [tiles, 128, boxes]
  intermediate.  Tiles at or beyond the live-tile bound ``n_live`` skip
  the work and read ``INF_DIST``.
* ``pair_block_masks`` — the pair-driven refine of the two-level cull:
  per compacted (tile, superblock) pair, the 8-bit mask of the
  superblock's blocks that some ray of the tile passes.

The reference's analog of this scheduling work is the per-ray BVH
descent of ``directTraverse.comp`` (383-464).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from prismarine_core_tpu.ops.pallas_intersect import (
    RAY_COLS, RC_IVX, RC_IVY, RC_IVZ, RC_OX, RC_OY, RC_OZ, RC_TCAP,
    SB as _SB, TILE)
from prismarine_core_tpu.utils.config import INF_DIST


def _slab_entry(r, lo, hi):
    """Slab entry distance of rays ``r`` (ray-matrix columns, any
    leading shape + trailing broadcast axis) against boxes ``lo``/``hi``
    (component-major, broadcast against the rays): max(tn, 0) where the
    ray passes the box within its cap, INF_DIST elsewhere.  The tc > 0
    term keeps dead lanes from listing boxes their origin sits in."""
    def rc(c):
        return r[..., c][..., None]

    tc = rc(RC_TCAP)
    t0x = (lo[0] - rc(RC_OX)) * rc(RC_IVX)
    t1x = (hi[0] - rc(RC_OX)) * rc(RC_IVX)
    t0y = (lo[1] - rc(RC_OY)) * rc(RC_IVY)
    t1y = (hi[1] - rc(RC_OY)) * rc(RC_IVY)
    t0z = (lo[2] - rc(RC_OZ)) * rc(RC_IVZ)
    t1z = (hi[2] - rc(RC_OZ)) * rc(RC_IVZ)
    tn = jnp.maximum(jnp.maximum(jnp.minimum(t0x, t1x),
                                 jnp.minimum(t0y, t1y)),
                     jnp.minimum(t0z, t1z))
    tf = jnp.minimum(jnp.minimum(jnp.maximum(t0x, t1x),
                                 jnp.maximum(t0y, t1y)),
                     jnp.maximum(t0z, t1z))
    tn0 = jnp.maximum(tn, 0.0)
    hit = (tf >= tn0) & (tn <= tc) & (tc > 0.0)
    return jnp.where(hit, tn0, INF_DIST)


@partial(jax.jit, static_argnames=("chunk",))
def box_entry(rays, box_lo, box_hi, n_live, chunk: int = 512):
    """f32[nt, nbx] per-(tile, box) entry distance, INF_DIST where no
    ray of the tile passes the box's slab test under its cap.

    rays f32[(nt+1)*TILE, RAY_COLS] (the trailing sentinel tile is not
    reported); box_lo/box_hi f32[nbx, 3]; ``n_live`` i32[] bounds the
    work: tiles >= n_live read INF_DIST without testing.  Tiles run in
    chunks of ``chunk`` in a while_loop whose trip count follows
    n_live; 512 was the fastest of 32/128/512 on an H100 at the bench's
    1280x720 hall (PERF.md)."""
    nt = rays.shape[0] // TILE - 1
    nbx = box_lo.shape[0]
    c = max(1, min(chunk, nt))
    n_chunks = -(-nt // c)
    body = rays[:nt * TILE]
    pad = (n_chunks * c - nt) * TILE
    if pad:
        body = jnp.concatenate([body, jnp.zeros((pad, RAY_COLS),
                                                jnp.float32)])
    lo = box_lo.T[:, None, :]                       # [3, 1, nbx]
    hi = box_hi.T[:, None, :]
    n_live = jnp.asarray(n_live, jnp.int32)

    def step(state):
        i, out = state
        r = jax.lax.dynamic_slice(body, (i * c * TILE, 0),
                                  (c * TILE, RAY_COLS))
        tn = _slab_entry(r, lo, hi).reshape(c, TILE, nbx).min(axis=1)
        tile = i * c + jnp.arange(c, dtype=jnp.int32)[:, None]
        tn = jnp.where(tile < n_live, tn, INF_DIST)
        return i + 1, jax.lax.dynamic_update_slice(out, tn, (i * c, 0))

    n_iter = jnp.minimum((n_live + c - 1) // c, n_chunks)
    out0 = jnp.full((n_chunks * c, nbx), INF_DIST, jnp.float32)
    _, out = jax.lax.while_loop(lambda s: s[0] < n_iter, step,
                                (jnp.int32(0), out0))
    return out[:nt]


@partial(jax.jit, static_argnames=("window",))
def pair_block_masks(rays, pair_tile, pair_sb, n_pairs, block_lo,
                     block_hi, window: int = 32768):
    """i32[L] per-pair 8-bit block masks: bit k set iff some ray of the
    pair's tile passes block ``sb*SB + k`` under its cap (0 past
    ``n_pairs``).

    rays f32[(nt+1)*TILE, RAY_COLS] (caps may be tightened per ray);
    block_lo/block_hi f32[nsb*SB, 3].  Windows of ``window`` pairs in a
    while_loop, so the cost follows the survivor count; 32768 was the
    fastest of 2048/8192/32768 on an H100 at the bench's hall
    (PERF.md)."""
    nt = rays.shape[0] // TILE - 1
    nsb = block_lo.shape[0] // _SB
    sblk_lo = block_lo.reshape(nsb, _SB, 3)
    sblk_hi = block_hi.reshape(nsb, _SB, 3)
    lw = pair_tile.shape[0]
    window = min(window, lw)
    wpad = (-lw) % window
    if wpad:
        pair_tile = jnp.concatenate(
            [pair_tile, jnp.full((wpad,), nt, jnp.int32)])
        pair_sb = jnp.concatenate(
            [pair_sb, jnp.full((wpad,), nsb, jnp.int32)])
    rays_t = rays.reshape(nt + 1, TILE, RAY_COLS)
    bits = (1 << jnp.arange(_SB, dtype=jnp.int32))[None, :]

    def body(state):
        start, masks = state
        pt = jax.lax.dynamic_slice(pair_tile, (start,), (window,))
        psb = jax.lax.dynamic_slice(pair_sb, (start,), (window,))
        live = (start + jnp.arange(window, dtype=jnp.int32)) < n_pairs
        pt = jnp.where(live, pt, nt)
        psb = jnp.minimum(psb, nsb - 1)
        lo = jnp.moveaxis(sblk_lo[psb], -1, 0)[:, :, None, :]
        hi = jnp.moveaxis(sblk_hi[psb], -1, 0)[:, :, None, :]
        tn = _slab_entry(rays_t[pt], lo, hi)          # [W, TILE, SB]
        bm = jnp.any(tn < INF_DIST, axis=1) & live[:, None]
        mw = jnp.sum(jnp.where(bm, bits, 0), axis=1)  # [W] i32
        return start + window, jax.lax.dynamic_update_slice(
            masks, mw.astype(jnp.int32), (start,))

    masks0 = jnp.zeros((pair_tile.shape[0],), jnp.int32)
    _, masks = jax.lax.while_loop(lambda s: s[0] < n_pairs, body,
                                  (jnp.int32(0), masks0))
    return masks[:lw]


def derive_pair_tables(tn_blk, nsb, sb: int):
    """[nt, nsb*sb] block entry distances -> (sb_mask, sb_tn, mask8).

    sb_mask bool[nt, nsb]: tile lists superblock (any block hit);
    sb_tn   f32[nt, nsb]: min block entry (front-to-back lower bound);
    mask8   i32[nt, nsb]: per-pair block bitmask (bit k = block sb*SB+k).
    """
    blk = tn_blk[:, :nsb * sb].reshape(tn_blk.shape[0], nsb, sb)
    hit = blk < INF_DIST
    bits = (1 << jnp.arange(sb, dtype=jnp.int32))[None, None, :]
    mask8 = jnp.sum(jnp.where(hit, bits, 0), axis=-1).astype(jnp.int32)
    return mask8 != 0, blk.min(axis=-1), mask8
