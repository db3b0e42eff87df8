"""Packet (tile x superblock) intersector — the production fast path.

The skip-link walk (accel/traverse.py) steps every lane of a query
through the tree in lockstep, one data-dependent gather per step, until
the slowest ray finishes.  This module replaces pointer-chasing with
dense work over coherent ray packets:

1. rays sort by (direction octant, origin Morton, direction Morton) and
   group into TILES of 128 contiguous rays (the analog of the reference's
   optional ray sorting, ``Pipeline.hpp:101``, taken to its logical end);
   the ray matrix is built unsorted and permuted with ONE 64-byte-row
   gather (``_sorted_rays_matrix``);
2. triangles are already Morton-sorted by the BVH build; consecutive runs
   of 128 slots form BLOCKS and runs of SB=8 blocks form SUPERBLOCKS with
   precomputed AABBs (two coarse levels of the same implicit tree);
3. a dense slab cull of every tile's rays against block or superblock
   boxes (ops/cull.py) yields candidate superblocks, front-to-back entry
   bounds and per-pair 8-bit block masks;
4. surviving (tile, superblock) pairs compact tile-major via ONE
   windowed packed scatter bounded by the live-tile prefix (masks ride
   along as code bits) and execute FRONT-TO-BACK under one of two
   strategies (``_run_packet_pallas``): "two_round" for closest-hit (K
   nearest superblocks per tile, then one per-ray re-cull of the rest
   against the tightened caps) and "rounds" for any-hit (fully ordered
   K-at-a-time rounds with exact cap-based exit);
5. the Pallas kernel (ops/pallas_intersect.py) runs each tile's pairs
   with the tile's rays and running closest hits in registers, then the
   result unsorts.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from prismarine_core_tpu.accel.lbvh import BVH, EMPTY_BOX
from prismarine_core_tpu.models.geometry import TriangleSoup
from prismarine_core_tpu.ops.cull import (
    box_entry, derive_pair_tables, pair_block_masks)
from prismarine_core_tpu.ops.intersect import Hit, moller_trumbore
from prismarine_core_tpu.ops.pallas_intersect import (
    BLOCK, RAY_COLS, RC_DX, RC_IVX, RC_OX, RC_OZ, RC_TCAP, SB, TILE,
    pallas_execute_pairs)
from prismarine_core_tpu.utils.config import INF_DIST


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PacketSet:
    """Block/superblock-level view over the BVH's Morton-sorted triangle
    slots.

    ``planes`` holds SoA component planes of the sorted triangles
    (positions + precomputed edges) in superblock-contiguous layout —
    the rows the pair kernel reads (ops/pallas_intersect.py).  The block count pads to a multiple of
    SB; padding blocks carry far-point AABBs (never pass a slab test)
    and invalid planes."""

    block_lo: jax.Array  # f32[B,3]
    block_hi: jax.Array  # f32[B,3]
    sb_lo: jax.Array     # f32[B/SB,3] superblock AABB min
    sb_hi: jax.Array     # f32[B/SB,3]
    #: f32[B/SB + 1, 16, SB*BLOCK] component rows: v0xyz, e1xyz, e2xyz,
    #: valid, pad; sub-block k on lanes [128k, 128k+128).  The trailing
    #: superblock is all-zero (the pair-padding sentinel: valid=0).
    planes: jax.Array
    slot_orig: jax.Array  # i32[B*BLOCK] slot -> original triangle id

    @property
    def n_blocks(self) -> int:
        return self.block_lo.shape[0]

    @property
    def n_superblocks(self) -> int:
        return self.sb_lo.shape[0]


def build_packet_set(bvh: BVH) -> PacketSet:
    """Block/superblock AABBs + SoA triangle planes (build-time, fully
    jittable)."""
    s = bvh.tv0.shape[0]
    bk = BLOCK
    assert s % bk == 0, "slot count must be a multiple of BLOCK (lbvh pads)"
    nb = -(-(s // bk) // SB) * SB   # pad block count to superblock size
    nsb = nb // SB
    pad = nb * bk - s
    big = jnp.float32(EMPTY_BOX)

    def padded(a, fill=0.0):
        if pad:
            widths = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
            return jnp.pad(a, widths, constant_values=fill)
        return a

    tv0 = padded(bvh.tv0)
    tv1 = padded(bvh.tv1)
    tv2 = padded(bvh.tv2)
    orig = padded(bvh.orig, -1)

    valid = (orig >= 0)[:, None]
    slo = jnp.where(valid, jnp.minimum(jnp.minimum(tv0, tv1), tv2), big)
    shi = jnp.where(valid, jnp.maximum(jnp.maximum(tv0, tv1), tv2), -big)
    block_lo = slo.reshape(nb, bk, 3).min(axis=1)
    block_hi = shi.reshape(nb, bk, 3).max(axis=1)
    # empty blocks -> far point box (always misses the overlap test)
    empty = (block_lo > block_hi).any(-1, keepdims=True)
    block_lo = jnp.where(empty, big, block_lo)
    block_hi = jnp.where(empty, big, block_hi)

    # superblock AABBs (union of SB consecutive blocks; far point boxes
    # stay far, so fully-empty superblocks remain point boxes)
    sb_lo = block_lo.reshape(nsb, SB, 3).min(axis=1)
    sb_hi = block_hi.reshape(nsb, SB, 3).max(axis=1)

    e1 = tv1 - tv0
    e2 = tv2 - tv0
    rows = [tv0[:, 0], tv0[:, 1], tv0[:, 2],
            e1[:, 0], e1[:, 1], e1[:, 2],
            e2[:, 0], e2[:, 1], e2[:, 2],
            (orig >= 0).astype(jnp.float32)]
    rows += [jnp.zeros_like(rows[0])] * (16 - len(rows))
    planes = jnp.stack([x.reshape(nb, bk) for x in rows], axis=1)
    # superblock-contiguous layout + trailing zero sentinel superblock
    planes = planes.reshape(nsb, SB, 16, bk).transpose(0, 2, 1, 3)
    planes = planes.reshape(nsb, 16, SB * bk)
    planes = jnp.concatenate(
        [planes, jnp.zeros((1, 16, SB * bk), jnp.float32)])

    return PacketSet(block_lo=block_lo, block_hi=block_hi,
                     sb_lo=sb_lo, sb_hi=sb_hi,
                     planes=planes, slot_orig=orig)


def _safe_inv(d):
    return 1.0 / jnp.where(jnp.abs(d) < 1e-12,
                           jnp.where(d < 0, -1e-12, 1e-12), d)


def _interval_overlap(o_lo, o_hi, inv_lo, inv_hi, blk_lo, blk_hi, t_hi):
    """Conservative tile-frustum vs block-AABB test.

    All tile quantities are [T,1,3] intervals, blocks [1,B,3]; returns
    [T,B] bool that is True whenever ANY ray in the tile could hit.
    Interval slab test: entry/exit times bound by interval products.
    """
    # candidate products of interval endpoints (4 per axis per face)
    def prods(a_lo, a_hi):
        p1 = a_lo * inv_lo
        p2 = a_lo * inv_hi
        p3 = a_hi * inv_lo
        p4 = a_hi * inv_hi
        return (jnp.minimum(jnp.minimum(p1, p2), jnp.minimum(p3, p4)),
                jnp.maximum(jnp.maximum(p1, p2), jnp.maximum(p3, p4)))

    # slab k entered between (blk_lo - o) and (blk_hi - o) times inv_d
    a_lo = blk_lo - o_hi          # min of (blk_lo - o)
    a_hi = blk_lo - o_lo
    b_lo = blk_hi - o_hi
    b_hi = blk_hi - o_lo
    lo1, hi1 = prods(a_lo, a_hi)
    lo2, hi2 = prods(b_lo, b_hi)
    t0_lo = jnp.minimum(lo1, lo2)     # earliest any ray can enter slab
    t1_hi = jnp.maximum(hi1, hi2)     # latest any ray can leave slab
    tn = jnp.max(t0_lo, axis=-1)      # over xyz
    tf = jnp.min(t1_hi, axis=-1)
    return (tf >= jnp.maximum(tn, 0.0)) & (tn <= t_hi)


def _live_tile_bound(tct):
    """i32[]: 1 + index of the LAST tile holding any live lane.

    Dead lanes sort last (``_ray_sort_keys``), so for freshly-sorted
    queries this is the live-tile prefix length; for order-reusing
    shadow queries it is a correct (if looser) bound.  Cull and
    compaction cost scale with it instead of with nt."""
    live_t = (tct > 0.0).any(axis=1)
    idx = jnp.arange(live_t.shape[0], dtype=jnp.int32)
    return jnp.max(jnp.where(live_t, idx + 1, 0))


def _compact_codes(flat, codes, bound, sentinel, window: int = 1 << 18):
    """Windowed cumsum+scatter compaction of ``codes[flat]`` bounded by
    the live prefix.

    ``flat`` bool[lw] selects entries; positions >= ``bound`` must all
    be False (dead-tile suffix).  The while_loop trip count is
    ceil(bound / window), so late-bounce queries (mostly-dead tiles)
    pay a fraction of the full scatter.  Returns (packed i32[lw],
    n_set)."""
    lw = flat.shape[0]
    window = min(window, lw)
    wpad = (-lw) % window
    fi = flat.astype(jnp.int32)
    if wpad:
        fi = jnp.concatenate([fi, jnp.zeros((wpad,), jnp.int32)])
        codes = jnp.concatenate(
            [codes, jnp.full((wpad,), sentinel, jnp.int32)])
    out0 = jnp.full((lw + 1,), sentinel, jnp.int32)

    def cond(state):
        start, _, _ = state
        return start < bound

    def body(state):
        start, total, out = state
        f = jax.lax.dynamic_slice(fi, (start,), (window,))
        c = jax.lax.dynamic_slice(codes, (start,), (window,))
        pos = total + jnp.cumsum(f) - f
        # unselected entries all land on the last slot (sliced off
        # below); the duplicate writes there are benign
        target = jnp.where(f > 0, pos, lw)
        out = out.at[target].set(c, mode="drop", unique_indices=True)
        return start + window, total + jnp.sum(f), out

    _, n_set, out = jax.lax.while_loop(
        cond, body, (jnp.int32(0), jnp.int32(0), out0))
    return out[:lw], n_set


def _compact_rows_masked(mask2d, sb2d, pm2d, nt, nsb, bound):
    """Generic masked row compaction: [nt, K] selection mask +
    superblock ids + 8-bit masks -> packed tile-major pair list via ONE
    windowed scatter (two when the id+mask packing exceeds 31 bits).
    ``pm2d=None`` skips the mask bits entirely and returns ``pm=None``
    (the two-level cull derives masks after compaction,
    ops/cull.py:pair_block_masks)."""
    rows, k = mask2d.shape
    lw = nt * k
    tb = max(nt, 1).bit_length()
    sbb = max(nsb, 1).bit_length()
    tile_of = jnp.arange(lw, dtype=jnp.int32) // k
    flat = mask2d.reshape(-1)
    sb_of = jnp.minimum(sb2d.reshape(-1), nsb)
    with_mask = pm2d is not None and tb + sbb + 8 <= 31
    assert with_mask or pm2d is None or tb + sbb <= 31, \
        "scene/ray count exceeds pair-packing range"
    shift = (sbb + 8) if with_mask else sbb
    if with_mask:
        codes = ((tile_of << shift) | (sb_of << 8)
                 | (pm2d.reshape(-1) & 0xFF))
    else:
        codes = (tile_of << shift) | sb_of
    sentinel = (nt << shift) | (nsb << 8 if with_mask else nsb)
    packed, n_pairs = _compact_codes(flat, codes, bound, sentinel)

    pt = packed >> shift
    psb = (packed >> 8 if with_mask else packed) & ((1 << sbb) - 1)
    if with_mask:
        return pt, psb, packed & 0xFF, n_pairs
    if pm2d is None:
        return pt, psb, None, n_pairs
    pm, _ = _compact_codes(flat, pm2d.reshape(-1), bound, 0)
    return pt, psb, pm, n_pairs


def _compact_pairs_masked(sb_mask, mask8, bound_rows):
    """[nt, nsb] candidate mask + per-pair 8-bit block masks (or None)
    -> packed tile-major pair list; masks ride along as code bits, so
    there is no separate mask stage and no gather."""
    nt, nsb = sb_mask.shape
    sb2d = jnp.broadcast_to(jnp.arange(nsb, dtype=jnp.int32),
                            (nt, nsb))
    bound = jnp.minimum(bound_rows * nsb, nt * nsb)
    return _compact_rows_masked(sb_mask, sb2d, mask8, nt, nsb, bound)


def _compact_topk_masked(cand, cand_ok, pmask, nt, nsb):
    """[nt, K] per-tile candidates + validity + per-candidate 8-bit
    masks (or None) -> packed tile-major pair list."""
    return _compact_rows_masked(cand_ok, cand, pmask, nt, nsb,
                                nt * cand.shape[1])


def _tables_with_cap(tn_blk, cap_tile, nsb):
    """Re-derive (sb_mask, mask8) from saved block entry distances under
    TIGHTENED per-tile caps — the cheap two_round re-cull: blocks whose
    round-1 entry distance exceeds the tile's worst surviving cap can
    no longer contain a better hit.  Tile-granular (the kernel re-cull
    is per-ray exact); strictly conservative, so results are
    unchanged."""
    nt = tn_blk.shape[0]
    cap = cap_tile[:, None, None]
    blk = tn_blk[:, :nsb * SB].reshape(nt, nsb, SB)
    ok = (blk <= cap) & (cap > 0.0)
    bits = (1 << jnp.arange(SB, dtype=jnp.int32))[None, None, :]
    mask8 = jnp.sum(jnp.where(ok, bits, 0), axis=-1)
    return mask8 != 0, mask8


def _ray_sort_keys(root_lo, root_hi, o, d, t_cap=None):
    """Coherence key: dead(1b) ++ octant(3b) ++ origin-Morton(15b) ++
    direction-Morton(12b).

    Bounce rays share origins but scatter in direction; without the
    direction bits a tile's direction cone covers a whole octant and its
    overlap list approaches *every* superblock.  Binning by |d| within
    the octant (4 bits/axis) tightens tile cones to ~20 degrees,
    collapsing the pair count for incoherent queries.  Dead lanes
    (t_cap == 0) sort LAST: they concentrate into all-dead trailing
    tiles whose cull rows are empty, so late bounces (~50% dead) stop
    diluting live tiles' boxes and pair lists shrink with liveness.
    """
    from prismarine_core_tpu.ops.morton import morton30
    unit = jnp.clip((o - root_lo)
                    / jnp.maximum(root_hi - root_lo, 1e-6), 0.0, 1.0)
    om = morton30((unit * 31.0).astype(jnp.uint32))        # 15 bits
    dm = morton30((jnp.abs(d) * 15.0).astype(jnp.uint32))  # 12 bits
    octant = ((d[:, 0] >= 0).astype(jnp.uint32)
              | ((d[:, 1] >= 0).astype(jnp.uint32) << 1)
              | ((d[:, 2] >= 0).astype(jnp.uint32) << 2))
    keys = (octant << 27) | (om << 12) | (dm & 0xFFF)
    if t_cap is not None:
        keys = keys | ((t_cap <= 0.0).astype(jnp.uint32) << 31)
    return keys


def _packet_core(bvh: BVH, ps: PacketSet, o, d, t_cap, any_hit: bool):
    """Sorted-ray packet query. o/d/t_cap padded to a multiple of TILE.

    The pure-XLA packet path: conservative tile-frustum cull at block
    granularity, then a while_loop over each tile's m-th candidate block
    with dense [TILE, BLOCK] Möller–Trumbore.
    """
    r = o.shape[0]
    nt = r // TILE
    nb = ps.n_blocks
    s = bvh.tv0.shape[0]
    bk = min(BLOCK, s)

    ot = o.reshape(nt, TILE, 3)
    dt = d.reshape(nt, TILE, 3)
    tct = t_cap.reshape(nt, TILE)

    # tile intervals
    o_lo = ot.min(axis=1)[:, None, :]
    o_hi = ot.max(axis=1)[:, None, :]
    inv = _safe_inv(dt)
    inv_lo = inv.min(axis=1)[:, None, :]
    inv_hi = inv.max(axis=1)[:, None, :]
    t_hi = tct.max(axis=1)[:, None]

    overlap = _interval_overlap(
        o_lo, o_hi, inv_lo, inv_hi,
        ps.block_lo[None, :, :], ps.block_hi[None, :, :], t_hi)  # [T,B]

    counts = overlap.sum(axis=1).astype(jnp.int32)               # [T]
    # per-tile list of overlapping block ids, hits first (stable sort on
    # ~overlap keeps ascending block order within each class)
    keys = (~overlap).astype(jnp.int32)
    blk_ids = jnp.broadcast_to(jnp.arange(nb, dtype=jnp.int32),
                               (nt, nb))
    _, blk_list = jax.lax.sort((keys, blk_ids), dimension=1, num_keys=1,
                               is_stable=True)                   # [T,B]
    max_m = jnp.max(counts)

    tv0, tv1, tv2 = bvh.tv0, bvh.tv1, bvh.tv2
    orig = bvh.orig

    def get_block(base, arr, width):
        return jax.lax.dynamic_slice(arr, (base, 0), (bk, width))

    def cond(state):
        m = state[0]
        done_all = state[5]
        return (m < max_m) & ~done_all

    def body(state):
        m, bt, bslot, bu, bv, _ = state
        blk = blk_list[:, m]                                     # [T]
        live = m < counts                                        # [T]
        base = jnp.where(live, blk, 0) * bk
        base = jnp.minimum(base, s - bk)  # padding blocks clamp into s

        b0 = jax.vmap(lambda b: get_block(b, tv0, 3))(base)      # [T,bk,3]
        b1 = jax.vmap(lambda b: get_block(b, tv1, 3))(base)
        b2 = jax.vmap(lambda b: get_block(b, tv2, 3))(base)
        bo = jax.vmap(lambda b: jax.lax.dynamic_slice(orig, (b,), (bk,))
                      )(base)                                    # [T,bk]

        tt, tu, tv_, ok = moller_trumbore(
            ot[:, :, None, :], dt[:, :, None, :],
            b0[:, None, :, :], b1[:, None, :, :], b2[:, None, :, :])
        ok = ok & (bo[:, None, :] >= 0) & live[:, None, None]
        tt = jnp.where(ok & (tt < bt[:, :, None]), tt, INF_DIST)
        j = jnp.argmin(tt, axis=2)                               # [T,TILE]
        tj = jnp.take_along_axis(tt, j[:, :, None], axis=2)[:, :, 0]
        better = tj < bt
        slot_j = base[:, None] + j
        bt = jnp.where(better, tj, bt)
        bslot = jnp.where(better, slot_j, bslot)
        bu = jnp.where(
            better,
            jnp.take_along_axis(tu, j[:, :, None], axis=2)[:, :, 0], bu)
        bv = jnp.where(
            better,
            jnp.take_along_axis(tv_, j[:, :, None], axis=2)[:, :, 0], bv)
        done_all = jnp.array(False)
        if any_hit:
            done_all = jnp.all(bslot >= 0)  # every lane shadowed already
        return (m + 1, bt, bslot, bu, bv, done_all)

    init = (
        jnp.int32(0),
        tct.astype(jnp.float32),
        jnp.full((nt, TILE), -1, jnp.int32),
        jnp.zeros((nt, TILE), jnp.float32),
        jnp.zeros((nt, TILE), jnp.float32),
        jnp.array(False),
    )
    _, bt, bslot, bu, bv, _ = jax.lax.while_loop(cond, body, init)
    return (bt.reshape(r), bslot.reshape(r), bu.reshape(r),
            bv.reshape(r))


def _sort_pad_rays(root_lo, root_hi, o, d, t_cap, order=None,
                   mode: str = "full"):
    """Coherence-sort rays and pad to a TILE multiple.

    ``order`` (perm, inv_perm) reuses a previous query's sort — shadow
    rays originate at the closest-hit points, so the bounce query's
    origin-coherent order transfers to them and the (expensive) u32
    lax.sort is paid once per bounce, not once per query.

    ``mode`` trades sort cost against tile tightness:

    * ``"full"``   — 2-array (key, iota) sort on the full 31-bit key.
    * ``"packed"`` — ONE-array u32 sort: the top ``32 - ceil_log2(R)``
      key bits become the bin, the low bits carry the ray index, so the
      permutation falls out of the sorted word itself.  Within a bin,
      rays keep image order (scanline-adjacent pixels stay adjacent).
    * ``"group"``  — sort GROUPS of 16 consecutive rays by their
      live-lane centroid key (16x fewer elements, full key width).
      Exact for any estimator; tightest when neighboring rays are
      already correlated (camera rays, coherent bounce sampling).

    Returns (o, d, t_cap, (perm, inv_perm), n_orig)."""
    r = o.shape[0]
    if order is None:
        order = _coherence_perm(root_lo, root_hi, o, d, t_cap, mode)
    perm, inv_perm = order
    o, d, t_cap = o[perm], d[perm], t_cap[perm]

    pad = (-r) % TILE
    if pad:
        o = jnp.concatenate([o, jnp.tile(jnp.asarray([[0.0, 0.0, 1e8]]),
                                         (pad, 1))])
        d = jnp.concatenate([d, jnp.tile(jnp.asarray([[1.0, 0.0, 0.0]]),
                                         (pad, 1))])
        t_cap = jnp.concatenate([t_cap, jnp.zeros((pad,))])
    return o, d, t_cap, (perm, inv_perm), r


def _coherence_perm(root_lo, root_hi, o, d, t_cap, mode: str = "full"):
    """(perm, inv_perm) of the coherence sort — key logic of
    _sort_pad_rays without any data gathers (callers that build the
    kernel ray matrix apply the permutation as ONE row gather)."""
    r = o.shape[0]
    if True:   # noqa: indentation kept shallow for the mode ladder
        iota = jnp.arange(r, dtype=jnp.int32)
        if mode == "group" and r % 16 == 0 and r >= 2048:
            g = 16
            ng = r // g
            live = (t_cap.reshape(ng, g) > 0.0)
            cnt = live.sum(axis=1)
            w = live[:, :, None].astype(jnp.float32)
            denom = jnp.maximum(cnt, 1).astype(jnp.float32)[:, None]
            oc = (o.reshape(ng, g, 3) * w).sum(axis=1) / denom
            dc = (d.reshape(ng, g, 3) * w).sum(axis=1) / denom
            keys_g = _ray_sort_keys(
                root_lo, root_hi, oc, dc,
                t_cap=jnp.where(cnt > 0, 1.0, 0.0))
            iota_g = jnp.arange(ng, dtype=jnp.int32)
            _, perm_g = jax.lax.sort((keys_g, iota_g), num_keys=1)
            perm = (perm_g[:, None] * g
                    + jnp.arange(g, dtype=jnp.int32)[None, :]).reshape(-1)
            inv_g = jnp.zeros((ng,), jnp.int32).at[perm_g].set(iota_g)
            inv_perm = inv_g[iota // g] * g + (iota % g)
        elif mode == "packed":
            keys = _ray_sort_keys(root_lo, root_hi, o, d, t_cap)
            idx_bits = max(1, (r - 1).bit_length())
            packed = ((keys >> jnp.uint32(idx_bits)) << jnp.uint32(idx_bits)
                      ) | iota.astype(jnp.uint32)
            packed = jax.lax.sort(packed)
            perm = (packed
                    & jnp.uint32((1 << idx_bits) - 1)).astype(jnp.int32)
            inv_perm = jnp.zeros((r,), jnp.int32).at[perm].set(iota)
        else:
            keys = _ray_sort_keys(root_lo, root_hi, o, d, t_cap)
            _, perm = jax.lax.sort((keys, iota), num_keys=1)
            inv_perm = jnp.zeros((r,), jnp.int32).at[perm].set(iota)
    return perm, inv_perm


def _sorted_rays_matrix(root_lo, root_hi, o, d, t_cap, order=None,
                        mode: str = "full"):
    """Kernel ray matrix f32[(nt+1)*TILE, RAY_COLS] in coherence order
    with ONE row gather.

    The unsorted matrix is built first and whole 64-byte rows are
    permuted once (instead of three 12-byte-row gathers of o/d/t_cap).
    Trailing rows: dead-ray padding to a TILE multiple + the all-zero
    sentinel tile.  Returns (rays, (perm, inv_perm), n_orig).

    ``order="identity"`` skips the sort AND the row gather entirely
    (cfg.primary_identity: camera rays in scanline order are already
    tile-coherent) and is returned as-is so shadow-query reuse stays
    gather-free too."""
    r = o.shape[0]
    identity = isinstance(order, str) and order == "identity"
    if order is None:
        order = _coherence_perm(root_lo, root_hi, o, d, t_cap, mode)

    cols = jnp.zeros((r, RAY_COLS), jnp.float32)
    cols = cols.at[:, RC_OX:RC_OX + 3].set(o)
    cols = cols.at[:, RC_DX:RC_DX + 3].set(d)
    cols = cols.at[:, RC_TCAP].set(t_cap)
    cols = cols.at[:, RC_IVX:RC_IVX + 3].set(_safe_inv(d))
    rays = cols if identity else cols[order[0]]   # the one row gather

    pad = (-r) % TILE
    if pad:
        dead = jnp.zeros((pad, RAY_COLS), jnp.float32)
        dead = dead.at[:, RC_OZ].set(1e8)   # o = (0, 0, 1e8)
        dead = dead.at[:, RC_DX].set(1.0)   # d = (1, 0, 0)
        dead = dead.at[:, RC_IVX:RC_IVX + 3].set(
            _safe_inv(jnp.asarray([[1.0, 0.0, 0.0]])))
        rays = jnp.concatenate([rays, dead])
    rays = jnp.concatenate(
        [rays, jnp.zeros((TILE, RAY_COLS), jnp.float32)])
    return rays, order, r


#: per-round budget of the front-to-back query: each round executes
#: each tile's next K_FIRST nearest remaining superblocks (by tile-min
#: box entry distance).  Morton-adjacent blocks make "nearest
#: superblock contains the hit" unreliable for K=1 (~1-2% wrong hits
#: when round 2 was skipped) but K=8 captures the true hit for the
#: large majority of rays in the first round, so later rounds retire
#: almost everything against the tightened per-ray caps.
K_FIRST = 8


def _run_packet_pallas(root_lo, root_hi, ps: PacketSet, o, d, t_cap,
                       any_hit: bool = False,
                       order=None, two_round: bool = True,
                       k_round: int | None = None,
                       strategy: str | None = None,
                       cull_impl: str = "pallas",
                       sort_mode: str = "full",
                       recull: str = "sb",
                       stale_round_masks: bool = False,
                       near_frac: float = 0.0,
                       with_counters: bool = False):
    """Packet fast path: sort+tile rays, cull, front-to-back pair
    execution through the Pallas kernel, unsort.  Returns (t, slot,
    order).

    Three execution strategies:

    * ``"single"``  — one dense compaction, every pair executes.
    * ``"two_round"`` — K nearest superblocks per tile (top_k on the
      cull's entry distances) first, then ONE re-cull of the rest
      against the tightened caps (default for closest-hit queries).
    * ``"rounds"``  — full per-tile front-to-back ordering (one
      row-wise ``lax.sort``), then K-at-a-time rounds in a
      ``while_loop``; each round re-reads per-ray caps, and the loop
      exits as soon as no tile's nearest remaining candidate can beat
      its cap (exact: candidates are tn-ascending).  Default for
      ANY-HIT queries: finished lanes zero their caps, so whole rounds
      evaporate.

    ``cull_impl``: "pallas" culls densely at BLOCK granularity
    (ops/cull.py:box_entry) and derives superblock candidates, entry
    distances AND the per-pair 8-bit block masks from that one pass;
    "pallas2" and "xla" (the same two-level cull) cull densely at
    SUPERBLOCK granularity and refine the compacted pairs to block
    masks (ops/cull.py:pair_block_masks).  ``recull``: how two_round
    prunes round 2 under one-level culling — "sb" re-culls per ray at
    superblock granularity and keeps the round-1 block masks, "kernel"
    re-runs the block cull with per-ray tightened caps, "tn" filters
    the saved block entry distances by per-tile caps.
    ``stale_round_masks``: the "rounds" strategy normally re-derives
    per-ray block masks each round against the tightened caps; True
    keeps round-0 masks (cheaper for coherent queries that finish in a
    round or two).  ``sort_mode``: see _sort_pad_rays.
    ``with_counters``: additionally return a dict of work counters —
    executed pairs and live [128x128] Möller–Trumbore sub-blocks
    (popcount of the executed masks).  All variants return identical
    hits: they schedule the same exact tests.
    """
    rays, order, r = _sorted_rays_matrix(root_lo, root_hi, o, d, t_cap,
                                         order, mode=sort_mode)
    nt = rays.shape[0] // TILE - 1
    nsb = ps.n_superblocks
    tct = rays[:nt * TILE, RC_TCAP].reshape(nt, TILE)

    k_first = K_FIRST if k_round is None else k_round
    if strategy is None:
        strategy = "rounds" if any_hit else "two_round"
    if not two_round or nsb <= k_first:
        strategy = "single"
    assert cull_impl in ("pallas", "pallas2", "xla"), cull_impl
    two_level = cull_impl != "pallas"
    n_live = _live_tile_bound(tct)

    # ---- dense cull: candidate superblocks + entry distances (+ block
    # masks on the one-level path)
    tn_blk = None
    if two_level:
        sb_tn = box_entry(rays, ps.sb_lo, ps.sb_hi, n_live)
        sb_mask = sb_tn < INF_DIST
        mask8 = None
    else:
        tn_blk = box_entry(rays, ps.block_lo, ps.block_hi, n_live)
        sb_mask, sb_tn, mask8 = derive_pair_tables(tn_blk, nsb, SB)

    def rays_with_caps(tct_eff):
        return rays.at[:nt * TILE, RC_TCAP].set(tct_eff.reshape(-1))

    def refine(pt, psb, np_, rays_eff):
        return pair_block_masks(rays if rays_eff is None else rays_eff,
                                pt, psb, np_, ps.block_lo, ps.block_hi)

    def compact_dense(mask, m8, bound, rays_eff=None):
        """[nt, nsb] candidate mask -> (pt, psb, pm, n_pairs)."""
        pt, psb, pm, np_ = _compact_pairs_masked(mask, m8, bound)
        if pm is None:
            pm = refine(pt, psb, np_, rays_eff)
        return pt, psb, pm, np_

    def compact_topk(cand, ok, m8, rays_eff=None):
        """[nt, K] candidates -> (pt, psb, pm, n_pairs)."""
        pmk = None
        if m8 is not None:
            pmk = jnp.where(ok, jnp.take_along_axis(
                m8, jnp.minimum(cand, nsb - 1), axis=1), 0)
        pt, psb, pm, np_ = _compact_topk_masked(cand, ok, pmk, nt, nsb)
        if pm is None:
            pm = refine(pt, psb, np_, rays_eff)
        return pt, psb, pm, np_

    def execute(pt, psb, pm, np_, prior=None):
        return pallas_execute_pairs(pt, psb, pm, np_, rays, ps.planes,
                                    prior)

    def caps_from(out):
        """Per-ray caps after a partial execution: finished any-hit
        lanes drop out, closest-hit lanes tighten to their best t."""
        best = out[0].reshape(nt + 1, TILE)[:nt]
        if any_hit:
            slot = out[1].reshape(nt + 1, TILE)[:nt]
            return jnp.where(slot >= 0, 0.0, tct)
        return jnp.minimum(tct, best)

    def _bits(pm):
        return jnp.sum(jnp.bitwise_count(pm.astype(jnp.uint32)
                                         ).astype(jnp.int32))

    counters = None
    if strategy == "single":
        pt, psb, pm, np_ = compact_dense(sb_mask, mask8, n_live)
        out = execute(pt, psb, pm, np_)
        if with_counters:
            counters = dict(n_pairs=np_, mt_subblocks=_bits(pm))
    elif strategy == "two_round":
        # ---- round 1: nearest candidate superblocks per tile ----
        tn_cand = jnp.where(sb_mask, sb_tn, INF_DIST)
        if near_frac > 0.0:
            # THRESHOLD selection: superblocks whose entry distance is
            # within near_frac of the tile's candidate range run first
            # (two row reduces instead of a top_k)
            tmin = jnp.min(tn_cand, axis=1, keepdims=True)
            tmax = jnp.max(jnp.where(sb_mask, sb_tn, -INF_DIST),
                           axis=1, keepdims=True)
            thr = tmin + jnp.float32(near_frac) * jnp.maximum(
                tmax - tmin, 0.0)
            executed = sb_mask & (sb_tn <= thr)
            pt1, psb1, pm1, np1 = compact_dense(executed, mask8, n_live)
        else:
            neg_tn, cand = jax.lax.top_k(-tn_cand, k_first)  # [nt, K]
            cand_ok = -neg_tn < INF_DIST
            pt1, psb1, pm1, np1 = compact_topk(cand, cand_ok, mask8)
            executed = jnp.zeros((nt, nsb + 1), bool).at[
                jnp.arange(nt, dtype=jnp.int32)[:, None],
                jnp.where(cand_ok, cand, nsb)].set(True)[:, :nsb]
        out = execute(pt1, psb1, pm1, np1)

        # ---- round 2: re-cull the rest against tightened caps ----
        tct2 = caps_from(out)
        n_live2 = _live_tile_bound(tct2)
        rays2 = None
        if two_level:
            # per-ray exact pruning at superblock granularity; the pair
            # refine derives masks under the same tightened caps
            rays2 = rays_with_caps(tct2)
            sb_mask2 = box_entry(rays2, ps.sb_lo, ps.sb_hi,
                                 n_live2) < INF_DIST
            mask8_2 = None
        elif recull == "kernel":
            rays2 = rays_with_caps(tct2)
            sb_mask2, _, mask8_2 = derive_pair_tables(
                box_entry(rays2, ps.block_lo, ps.block_hi, n_live2),
                nsb, SB)
        elif recull == "sb":
            # per-ray superblock recull + the round-1 block masks
            # (stale bits are conservative): per-ray caps prune what a
            # per-tile cap cannot — one sky lane's INF cap otherwise
            # re-admits the whole tile
            sb_mask2 = box_entry(rays_with_caps(tct2), ps.sb_lo,
                                 ps.sb_hi, n_live2) < INF_DIST
            mask8_2 = mask8
        else:   # "tn": per-tile caps on saved block distances
            sb_mask2, mask8_2 = _tables_with_cap(
                tn_blk, jnp.max(tct2, axis=1), nsb)
        sb_mask2 = sb_mask2 & sb_mask & ~executed
        pt2, psb2, pm2, np2 = compact_dense(sb_mask2, mask8_2, n_live2,
                                            rays_eff=rays2)
        out = execute(pt2, psb2, pm2, np2, prior=out)
        if with_counters:
            counters = dict(n_pairs=np1 + np2,
                            mt_subblocks=_bits(pm1) + _bits(pm2))
    else:
        k = k_first
        # per-tile front-to-back candidate order (one row-wise sort)
        tn_cand = jnp.where(sb_mask, sb_tn, INF_DIST)     # [nt, nsb]
        ids = jnp.broadcast_to(jnp.arange(nsb, dtype=jnp.int32),
                               (nt, nsb))
        tn_sorted, sb_sorted = jax.lax.sort(
            (tn_cand, ids), dimension=1, num_keys=1)
        n_rounds = -(-nsb // k)
        pad_cols = n_rounds * k - nsb
        if pad_cols:
            tn_sorted = jnp.concatenate(
                [tn_sorted, jnp.full((nt, pad_cols), INF_DIST)], axis=1)
            sb_sorted = jnp.concatenate(
                [sb_sorted, jnp.full((nt, pad_cols), nsb, jnp.int32)],
                axis=1)

        def do_round(rr, out, tct_eff):
            tile_cap = jnp.max(tct_eff, axis=1)
            cand = jax.lax.dynamic_slice(sb_sorted, (0, rr * k),
                                         (nt, k))
            ctn = jax.lax.dynamic_slice(tn_sorted, (0, rr * k),
                                        (nt, k))
            ok = (ctn <= tile_cap[:, None]) & (ctn < INF_DIST)
            # refresh the block masks against the PER-RAY tightened
            # caps (lanes retire individually) unless stale masks are
            # asked for
            rays_eff = None if stale_round_masks else rays_with_caps(
                tct_eff)
            pt, psb, pm, npairs = compact_topk(
                cand, ok, mask8, rays_eff=rays_eff if two_level else None)
            if not two_level and not stale_round_masks:
                pm = refine(pt, psb, npairs, rays_eff)
            out = execute(pt, psb, pm, npairs, prior=out)
            return out, npairs, _bits(pm)

        # round 0 always runs (no prior: the execution starts from the
        # rays' caps)
        ok0 = tn_sorted[:, :k] < INF_DIST
        pt0, psb0, pm0, np0 = compact_topk(sb_sorted[:, :k], ok0, mask8)
        out = execute(pt0, psb0, pm0, np0)

        def cond(state):
            rr, out, _, _ = state
            # exact: per tile, candidates are tn-ascending, so if the
            # round's FIRST candidate cannot beat the tile's worst
            # live cap, none can
            nxt = jax.lax.dynamic_slice(tn_sorted, (0, rr * k),
                                        (nt, 1))[:, 0]
            tile_cap = jnp.max(caps_from(out), axis=1)
            return (rr < n_rounds) & jnp.any(nxt <= tile_cap)

        def body(state):
            rr, out, npa, bca = state
            out, npr, bcr = do_round(rr, out, caps_from(out))
            return rr + 1, out, npa + npr, bca + bcr

        _, out, np_acc, bc_acc = jax.lax.while_loop(
            cond, body, (jnp.int32(1), out, np0, _bits(pm0)))
        if with_counters:
            counters = dict(n_pairs=np_acc, mt_subblocks=bc_acc)

    t, slot = (x[:r] for x in out)
    if not isinstance(order, str):
        inv_perm = order[1]
        t, slot = t[inv_perm], slot[inv_perm]
    if with_counters:
        return t, slot, order, counters
    return t, slot, order


def _run_packet(bvh: BVH, ps: PacketSet, o, d, t_cap, any_hit: bool):
    """Sort rays, pad to a tile multiple, run the packet core, unsort."""
    o, d, t_cap, order, r = _sort_pad_rays(bvh.lo[0], bvh.hi[0], o, d,
                                           t_cap)
    t, slot, u, v = _packet_core(bvh, ps, o, d, t_cap, any_hit)
    t, slot = t[:r], slot[:r]
    return t[order[1]], slot[order[1]]


def _reeval_hit(bvh: BVH, soup: TriangleSoup, o, d, slot) -> Hit:
    """Differentiable re-evaluation of a detached discrete hit."""
    sg = jax.lax.stop_gradient
    tri = jnp.where(slot >= 0, bvh.orig[jnp.maximum(slot, 0)], -1)
    tri = sg(tri)
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


def intersect_closest_packet(bvh: BVH, ps: PacketSet, soup: TriangleSoup,
                             o, d) -> Hit:
    """Closest hit via packets; differentiable like the BVH path (detached
    discrete hit + differentiable re-evaluation)."""
    sg = jax.lax.stop_gradient
    _, slot = _run_packet(
        sg(bvh), sg(ps), sg(o), sg(d),
        jnp.full((o.shape[0],), INF_DIST), any_hit=False)
    return _reeval_hit(bvh, soup, o, d, slot)


def occluded_packet(bvh: BVH, ps: PacketSet, soup: TriangleSoup,
                    o, d, t_max):
    sg = jax.lax.stop_gradient
    _, slot = _run_packet(sg(bvh), sg(ps), sg(o), sg(d), sg(t_max),
                          any_hit=True)
    return slot >= 0


def intersect_closest_pallas(bvh: BVH, ps: PacketSet, soup: TriangleSoup,
                             o, d, t_cap=None, return_order=False,
                             order=None, **kw):
    """Closest hit via the fused Pallas kernel (fast path).

    ``t_cap`` (f32[R], optional): per-lane far limit; lanes with 0 are
    culled out of the pair lists entirely (dead-lane compaction).
    ``return_order``: also return the coherence sort (perm, inv_perm)
    for reuse by this bounce's shadow query.  ``order``: reuse a
    previous query's sort instead of re-sorting
    (cfg.reuse_bounce_order).  ``**kw``: strategy/cull/sort knobs,
    forwarded to _run_packet_pallas."""
    sg = jax.lax.stop_gradient
    if t_cap is None:
        t_cap = jnp.full((o.shape[0],), INF_DIST)
    _, slot, order = _run_packet_pallas(
        sg(bvh.lo[0]), sg(bvh.hi[0]), sg(ps), sg(o), sg(d), sg(t_cap),
        order=order, **kw)
    hit = _reeval_hit(bvh, soup, o, d, slot)
    return (hit, order) if return_order else hit


def occluded_pallas(bvh: BVH, ps: PacketSet, soup: TriangleSoup,
                    o, d, t_max, order=None, **kw):
    """Any-hit query.  ``order`` reuses a closest query's ray sort
    (shadow origins = that query's hit points, so coherence carries)."""
    sg = jax.lax.stop_gradient
    _, slot, _ = _run_packet_pallas(sg(bvh.lo[0]), sg(bvh.hi[0]),
                                    sg(ps), sg(o), sg(d), sg(t_max),
                                    any_hit=True, order=order, **kw)
    return slot >= 0
