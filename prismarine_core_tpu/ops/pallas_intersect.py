"""Exact execution of a (ray tile x triangle superblock) pair list — the
hot op of the packet intersector.

The caller (accel/packet.py) sorts rays into TILEs of 128, culls them
against the Morton-ordered triangle blocks and compacts the surviving
(tile, superblock) pairs TILE-MAJOR, each with an 8-bit mask of the
superblock's sub-blocks that some ray of the tile can reach.  This
module runs the exact Möller–Trumbore test of every ray of a pair's
tile against every triangle of the pair's live sub-blocks and keeps the
closest hit per ray.  Two executors share that contract:

* ``pallas_execute_pairs`` — a Pallas kernel on the Triton route.  One
  program owns ``rb`` rays of one tile and loops over that tile's pairs
  (``[start, end)`` offsets built in XLA by ``tile_offsets``), their set
  mask bits and ``tc``-wide triangle chunks, keeping the rays and their
  running best in registers; it writes its result once.  No atomics, no
  cross-program merge: the pair list is tile-major, so each tile's work
  belongs to its own programs.
* ``xla_execute_pairs`` — the plain XLA version of the same contract:
  windows of pairs, a fused [pairs, 128, 1024] Möller–Trumbore grid
  reduced to per-pair candidates, merged per ray with a scatter-min.
  It is the kernel's reference (tests, chip_smoke.py).

Both break ties identically: at equal ``t`` the lowest slot wins, and a
hit at exactly the ray's cap never replaces the prior (slot -1 is the
lowest slot).  That makes the result independent of the order in which
pairs run.

Layouts:
  rays   f32[(nt+1)*TILE, RAY_COLS] — columns [o d t_cap pad inv_d ...];
         the last tile is the all-zero sentinel (t_cap 0, never hit).
  planes f32[nsb+1, 16, SB*BLOCK] — per-superblock SoA triangle rows
         [v0xyz e1xyz e2xyz valid 0...]; sub-block k occupies columns
         [128k, 128k+128).  Row TC_VALID is 0 for padding slots; the
         trailing superblock is all-zero (the pair-padding sentinel).
  result (t f32[(nt+1)*TILE], slot i32[(nt+1)*TILE]) — slot -1 = no hit
         under the cap.  Barycentrics are not tracked: callers
         re-evaluate the winning triangle differentiably.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltr

from prismarine_core_tpu.utils.config import INF_DIST, PZERO

TILE = 128      # rays per tile
BLOCK = 128     # triangle slots per sub-block
SB = 8          # sub-blocks per superblock
_DET_EPS = 1e-10
_NO_SLOT = 2 ** 30   # larger than any slot; loses every tie

# ray component columns
(RC_OX, RC_OY, RC_OZ, RC_DX, RC_DY, RC_DZ, RC_TCAP, _RC_PAD,
 RC_IVX, RC_IVY, RC_IVZ) = range(11)
RAY_COLS = 16
# triangle component rows
(TC_V0X, TC_V0Y, TC_V0Z, TC_E1X, TC_E1Y, TC_E1Z,
 TC_E2X, TC_E2Y, TC_E2Z, TC_VALID) = range(10)

#: Triton block configuration of ``pallas_execute_pairs`` on the GPU:
#: rays per program, triangles per inner chunk, warps per program.
#: Tuned on an H100 at the bench's hall pair lists (PERF.md): the ~20
#: live [rb, tc] Möller–Trumbore intermediates must stay in registers.
GPU_BLOCKS = dict(rb=32, tc=32, num_warps=4)
#: interpret mode (CPU) runs one program per tile and whole sub-blocks
#: per step: the interpreter's cost is per loop iteration, not per lane
_INTERPRET_BLOCKS = dict(rb=TILE, tc=BLOCK, num_warps=4)


def _mt_grid(ox, oy, oz, dx, dy, dz, row):
    """Masked-hit distances of rays ``o``/``d`` (broadcastable columns)
    against triangle rows ``row(c)``: t where the hit is valid and
    beyond PZERO, INF_DIST elsewhere."""
    e1x, e1y, e1z = row(TC_E1X), row(TC_E1Y), row(TC_E1Z)
    e2x, e2y, e2z = row(TC_E2X), row(TC_E2Y), row(TC_E2Z)
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv = 1.0 / jnp.where(jnp.abs(det) < _DET_EPS, _DET_EPS, det)
    sx = ox - row(TC_V0X)
    sy = oy - row(TC_V0Y)
    sz = oz - row(TC_V0Z)
    uu = (sx * px + sy * py + sz * pz) * inv
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    vv = (dx * qx + dy * qy + dz * qz) * inv
    tt = (e2x * qx + e2y * qy + e2z * qz) * inv
    ok = ((jnp.abs(det) >= _DET_EPS)
          & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
          & (tt > PZERO) & (row(TC_VALID) > 0.5))
    return jnp.where(ok, tt, INF_DIST)


def _fold(bt, bs, t, s):
    """Lexicographic (t, slot) minimum: lower t wins, lower slot on a
    tie."""
    better = (t < bt) | ((t == bt) & (s < bs))
    return jnp.where(better, t, bt), jnp.where(better, s, bs)


def tile_offsets(pair_tile, n_real, n_tiles: int):
    """Per-tile ``[start, end)`` ranges into a tile-major pair list.

    ``pair_tile`` i32[L] is non-decreasing over its first ``n_real``
    entries; entries past ``n_real`` are padding.  Returns (start, end),
    each i32[n_tiles]; a tile with no pair gets start == end."""
    lw = pair_tile.shape[0]
    idx = jnp.arange(lw, dtype=jnp.int32)
    pt = jnp.where(idx < n_real, pair_tile, n_tiles)
    bounds = jnp.searchsorted(
        pt, jnp.arange(n_tiles + 1, dtype=jnp.int32),
        side="left").astype(jnp.int32)
    return bounds[:-1], jnp.minimum(bounds[1:], n_real)


def _pair_kernel(rb, tc, start_ref, end_ref, psb_ref, pm_ref,
                 ray_ref, planes_ref, pt_ref, ps_ref, t_ref, s_ref):
    progs_per_tile = TILE // rb
    tile = pl.program_id(0) // progs_per_tile

    def col(c):
        return ray_ref[:, c][:, None]                  # [rb, 1]

    ox, oy, oz = col(RC_OX), col(RC_OY), col(RC_OZ)
    dx, dy, dz = col(RC_DX), col(RC_DY), col(RC_DZ)
    lane = jax.lax.broadcasted_iota(jnp.int32, (rb, tc), 1)

    def chunk(sb, off, carry):
        def row(c):
            return planes_ref[sb, c, pl.ds(off, tc)][None, :]   # [1, tc]

        tt = _mt_grid(ox, oy, oz, dx, dy, dz, row)      # [rb, tc]
        tmin = jnp.min(tt, axis=1)
        j = jnp.min(jnp.where(tt == tmin[:, None], lane, _NO_SLOT),
                    axis=1)
        return _fold(*carry, tmin, sb * (SB * BLOCK) + off + j)

    def pair(p, carry):
        sb = psb_ref[p]
        mask = pm_ref[p]

        def sub_block(k, carry):
            def run(carry):
                return jax.lax.fori_loop(
                    0, BLOCK // tc,
                    lambda q, c: chunk(sb, k * BLOCK + q * tc, c), carry)

            return jax.lax.cond(((mask >> k) & 1) == 1, run,
                                lambda c: c, carry)

        return jax.lax.fori_loop(0, SB, sub_block, carry)

    bt, bs = jax.lax.fori_loop(start_ref[tile], end_ref[tile], pair,
                               (pt_ref[...], ps_ref[...]))
    t_ref[...] = bt
    s_ref[...] = bs


def _prior(rays, prior):
    """(t, slot) the execution starts from: the caller's prior, or the
    ray caps with no hit."""
    if prior is not None:
        return prior
    return (rays[:, RC_TCAP],
            jnp.full((rays.shape[0],), -1, jnp.int32))


@partial(jax.jit, static_argnames=("rb", "tc"))
def pallas_execute_pairs(pair_tile, pair_sb, pair_mask, n_real, rays,
                         planes, prior=None, *, rb: int | None = None,
                         tc: int | None = None):
    """Closest hit per ray over a tile-major pair list (Triton kernel).

    pair_tile/pair_sb/pair_mask i32[L] (tile-major over the first
    ``n_real`` entries), rays f32[(nt+1)*TILE, RAY_COLS], planes
    f32[nsb+1, 16, SB*BLOCK]; ``prior`` (t, slot) seeds the result (a
    later round of a multi-round query), else (t_cap, -1).  Returns
    (t f32[rows], slot i32[rows]).  ``rb``/``tc`` override the
    backend's rays per program and triangles per chunk (tests)."""
    interpret = jax.default_backend() == "cpu"
    blocks = _INTERPRET_BLOCKS if interpret else GPU_BLOCKS
    rb = blocks["rb"] if rb is None else rb
    tc = blocks["tc"] if tc is None else tc
    assert TILE % rb == 0 and BLOCK % tc == 0, (rb, tc)
    n_rows = rays.shape[0]
    n_tiles = n_rows // TILE
    start, end = tile_offsets(pair_tile, n_real, n_tiles)
    prior_t, prior_s = _prior(rays, prior)

    def whole(x):
        return pl.BlockSpec(x.shape, lambda i: (0,) * x.ndim)

    rows = pl.BlockSpec((rb,), lambda i: (i,))
    return pl.pallas_call(
        partial(_pair_kernel, rb, tc),
        grid=(n_rows // rb,),
        in_specs=[whole(start), whole(end), whole(pair_sb),
                  whole(pair_mask),
                  pl.BlockSpec((rb, RAY_COLS), lambda i: (i, 0)),
                  whole(planes), rows, rows],
        out_specs=[rows, rows],
        out_shape=[jax.ShapeDtypeStruct((n_rows,), jnp.float32),
                   jax.ShapeDtypeStruct((n_rows,), jnp.int32)],
        backend="triton",
        compiler_params=pltr.CompilerParams(
            num_warps=blocks["num_warps"], num_stages=1),
        interpret=interpret,
        name="sb_pair_intersect",
    )(start, end, pair_sb, pair_mask, rays, planes, prior_t, prior_s)


def _argmin_tie_low(a, b):
    (ta, ia), (tb, ib) = a, b
    take_b = (tb < ta) | ((tb == ta) & (ib < ia))
    return jnp.where(take_b, tb, ta), jnp.where(take_b, ib, ia)


@partial(jax.jit, static_argnames=("window",))
def xla_execute_pairs(pair_tile, pair_sb, pair_mask, n_real, rays,
                      planes, prior=None, *, window: int = 1024):
    """Plain-XLA executor with the contract of ``pallas_execute_pairs``.

    Per window of ``window`` pairs: gather the pairs' ray tiles and
    superblock planes, reduce the [window, TILE, SB*BLOCK] masked
    Möller–Trumbore grid to one (t, slot) candidate per (pair, ray)
    with a lowest-slot argmin, and merge into the per-ray result with
    two scatter-mins (t, then slot among the rays' equal-t
    candidates)."""
    n_rows = rays.shape[0]
    nt = n_rows // TILE - 1
    nsb = planes.shape[0] - 1
    lw = pair_tile.shape[0]
    wpad = (-lw) % window
    if wpad:
        pair_tile = jnp.concatenate(
            [pair_tile, jnp.full((wpad,), nt, jnp.int32)])
        pair_sb = jnp.concatenate(
            [pair_sb, jnp.full((wpad,), nsb, jnp.int32)])
        pair_mask = jnp.concatenate(
            [pair_mask, jnp.zeros((wpad,), jnp.int32)])
    rays_t = rays.reshape(nt + 1, TILE, RAY_COLS)
    w = SB * BLOCK
    lane = jnp.arange(w, dtype=jnp.int32)
    lane_bit = (lane // BLOCK)[None, None, :]

    def body(state):
        start, bt, bs = state
        idx = start + jnp.arange(window, dtype=jnp.int32)
        live = idx < n_real
        pt = jnp.where(live, jax.lax.dynamic_slice(
            pair_tile, (start,), (window,)), nt)
        psb = jax.lax.dynamic_slice(pair_sb, (start,), (window,))
        pm = jnp.where(live, jax.lax.dynamic_slice(
            pair_mask, (start,), (window,)), 0)
        r = rays_t[pt]                                   # [W, TILE, C]
        tri = planes[psb]                                # [W, 16, w]

        def col(c):
            return r[:, :, c][:, :, None]                # [W, TILE, 1]

        def row(c):
            return tri[:, c, :][:, None, :]              # [W, 1, w]

        tt = _mt_grid(col(RC_OX), col(RC_OY), col(RC_OZ),
                      col(RC_DX), col(RC_DY), col(RC_DZ), row)
        on = ((pm[:, None, None] >> lane_bit) & 1) == 1
        tt = jnp.where(on, tt, INF_DIST)
        tmin, j = jax.lax.reduce(
            (tt, jnp.broadcast_to(lane, tt.shape)),
            (jnp.float32(INF_DIST), jnp.int32(_NO_SLOT)),
            _argmin_tie_low, (2,))                       # [W, TILE]
        cand = psb[:, None] * w + j
        rows = (pt[:, None] * TILE
                + jnp.arange(TILE, dtype=jnp.int32)[None, :]).reshape(-1)
        tmin = tmin.reshape(-1)
        cand = cand.reshape(-1)
        bt2 = bt.at[rows].min(tmin)
        keep = jnp.where(bt == bt2, bs, _NO_SLOT)
        bs2 = keep.at[rows].min(jnp.where(tmin == bt2[rows], cand,
                                          _NO_SLOT))
        return start + window, bt2, bs2

    bt, bs = _prior(rays, prior)
    _, bt, bs = jax.lax.while_loop(lambda s: s[0] < n_real, body,
                                   (jnp.int32(0), bt, bs))
    return bt, bs
