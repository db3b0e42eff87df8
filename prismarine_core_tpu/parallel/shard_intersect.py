"""Model-parallel intersection: shard the production (packet) intersector.

This module shards the production intersector's *block ranges* over the mesh's
``model`` axis (SURVEY.md §7 stage 7, option (b)): each model shard owns
a contiguous superblock range of the Morton-sorted triangle slots —
planes, block/superblock AABBs and slot->triangle ids all split on their
leading axis — runs the full local query (dense superblock cull, pair
compaction, block masks, pair kernel), and the per-ray closest hits
min-reduce across ``model`` with one ``all_gather`` (rays stay sharded
over ``data``).  The reference has no distributed capability at all
(SURVEY.md §2: single GL context); the closest analog being replaced is
its single-GPU buffer traffic (``Pipeline.inl:325-359``).

Scene memory scales: the packet planes (the largest per-scene
structure, 64 KB/superblock), the slot->triangle maps AND the triangle
vertices used for the differentiable hit re-evaluation are all divided
``mp`` ways.  Each model shard re-evaluates t/u/v for its own winning
slots against its LOCAL vertex shard *before* the min-reduce, and the
reduce carries the (t, u, v, tri) payload alongside the key — so no
replicated TriangleSoup gather remains anywhere in the query
(SURVEY.md §7 hard-part 6; the r2 build still gathered from a
replicated soup after the reduce).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from prismarine_core_tpu.accel.lbvh import BVH, EMPTY_BOX
from prismarine_core_tpu.accel.packet import (
    SB, PacketSet, _run_packet_pallas, build_packet_set)
from prismarine_core_tpu.ops.intersect import Hit, moller_trumbore
from prismarine_core_tpu.utils.config import INF_DIST


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ShardedPackets:
    """PacketSet arrays re-laid out for 'model'-axis sharding.

    All arrays lead with the superblock axis (padded to a multiple of
    the model-parallel degree); ``planes`` carries NO sentinel row —
    each shard appends its own locally.
    """

    planes: jax.Array    # f32[nsb, 16, SB*BLOCK]
    sb_lo: jax.Array     # f32[nsb, 3]
    sb_hi: jax.Array     # f32[nsb, 3]
    block_lo: jax.Array  # f32[nsb, SB, 3]
    block_hi: jax.Array  # f32[nsb, SB, 3]
    orig: jax.Array      # i32[nsb, SB*BLOCK] slot -> global triangle id
    #: Morton-sorted triangle vertices for the differentiable re-eval,
    #: sharded like the planes (DIFFERENTIABLE leaves — unlike planes,
    #: which the query consumes under stop_gradient)
    tv0: jax.Array       # f32[nsb, SB*BLOCK, 3]
    tv1: jax.Array       # f32[nsb, SB*BLOCK, 3]
    tv2: jax.Array       # f32[nsb, SB*BLOCK, 3]
    #: per-slot SHADING attributes (VERDICT r3 item 6: the attribute
    #: soup used to replicate): vertex normals, uvs, material ids in
    #: Morton slot order.  The winning shard interpolates its own
    #: surface fields and carries them through the min-reduce, so no
    #: replicated TriangleSoup remains for shading either.  All-zero
    #: when built without a soup (intersection-only usage).
    n0: jax.Array        # f32[nsb, SB*BLOCK, 3]
    n1: jax.Array        # f32[nsb, SB*BLOCK, 3]
    n2: jax.Array        # f32[nsb, SB*BLOCK, 3]
    t0: jax.Array        # f32[nsb, SB*BLOCK, 2]
    t1: jax.Array        # f32[nsb, SB*BLOCK, 2]
    t2: jax.Array        # f32[nsb, SB*BLOCK, 2]
    mat_id: jax.Array    # i32[nsb, SB*BLOCK]
    root_lo: jax.Array   # f32[3]
    root_hi: jax.Array   # f32[3]

    @property
    def n_superblocks(self) -> int:
        return self.planes.shape[0]


def build_sharded_packets(bvh: BVH, mp: int, soup=None) -> ShardedPackets:
    """Global PacketSet -> shard-friendly layout, nsb padded to mp.

    ``soup`` (TriangleSoup, optional): also slot-order the shading
    attributes so the sharded query can interpolate surfaces locally;
    omitted -> zero attributes (intersection-only)."""
    ps = build_packet_set(bvh)
    nsb = ps.n_superblocks
    nsb_pad = -(-nsb // mp) * mp
    pad = nsb_pad - nsb
    big = jnp.float32(EMPTY_BOX)

    planes = ps.planes[:-1]                      # strip global sentinel
    block_lo = ps.block_lo.reshape(nsb, SB, 3)
    block_hi = ps.block_hi.reshape(nsb, SB, 3)
    orig = ps.slot_orig.reshape(nsb, -1)
    sb_lo, sb_hi = ps.sb_lo, ps.sb_hi
    spb = orig.shape[1]                          # slots per superblock

    def slots_per_sb(tv):                        # [S,3] -> [nsb,spb,3]
        s = tv.shape[0]
        want = nsb * spb
        if want > s:
            tv = jnp.concatenate(
                [tv, jnp.zeros((want - s, 3), tv.dtype)])
        return tv[:want].reshape(nsb, spb, 3)

    tv0 = slots_per_sb(bvh.tv0)
    tv1 = slots_per_sb(bvh.tv1)
    tv2 = slots_per_sb(bvh.tv2)

    def attr_per_sb(src, width):
        """Gather a per-triangle attribute into slot order [nsb,spb,w]."""
        if soup is None:
            shape = (nsb, spb, width) if width > 1 else (nsb, spb)
            dt = jnp.int32 if width == 1 else jnp.float32
            return jnp.zeros(shape, dt)
        gi = jnp.maximum(ps.slot_orig, 0)
        a = src[gi]
        a = jnp.where((ps.slot_orig >= 0)[:, None] if a.ndim == 2
                      else (ps.slot_orig >= 0), a, 0)
        if width > 1:
            return a.reshape(nsb, spb, width)
        return a.reshape(nsb, spb)

    n0 = attr_per_sb(soup.n0 if soup else None, 3)
    n1 = attr_per_sb(soup.n1 if soup else None, 3)
    n2 = attr_per_sb(soup.n2 if soup else None, 3)
    t0 = attr_per_sb(soup.t0 if soup else None, 2)
    t1 = attr_per_sb(soup.t1 if soup else None, 2)
    t2 = attr_per_sb(soup.t2 if soup else None, 2)
    mat_id = attr_per_sb(soup.mat_id if soup else None, 1)
    if pad:
        planes = jnp.concatenate(
            [planes, jnp.zeros((pad,) + planes.shape[1:], jnp.float32)])
        block_lo = jnp.concatenate(
            [block_lo, jnp.full((pad, SB, 3), big)])
        block_hi = jnp.concatenate(
            [block_hi, jnp.full((pad, SB, 3), big)])
        sb_lo = jnp.concatenate([sb_lo, jnp.full((pad, 3), big)])
        sb_hi = jnp.concatenate([sb_hi, jnp.full((pad, 3), big)])
        orig = jnp.concatenate(
            [orig, jnp.full((pad, orig.shape[1]), -1, jnp.int32)])
        zpad = jnp.zeros((pad, spb, 3), jnp.float32)
        zpad2 = jnp.zeros((pad, spb, 2), jnp.float32)
        tv0 = jnp.concatenate([tv0, zpad])
        tv1 = jnp.concatenate([tv1, zpad])
        tv2 = jnp.concatenate([tv2, zpad])
        n0 = jnp.concatenate([n0, zpad])
        n1 = jnp.concatenate([n1, zpad])
        n2 = jnp.concatenate([n2, zpad])
        t0 = jnp.concatenate([t0, zpad2])
        t1 = jnp.concatenate([t1, zpad2])
        t2 = jnp.concatenate([t2, zpad2])
        mat_id = jnp.concatenate(
            [mat_id, jnp.zeros((pad, spb), jnp.int32)])
    return ShardedPackets(planes=planes, sb_lo=sb_lo, sb_hi=sb_hi,
                          block_lo=block_lo, block_hi=block_hi,
                          orig=orig, tv0=tv0, tv1=tv1, tv2=tv2,
                          n0=n0, n1=n1, n2=n2, t0=t0, t1=t1, t2=t2,
                          mat_id=mat_id,
                          root_lo=bvh.lo[0], root_hi=bvh.hi[0])


def shard_packets(sp: ShardedPackets, mesh: Mesh) -> ShardedPackets:
    """Place the packet arrays on the mesh: superblock axis over
    'model', root box replicated."""
    model = NamedSharding(mesh, P("model"))
    repl = NamedSharding(mesh, P())

    def put(x, name):
        return jax.device_put(
            x, repl if name in ("root_lo", "root_hi") else model)

    return ShardedPackets(**{
        f.name: put(getattr(sp, f.name), f.name)
        for f in dataclasses.fields(sp)})


def _local_query(sp_local: ShardedPackets, o, d, t_cap, any_hit: bool,
                 order=None, query_kw: dict | None = None):
    """One shard's query against its local superblock range.

    Returns (t_key, t, u, v, tri): ``t_key`` is the detached kernel
    distance (the reduce key); t/u/v re-evaluate the winning slot
    against the shard's LOCAL vertex arrays, differentiably — no
    replicated soup anywhere.  ``query_kw``: the single-device
    production knobs (cull_impl / strategies / sort mode...),
    forwarded verbatim to ``_run_packet_pallas`` — the sharded path
    runs the SAME tuned pipeline per shard.
    """
    nsb_l = sp_local.planes.shape[0]
    sg = jax.lax.stop_gradient
    planes = jnp.concatenate(
        [sg(sp_local.planes),
         jnp.zeros((1,) + sp_local.planes.shape[1:], jnp.float32)])
    ps = PacketSet(
        block_lo=sg(sp_local.block_lo).reshape(nsb_l * SB, 3),
        block_hi=sg(sp_local.block_hi).reshape(nsb_l * SB, 3),
        sb_lo=sg(sp_local.sb_lo), sb_hi=sg(sp_local.sb_hi),
        planes=planes,
        slot_orig=sp_local.orig.reshape(-1),
    )
    t_key, slot, order = _run_packet_pallas(
        sg(sp_local.root_lo), sg(sp_local.root_hi),
        ps, sg(o), sg(d), sg(t_cap), any_hit=any_hit, order=order,
        **(query_kw or {}))
    slot = sg(slot)
    tri = jnp.where(slot >= 0, ps.slot_orig[jnp.maximum(slot, 0)], -1)
    # differentiable re-eval against the local vertex shard
    six = jnp.maximum(slot, 0)
    v0l, v1l, v2l = (sp_local.tv0.reshape(-1, 3)[six],
                     sp_local.tv1.reshape(-1, 3)[six],
                     sp_local.tv2.reshape(-1, 3)[six])
    t, u, v, _ = moller_trumbore(o, d, v0l, v1l, v2l)
    hitm = tri >= 0
    t = jnp.where(hitm, t, INF_DIST)
    u = jnp.where(hitm, u, 0.0)
    v = jnp.where(hitm, v, 0.0)

    # shard-local surface interpolation (VERDICT r3 item 6): the
    # winning shard OWNS the attribute slots, so interpolated shading
    # fields ride the min-reduce payload and no replicated soup is
    # touched downstream.  12 channels: ns(3) ng(3) tang(3) uv(2)
    # mat(1, exact float for ids < 2^24).
    w_b = (1.0 - u - v)[:, None]
    u_b, v_b = u[:, None], v[:, None]
    ns = (w_b * sp_local.n0.reshape(-1, 3)[six]
          + u_b * sp_local.n1.reshape(-1, 3)[six]
          + v_b * sp_local.n2.reshape(-1, 3)[six])
    e1 = v1l - v0l
    e2 = v2l - v0l
    ng = jnp.cross(e1, e2)
    t0l = sp_local.t0.reshape(-1, 2)[six]
    duv1 = sp_local.t1.reshape(-1, 2)[six] - t0l
    duv2 = sp_local.t2.reshape(-1, 2)[six] - t0l
    uv = w_b * t0l + u_b * sp_local.t1.reshape(-1, 2)[six] \
        + v_b * sp_local.t2.reshape(-1, 2)[six]
    det_uv = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
    rdet = jnp.where(jnp.abs(det_uv) < 1e-12, 0.0,
                     1.0 / jnp.where(jnp.abs(det_uv) < 1e-12, 1.0,
                                     det_uv))[:, None]
    tang = (e1 * duv2[:, 1:2] - e2 * duv1[:, 1:2]) * rdet
    mat_f = sp_local.mat_id.reshape(-1)[six].astype(jnp.float32)
    surf = jnp.concatenate(
        [ns, ng, tang, uv, mat_f[:, None]], axis=-1)      # [r, 12]
    surf = jnp.where(hitm[:, None], surf, 0.0)
    return t_key, t, u, v, tri, surf, order


def make_sharded_query(mesh: Mesh, any_hit: bool = False,
                       use_order: bool = False,
                       query_kw: dict | None = None):
    """shard_map-wrapped closest-hit/any-hit query: rays over 'data',
    superblock ranges over 'model', one all_gather('model') min-reduce.

    Returns fn(sp_sharded, o, d, t_cap[, perm, inv_perm]) ->
    (t, u, v, tri, surf, perm, inv_perm) with o/d/t_cap sharded over
    'data' and results likewise; t/u/v are differentiable w.r.t. the
    vertex shards and the rays.  ``use_order``: accept a previous
    query's per-shard coherence permutation instead of re-sorting (the
    single-chip one-sort-per-bounce contract, VERDICT r3 weak 4 —
    shadow origins are the closest query's hit points, so its order
    transfers; perm VALUES are shard-local indices and only make sense
    re-fed to the same 'data' sharding).
    """
    packs_spec = ShardedPackets(**{
        f.name: (P() if f.name in ("root_lo", "root_hi")
                 else P("model"))
        for f in dataclasses.fields(ShardedPackets)})

    def local_fn(sp_local, o, d, t_cap, *order_in):
        order = order_in if use_order else None
        t_key, t, u, v, tri, surf, order = _local_query(
            sp_local, o, d, t_cap, any_hit, order=order,
            query_kw=query_kw)
        keys = jax.lax.all_gather(jax.lax.stop_gradient(t_key), "model")
        ts = jax.lax.all_gather(t, "model")        # [mp, r_local]
        us = jax.lax.all_gather(u, "model")
        vs = jax.lax.all_gather(v, "model")
        tris = jax.lax.all_gather(tri, "model")
        surfs = jax.lax.all_gather(surf, "model")  # [mp, r_local, 12]
        # min-reduce over shards; on ties the lowest shard index wins
        # (deterministic); misses carry t_key == t_cap and tri == -1
        k = jnp.argmin(keys, axis=0)[None]
        pick = lambda a: jnp.take_along_axis(a, k, 0)[0]  # noqa: E731
        surf_w = jnp.take_along_axis(surfs, k[..., None], 0)[0]
        return (pick(ts), pick(us), pick(vs), pick(tris), surf_w,
                order[0], order[1])

    extra = (P("data"), P("data")) if use_order else ()
    return shard_map(
        local_fn, mesh=mesh,
        in_specs=(packs_spec, P("data"), P("data"), P("data")) + extra,
        out_specs=(P("data"), P("data"), P("data"), P("data"),
                   P("data"), P("data"), P("data")),
        check_vma=False,
    )


def constrain_packets(sp: ShardedPackets, mesh: Mesh) -> ShardedPackets:
    """`with_sharding_constraint` counterpart of ``shard_packets`` for
    packets built INSIDE a jitted computation (e.g. the train step's
    per-iteration rebuild): superblock axis over 'model', roots
    replicated."""
    def c(x, name):
        spec = P() if name in ("root_lo", "root_hi") else P("model")
        return jax.lax.with_sharding_constraint(
            x, NamedSharding(mesh, spec))

    return ShardedPackets(**{
        f.name: c(getattr(sp, f.name), f.name)
        for f in dataclasses.fields(sp)})


def distribute_scene(scene, mesh: Mesh, shard_soup: bool = True,
                     shard_textures: bool = True):
    """Scene -> mesh-distributed Scene for ``intersector='pallas_sharded'``.

    The packet structures (planes, AABBs, slot maps, re-eval vertices
    AND the slot-ordered shading attributes) shard over 'model';
    materials/lights (small) replicate.  With ``shard_soup`` (default)
    the replicated TriangleSoup is reduced to an 8-row husk —
    the sharded query interpolates surfaces shard-locally and carries
    them through the min-reduce, so nothing reads it — and per-device
    TOTAL scene bytes scale ~1/mp (tests/test_parallel.py asserts via
    ``addressable_shards``).  ``shard_soup=False`` keeps the full soup
    replicated for flows that use it as host-side state (e.g. the
    training loop, whose PARAMETERS are the vertex arrays).

    ``shard_textures`` (default, no-op on stub stacks): partition the
    texture stack's ``data``/``quad`` over 'model' on the texture-index
    axis (padded with white to a multiple of mp) and mark the stack so
    every fetch runs shard-local + one psum('model')
    (models/textures.py:_sharded_texel_rows) — texture residency then
    scales 1/mp too, closing the one array family that used to
    replicate (VERDICT r4 item 6; reference analog: bindless residency,
    ``TextureSet.inl:15-38``).
    """
    mp = mesh.shape["model"]
    sp = shard_packets(
        build_sharded_packets(scene.bvh, mp, soup=scene.triangles),
        mesh)
    repl = NamedSharding(mesh, P())
    if shard_soup:
        husk = jax.tree_util.tree_map(
            lambda x: jnp.zeros((8,) + x.shape[1:], x.dtype),
            scene.triangles)
        scene = dataclasses.replace(scene, triangles=husk)
    tex = scene.textures
    shard_tex = (shard_textures and tex is not None
                 and not getattr(tex, "stub", False))
    if shard_tex:
        scene = dataclasses.replace(scene, textures=None)
    scene = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, repl),
        dataclasses.replace(scene, packets=None, bvh=None))
    if shard_tex:
        npad = (-tex.count) % mp
        model = NamedSharding(mesh, P("model"))

        def pad_put(arr):
            if arr is None:
                return None
            if npad:
                arr = jnp.concatenate(
                    [arr, jnp.ones((npad,) + arr.shape[1:], arr.dtype)])
            return jax.device_put(arr, model)

        sizes = tex.sizes
        if sizes is not None and npad:
            sizes = jnp.concatenate(
                [sizes, jnp.ones((npad, 2), jnp.int32)])
        tex = dataclasses.replace(
            tex, data=pad_put(tex.data), quad=pad_put(tex.quad),
            sizes=None if sizes is None else jax.device_put(sizes, repl),
            mesh=mesh)
        scene = dataclasses.replace(scene, textures=tex)
    return dataclasses.replace(scene, packets=sp, bvh=None)


def sharded_intersect_closest(mesh: Mesh, sp: ShardedPackets, o, d,
                              t_cap=None, return_surface: bool = False,
                              return_order: bool = False,
                              query_kw: dict | None = None):
    """Closest hit over the sharded scene — differentiable: each model
    shard re-evaluates its own winners locally (no replicated soup).

    ``return_surface``: also return the carried shard-local surface
    fields dict (ns/ng/tang/uv/mat_id) for replicated-soup-free
    shading.  ``return_order``: also return the per-shard coherence
    permutation for reuse by this bounce's shadow query.
    ``query_kw``: single-device production knobs forwarded to each
    shard's `_run_packet_pallas` (the integrator passes
    `_pallas_kwargs(cfg)`)."""
    if t_cap is None:
        t_cap = jnp.full((o.shape[0],), INF_DIST)
    query = make_sharded_query(mesh, any_hit=False, query_kw=query_kw)
    t, u, v, tri, surf, perm, inv_perm = query(sp, o, d, t_cap)
    hit = Hit(t=t, tri=tri, u=u, v=v)
    out = (hit,)
    if return_surface:
        out = out + (dict(
            ns=surf[:, 0:3], ng=surf[:, 3:6], tang=surf[:, 6:9],
            uv=surf[:, 9:11],
            mat_id=surf[:, 11].astype(jnp.int32)),)
    if return_order:
        out = out + ((perm, inv_perm),)
    return out if len(out) > 1 else hit


def sharded_occluded(mesh: Mesh, sp: ShardedPackets, o, d, t_max,
                     order=None, query_kw: dict | None = None):
    """Any-hit query; ``order`` reuses a closest query's per-shard
    coherence sort (one u32 sort per bounce, not per query)."""
    sg = jax.lax.stop_gradient
    query = make_sharded_query(mesh, any_hit=True,
                               use_order=order is not None,
                               query_kw=query_kw)
    args = (sg(sp), sg(o), sg(d), sg(t_max))
    if order is not None:
        args = args + (sg(order[0]), sg(order[1]))
    _, _, _, tri, _, _, _ = query(*args)
    return tri >= 0
