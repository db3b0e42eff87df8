"""Stage-level breakdown of the packet query + full frame.

Times each stage of `_run_packet_pallas` separately (ray matrix + sort,
dense superblock cull, pair compaction, block-mask refinement, pair
kernel) on both coherent camera rays and incoherent bounce-style rays,
reports cull statistics (superblocks/tile, pairs/query, tests/ray), and
times one full frame.

Run on the card: `python examples/profile_breakdown.py [n_tris]`.
"""

from __future__ import annotations

import sys
import time

import jax
import jax.numpy as jnp

from prismarine_core_tpu.accel import packet as pk
from prismarine_core_tpu.models.camera import Camera, generate_rays
from prismarine_core_tpu.models.procedural import make_hall_scene
from prismarine_core_tpu.ops.cull import box_entry, pair_block_masks
from prismarine_core_tpu.ops.pallas_intersect import pallas_execute_pairs
from prismarine_core_tpu.ops.sampling import make_sample_arrays
from prismarine_core_tpu.render.integrator import render_with_samples
from prismarine_core_tpu.utils.config import INF_DIST, RenderConfig


def timeit(fn, *args, n=3, label=""):
    out = jax.block_until_ready(fn(*args))        # warm the exact callable
    t0 = time.perf_counter()
    for _ in range(n):
        out = jax.block_until_ready(fn(*args))
    dt = (time.perf_counter() - t0) / n * 1e3
    print(f"  {label:<42s} {dt:9.2f} ms", flush=True)
    return out, dt


def main():
    n_tris = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    width, height = 1280, 720
    cfg = RenderConfig(width=width, height=height, spp=1, max_bounces=4,
                       intersector="pallas", bvh_leaf_size=4)
    scene = jax.device_put(make_hall_scene(target_tris=n_tris))
    bvh, ps = scene.bvh, scene.packets
    camera = Camera.look_at(eye=(-10.0, 2.2, 0.0), target=(6.0, 1.6, 0.0),
                            fov_y_deg=60.0)
    cam_s, bounce_s = make_sample_arrays(jax.random.key(0), cfg.n_rays,
                                         cfg.max_bounces)
    print(f"tris={int(scene.triangles.num_valid())} "
          f"bvh_nodes={bvh.n_nodes} blocks={ps.n_blocks} "
          f"superblocks={ps.n_superblocks} rays={cfg.n_rays}", flush=True)

    o, d = generate_rays(camera, cfg, cam_s)
    t_cap = jnp.full((o.shape[0],), INF_DIST)

    # incoherent rays: same pixel origins lifted into the scene with
    # random directions (bounce-1-like distribution)
    key = jax.random.key(1)
    hit_p = o + jax.random.uniform(key, (o.shape[0], 1), minval=2.0,
                                   maxval=14.0) * d
    d_inc = jax.random.normal(jax.random.key(2), (o.shape[0], 3))
    d_inc = d_inc / jnp.linalg.norm(d_inc, axis=-1, keepdims=True)

    for name, (oo, dd) in [("coherent(camera)", (o, d)),
                           ("incoherent(bounce-like)", (hit_p, d_inc))]:
        print(f"\n=== {name} ===", flush=True)
        r = oo.shape[0]

        @jax.jit
        def sort_stage(oo, dd, tc):
            return pk._sorted_rays_matrix(bvh.lo[0], bvh.hi[0], oo, dd,
                                          tc)[0]

        rays, _ = timeit(sort_stage, oo, dd, t_cap,
                         label="ray sort + ray matrix")
        nt = rays.shape[0] // pk.TILE - 1
        n_live = jnp.int32(nt)

        @jax.jit
        def cull_stage(rays):
            return box_entry(rays, ps.sb_lo, ps.sb_hi, n_live) < INF_DIST

        sb_mask, _ = timeit(cull_stage, rays,
                            label="dense superblock cull")

        @jax.jit
        def pair_stage(sb_mask):
            return pk._compact_pairs_masked(sb_mask, None, n_live)

        (pt, psb, _, npairs), _ = timeit(pair_stage, sb_mask,
                                         label="pair compaction")

        @jax.jit
        def mask_stage(pt, psb, npairs):
            return pair_block_masks(rays, pt, psb, npairs, ps.block_lo,
                                    ps.block_hi)

        pm, _ = timeit(mask_stage, pt, psb, npairs,
                       label="block-mask refinement")
        nbits = jnp.sum(jnp.bitwise_count(pm.astype(jnp.uint32)))
        print(f"  real block-tests={int(nbits)} "
              f"({float(nbits)/max(int(npairs),1):.2f}/pair)", flush=True)
        timeit(pallas_execute_pairs, pt, psb, pm, npairs, rays, ps.planes,
               label="pair kernel (all pairs, one round)")

        counts = sb_mask.sum(axis=1)
        print(f"  sbs/tile: mean={float(counts.mean()):.1f} "
              f"p50={float(jnp.percentile(counts, 50)):.0f} "
              f"p99={float(jnp.percentile(counts, 99)):.0f} "
              f"max={int(counts.max())} of {ps.n_superblocks}; "
              f"n_pairs={int(npairs)}", flush=True)

        @jax.jit
        def full_query(oo, dd, t_cap):
            return pk._run_packet_pallas(bvh.lo[0], bvh.hi[0], ps, oo, dd, t_cap, False)

        timeit(full_query, oo, dd, t_cap, label="full closest-hit query")

        # tests/ray tracking (VERDICT r4 item 2): live MT sub-blocks
        # executed by the PRODUCTION closest config, per live ray
        @jax.jit
        def counted(oo, dd, t_cap):
            return pk._run_packet_pallas(
                bvh.lo[0], bvh.hi[0], ps, oo, dd, t_cap,
                cull_impl="pallas2", k_round=16,
                with_counters=True)[3]

        c = counted(oo, dd, t_cap)
        print(f"  closest (prod cfg): pairs={int(c['n_pairs']):,} "
              f"mt_subblocks={int(c['mt_subblocks']):,} "
              f"tests/ray={int(c['mt_subblocks'])*128*128/r:,.0f}",
              flush=True)

        @jax.jit
        def shadow_query(oo, dd, t_cap):
            return pk._run_packet_pallas(bvh.lo[0], bvh.hi[0], ps, oo, dd, t_cap, True)

        timeit(shadow_query, oo, dd,
               jnp.full((r,), 30.0), label="full any-hit query")

    print("\n=== full frame ===", flush=True)

    def frame():
        return render_with_samples(scene, camera, cfg, cam_s, bounce_s)

    timeit(frame, label="render_with_samples (4 bounces)")


if __name__ == "__main__":
    main()
