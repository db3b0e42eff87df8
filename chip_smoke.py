"""Smoke test of the path tracer on the GPU, through its normal entry points.

    python chip_smoke.py                # one card: phases 1-5 below
    python chip_smoke.py --four-cards   # four cards: the sharded path only

One card, in one process, in order:

1. device — JAX's default device must be a GPU (exit non-zero otherwise);
   prints its kind, the device count and nvidia-smi's name and power
   limit;
2. kernels — on the bench's hall scene (HDR sky) at 1280x720, the
   primary query and one secondary bounce: the Pallas pair kernel
   against the plain-XLA pair executor on the same pair lists for every
   ray, both against brute force on a fixed 16k-ray subset, and the XLA
   culls against a per-ray slab reference on that subset; each with its
   time on the card;
3. main path — ``prismarine_core_tpu.cli.main`` on the hall at 1280x720,
   4 bounces, 4 progressive frames with the bench's knobs, then one
   ``render_with_samples`` frame compared with the ``"bvh"`` intersector
   on the same samples, with its memory analysis;
4. oracle — Cornell box, 64x64, 2 spp, 3 bounces: the "pallas" and
   "bvh" paths against the numpy reference renderer;
5. gradient — one inverse-rendering gradient (image MSE w.r.t. vertices
   and the diffuse table), hall at 512x512, 2 bounces, "pallas" against
   "bvh".

``--four-cards`` runs the textured hall through ``distribute_scene`` on a
1x4 ('data', 'model') mesh at 1024x1024 and 8 bounces against the same
frame on one card, one sharded train step against the one-card step,
and prints the per-device scene bytes.

Every phase prints its findings; any failure raises and exits non-zero.
The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": n}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

HALL_TRIS = 100_000
HALL_EYE, HALL_TARGET = (-10.0, 2.2, 0.0), (6.0, 1.6, 0.0)
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chiprun_out", "chip_smoke")

#: production knobs of bench.py's main config
BENCH_KNOBS = dict(intersector="pallas", coherent_bounce_sampling=True,
                   stale_round_masks=True, anyhit_strategy="single",
                   cull_impl="pallas2", closest_k=16)
#: pixel difference that counts a pixel as different between the
#: "pallas" and "bvh" paths (both exact; they differ only where two
#: triangles tie or a hit grazes an edge)
PIXEL_TOL = 1e-3


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def timed(fn, *args, n: int = 10) -> float:
    """Median seconds of ``n`` calls after one warm-up call, each ended
    by block_until_ready."""
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def hall_scene(n_tris: int = HALL_TRIS, textured: bool = False,
               texture_resolution: int = 512):
    """bench.py's hall with its HDR equirect sky."""
    from prismarine_core_tpu.models.procedural import (
        make_hall_scene, make_sky_environment)
    scene = make_hall_scene(target_tris=n_tris, textured=textured,
                            texture_resolution=texture_resolution)
    return dataclasses.replace(
        scene, environment=make_sky_environment(resolution=128))


def hall_camera():
    from prismarine_core_tpu.models.camera import Camera
    return Camera.look_at(eye=HALL_EYE, target=HALL_TARGET,
                          fov_y_deg=60.0)


def bench_config(width: int, height: int, max_bounces: int, **kw):
    from prismarine_core_tpu.utils.config import RenderConfig
    return RenderConfig(width=width, height=height, spp=1,
                        max_bounces=max_bounces, **{**BENCH_KNOBS, **kw})


def coherent_samples(cfg, seed: int = 0):
    from prismarine_core_tpu.ops.sampling import (
        make_coherent_sample_arrays)
    return make_coherent_sample_arrays(jax.random.key(seed), cfg,
                                       block=(64, 64))


# ---------------------------------------------------------------- phase 2

def _query_rays(scene, camera, cfg):
    """(name, o, d, t_cap) of the primary query and the first secondary
    bounce, as the integrator produces them."""
    from prismarine_core_tpu.models.camera import generate_rays
    from prismarine_core_tpu.render.integrator import make_bounce_step
    from prismarine_core_tpu.utils.config import INF_DIST
    cam_s, bounce_s = coherent_samples(cfg)
    o, d = generate_rays(camera, cfg, cam_s)
    r = o.shape[0]
    init = (o, d, jnp.ones((r, 3)), jnp.zeros((r, 3)),
            jnp.ones((r,), bool), jnp.zeros((r,)),
            jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (r, 3)),
            jnp.zeros((r, 3)), jnp.zeros((r,)), jnp.int32(0))
    carry, _ = jax.jit(make_bounce_step(scene, cfg))(init, bounce_s[0])
    o1, d1, alive1 = carry[0], carry[1], carry[4]
    return [("primary", o, d, jnp.full((r,), INF_DIST)),
            ("bounce1", o1, d1, jnp.where(alive1, INF_DIST, 0.0))]


def _pair_lists(ps, root_lo, root_hi, o, d, t_cap):
    """Sorted ray matrix + the two-level cull's full pair list (every
    candidate superblock of every tile, one round)."""
    from prismarine_core_tpu.accel import packet as pk
    from prismarine_core_tpu.ops.cull import box_entry, pair_block_masks
    from prismarine_core_tpu.utils.config import INF_DIST
    rays, _, _ = pk._sorted_rays_matrix(root_lo, root_hi, o, d, t_cap)
    nt = rays.shape[0] // pk.TILE - 1
    n_live = pk._live_tile_bound(
        rays[:nt * pk.TILE, pk.RC_TCAP].reshape(nt, pk.TILE))
    sb_mask = box_entry(rays, ps.sb_lo, ps.sb_hi, n_live) < INF_DIST
    pt, psb, _, n_pairs = pk._compact_pairs_masked(sb_mask, None, n_live)
    pm = pair_block_masks(rays, pt, psb, n_pairs, ps.block_lo,
                          ps.block_hi)
    return rays, (pt, psb, pm, n_pairs)


def _slab_reference(r, lo, hi):
    """Per-ray slab entry distance f32[rays, boxes], written plainly."""
    from prismarine_core_tpu.ops import pallas_intersect as pi
    from prismarine_core_tpu.utils.config import INF_DIST
    o = r[:, None, pi.RC_OX:pi.RC_OX + 3]
    inv = r[:, None, pi.RC_IVX:pi.RC_IVX + 3]
    tc = r[:, None, pi.RC_TCAP]
    t0 = (lo[None] - o) * inv
    t1 = (hi[None] - o) * inv
    tn = jnp.max(jnp.minimum(t0, t1), axis=-1)
    tf = jnp.min(jnp.maximum(t0, t1), axis=-1)
    tn0 = jnp.maximum(tn, 0.0)
    hit = (tf >= tn0) & (tn <= tc) & (tc > 0.0)
    return jnp.where(hit, tn0, INF_DIST)


def phase_kernels(scene, camera, cfg, n_subset_tiles: int = 128,
                  n_time: int = 10, card: str = "") -> dict:
    """Phase 2; returns the per-query findings."""
    from prismarine_core_tpu.ops import pallas_intersect as pi
    from prismarine_core_tpu.ops.cull import box_entry, pair_block_masks
    from prismarine_core_tpu.ops.intersect import intersect_closest_brute
    ps, bvh = scene.packets, scene.bvh
    root_lo, root_hi = bvh.lo[0], bvh.hi[0]
    out = {}
    for name, o, d, t_cap in _query_rays(scene, camera, cfg):
        rays, pairs = _pair_lists(ps, root_lo, root_hi, o, d, t_cap)
        pt, psb, pm, n_pairs = pairs
        tk, sk = pi.pallas_execute_pairs(*pairs, rays, ps.planes)
        tx, sx = pi.xla_execute_pairs(*pairs, rays, ps.planes)
        tk, sk, tx, sx = (np.asarray(a) for a in (tk, sk, tx, sx))
        rows = rays.shape[0] - pi.TILE              # without sentinel
        same = sk[:rows] == sx[:rows]
        hit = same & (sk[:rows] >= 0)
        rel = np.abs(tk[:rows] - tx[:rows])[hit] / np.abs(tx[:rows])[hit]
        f = dict(rays=int(rows), pairs=int(n_pairs),
                 live_subblocks=int(np.bitwise_count(
                     np.asarray(pm)[:int(n_pairs)]).sum()),
                 slot_diff_vs_xla=int((~same).sum()),
                 t_relerr_vs_xla=float(rel.max(initial=0.0)))
        log("kernels", f"{name}: {f['rays']} rays, {f['pairs']} pairs, "
            f"{f['live_subblocks']} live sub-blocks; kernel vs XLA "
            f"executor: {f['slot_diff_vs_xla']} lanes differ in slot, "
            f"max rel t err {f['t_relerr_vs_xla']:.3g}")
        assert f["slot_diff_vs_xla"] <= 1e-5 * rows, f
        assert f["t_relerr_vs_xla"] <= 1e-5, f

        # fixed subset: n_subset_tiles evenly spaced tiles of live rays
        nt = rows // pi.TILE
        tiles = np.linspace(0, nt - 1, min(n_subset_tiles, nt)
                            ).astype(np.int64)
        sub = (tiles[:, None] * pi.TILE
               + np.arange(pi.TILE)[None]).reshape(-1)
        r_sub = rays[sub]
        live = np.asarray(r_sub[:, pi.RC_TCAP]) > 0.0
        with jax.default_matmul_precision("highest"):
            hb = intersect_closest_brute(
                scene.triangles, r_sub[:, pi.RC_OX:pi.RC_OX + 3],
                r_sub[:, pi.RC_DX:pi.RC_DX + 3])
        tri_b = np.asarray(hb.tri)
        orig = np.asarray(ps.slot_orig)
        t_b = np.asarray(hb.t)
        for exe, t_e, s_e in (("kernel", tk, sk), ("xla", tx, sx)):
            tri_e = np.where(s_e[sub] >= 0, orig[np.maximum(s_e[sub], 0)],
                             -1)
            same = tri_e == tri_b
            # a different triangle at the same distance is a tie (an
            # edge shared by two triangles): brute force keeps the lower
            # triangle id, the executors the lower slot
            tie = (~same & (tri_e >= 0) & (tri_b >= 0)
                   & (np.abs(t_e[sub] - t_b) <= 1e-5 * np.abs(t_b)))
            diff = int((live & ~same & ~tie).sum())
            both = live & same & (tri_b >= 0)
            rel_b = np.abs(t_e[sub][both] - t_b[both]) / t_b[both]
            log("kernels", f"{name}: {exe} vs brute force on "
                f"{int(live.sum())} live subset rays: {diff} lanes "
                f"differ ({diff / max(live.sum(), 1):.2e}, limit 1e-4), "
                f"{int((live & tie).sum())} equal-t ties resolved to "
                f"another triangle, max rel t err "
                f"{rel_b.max(initial=0.0):.3g}")
            assert diff <= 1e-4 * live.sum(), (name, exe, diff)
            assert rel_b.max(initial=0.0) <= 1e-5, (name, exe)

        # XLA culls against the per-ray slab reference on the subset
        n_live = jnp.int32(nt)
        for level, lo, hi in (("superblock", ps.sb_lo, ps.sb_hi),
                              ("block", ps.block_lo, ps.block_hi)):
            got = np.asarray(box_entry(rays, lo, hi, n_live))[tiles]
            ref = np.asarray(_slab_reference(r_sub, lo, hi)).reshape(
                len(tiles), pi.TILE, -1).min(axis=1)
            bad = int((got != ref).sum())
            log("kernels", f"{name}: {level} cull vs per-ray slab "
                f"reference on the subset tiles: {bad} of {ref.size} "
                f"entries differ")
            assert bad == 0, (name, level, bad)
        pm_np = np.asarray(pm)[:int(n_pairs)]
        pt_np = np.asarray(pt)[:int(n_pairs)]
        psb_np = np.asarray(psb)[:int(n_pairs)]
        in_sub = np.isin(pt_np, tiles)
        blk = np.asarray(_slab_reference(
            r_sub, ps.block_lo, ps.block_hi)).reshape(
            len(tiles), pi.TILE, -1, pi.SB).min(axis=1) < 1e4
        pos = np.searchsorted(tiles, pt_np[in_sub])
        ref_codes = (blk[pos, psb_np[in_sub]]
                     * (1 << np.arange(pi.SB))).sum(-1)
        bad = int((ref_codes != pm_np[in_sub]).sum())
        log("kernels", f"{name}: pair cull vs per-ray slab reference: "
            f"{bad} of {int(in_sub.sum())} subset pair codes differ")
        assert bad == 0, (name, bad)

        # times on the card
        tms = {
            "pair kernel (Pallas/Triton)": timed(
                pi.pallas_execute_pairs, *pairs, rays, ps.planes,
                n=n_time),
            "pair executor (plain XLA)": timed(
                pi.xla_execute_pairs, *pairs, rays, ps.planes, n=n_time),
            "superblock cull (plain XLA)": timed(
                box_entry, rays, ps.sb_lo, ps.sb_hi, n_live, n=n_time),
            "block cull (plain XLA)": timed(
                box_entry, rays, ps.block_lo, ps.block_hi, n_live,
                n=n_time),
            "pair cull (plain XLA)": timed(
                pair_block_masks, rays, pt, psb, n_pairs, ps.block_lo,
                ps.block_hi, n=n_time),
        }
        for k, v in tms.items():
            log("kernels", f"{name}: {k}: {v * 1e3:.3f} ms (median of "
                f"{n_time}; {card})")
        f["times_ms"] = {k: v * 1e3 for k, v in tms.items()}
        out[name] = f
    return out


# ---------------------------------------------------------------- phase 3

def phase_main_path(scene, camera, cfg, n_tris: int, frames: int = 4,
                    out_dir: str = OUT_DIR) -> dict:
    """Phase 3: the CLI, then one frame against the "bvh" intersector."""
    from prismarine_core_tpu import cli
    from prismarine_core_tpu.render.integrator import render_with_samples
    os.makedirs(out_dir, exist_ok=True)
    argv = ["--scene", "hall", "--hall-tris", str(n_tris),
            "--res", f"{cfg.width}x{cfg.height}",
            "--depth", str(cfg.max_bounces), "--coherent",
            "--frames", str(frames), "--stale-round-masks",
            "--cull-impl", cfg.cull_impl,
            "--strategy-k", str(cfg.closest_k),
            "--anyhit-strategy", cfg.anyhit_strategy,
            "--out", os.path.join(out_dir, "hall.png")]
    t0 = time.perf_counter()
    assert cli.main(argv) == 0
    log("main", f"cli.main({' '.join(argv)}) ok in "
        f"{time.perf_counter() - t0:.1f} s")
    img_cli = np.load(os.path.join(out_dir, "hall.npy"))
    assert np.isfinite(img_cli).all() and img_cli.shape == (
        cfg.height, cfg.width, 3)

    cam_s, bounce_s = coherent_samples(cfg)
    lowered = render_with_samples.lower(scene, camera, cfg, cam_s,
                                        bounce_s)
    compiled = lowered.compile()
    log("main", f"frame memory_analysis: {compiled.memory_analysis()}")
    img = np.asarray(render_with_samples(scene, camera, cfg, cam_s,
                                         bounce_s))
    stats = jax.devices()[0].memory_stats() or {}
    mean = float(img.mean())
    f = dict(mean=mean, cli_mean=float(img_cli.mean()),
             peak_bytes_in_use=stats.get("peak_bytes_in_use"))
    log("main", f"frame mean {mean:.5f} (cli {f['cli_mean']:.5f}), "
        f"finite {bool(np.isfinite(img).all())}, peak_bytes_in_use "
        f"{f['peak_bytes_in_use']}")
    assert np.isfinite(img).all()
    assert 0.05 < mean < 2.0, mean           # lit hall, not black/blown
    ref = np.asarray(render_with_samples(
        scene, camera, cfg.replace(intersector="bvh"), cam_s, bounce_s))
    diff = np.abs(img - ref)
    f.update(mean_abs_diff=float(diff.mean()),
             differing=float((diff.max(-1) > PIXEL_TOL).mean()))
    log("main", f"pallas vs bvh frame: mean |diff| "
        f"{f['mean_abs_diff']:.3g} (limit 1e-3), pixels differing "
        f"by > {PIXEL_TOL}: {f['differing']:.3%} (limit 0.5%)")
    assert f["mean_abs_diff"] < 1e-3 and f["differing"] < 0.005, f
    return f


# ---------------------------------------------------------------- phase 4

def phase_oracle(size: int = 64, spp: int = 2, bounces: int = 3) -> dict:
    """Phase 4: Cornell box against the numpy reference renderer."""
    from prismarine_core_tpu.models.camera import Camera
    from prismarine_core_tpu.models.scene import make_cornell_scene
    from prismarine_core_tpu.ops.sampling import make_sample_arrays
    from prismarine_core_tpu.reference.cpu_reference import (
        render_reference)
    from prismarine_core_tpu.render.integrator import render_with_samples
    from prismarine_core_tpu.utils.config import RenderConfig
    scene = make_cornell_scene()
    cam = Camera.look_at(eye=(0.0, 0.0, 3.4), target=(0.0, 0.0, 0.0),
                         fov_y_deg=50.0)
    cfg = RenderConfig(width=size, height=size, spp=spp,
                       max_bounces=bounces)
    cam_s, bounce_s = make_sample_arrays(jax.random.key(0), cfg.n_rays,
                                         cfg.max_bounces)
    ref = render_reference(scene, cam, cfg, np.asarray(cam_s),
                           np.asarray(bounce_s))
    out = {}
    for inter in ("pallas", "bvh"):
        img = np.asarray(render_with_samples(
            scene, cam, cfg.replace(intersector=inter), cam_s, bounce_s))
        diff = np.abs(img - ref)
        bad = float((diff.max(-1) > PIXEL_TOL).mean())
        out[inter] = dict(differing=bad, median=float(np.median(diff)))
        log("oracle", f"{inter} vs numpy reference: {bad:.2%} of pixels "
            f"differ by > {PIXEL_TOL} (limit 1%), median |diff| "
            f"{out[inter]['median']:.3g} (limit 1e-4), mean "
            f"{img.mean():.4f} vs {ref.mean():.4f}")
        assert np.isfinite(img).all() and img.mean() > 1e-3
        assert bad < 0.01 and out[inter]["median"] < 1e-4, out
    return out


# ---------------------------------------------------------------- phase 5

def phase_gradient(scene, camera, cfg) -> dict:
    """Phase 5: d(image MSE)/d(vertices, diffuse table), pallas vs bvh."""
    from prismarine_core_tpu.render.integrator import render_with_samples
    cam_s, bounce_s = coherent_samples(cfg, seed=1)
    target = jnp.full((cfg.height, cfg.width, 3), 0.25)

    def grads(c):
        def loss(v0, v1, v2, diffuse):
            s = dataclasses.replace(
                scene,
                triangles=dataclasses.replace(scene.triangles, v0=v0,
                                              v1=v1, v2=v2),
                materials=dataclasses.replace(scene.materials,
                                              diffuse=diffuse))
            img = render_with_samples(s, camera, c, cam_s, bounce_s)
            return jnp.mean((img - target) ** 2)
        tr = scene.triangles
        return jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3)))(
            tr.v0, tr.v1, tr.v2, scene.materials.diffuse)

    (lp, gp), (lb, gb) = grads(cfg), grads(cfg.replace(intersector="bvh"))
    out = dict(loss_pallas=float(lp), loss_bvh=float(lb))
    for name, a, b in zip(("v0", "v1", "v2", "diffuse"), gp, gb):
        a, b = np.asarray(a), np.asarray(b)
        rel = float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
        out[name] = dict(norm=float(np.linalg.norm(a)), rel_diff=rel)
        log("gradient", f"d loss/d {name}: |g| {out[name]['norm']:.4g}, "
            f"finite {bool(np.isfinite(a).all())}, pallas vs bvh "
            f"relative difference {rel:.3g} (limit 1e-2)")
        assert np.isfinite(a).all() and out[name]["norm"] > 0.0, name
        assert rel < 1e-2, (name, rel)
    log("gradient", f"loss pallas {float(lp):.6g} bvh {float(lb):.6g}")
    assert abs(float(lp) - float(lb)) <= 1e-3 * abs(float(lb)), out
    return out


# ------------------------------------------------------------ four cards

def phase_four_cards(n_tris: int = HALL_TRIS, size: int = 1024,
                     bounces: int = 8, train_size: int = 256,
                     texture_resolution: int = 256) -> dict:
    """The sharded renderer and train step on a 1x4 mesh, each against
    the same computation on one card."""
    from prismarine_core_tpu.ops.sampling import make_sample_arrays
    from prismarine_core_tpu.parallel.mesh import (
        init_params, make_mesh, make_sharded_renderer, make_train_step)
    from prismarine_core_tpu.parallel.shard_intersect import (
        distribute_scene)
    from prismarine_core_tpu.render.integrator import render_with_samples
    devs = jax.devices()
    assert len(devs) >= 4, f"--four-cards needs 4 devices, {len(devs)}"
    mesh = make_mesh(4, model_parallel=4)
    scene = hall_scene(n_tris, textured=True,
                       texture_resolution=texture_resolution)
    camera = hall_camera()
    cfg = bench_config(size, size, bounces)
    cam_s, bounce_s = coherent_samples(cfg, seed=7)
    out = {}

    # one-card reference frame
    one = jax.device_put(scene, devs[0])
    ref = np.asarray(render_with_samples(one, camera, cfg, cam_s,
                                         bounce_s))
    dscene = distribute_scene(scene, mesh, shard_soup=True,
                              shard_textures=True)
    cfg_sh = cfg.replace(intersector="pallas_sharded", mesh=mesh)
    renderer = make_sharded_renderer(mesh, cfg_sh)
    t0 = time.perf_counter()
    img = np.asarray(renderer(dscene, camera, cam_s, bounce_s))
    diff = np.abs(img - ref)
    out["frame"] = dict(mean=float(img.mean()), ref_mean=float(ref.mean()),
                        mean_abs_diff=float(diff.mean()),
                        differing=float((diff.max(-1) > PIXEL_TOL).mean()))
    log("four", f"sharded {size}x{size}x{bounces}b frame over mesh "
        f"{dict(mesh.shape)} in {time.perf_counter() - t0:.1f} s "
        f"(incl. compile): mean {img.mean():.5f} vs one card "
        f"{ref.mean():.5f}; mean |diff| {diff.mean():.3g} (limit 1e-3), "
        f"pixels differing: {out['frame']['differing']:.3%} (limit 0.5%)")
    assert np.isfinite(img).all()
    assert out["frame"]["mean_abs_diff"] < 1e-3
    assert out["frame"]["differing"] < 0.005

    # per-device bytes
    leaves = [x for x in jax.tree_util.tree_leaves(dscene)
              if hasattr(x, "addressable_shards")]
    dev_b = sum(x.addressable_shards[0].data.nbytes for x in leaves)
    tot_b = sum(x.nbytes for x in leaves)
    planes = dscene.packets.planes
    tex = dscene.textures
    planes_dev = planes.addressable_shards[0].data.nbytes
    tex_dev = (tex.data.addressable_shards[0].data.nbytes
               + tex.quad.addressable_shards[0].data.nbytes)
    tex_tot = tex.data.nbytes + tex.quad.nbytes
    out["bytes"] = dict(scene_device=dev_b, scene_total=tot_b,
                        planes_device=planes_dev,
                        planes_total=planes.nbytes,
                        textures_device=tex_dev, textures_total=tex_tot)
    log("four", f"per-device bytes: planes {planes_dev} of "
        f"{planes.nbytes} (1/{planes.nbytes / planes_dev:.2f}), textures "
        f"{tex_dev} of {tex_tot} (1/{tex_tot / tex_dev:.2f}), whole scene "
        f"{dev_b} of {tot_b}")
    assert planes_dev * 4 <= planes.nbytes + 1024
    assert tex_dev * 4 <= tex_tot + 1024

    # one train step, sharded and on one card
    tcfg = bench_config(train_size, train_size, 2)
    tcam_s, tbounce_s = make_sample_arrays(jax.random.key(0), tcfg.n_rays,
                                           tcfg.max_bounces)
    losses = {}
    for name, m in (("four", mesh),
                    ("one", make_mesh(1, model_parallel=1,
                                      devices=devs[:1]))):
        c = tcfg.replace(intersector="pallas_sharded", mesh=m)
        s = distribute_scene(scene, m, shard_soup=False)
        target = make_sharded_renderer(m, c)(s, camera, tcam_s,
                                             tbounce_s) + 0.05
        params, loss = make_train_step(m, c)(init_params(s), s, camera,
                                             tcam_s, tbounce_s, target)
        jax.block_until_ready(params)
        losses[name] = float(loss)
        assert np.isfinite(losses[name])
    out["train"] = losses
    rel = abs(losses["four"] - losses["one"]) / abs(losses["one"])
    log("four", f"train step loss: four cards {losses['four']:.6g}, one "
        f"card {losses['one']:.6g} (relative difference {rel:.3g}, "
        f"limit 1e-3)")
    assert rel <= 1e-3, losses
    return out


def _cache_entries(path) -> int:
    return len(os.listdir(path)) if path and os.path.isdir(path) else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card sharded path")
    args = ap.parse_args(argv)

    from prismarine_core_tpu.utils.compile_cache import (
        configure_compile_cache)
    from prismarine_core_tpu.utils.device import (
        card_name_and_power_limit, require_gpu)

    dev = require_gpu()
    cache = configure_compile_cache()
    card = card_name_and_power_limit()
    log("device", f"{dev['kind']} x{dev['count']} ({dev['platform']}); "
        f"nvidia-smi: {card}; compile cache {cache} "
        f"({_cache_entries(cache)} entries at start)")

    if args.four_cards:
        phase_four_cards()
    else:
        scene = jax.device_put(hall_scene())
        camera = hall_camera()
        cfg = bench_config(1280, 720, 4)
        phase_kernels(scene, camera, cfg, card=card)
        phase_main_path(scene, camera, cfg, HALL_TRIS)
        phase_oracle()
        phase_gradient(scene, camera, bench_config(512, 512, 2))
    log("device", f"compile cache {cache}: {_cache_entries(cache)} "
        f"entries at the end")
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
