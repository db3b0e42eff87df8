"""The path-tracing integrator: a `lax.scan` over bounces with masked lanes.

This one module replaces the reference's whole wavefront kernel pipeline —
camera.comp, directTraverse.comp, surface.comp, rayshading.comp and the
ray-pool/counter machinery (``rayslib.glsl``, ``Pipeline.inl:325-359``).
There are no atomics and no dynamic queues: every ray occupies a fixed
lane for the full bounce budget; dead lanes are masked.  Radiance is
accumulated per-lane and reduced to pixels by a reshape-mean (the analog of
sampler.comp's color-chain walk, without linked lists).

Light transport model (behavioral parity with ``rayshading.comp:160-277``
and ``shadinglib.glsl``; divergences documented inline):

  * miss         -> radiance += beta * env(dir)            [env on miss]
  * surface      -> radiance += beta * emissive            [emissive add]
  * with prob (1 - alpha): pass through (alpha transmission coin,
    rayshading.comp:180)
  * else with prob spca = |specular color|: reflect with glossy
    perturbation, beta *= sc/spca (rayshading.comp:203,267)
  * else: cosine diffuse bounce, beta *= albedo (shadinglib diffuse())
  * NEE: one shadow ray toward sphere light 0 from the diffuse branch,
    weight = samplingWeight heuristic (shadinglib.glsl:50-52); sphere
    lights are visible *only* through these shadow rays (the reference
    gates its light test to type-2 rays, rayshading.comp:121-138).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from prismarine_core_tpu.models.camera import Camera, generate_rays
from prismarine_core_tpu.models.scene import Scene
from prismarine_core_tpu.models.textures import sample_bilinear
from prismarine_core_tpu.ops import sampling as smp
from prismarine_core_tpu.ops.intersect import (
    Hit, intersect_closest_brute, intersect_sphere, occluded_brute)
from prismarine_core_tpu.utils import math as pm
from prismarine_core_tpu.utils.config import GAP, INF_DIST, RenderConfig


def _pallas_kwargs(cfg: RenderConfig, any_hit: bool) -> dict:
    """Map RenderConfig's pallas knobs to _run_packet_pallas kwargs."""
    cull = (cfg.anyhit_cull_impl or cfg.cull_impl) if any_hit \
        else cfg.cull_impl
    kw = dict(cull_impl=cull, sort_mode=cfg.sort_mode,
              recull=cfg.recull,
              stale_round_masks=cfg.stale_round_masks,
              near_frac=cfg.near_frac)
    strat = cfg.anyhit_strategy if any_hit else cfg.closest_strategy
    k = cfg.anyhit_k if any_hit else cfg.closest_k
    if strat:
        kw["strategy"] = strat
    if k:
        kw["k_round"] = k
    return kw


def closest_hit(scene: Scene, o, d, cfg: RenderConfig,
                t_cap=None, with_order: bool = False, order=None,
                with_surface: bool = False):
    """Dispatch to the configured intersector.  ``t_cap`` lets callers
    zero out lanes whose result is unused (dead-lane compaction; only
    the pallas path exploits it today).  ``with_order=True`` returns
    (hit, order) where ``order`` is the pallas path's coherence sort,
    reusable by the same bounce's shadow query (None elsewhere);
    ``order`` passes a previous sort IN (cfg.reuse_bounce_order).
    ``with_surface``: additionally return the sharded path's carried
    surface-field dict (None on single-device paths, which gather from
    the local soup instead)."""
    def ret(hit, order=None, carried=None):
        if with_order and with_surface:
            return hit, order, carried
        return (hit, order) if with_order else hit

    if cfg.intersector == "brute":
        return ret(intersect_closest_brute(scene.triangles, o, d,
                                           block=cfg.tri_block))
    elif cfg.intersector == "bvh":
        from prismarine_core_tpu.accel.traverse import intersect_closest_bvh
        if scene.bvh is None:
            raise ValueError(
                "cfg.intersector='bvh' but scene.bvh is None — build it "
                "with scene.with_bvh() (Scene.assemble does by default)")
        return ret(intersect_closest_bvh(scene.bvh, scene.triangles,
                                         o, d, chunk=cfg.traverse_chunk,
                                         sort=cfg.sort_rays))
    elif cfg.intersector in ("packet", "pallas"):
        from prismarine_core_tpu.accel import packet as pk
        if scene.packets is None:
            raise ValueError("scene.packets is None — build with "
                             "scene.with_bvh()")
        if cfg.intersector == "pallas":
            hit, order = pk.intersect_closest_pallas(
                scene.bvh, scene.packets, scene.triangles, o, d,
                t_cap=t_cap, return_order=True, order=order,
                **_pallas_kwargs(cfg, any_hit=False))
            return ret(hit, order)
        return ret(pk.intersect_closest_packet(
            scene.bvh, scene.packets, scene.triangles, o, d))
    elif cfg.intersector == "pallas_sharded":
        from prismarine_core_tpu.parallel.shard_intersect import (
            sharded_intersect_closest)
        if cfg.mesh is None:
            raise ValueError("intersector='pallas_sharded' needs "
                             "cfg.mesh (jax.sharding.Mesh)")
        hit, carried, s_order = sharded_intersect_closest(
            cfg.mesh, scene.packets, o, d, t_cap=t_cap,
            return_surface=True, return_order=True,
            query_kw=_pallas_kwargs(cfg, any_hit=False))
        return ret(hit, order=s_order, carried=carried)
    raise ValueError(f"unknown intersector {cfg.intersector!r}")


def occluded(scene: Scene, o, d, t_max, cfg: RenderConfig, order=None):
    if cfg.intersector == "brute":
        return occluded_brute(scene.triangles, o, d, t_max,
                              block=cfg.tri_block)
    elif cfg.intersector == "bvh":
        from prismarine_core_tpu.accel.traverse import occluded_bvh
        if scene.bvh is None:
            raise ValueError(
                "cfg.intersector='bvh' but scene.bvh is None — build it "
                "with scene.with_bvh() (Scene.assemble does by default)")
        return occluded_bvh(scene.bvh, scene.triangles, o, d, t_max,
                            chunk=cfg.traverse_chunk, sort=cfg.sort_rays)
    elif cfg.intersector in ("packet", "pallas"):
        from prismarine_core_tpu.accel import packet as pk
        if scene.packets is None:
            raise ValueError("scene.packets is None — build with "
                             "scene.with_bvh()")
        if cfg.intersector == "pallas":
            return pk.occluded_pallas(scene.bvh, scene.packets,
                                      scene.triangles, o, d, t_max,
                                      order=order,
                                      **_pallas_kwargs(cfg,
                                                       any_hit=True))
        return pk.occluded_packet(scene.bvh, scene.packets,
                                  scene.triangles, o, d, t_max)
    elif cfg.intersector == "pallas_sharded":
        from prismarine_core_tpu.parallel.shard_intersect import (
            sharded_occluded)
        return sharded_occluded(cfg.mesh, scene.packets, o, d, t_max,
                                order=order,
                                query_kw=_pallas_kwargs(cfg,
                                                        any_hit=True))
    raise ValueError(f"unknown intersector {cfg.intersector!r}")


def _interpolate_surface(scene: Scene, hit: Hit, d,
                         cfg: RenderConfig | None = None,
                         carried: dict | None = None):
    """Gather + interpolate triangle attributes at the hit point.

    The analog of ``interpolateMeshData`` (``directTraverse.comp:116-180``)
    and the material resolve of ``surface.comp:102-195``.
    Returns dict of per-ray surface fields (garbage where hit.missed —
    callers mask).

    ``carried``: shard-local interpolated fields from the sharded
    query's min-reduce payload (ns/ng/tang/uv/mat_id) — used instead
    of gathering from scene.triangles, which under
    ``distribute_scene(shard_soup=True)`` is only a husk.
    """
    if cfg is not None and cfg.texture_filter == "bicubic":
        from prismarine_core_tpu.models.textures import sample_bicubic
        sample_tex = sample_bicubic
    else:
        sample_tex = sample_bilinear
    stub = bool(getattr(scene.textures, "stub", False))
    if carried is not None:
        ng = pm.normalize(carried["ng"])
        ns = pm.normalize(carried["ns"])
        ns = jnp.where(jnp.isfinite(ns).all(-1, keepdims=True), ns, ng)
        uv = carried["uv"]
        mat = scene.materials.lookup(carried["mat_id"])
        tang = pm.normalize(carried["tang"])
        tang = jnp.where(jnp.isfinite(tang).all(-1, keepdims=True),
                         tang, 0.0)
        albedo4 = mat.diffuse
        rough, metal = mat.specular[:, 1], mat.specular[:, 2]
        emissive = mat.emissive[:, :3]
        transm = mat.transmission[:, :3]
        ior = mat.ior
        texids = (mat.tex_diffuse, mat.tex_specular,
                  mat.tex_emissive, mat.tex_bump)
    else:
        tri = jnp.maximum(hit.tri, 0)
        soup = scene.triangles
        w = (1.0 - hit.u - hit.v)[:, None]
        uu = hit.u[:, None]
        vv = hit.v[:, None]

        # separate per-field gathers (XLA fuses them well; a packed
        # [T, 31] attribute-matrix row gather was slower on an earlier
        # device and has not been re-measured on the GPU)
        ns = pm.normalize(w * soup.n0[tri] + uu * soup.n1[tri]
                          + vv * soup.n2[tri])
        ng = pm.normalize(jnp.cross(soup.v1[tri] - soup.v0[tri],
                                    soup.v2[tri] - soup.v0[tri]))
        # Use the geometric normal where shading normals are degenerate.
        ns = jnp.where(jnp.isfinite(ns).all(-1, keepdims=True), ns, ng)

        mat = scene.materials.lookup(soup.mat_id[tri])
        albedo4 = mat.diffuse
        rough, metal = mat.specular[:, 1], mat.specular[:, 2]
        emissive = mat.emissive[:, :3]
        transm = mat.transmission[:, :3]
        ior = mat.ior
        texids = (mat.tex_diffuse, mat.tex_specular,
                  mat.tex_emissive, mat.tex_bump)

        # STATIC per-kind binding flags: a kind no material binds skips
        # its whole fetch+filter chain at trace time (texture ids are
        # traced arrays, so without this every chain's gathers execute
        # and get discarded by the blend `where`)
        kb = getattr(scene.materials, "kinds_bound", (True,) * 4)
        if stub:
            # uv and the tangent frame only feed texture fetches —
            # skipped on texture-less scenes (dict uv is zeros there)
            uv = jnp.zeros((tri.shape[0], 2), jnp.float32)
            tang = ns
        else:
            t0 = soup.t0[tri]
            t1 = soup.t1[tri]
            t2 = soup.t2[tri]
            uv = w * t0 + uu * t1 + vv * t2
            if kb[3]:   # the tangent frame only feeds normal mapping
                duv1 = t1 - t0
                duv2 = t2 - t0
                det_uv = (duv1[:, 0] * duv2[:, 1]
                          - duv1[:, 1] * duv2[:, 0])
                rdet = pm.safe_rcp(det_uv)[:, None]
                tang = pm.normalize(
                    ((soup.v1[tri] - soup.v0[tri]) * duv2[:, 1:2]
                     - (soup.v2[tri] - soup.v0[tri]) * duv1[:, 1:2])
                    * rdet)
            else:
                tang = ns

    if not stub:
        kb = getattr(scene.materials, "kinds_bound", (True,) * 4)
        tex_d, tex_s, tex_e, tex_b = texids
        if kb[3]:
            # Tangent-space normal mapping (surface.comp:121-163):
            # perturb the interpolated normal by the bump texture.
            has_btex = tex_b >= 0
            btex = sample_tex(scene.textures, tex_b, uv)
            bitan = jnp.cross(ns, tang)
            nt = btex[:, :3] * 2.0 - 1.0
            n_mapped = pm.normalize(
                tang * nt[:, 0:1] + bitan * nt[:, 1:2] + ns * nt[:, 2:3])
            ns = jnp.where(has_btex[:, None], n_mapped, ns)

        if kb[0]:
            has_tex = tex_d >= 0
            tex = sample_tex(scene.textures, tex_d, uv)
            albedo4 = jnp.where(has_tex[:, None], albedo4 * tex,
                                albedo4)

        if kb[2]:
            has_etex = tex_e >= 0
            etex = sample_tex(scene.textures, tex_e, uv)
            emissive = jnp.where(has_etex[:, None],
                                 emissive * etex[:, :3], emissive)

        if kb[1]:
            has_stex = tex_s >= 0
            stex = sample_tex(scene.textures, tex_s, uv)
            rough = jnp.where(has_stex, rough * stex[:, 1], rough)
            metal = jnp.where(has_stex, metal * stex[:, 2], metal)

    return dict(
        shading_normal=ns,
        geom_normal=ng,
        uv=uv,
        albedo=albedo4[:, :3],
        alpha=albedo4[:, 3],
        roughness=rough,
        metallic=metal,
        emissive=emissive,
        transmission=transm,
        ior=ior,
    )


def _nee_contribution(scene: Scene, cfg: RenderConfig, p, n, ns_raw,
                      diffuse_beta, u, order=None):
    """Next-event estimation toward one uniformly chosen sphere light.

    Mirrors ``directLight`` + ``applyLight`` (``shadinglib.glsl:75-93,
    181-189``): sample a point *inside* the light sphere, weight by the
    samplingWeight heuristic, gate on the un-faceforwarded normal, test
    occlusion against scene geometry vs the analytic sphere hit.
    Extends the reference (which only ever samples light 0,
    ``rayshading.comp:270``): with L lights one is chosen per sample
    from the reserved uniform and weighted by L (unbiased); L == 1
    reduces to the reference behavior exactly.
    """
    n_lights = scene.lights.count
    li = jnp.clip((u[:, smp.S_RESERVED] * n_lights).astype(jnp.int32),
                  0, n_lights - 1)
    center = scene.lights.center[li]
    radius = scene.lights.radius[li]
    lcolor = scene.lights.color[li] * float(n_lights)

    sphere_pt = center + radius[:, None] * smp.uniform_sphere(
        u[:, smp.S_LIGHT1], u[:, smp.S_LIGHT2])
    lpath = sphere_pt - p
    ldir = pm.normalize(lpath)
    dist = pm.length(center - p)
    weight = smp.light_sampling_weight(ldir, n, radius, dist)

    shadow_o = p + ldir * GAP
    t_light = intersect_sphere(shadow_o, ldir, center, radius + GAP)
    front = pm.dot(ns_raw, ldir) >= 0.0
    # Lanes with zero potential contribution get t_cap = 0: the packet
    # culling then produces no pairs for them, so the shadow query only
    # pays for lanes that matter (the compaction analog of the
    # reference's shadow rays being separate pool entries).
    need = front & (weight > 0.0) & (diffuse_beta > 0.0).any(-1)
    t_query = jnp.where(need, t_light, 0.0)
    occ = occluded(scene, shadow_o, ldir, t_query, cfg, order=order)
    vis = need & (~occ) & (t_light < INF_DIST)
    contrib = jnp.where(vis[:, None],
                        diffuse_beta * weight[:, None] * lcolor, 0.0)
    return contrib, jnp.sum(need.astype(jnp.int32))


def _env_nee_contribution(scene: Scene, cfg: RenderConfig, p, n,
                          diffuse_beta, u, order=None):
    """NEE toward the environment's bright texels with balance-heuristic
    MIS against the cosine bounce (cfg.env_nee).

    Samples the luminance distribution (textures.sample_env_direction),
    shadow-tests to infinity, and weights by pdf_env/(pdf_env+pdf_cos);
    the matching pdf_cos/(pdf_cos+pdf_env) factor is applied to the
    miss-shading env pickup of the NEXT bounce via the ``prev_pdf``
    carry, keeping the combined estimator unbiased.
    """
    from prismarine_core_tpu.models.textures import (env_pdf,
                                                     sample_env_direction)
    ldir, pdf_e = sample_env_direction(scene.environment,
                                       u[:, smp.S_ENV1], u[:, smp.S_ENV2])
    cos_l = pm.dot(ldir, n)
    pdf_c = jnp.maximum(cos_l, 0.0) / jnp.pi
    w_mis = pdf_e / jnp.maximum(pdf_e + pdf_c, 1e-20)
    # gate on the SAME faceforwarded normal the cosine lobe samples
    # around — the diffuse BSDF's hemisphere is n's, so pairing the MIS
    # strategies on any other frame would lose energy
    need = ((cos_l > 0.0) & (pdf_e > 0.0)
            & (diffuse_beta > 0.0).any(-1))
    shadow_o = p + ldir * GAP
    t_query = jnp.where(need, INF_DIST, 0.0)
    occ = occluded(scene, shadow_o, ldir, t_query, cfg, order=order)
    env_l = scene.environment.sample(ldir)
    # f/pdf for the lambertian: albedo/pi * cos / pdf_env, MIS-weighted
    fac = (cos_l / jnp.pi) / jnp.maximum(pdf_e, 1e-20) * w_mis
    contrib = jnp.where((need & ~occ)[:, None],
                        diffuse_beta * env_l * fac[:, None], 0.0)
    return contrib, jnp.sum(need.astype(jnp.int32))


def make_bounce_step(scene: Scene, cfg: RenderConfig,
                     fixed_order=None):
    """Build the per-bounce scan body (closure over static scene/config).

    ``fixed_order``: reuse a previous bounce's coherence permutation
    instead of re-sorting (cfg.reuse_bounce_order; see ``trace``)."""

    def step(carry, u):
        (o, d, beta, radiance, alive, prev_pdf,
         miss_dir, miss_beta, miss_pdf, bounce_i) = carry
        t_cap = jnp.where(alive, INF_DIST, 0.0)
        hit, order, carried = closest_hit(scene, o, d, cfg, t_cap=t_cap,
                                          with_order=True,
                                          order=fixed_order,
                                          with_surface=True)

        # DEFERRED env pickup: each lane misses at most once (a missed
        # lane is dead for good), so instead of fetching the env map on
        # every bounce for every lane (4 bilinear taps x bounces of
        # [R]-row gathers), record (direction, throughput, bsdf pdf) at
        # the miss and fetch ONCE after the scan.
        miss = alive & hit.missed
        miss_dir = jnp.where(miss[:, None], d, miss_dir)
        miss_beta = jnp.where(miss[:, None], beta, miss_beta)
        miss_pdf = jnp.where(miss, prev_pdf, miss_pdf)

        on_surf = alive & ~hit.missed
        surf = _interpolate_surface(scene, hit, d, cfg, carried=carried)
        p = o + hit.t[:, None] * d
        n = pm.faceforward(surf["shading_normal"], d)

        # Emissive pickup (rayshading.comp:206,273 — physically-correct
        # version: add beta * emissive, path continues).
        radiance = radiance + jnp.where(
            on_surf[:, None], beta * surf["emissive"], 0.0)

        # Specular color model (rayshading.comp:168-177).
        # |cos| floored at 1e-6: the fractional power's derivative is
        # infinite at 0, which would NaN gradients for grazing lanes.
        cosmag = jnp.clip(
            jnp.maximum(jnp.abs(pm.dot(d, n)), 1e-6) ** (cfg.ior - 1.0),
            0.0, 1.0)
        dielectric = pm.mix(jnp.ones_like(beta),
                            jnp.full_like(beta, 0.05), cosmag[:, None])
        sc = pm.mix(dielectric, surf["albedo"],
                    jnp.sqrt(jnp.clip(surf["metallic"], 0.0, 1.0))[:, None])
        spca = jnp.clip(pm.length(sc), 0.0, 1.0)

        # Branch coins.
        prom = 1.0 - surf["alpha"]
        pass_through = u[:, smp.S_ALPHA] < prom
        choose_spec = (~pass_through) & (u[:, smp.S_SPEC] < spca)
        choose_diff = (~pass_through) & (~choose_spec)

        # Continuation directions.
        cos_dir = smp.cosine_hemisphere(n, u[:, smp.S_COS1],
                                        u[:, smp.S_COS2])
        gloss = jnp.clip(surf["roughness"] * u[:, smp.S_GLOSS],
                         0.0, 1.0)[:, None]
        spec_dir = pm.normalize(
            pm.mix(pm.reflect(d, n), cos_dir, gloss))

        # Pass-through refracts through the interface (the reference's
        # refraction() constructor, shadinglib.glsl:150-176): eta from
        # entering/exiting the medium; with ior == 1 refract() reduces
        # exactly to the straight-through continuation.  Total internal
        # reflection falls back to the mirror direction.
        entering = pm.dot(d, surf["shading_normal"]) < 0.0
        eta = jnp.where(entering, 1.0 / surf["ior"], surf["ior"])
        refr = pm.refract(d, n, eta[:, None])
        tir = pm.dot(refr, refr) < 1e-12
        safe_refr = pm.normalize(
            jnp.where(tir[:, None], jnp.ones_like(refr), refr))
        pass_dir = jnp.where(tir[:, None], pm.reflect(d, n), safe_refr)
        trans_tint = jnp.where(
            (surf["transmission"] > 0.0).any(-1, keepdims=True),
            surf["transmission"], 1.0)

        new_d = jnp.where(pass_through[:, None], pass_dir,
                          jnp.where(choose_spec[:, None], spec_dir,
                                    cos_dir))
        branch_beta = jnp.where(
            pass_through[:, None], trans_tint,
            jnp.where(choose_spec[:, None],
                      jnp.clip(sc / jnp.maximum(spca, 1e-6)[:, None],
                               0.0, 1.0),
                      surf["albedo"]))
        new_beta = beta * branch_beta
        new_o = p + new_d * GAP

        # NEE from the diffuse branch (rayshading.comp:270-274).
        n_shadow = jnp.int32(0)
        diffuse_beta = jnp.where(
            (on_surf & choose_diff)[:, None], beta * surf["albedo"], 0.0)
        if cfg.direct_light and scene.lights.count > 0:
            nee, n_shadow = _nee_contribution(
                scene, cfg, p, n, surf["shading_normal"], diffuse_beta,
                u, order=order)
            radiance = radiance + nee
        if cfg.env_nee:
            env_nee, n_env_shadow = _env_nee_contribution(
                scene, cfg, p, n, diffuse_beta, u, order=order)
            radiance = radiance + env_nee
            n_shadow = n_shadow + n_env_shadow

        # Lane liveness: throughput cutoff (rayshading.comp:240).
        new_alive = on_surf & (pm.length(new_beta) > cfg.min_throughput)

        # Russian roulette (opt-in, beyond reference parity): from
        # bounce cfg.rr_start_bounce on, survive with probability
        # q = clamp(max channel of throughput, rr_min_q, 1) and
        # reweight survivors by 1/q — unbiased
        # (tests/test_transport.py::test_russian_roulette_unbiased).
        # Under coherent_bounce_sampling the coin is block-correlated
        # like every other branch coin: whole blocks retire together,
        # which the dead-lane sort turns into skipped kernel pairs.
        if cfg.rr_start_bounce > 0:
            q = jnp.clip(jnp.max(new_beta, axis=-1),
                         cfg.rr_min_q, 1.0)
            rr_on = bounce_i >= cfg.rr_start_bounce   # traced scalar
            survive = rr_on & (u[:, smp.S_RR] < q)
            keep = survive | ~rr_on
            new_alive = new_alive & keep
            new_beta = jnp.where(survive[:, None],
                                 new_beta / q[:, None], new_beta)

        # pdf of the chosen continuation direction under its strategy:
        # cosine pdf for diffuse lanes, 0 (delta) for specular /
        # pass-through — consumed by the next bounce's miss-side MIS.
        new_prev_pdf = jnp.where(
            choose_diff & on_surf,
            jnp.maximum(pm.dot(new_d, n), 0.0) / jnp.pi, 0.0)

        new_o = jnp.where(on_surf[:, None], new_o, o)
        new_d = jnp.where(on_surf[:, None], new_d, d)
        new_beta = jnp.where(on_surf[:, None], new_beta, beta)
        # per-bounce counters — the analog of the reference's arcounter
        # readbacks (Pipeline.inl:325-359), kept on device
        stats = jnp.stack([
            jnp.sum(alive.astype(jnp.int32)),      # lanes entering bounce
            jnp.sum(on_surf.astype(jnp.int32)),    # surface interactions
            jnp.sum(miss.astype(jnp.int32)),       # env terminations
            jnp.sum(new_alive.astype(jnp.int32)),  # survivors
            n_shadow,                              # NEE shadow lanes
        ])
        return ((new_o, new_d, new_beta, radiance, new_alive,
                 new_prev_pdf, miss_dir, miss_beta, miss_pdf,
                 bounce_i + 1), stats)

    return step


def _env_pickup(scene: Scene, cfg: RenderConfig, radiance,
                miss_dir, miss_beta, miss_pdf):
    """The deferred miss-shading env fetch: ONE bilinear lookup for all
    lanes after the bounce scan (miss_beta is zero for lanes that never
    missed).  Under cfg.env_nee the recorded bsdf pdf reconstructs the
    balance-heuristic MIS weight exactly as the per-bounce form did."""
    env = scene.environment.sample(miss_dir)
    if cfg.env_nee:
        from prismarine_core_tpu.models.textures import env_pdf
        pdf_e_d = env_pdf(scene.environment, miss_dir)
        w_miss = jnp.where(
            miss_pdf > 0.0,
            miss_pdf / jnp.maximum(miss_pdf + pdf_e_d, 1e-20), 1.0)
        env = env * w_miss[:, None]
    return radiance + miss_beta * env


def interlace_mask(cfg: RenderConfig, stage) -> jax.Array:
    """Checkerboard pixel mask for interlaced rendering
    (camera.comp:96: active when (x+y) % 2 != stage)."""
    x = jnp.arange(cfg.width)[None, :]
    y = jnp.arange(cfg.height)[:, None]
    return ((x + y) % 2) != (stage % 2)


def trace(scene: Scene, cfg: RenderConfig, o, d, bounce_samples,
          active=None):
    """Trace rays through ``cfg.max_bounces`` bounces.

    o, d: f32[R,3]; bounce_samples: f32[B,R,SAMPLES_PER_BOUNCE];
    ``active`` optionally
    masks lanes off from the start (interlacing).
    Returns radiance f32[R,3].
    """
    r = o.shape[0]
    init = (
        o, d,
        jnp.ones((r, 3), jnp.float32),
        jnp.zeros((r, 3), jnp.float32),
        jnp.ones((r,), bool) if active is None else active,
        jnp.zeros((r,), jnp.float32),   # prev_pdf: primary rays = delta
        jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (r, 3)),  # miss d
        jnp.zeros((r, 3), jnp.float32),                   # miss beta
        jnp.zeros((r,), jnp.float32),                     # miss bsdf pdf
        jnp.int32(0),                                     # bounce index
    )
    from prismarine_core_tpu.models.camera import tile_order_active
    is_pallas = cfg.intersector == "pallas"
    primary_ident = (cfg.primary_identity
                     or tile_order_active(cfg)) and is_pallas
    if is_pallas and (cfg.reuse_bounce_order or primary_ident):
        # Peel bounce 0 out of the scan.  With ``primary_identity`` it
        # runs in scanline (identity) order — camera rays are already
        # tile-coherent, so the u32 key sort AND the 64-byte-row
        # gather are skipped once per frame.  With
        # ``reuse_bounce_order`` its coherence permutation is reused
        # by every later bounce (bounce origins are the previous hits,
        # so spatial coherence persists; with
        # coherent_bounce_sampling, directions and branch coins stay
        # block-correlated too), saving one 921k-key u32 sort per
        # later bounce.
        step0 = make_bounce_step(
            scene, cfg, fixed_order="identity" if primary_ident
            else None)
        carry, stats0 = step0(init, bounce_samples[0])
        if bounce_samples.shape[0] > 1:
            if cfg.reuse_bounce_order:
                o0, d0, *_ = carry
                from prismarine_core_tpu.accel import packet as pk
                _, _, _, order0, _ = pk._sort_pad_rays(
                    scene.bvh.lo[0], scene.bvh.hi[0],
                    jax.lax.stop_gradient(o0),
                    jax.lax.stop_gradient(d0),
                    jnp.ones((r,)), mode=cfg.sort_mode)
                step_rest = make_bounce_step(scene, cfg,
                                             fixed_order=order0)
            else:
                step_rest = make_bounce_step(scene, cfg)
            carry, stats_rest = jax.lax.scan(
                step_rest, carry, bounce_samples[1:])
            stats = jnp.concatenate([stats0[None], stats_rest])
        else:
            stats = stats0[None]
        (_, _, _, radiance, _, _, miss_dir, miss_beta, miss_pdf,
         _) = carry
        radiance = _env_pickup(scene, cfg, radiance, miss_dir,
                               miss_beta, miss_pdf)
        return radiance, stats
    step = make_bounce_step(scene, cfg)
    carry, stats = jax.lax.scan(step, init, bounce_samples)
    (_, _, _, radiance, _, _, miss_dir, miss_beta, miss_pdf,
     _) = carry
    radiance = _env_pickup(scene, cfg, radiance, miss_dir,
                           miss_beta, miss_pdf)
    return radiance, stats


def trace_radiance(scene, cfg, o, d, bounce_samples, active=None):
    return trace(scene, cfg, o, d, bounce_samples, active)[0]


@partial(jax.jit, static_argnames=("cfg", "with_stats"))
def render_with_samples(
    scene: Scene, camera: Camera, cfg: RenderConfig,
    cam_samples, bounce_samples, interlace_stage=0,
    with_stats: bool = False,
):
    """Deterministic render given explicit uniforms.

    Returns linear-HDR image f32[H,W,3] (mean over spp); the functional
    analog of one full frame of ``Viewer.cpp:284-315``.  With
    ``cfg.interlace``, pixels of the inactive checkerboard parity come
    back zero (the progressive pipeline tracks per-pixel weights).
    ``with_stats=True`` additionally returns i32[bounces, 5] per-bounce
    lane counters [entering, surface, env-miss, surviving, NEE-shadow].
    """
    from prismarine_core_tpu.models.camera import (tile_order_active,
                                                   tile_pixel_inv_perm,
                                                   tile_pixel_perm)
    tile_order = tile_order_active(cfg)
    o, d = generate_rays(camera, cfg, cam_samples)
    active = None
    if cfg.interlace:
        mask = interlace_mask(cfg, interlace_stage).reshape(-1)
        if tile_order:
            mask = mask[tile_pixel_perm(cfg)]
        active = jnp.tile(mask, cfg.spp)
    radiance, stats = trace(scene, cfg, o, d, bounce_samples,
                            active=active)
    if tile_order:
        # lanes ran in 16x8-pixel-tile order; ONE gather restores
        # pixel (scanline) order before the image reshape
        radiance = radiance.reshape(
            cfg.spp, -1, 3)[:, tile_pixel_inv_perm(cfg), :]
    img = radiance.reshape(cfg.spp, cfg.height, cfg.width, 3)
    img = jnp.mean(img, axis=0)
    if with_stats:
        return img, stats
    return img


def render(scene: Scene, camera: Camera, cfg: RenderConfig,
           key: jax.Array, interlace_stage=0) -> jax.Array:
    """Convenience wrapper: generate the frame's sample arrays from a
    threefry key and render."""
    if cfg.coherent_bounce_sampling:
        cam, bounce = smp.make_coherent_sample_arrays(key, cfg)
    else:
        cam, bounce = smp.make_sample_arrays(key, cfg.n_rays,
                                             cfg.max_bounces)
    return render_with_samples(scene, camera, cfg, cam, bounce,
                               interlace_stage)
