"""Edge-sampled visibility (boundary) gradients for primary rays.

The detached-visibility estimator (``accel/traverse.py``) differentiates
the *interior* term of the rendering integral only: the discrete hit id
is frozen, so a silhouette sweeping across pixels has an identically-zero
derivative.  This module adds the missing *boundary* term — the north
star of BASELINE.json ("reparameterized/edge-aware gradients",
SURVEY.md §7 hard-part 3; the CUDA/GLSL reference has no differentiable
rendering at all, so there is no reference file to cite for parity).

Method (edge sampling, re-derived for dense array programs):

  dI_j/dtheta = interior (autodiff through detached visibility)
              + sum_edges  INT_edge (L^- - L^+) (n_perp . dm/dtheta) dl

where the integral runs over the *screen-space projection* of every
triangle edge, ``m`` is the (differentiable) screen position of an edge
point, ``n_perp`` a unit normal of the projected edge, and ``L^+/-`` the
radiance just off either side.  Three design choices that keep it
dense and fixed-shape:

1. **No silhouette detection.**  All ``3T`` soup edges are candidates;
   for interior (shared, front-facing) or fully-occluded edges the two
   offset rays land on the same surface, so ``L^- - L^+`` ~ 0 and the
   contribution vanishes automatically.  This removes the reference-less
   adjacency analysis entirely and keeps every shape static.
2. **Length-proportional importance sampling** with a fixed budget ``B``:
   one cumsum over stop-gradiented screen lengths, ``B`` stratified
   inverse-CDF draws (``searchsorted``), so cost is O(B) radiance pairs
   regardless of edge count — no data-dependent shapes.
3. **Value-zero gradient attachment**: each sample contributes
   ``w * (phi - stop_grad(phi))`` with ``w = sg[(L^- - L^+) * total/B]``
   and ``phi = n_perp . m(theta)``; the forward image is bit-identical
   to the primal render while reverse mode accumulates the boundary
   term into vertex (and camera) gradients.

Both offset rays share one path-sample row, so the radiance difference
is a *correlated* estimate — interior edges cancel exactly, not just in
expectation.

Limitations (documented divergences): pinhole perspective only (no DOF /
360 reparameterization), primary visibility only (secondary/shadow
silhouettes still use the detached estimator), edges crossing the
near plane are skipped.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from prismarine_core_tpu.models.camera import Camera
from prismarine_core_tpu.models.scene import Scene
from prismarine_core_tpu.utils import math as pm
from prismarine_core_tpu.utils.config import (
    RenderConfig, SAMPLES_PER_BOUNCE)

sg = jax.lax.stop_gradient

#: screen-space half-offset (pixels) between the two side rays.  Any
#: delta > projection round-off works geometrically (the projected edge
#: is exactly straight); small keeps L^+/- representative of the limit.
EDGE_DELTA_PX = 0.03

_NEAR = 1e-4


def project_to_screen(camera: Camera, cfg: RenderConfig, p: jax.Array
                      ) -> Tuple[jax.Array, jax.Array]:
    """Perspective-project world points f32[...,3] to continuous pixel
    coordinates f32[...,2] (origin top-left, +y down — the exact inverse
    of ``generate_rays``'s pinhole branch).  Also returns the camera-z
    f32[...] for near-plane masking."""
    fwd, right, cup = camera.basis()
    rel = p - camera.eye
    z = jnp.einsum("...k,k->...", rel, fwd)
    x = jnp.einsum("...k,k->...", rel, right)
    y = jnp.einsum("...k,k->...", rel, cup)
    zs = jnp.where(jnp.abs(z) < _NEAR, _NEAR, z)
    tan_half = jnp.tan(camera.fov_y * 0.5)
    aspect = cfg.width / cfg.height
    sx = x / (zs * tan_half * aspect)
    sy = y / (zs * tan_half)
    px = (sx + 1.0) * 0.5 * cfg.width
    py = (1.0 - sy) * 0.5 * cfg.height
    return jnp.stack([px, py], axis=-1), z


def rays_through_screen(camera: Camera, cfg: RenderConfig, s: jax.Array
                        ) -> Tuple[jax.Array, jax.Array]:
    """Pinhole rays through arbitrary float pixel coords s f32[N,2]."""
    u = s[:, 0] / cfg.width
    v = s[:, 1] / cfg.height
    fwd, right, cup = camera.basis()
    tan_half = jnp.tan(camera.fov_y * 0.5)
    aspect = cfg.width / cfg.height
    sx = (u * 2.0 - 1.0) * tan_half * aspect
    sy = (1.0 - v * 2.0) * tan_half
    d = pm.normalize(fwd + sx[:, None] * right + sy[:, None] * cup)
    o = jnp.broadcast_to(camera.eye, d.shape)
    return o, d


def make_edge_sample_arrays(key: jax.Array, n_edge_samples: int,
                            max_bounces: int):
    """Uniforms for one boundary-term evaluation:
    (edge_u f32[B] stratified in [0,1), bounce f32[max_bounces,B,8])."""
    k1, k2 = jax.random.split(key)
    strata = (jnp.arange(n_edge_samples, dtype=jnp.float32)
              + jax.random.uniform(k1, (n_edge_samples,)))
    edge_u = strata / n_edge_samples
    bounce = jax.random.uniform(
        k2, (max_bounces, n_edge_samples, SAMPLES_PER_BOUNCE))
    return edge_u, bounce


def _edge_multiplicity(ea, eb, evalid):
    """i32[E] — how many directed edges in the list share each edge's
    unordered endpoint pair.

    On a watertight mesh every silhouette edge appears once per adjacent
    triangle; reversing direction flips both n_perp and (L^- - L^+), so
    the copies ADD rather than cancel — without the 1/multiplicity
    weight the boundary gradient of any shared edge is exactly 2x.
    Exact duplicate counting via a 6-key lexicographic sort (shared
    vertices in a soup are bitwise-equal copies of the same source
    vertex).  Invalid (padding) edges are keyed to +big so they only
    collide with each other.
    """
    n = ea.shape[0]
    swap = ((ea[:, 0] > eb[:, 0])
            | ((ea[:, 0] == eb[:, 0]) & (ea[:, 1] > eb[:, 1]))
            | ((ea[:, 0] == eb[:, 0]) & (ea[:, 1] == eb[:, 1])
               & (ea[:, 2] > eb[:, 2])))
    lo = jnp.where(swap[:, None], eb, ea)
    hi = jnp.where(swap[:, None], ea, eb)
    big = jnp.float32(3.0e38)
    lo = jnp.where(evalid[:, None], lo, big)
    hi = jnp.where(evalid[:, None], hi, big)
    cols = (lo[:, 0], lo[:, 1], lo[:, 2], hi[:, 0], hi[:, 1], hi[:, 2])
    iota = jnp.arange(n, dtype=jnp.int32)
    *k, order = jax.lax.sort(cols + (iota,), num_keys=6)
    k = jnp.stack(k, axis=-1)                                   # [E,6]
    new_run = jnp.concatenate(
        [jnp.ones((1,), bool), (k[1:] != k[:-1]).any(-1)])
    run_id = jnp.cumsum(new_run.astype(jnp.int32)) - 1
    counts = jnp.zeros((n,), jnp.int32).at[run_id].add(1)
    mult_sorted = counts[run_id]
    return jnp.zeros((n,), jnp.int32).at[order].set(mult_sorted)


def _clip_to_rect(sa, seg, w, h, pad_px=1.0):
    """Liang–Barsky: param range [t0, t1] of each screen segment inside
    the pad-expanded image rectangle (t1 < t0 => fully outside).

    Keeps near-plane-grazing edges — whose projections can be enormous
    — from dominating the length CDF while contributing only
    off-screen (zeroed) samples."""
    t0 = jnp.zeros(sa.shape[0], jnp.float32)
    t1 = jnp.ones(sa.shape[0], jnp.float32)
    for axis, lo_b, hi_b in ((0, -pad_px, w + pad_px),
                             (1, -pad_px, h + pad_px)):
        d = seg[:, axis]
        a = sa[:, axis]
        safe = jnp.where(jnp.abs(d) < 1e-9, 1e-9, d)
        c1 = (lo_b - a) / safe
        c2 = (hi_b - a) / safe
        tlo = jnp.minimum(c1, c2)
        thi = jnp.maximum(c1, c2)
        para = jnp.abs(d) < 1e-9
        inside = (a >= lo_b) & (a <= hi_b)
        tlo = jnp.where(para, jnp.where(inside, 0.0, 1.0), tlo)
        thi = jnp.where(para, jnp.where(inside, 1.0, 0.0), thi)
        t0 = jnp.maximum(t0, tlo)
        t1 = jnp.minimum(t1, thi)
    return jnp.clip(t0, 0.0, 1.0), jnp.clip(t1, 0.0, 1.0)


def edge_boundary_image(scene: Scene, camera: Camera, cfg: RenderConfig,
                        edge_u: jax.Array, bounce_samples: jax.Array,
                        delta_px: float = EDGE_DELTA_PX) -> jax.Array:
    """Value-zero f32[H,W,3] image carrying the boundary-term gradient.

    Add it to any primal render of the same (scene, camera, cfg): the
    sum's value is unchanged; its reverse-mode gradient gains the
    silhouette term.  ``edge_u``: f32[B] stratified uniforms selecting
    points on the global edge-length CDF; ``bounce_samples``:
    f32[bounces,B,8] path uniforms shared by both side rays.
    """
    assert not cfg.camera_360 and not cfg.dof, (
        "boundary term supports the pinhole perspective camera only")
    assert not cfg.interlace, (
        "boundary term is inconsistent with interlaced primal renders "
        "(gradient would splat onto masked-off parity pixels)")
    from prismarine_core_tpu.render.integrator import trace_radiance

    soup = scene.triangles
    B = edge_u.shape[0]

    # --- all 3T directed edges of the soup -------------------------------
    ea = jnp.concatenate([soup.v0, soup.v1, soup.v2], axis=0)   # [3T,3]
    eb = jnp.concatenate([soup.v1, soup.v2, soup.v0], axis=0)
    evalid = jnp.concatenate([soup.valid] * 3, axis=0)
    mult = sg(_edge_multiplicity(sg(ea), sg(eb), evalid))       # [3T]

    sa, za = project_to_screen(camera, cfg, ea)                 # [3T,2]
    sb, zb = project_to_screen(camera, cfg, eb)
    in_front = (za > _NEAR) & (zb > _NEAR)

    seg = sb - sa
    # clip each projected segment to the padded image rect so huge
    # near-plane projections don't starve real silhouettes of samples
    tc0, tc1 = _clip_to_rect(sg(sa), sg(seg), cfg.width, cfg.height)
    on_screen = tc1 > tc0
    use = evalid & in_front & on_screen

    length = jnp.linalg.norm(seg, axis=-1)                      # [3T]
    clip_frac = sg(jnp.maximum(tc1 - tc0, 0.0))
    # CDF weight: visible screen length, split across duplicate copies
    w_len = sg(jnp.where(use,
                         length * clip_frac
                         / jnp.maximum(mult, 1).astype(jnp.float32),
                         0.0))

    # --- length-proportional stratified draws ----------------------------
    cdf = jnp.cumsum(w_len)
    total = cdf[-1]
    targets = edge_u * total                                    # [B]
    idx = jnp.searchsorted(cdf, targets, side="right")
    idx = jnp.clip(idx, 0, w_len.shape[0] - 1)
    prev = jnp.where(idx > 0, cdf[jnp.maximum(idx - 1, 0)], 0.0)
    lsel = jnp.maximum(w_len[idx], 1e-12)
    # map the draw back to the unclipped [0,1] edge parameterization
    frac_c = sg(jnp.clip((targets - prev) / lsel, 0.0, 1.0))    # [B]
    frac = sg(tc0[idx] + frac_c * (tc1[idx] - tc0[idx]))

    # differentiable screen position of each sampled edge point
    m = sa[idx] + frac[:, None] * seg[idx]                      # [B,2]
    e_hat = sg(seg[idx] / jnp.maximum(length[idx], 1e-12)[:, None])
    n_perp = jnp.stack([-e_hat[:, 1], e_hat[:, 0]], axis=-1)    # [B,2]

    # --- radiance just off both sides (fully detached) -------------------
    m_sg = sg(m)
    s_plus = m_sg + delta_px * n_perp
    s_minus = m_sg - delta_px * n_perp
    scene_sg = sg(scene)
    cam_sg = sg(camera)
    o_p, d_p = rays_through_screen(cam_sg, cfg, s_plus)
    o_m, d_m = rays_through_screen(cam_sg, cfg, s_minus)
    bs = sg(bounce_samples)
    L_p = trace_radiance(scene_sg, cfg, o_p, d_p, bs)           # [B,3]
    L_m = trace_radiance(scene_sg, cfg, o_m, d_m, bs)

    # --- assemble + splat ------------------------------------------------
    pix = jnp.floor(m_sg).astype(jnp.int32)
    in_img = ((pix[:, 0] >= 0) & (pix[:, 0] < cfg.width)
              & (pix[:, 1] >= 0) & (pix[:, 1] < cfg.height)
              & (total > 0.0) & (w_len[idx] > 0.0))
    weight = sg((L_m - L_p) * (total / B)
                * in_img[:, None].astype(jnp.float32))          # [B,3]

    phi = jnp.einsum("bk,bk->b", n_perp, m)                     # [B]
    contrib = weight * (phi - sg(phi))[:, None]                 # [B,3]

    flat = jnp.zeros((cfg.height * cfg.width, 3), jnp.float32)
    lin = jnp.clip(pix[:, 1], 0, cfg.height - 1) * cfg.width \
        + jnp.clip(pix[:, 0], 0, cfg.width - 1)
    flat = flat.at[lin].add(contrib, mode="drop")
    return flat.reshape(cfg.height, cfg.width, 3)


def env_sun_params(env, frac: float = 0.25):
    """(sun direction f32[3], integrated radiance f32[3]) of the env
    map's bright region: texels with luminance >= frac * max form the
    "sun disc"; direction is their luminance-weighted mean, power the
    solid-angle integral of their radiance.  The directional analog of
    treating a sphere light as its center (exact as the disc shrinks).
    """
    h, w, _ = env.image.shape
    rgb = env.image * env.scale
    lum = jnp.maximum(jnp.einsum("hwc,c->hw", rgb,
                                 jnp.asarray([0.2126, 0.7152, 0.0722])),
                      0.0)
    sun = lum >= frac * jnp.max(lum)
    theta = ((jnp.arange(h, dtype=jnp.float32) + 0.5) / h * jnp.pi)
    phi = ((jnp.arange(w, dtype=jnp.float32) + 0.5) / w - 0.5) \
        * (2.0 * jnp.pi)
    sin_t = jnp.sin(theta)
    # equirect texel solid angle (matches textures.sample_env_direction)
    domega = (2.0 * jnp.pi ** 2 / (h * w)) * sin_t[:, None]      # [h,1]
    dirs = jnp.stack(
        [sin_t[:, None] * jnp.cos(phi)[None, :],
         jnp.cos(theta)[:, None] * jnp.ones((1, w)),
         sin_t[:, None] * jnp.sin(phi)[None, :]], axis=-1)       # [h,w,3]
    wgt = jnp.where(sun, lum * domega, 0.0)
    s = pm.normalize(jnp.einsum("hwc,hw->c", dirs, wgt)[None, :])[0]
    power = jnp.einsum("hwc,hw->c", rgb, jnp.where(sun, domega, 0.0))
    return s, power


def shadow_boundary_image(scene: Scene, camera: Camera,
                          cfg: RenderConfig, edge_u: jax.Array,
                          delta_px: float = 0.75,
                          light_index: int = 0,
                          light_u: jax.Array | None = None
                          ) -> jax.Array:
    """Value-zero f32[H,W,3] image carrying the SHADOW-silhouette
    boundary gradient: the derivative of NEE visibility w.r.t. a
    blocker's vertices (VERDICT r2 item 6 — the cast-shadow term the
    primary-edge attachment cannot see, because the blocker's screen
    silhouette may not move at all).

    Method (light-space edge sampling, same estimator family as
    ``edge_boundary_image``): sample points z on blocker edges
    (3D-length CDF, 1/multiplicity), project each from the light CENTER
    onto the receiver surface behind it (one detached closest-hit), and
    attach a value-zero term at the screen projection m_s(theta) of the
    shadow-curve point — differentiable through z and the light
    center.  The radiance jump across the shadow curve is probed
    explicitly: two receiver-plane points just off either side of the
    curve are shadow-tested toward the light, so interior edges
    (both sides blocked), multi-blocker overlaps, and orientation all
    resolve from visibility (V^- - V^+ in {-1,0,+1}); the jump
    magnitude is the receiver's expected NEE contribution
    P(diffuse) * albedo * weight * lightcolor, evaluated with the
    integrator's exact branch model (integrator.py:245-300).

    ``light_index`` selects the sphere light (callers sum the term over
    all lights — render_with_edge_gradients does).  ``light_u``
    (f32[B,2], optional): per-sample uniforms selecting a point ON the
    light sphere to project from; None projects from the center.
    Sampling the sphere matches the NEE estimator's own light-point
    sampling, so FAT lights (radius comparable to the blocker) get
    penumbra-averaged boundary gradients instead of a hard
    center-shadow (tests/test_edge_gradients.py fat-radius test).

    Documented approximations: primary receivers only (shadows seen
    through mirrors still use the detached estimator); the NEE jump
    magnitude is evaluated toward the light center.
    """
    from prismarine_core_tpu.ops.intersect import intersect_sphere
    from prismarine_core_tpu.ops.sampling import (light_sampling_weight,
                                                  uniform_sphere)
    from prismarine_core_tpu.render.integrator import (
        _interpolate_surface, closest_hit, occluded)
    from prismarine_core_tpu.utils.config import GAP, INF_DIST

    soup = scene.triangles
    B = edge_u.shape[0]
    c = scene.lights.center[light_index]
    radius = scene.lights.radius[light_index]
    # expected NEE contribution of THIS light: the integrator picks one
    # of L lights with prob 1/L and weights by L, so per-light
    # expectation is just its color (no count factor)
    lcolor = scene.lights.color[light_index]
    if light_u is None:
        lp = jnp.broadcast_to(c, (B, 3))
    else:
        lp = c + radius * uniform_sphere(light_u[:, 0], light_u[:, 1])

    # --- blocker edge selection: 3D length CDF, split across copies ---
    ea = jnp.concatenate([soup.v0, soup.v1, soup.v2], axis=0)   # [3T,3]
    eb = jnp.concatenate([soup.v1, soup.v2, soup.v0], axis=0)
    evalid = jnp.concatenate([soup.valid] * 3, axis=0)
    mult = sg(_edge_multiplicity(sg(ea), sg(eb), evalid))
    len3 = jnp.linalg.norm(eb - ea, axis=-1)
    w_len = sg(jnp.where(evalid, len3 / jnp.maximum(mult, 1), 0.0))

    cdf = jnp.cumsum(w_len)
    total = cdf[-1]
    targets = edge_u * total
    idx = jnp.clip(jnp.searchsorted(cdf, targets, side="right"),
                   0, w_len.shape[0] - 1)
    prev = jnp.where(idx > 0, cdf[jnp.maximum(idx - 1, 0)], 0.0)
    frac = sg(jnp.clip((targets - prev)
                       / jnp.maximum(w_len[idx], 1e-12), 0.0, 1.0))

    z = ea[idx] + frac[:, None] * (eb[idx] - ea[idx])            # [B,3]
    dz = z - lp                                                  # diff.
    dz_n = pm.normalize(sg(dz))

    # --- detached receiver behind the blocker -------------------------
    hit_r = closest_hit(scene, sg(z) + GAP * dz_n, dz_n, cfg)
    tri_r = hit_r.tri
    has_recv = tri_r >= 0
    trix = jnp.maximum(tri_r, 0)
    # frozen receiver plane
    p0 = sg(soup.v0[trix])
    n_r = sg(pm.normalize(jnp.cross(soup.v1[trix] - soup.v0[trix],
                                    soup.v2[trix] - soup.v0[trix])))
    denom = jnp.einsum("bk,bk->b", dz, n_r)
    denom = jnp.where(jnp.abs(denom) < 1e-9, 1e-9, denom)
    s_par = jnp.einsum("bk,bk->b", p0 - lp, n_r) / denom
    r_pt = lp + s_par[:, None] * dz                              # diff.
    behind = sg(s_par) > 1.0 + 1e-4   # receiver beyond the blocker

    # --- screen projection + curve tangent ----------------------------
    m_s, z_cam = project_to_screen(camera, cfg, r_pt)            # [B,2]
    # tangent via a second (detached) point a bit along the edge
    # (backward difference near t = 1; the boundary product is
    # invariant under the implied n_perp flip, as the visibility jump
    # flips with it)
    dt_ = 1e-3
    shift = sg(jnp.where(frac + dt_ <= 1.0, dt_, -dt_))
    z2 = sg(ea[idx] + (frac + shift)[:, None] * (eb[idx] - ea[idx]))
    lp_sg = sg(lp)
    s2 = jnp.einsum("bk,bk->b", p0 - lp_sg, n_r) \
        / jnp.where(jnp.abs(jnp.einsum("bk,bk->b", z2 - lp_sg,
                                       n_r)) < 1e-9,
                    1e-9, jnp.einsum("bk,bk->b", z2 - lp_sg, n_r))
    r2 = lp_sg + s2[:, None] * (z2 - lp_sg)
    m_s2, _ = project_to_screen(camera, cfg, sg(r2))
    dm = sg(m_s2 - m_s)
    dm_dt = jnp.linalg.norm(dm, axis=-1) / dt_
    e_hat = dm / jnp.maximum(jnp.linalg.norm(dm, axis=-1,
                                             keepdims=True), 1e-12)
    n_perp = jnp.stack([-e_hat[:, 1], e_hat[:, 0]], axis=-1)

    # --- camera visibility of the receiver point ----------------------
    # the receiver match accepts any COPLANAR hit near the projected
    # distance (not an exact tri-id match): shadow curves crossing a
    # mesh's interior edges land on the adjacent coplanar triangle for
    # ~half their samples, and an id-equality test silently dropped
    # those terms (VERDICT r3 weak 5 — measured as a ~2x gradient loss
    # on a quad ground plane)
    m_sg = sg(m_s)
    o_cam, d_cam = rays_through_screen(sg(camera), cfg, m_sg)
    hit_cam = closest_hit(scene, o_cam, d_cam, cfg)
    same_pt = (jnp.abs(hit_cam.t - jnp.linalg.norm(sg(r_pt) - o_cam,
                                                   axis=-1))
               < 0.05 * jnp.maximum(hit_cam.t, 1.0))
    cam_pt = o_cam + sg(hit_cam.t)[:, None] * d_cam
    on_plane = (jnp.abs(jnp.einsum("bk,bk->b", cam_pt - p0, n_r))
                < 0.02 * jnp.maximum(sg(hit_cam.t), 1.0))
    cam_vis = ((hit_cam.tri >= 0) & same_pt & on_plane
               & (sg(z_cam) > _NEAR))

    # --- visibility probes on both sides of the shadow curve ----------
    def plane_point(spix):
        o_p, d_p = rays_through_screen(sg(camera), cfg, spix)
        dn = jnp.einsum("bk,bk->b", d_p, n_r)
        dn = jnp.where(jnp.abs(dn) < 1e-9, 1e-9, dn)
        tt = jnp.einsum("bk,bk->b", p0 - o_p, n_r) / dn
        return o_p + tt[:, None] * d_p

    def vis_at(pt):
        # probe toward the SAMPLED light point: the curve being probed
        # is that point's shadow curve
        ldir = pm.normalize(lp_sg - pt)
        t_l = intersect_sphere(pt + ldir * GAP, ldir, c[None, :],
                               radius + GAP)
        t_q = jnp.where(has_recv, t_l, 0.0)
        return ~occluded(scene, pt + ldir * GAP, ldir, t_q, cfg)

    v_plus = vis_at(plane_point(m_sg + delta_px * n_perp))
    v_minus = vis_at(plane_point(m_sg - delta_px * n_perp))
    jump = (v_minus.astype(jnp.float32)
            - v_plus.astype(jnp.float32))                        # [B]

    # --- expected NEE magnitude at the receiver -----------------------
    surf = _interpolate_surface(scene, hit_cam, d_cam, cfg)
    ns = surf["shading_normal"]
    n_ff = pm.faceforward(ns, d_cam)
    ldir_c = pm.normalize(c[None, :] - sg(r_pt))
    dist = pm.length(c[None, :] - sg(r_pt))
    w_light = light_sampling_weight(ldir_c, n_ff, radius, dist)
    front = pm.dot(ns, ldir_c) >= 0.0
    # branch model of integrator.step: P(diffuse) = alpha * (1 - spca)
    cosmag = jnp.clip(
        jnp.maximum(jnp.abs(pm.dot(d_cam, n_ff)), 1e-6)
        ** (cfg.ior - 1.0), 0.0, 1.0)
    dielectric = pm.mix(jnp.ones((B, 3)), jnp.full((B, 3), 0.05),
                        cosmag[:, None])
    sc = pm.mix(dielectric, surf["albedo"],
                jnp.sqrt(jnp.clip(surf["metallic"], 0.0, 1.0))[:, None])
    spca = jnp.clip(pm.length(sc), 0.0, 1.0)
    p_diff = surf["alpha"] * (1.0 - spca)
    f_nee = (surf["albedo"] * lcolor[None, :]
             * (p_diff * w_light * front)[:, None])              # [B,3]
    f_nee = jnp.where(jnp.isfinite(f_nee), f_nee, 0.0)

    # --- assemble + splat ---------------------------------------------
    pix = jnp.floor(m_sg).astype(jnp.int32)
    in_img = ((pix[:, 0] >= 0) & (pix[:, 0] < cfg.width)
              & (pix[:, 1] >= 0) & (pix[:, 1] < cfg.height))
    use = (has_recv & behind & cam_vis & in_img & (total > 0.0)
           & (w_len[idx] > 0.0))
    weight = sg(jump[:, None] * f_nee
                * (total * dm_dt / jnp.maximum(w_len[idx], 1e-12)
                   / B)[:, None]
                * use[:, None].astype(jnp.float32))              # [B,3]

    phi = jnp.einsum("bk,bk->b", n_perp, m_s)
    contrib = weight * (phi - sg(phi))[:, None]

    flat = jnp.zeros((cfg.height * cfg.width, 3), jnp.float32)
    lin = jnp.clip(pix[:, 1], 0, cfg.height - 1) * cfg.width \
        + jnp.clip(pix[:, 0], 0, cfg.width - 1)
    flat = flat.at[lin].add(contrib, mode="drop")
    return flat.reshape(cfg.height, cfg.width, 3)


def env_shadow_boundary_image(scene: Scene, camera: Camera,
                              cfg: RenderConfig, edge_u: jax.Array,
                              delta_px: float = 0.75,
                              sun_frac: float = 0.25) -> jax.Array:
    """Value-zero f32[H,W,3] image carrying the ENV-SUN cast-shadow
    boundary gradient (the directional counterpart of
    ``shadow_boundary_image``, VERDICT r3 item 4).

    Under cfg.env_nee the integrator importance-samples the environment
    map's bright texels; a blocker edge sweeping its sun shadow across
    a receiver moves radiance that the detached estimator cannot see.
    Directional projection is SIMPLER than the sphere case: blocker
    edge points z project along the fixed sun direction ``s``
    (env_sun_params) onto the frozen receiver plane,
    r(theta) = z(theta) - u * s — differentiable through z only.  The
    jump magnitude is the combined env estimator's expectation across
    the curve: albedo * P(diffuse) * cos(n, s)/pi * integrated sun
    radiance (the MIS weights of the two strategies sum to 1, so the
    TOTAL jump is MIS-free).

    Approximations (documented): the sun disc acts as its direction
    (exact as the disc shrinks — same family as the sphere-center
    limit), primary receivers only, the non-sun environment residual
    keeps the detached estimator.
    """
    from prismarine_core_tpu.render.integrator import (
        _interpolate_surface, closest_hit, occluded)
    from prismarine_core_tpu.utils.config import GAP, INF_DIST

    soup = scene.triangles
    B = edge_u.shape[0]
    s_sun, power = env_sun_params(scene.environment, frac=sun_frac)
    s_sun = sg(s_sun)
    power = sg(power)

    # --- blocker edge selection (same CDF as the sphere variant) ------
    ea = jnp.concatenate([soup.v0, soup.v1, soup.v2], axis=0)   # [3T,3]
    eb = jnp.concatenate([soup.v1, soup.v2, soup.v0], axis=0)
    evalid = jnp.concatenate([soup.valid] * 3, axis=0)
    mult = sg(_edge_multiplicity(sg(ea), sg(eb), evalid))
    len3 = jnp.linalg.norm(eb - ea, axis=-1)
    w_len = sg(jnp.where(evalid, len3 / jnp.maximum(mult, 1), 0.0))

    cdf = jnp.cumsum(w_len)
    total = cdf[-1]
    targets = edge_u * total
    idx = jnp.clip(jnp.searchsorted(cdf, targets, side="right"),
                   0, w_len.shape[0] - 1)
    prev = jnp.where(idx > 0, cdf[jnp.maximum(idx - 1, 0)], 0.0)
    frac = sg(jnp.clip((targets - prev)
                       / jnp.maximum(w_len[idx], 1e-12), 0.0, 1.0))

    z = ea[idx] + frac[:, None] * (eb[idx] - ea[idx])            # [B,3]
    away = -s_sun[None, :]                                       # [B?,3]

    # --- detached receiver along -s ----------------------------------
    hit_r = closest_hit(scene, sg(z) + GAP * away,
                        jnp.broadcast_to(away, (B, 3)), cfg)
    tri_r = hit_r.tri
    has_recv = tri_r >= 0
    trix = jnp.maximum(tri_r, 0)
    p0 = sg(soup.v0[trix])
    n_r = sg(pm.normalize(jnp.cross(soup.v1[trix] - soup.v0[trix],
                                    soup.v2[trix] - soup.v0[trix])))
    sn = jnp.einsum("bk,k->b", n_r, s_sun)
    sn = jnp.where(jnp.abs(sn) < 1e-9, 1e-9, sn)
    u_par = jnp.einsum("bk,bk->b", z - p0, n_r) / sn
    r_pt = z - u_par[:, None] * s_sun[None, :]                   # diff.
    in_front_of_sun = sg(u_par) > 1e-4   # receiver behind the blocker

    # --- screen projection + curve tangent ----------------------------
    m_s, z_cam = project_to_screen(camera, cfg, r_pt)            # [B,2]
    dt_ = 1e-3
    shift = sg(jnp.where(frac + dt_ <= 1.0, dt_, -dt_))
    z2 = sg(ea[idx] + (frac + shift)[:, None] * (eb[idx] - ea[idx]))
    u2_ = jnp.einsum("bk,bk->b", z2 - p0, n_r) / sn
    r2 = z2 - u2_[:, None] * s_sun[None, :]
    m_s2, _ = project_to_screen(camera, cfg, sg(r2))
    dm = sg(m_s2 - m_s)
    dm_dt = jnp.linalg.norm(dm, axis=-1) / dt_
    e_hat = dm / jnp.maximum(jnp.linalg.norm(dm, axis=-1,
                                             keepdims=True), 1e-12)
    n_perp = jnp.stack([-e_hat[:, 1], e_hat[:, 0]], axis=-1)

    # --- camera visibility of the receiver point ----------------------
    m_sg = sg(m_s)
    o_cam, d_cam = rays_through_screen(sg(camera), cfg, m_sg)
    hit_cam = closest_hit(scene, o_cam, d_cam, cfg)
    same_pt = (jnp.abs(hit_cam.t - jnp.linalg.norm(sg(r_pt) - o_cam,
                                                   axis=-1))
               < 0.05 * jnp.maximum(hit_cam.t, 1.0))
    # coplanar-receiver match, not tri-id equality (see the sphere
    # variant's comment — same VERDICT r3 weak-5 fix)
    cam_pt = o_cam + sg(hit_cam.t)[:, None] * d_cam
    on_plane = (jnp.abs(jnp.einsum("bk,bk->b", cam_pt - p0, n_r))
                < 0.02 * jnp.maximum(sg(hit_cam.t), 1.0))
    cam_vis = ((hit_cam.tri >= 0) & same_pt & on_plane
               & (sg(z_cam) > _NEAR))

    # --- visibility probes on both sides of the shadow curve ----------
    def plane_point(spix):
        o_p, d_p = rays_through_screen(sg(camera), cfg, spix)
        dn = jnp.einsum("bk,bk->b", d_p, n_r)
        dn = jnp.where(jnp.abs(dn) < 1e-9, 1e-9, dn)
        tt = jnp.einsum("bk,bk->b", p0 - o_p, n_r) / dn
        return o_p + tt[:, None] * d_p

    sdir = jnp.broadcast_to(s_sun, (B, 3))

    def vis_at(pt):
        t_q = jnp.where(has_recv, INF_DIST, 0.0)
        return ~occluded(scene, pt + sdir * GAP, sdir, t_q, cfg)

    v_plus = vis_at(plane_point(m_sg + delta_px * n_perp))
    v_minus = vis_at(plane_point(m_sg - delta_px * n_perp))
    jump = (v_minus.astype(jnp.float32)
            - v_plus.astype(jnp.float32))                        # [B]

    # --- expected env-NEE magnitude at the receiver -------------------
    surf = _interpolate_surface(scene, hit_cam, d_cam, cfg)
    ns = surf["shading_normal"]
    n_ff = pm.faceforward(ns, d_cam)
    cos_l = jnp.einsum("bk,k->b", n_ff, s_sun)
    front = cos_l > 0.0
    cosmag = jnp.clip(
        jnp.maximum(jnp.abs(pm.dot(d_cam, n_ff)), 1e-6)
        ** (cfg.ior - 1.0), 0.0, 1.0)
    dielectric = pm.mix(jnp.ones((B, 3)), jnp.full((B, 3), 0.05),
                        cosmag[:, None])
    sc = pm.mix(dielectric, surf["albedo"],
                jnp.sqrt(jnp.clip(surf["metallic"], 0.0, 1.0))[:, None])
    spca = jnp.clip(pm.length(sc), 0.0, 1.0)
    p_diff = surf["alpha"] * (1.0 - spca)
    f_sun = (surf["albedo"] * power[None, :]
             * (p_diff * jnp.maximum(cos_l, 0.0) / jnp.pi
                * front)[:, None])                               # [B,3]
    f_sun = jnp.where(jnp.isfinite(f_sun), f_sun, 0.0)

    # --- assemble + splat ---------------------------------------------
    pix = jnp.floor(m_sg).astype(jnp.int32)
    in_img = ((pix[:, 0] >= 0) & (pix[:, 0] < cfg.width)
              & (pix[:, 1] >= 0) & (pix[:, 1] < cfg.height))
    use = (has_recv & in_front_of_sun & cam_vis & in_img
           & (total > 0.0) & (w_len[idx] > 0.0))
    weight = sg(jump[:, None] * f_sun
                * (total * dm_dt / jnp.maximum(w_len[idx], 1e-12)
                   / B)[:, None]
                * use[:, None].astype(jnp.float32))              # [B,3]

    phi = jnp.einsum("bk,bk->b", n_perp, m_s)
    contrib = weight * (phi - sg(phi))[:, None]

    flat = jnp.zeros((cfg.height * cfg.width, 3), jnp.float32)
    lin = jnp.clip(pix[:, 1], 0, cfg.height - 1) * cfg.width \
        + jnp.clip(pix[:, 0], 0, cfg.width - 1)
    flat = flat.at[lin].add(contrib, mode="drop")
    return flat.reshape(cfg.height, cfg.width, 3)


@partial(jax.jit, static_argnames=("cfg", "shadow_term"))
def render_with_edge_gradients(scene: Scene, camera: Camera,
                               cfg: RenderConfig, cam_samples,
                               bounce_samples, edge_u,
                               edge_bounce_samples,
                               shadow_term: bool = False,
                               light_u=None):
    """Primal render + boundary-gradient attachment(s).

    Forward value == ``render_with_samples(...)`` exactly; reverse mode
    additionally differentiates silhouette motion w.r.t. vertex
    positions and camera parameters.  ``shadow_term=True`` adds the
    cast-shadow (NEE visibility) boundary terms: one per sphere light
    (``light_u`` f32[B,2] optionally samples the light spheres —
    penumbra-correct for fat lights) and, under cfg.env_nee, the
    env-sun directional term."""
    from prismarine_core_tpu.render.integrator import render_with_samples
    img = render_with_samples(scene, camera, cfg, cam_samples,
                              bounce_samples)
    img = img + edge_boundary_image(scene, camera, cfg, edge_u,
                                    edge_bounce_samples)
    if shadow_term:
        if cfg.direct_light:
            for li in range(scene.lights.count):
                img = img + shadow_boundary_image(
                    scene, camera, cfg, edge_u, light_index=li,
                    light_u=light_u)
        if cfg.env_nee:
            img = img + env_shadow_boundary_image(scene, camera, cfg,
                                                  edge_u)
    return img
