"""Packet intersector must agree with the brute-force intersector."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from prismarine_core_tpu.accel.lbvh import build_bvh
from prismarine_core_tpu.accel.packet import (
    build_packet_set, intersect_closest_packet, occluded_packet)
from prismarine_core_tpu.models.procedural import make_hall_scene
from prismarine_core_tpu.ops.intersect import (
    intersect_closest_brute, occluded_brute)
from test_bvh import _random_soup


def _rand_rays(r, seed=0, lo=-8, hi=8):
    rng = np.random.default_rng(seed)
    o = jnp.asarray(rng.uniform(lo, hi, (r, 3)).astype(np.float32))
    d = rng.normal(size=(r, 3)).astype(np.float32)
    d = jnp.asarray(d / np.linalg.norm(d, axis=-1, keepdims=True))
    return o, d


@pytest.mark.parametrize("n_tris,r", [(50, 64), (300, 512), (1000, 333)])
def test_packet_matches_brute(n_tris, r):
    soup = _random_soup(n_tris, capacity=n_tris + 7, seed=2)
    bvh = build_bvh(soup, leaf_size=4)
    ps = build_packet_set(bvh)
    o, d = _rand_rays(r, seed=1)

    hb = intersect_closest_brute(soup, o, d, block=64)
    hp = intersect_closest_packet(bvh, ps, soup, o, d)
    np.testing.assert_array_equal(np.asarray(hp.tri), np.asarray(hb.tri))
    m = np.asarray(hb.tri) >= 0
    np.testing.assert_allclose(np.asarray(hp.t)[m], np.asarray(hb.t)[m],
                               rtol=1e-5)


def test_packet_occlusion_matches_brute():
    soup = _random_soup(400, capacity=512, seed=4)
    bvh = build_bvh(soup, leaf_size=4)
    ps = build_packet_set(bvh)
    o, d = _rand_rays(300, seed=5)
    rng = np.random.default_rng(6)
    t_max = jnp.asarray(rng.uniform(0.5, 20, (300,)).astype(np.float32))
    ob = occluded_brute(soup, o, d, t_max, block=64)
    op = occluded_packet(bvh, ps, soup, o, d, t_max)
    np.testing.assert_array_equal(np.asarray(op), np.asarray(ob))


def test_packet_render_matches_bvh_render():
    from prismarine_core_tpu.models.camera import Camera
    from prismarine_core_tpu.ops.sampling import make_sample_arrays
    from prismarine_core_tpu.render.integrator import render_with_samples
    from prismarine_core_tpu.utils.config import RenderConfig

    scene = make_hall_scene(target_tris=3000)
    cam = Camera.look_at(eye=(-10.0, 2.2, 0.0), target=(6.0, 1.6, 0.0),
                         fov_y_deg=60.0)
    cfg_p = RenderConfig(width=32, height=24, spp=1, max_bounces=2,
                         intersector="packet")
    cfg_b = cfg_p.replace(intersector="bvh")
    cam_s, bounce_s = make_sample_arrays(
        jax.random.key(0), cfg_p.n_rays, cfg_p.max_bounces)
    ip = np.asarray(render_with_samples(scene, cam, cfg_p, cam_s,
                                        bounce_s))
    ib = np.asarray(render_with_samples(scene, cam, cfg_b, cam_s,
                                        bounce_s))
    diff = np.abs(ip - ib)
    assert (diff.max(axis=-1) > 1e-3).mean() < 0.005
    assert ip.mean() > 1e-2


def test_packet_gradients():
    soup = _random_soup(100, capacity=128, seed=8)
    bvh = build_bvh(soup, leaf_size=4)
    ps = build_packet_set(bvh)
    o, d = _rand_rays(64, seed=9)

    def f(v0):
        import dataclasses
        s2 = dataclasses.replace(soup, v0=v0)
        hit = intersect_closest_packet(bvh, ps, s2, o, d)
        return jnp.where(hit.tri >= 0, hit.t, 0.0).sum()

    g = jax.grad(f)(soup.v0)
    assert bool(jnp.isfinite(g).all())


@pytest.mark.parametrize("n_tris,r", [(300, 512), (1000, 200)])
def test_pallas_matches_brute(n_tris, r):
    from prismarine_core_tpu.accel.packet import (
        intersect_closest_pallas, occluded_pallas)
    soup = _random_soup(n_tris, capacity=n_tris + 5, seed=11)
    bvh = build_bvh(soup, leaf_size=4)
    ps = build_packet_set(bvh)
    o, d = _rand_rays(r, seed=12)

    hb = intersect_closest_brute(soup, o, d, block=64)
    hp = intersect_closest_pallas(bvh, ps, soup, o, d)
    np.testing.assert_array_equal(np.asarray(hp.tri), np.asarray(hb.tri))
    m = np.asarray(hb.tri) >= 0
    np.testing.assert_allclose(np.asarray(hp.t)[m], np.asarray(hb.t)[m],
                               rtol=1e-5)

    rng = np.random.default_rng(13)
    t_max = jnp.asarray(rng.uniform(0.5, 20, (r,)).astype(np.float32))
    ob = occluded_brute(soup, o, d, t_max, block=64)
    op = occluded_pallas(bvh, ps, soup, o, d, t_max)
    np.testing.assert_array_equal(np.asarray(op), np.asarray(ob))


def test_reuse_bounce_order_matches():
    """cfg.reuse_bounce_order reuses bounce 1's coherence permutation
    for later bounces; any permutation is valid (the min-reduce is
    order-independent), so images must match up to coplanar-edge
    tie-breaks."""
    import dataclasses

    import numpy as np

    from prismarine_core_tpu.models.camera import Camera
    from prismarine_core_tpu.models.scene import make_cornell_scene
    from prismarine_core_tpu.ops.sampling import make_sample_arrays
    from prismarine_core_tpu.render.integrator import render_with_samples
    from prismarine_core_tpu.utils.config import RenderConfig

    scene = make_cornell_scene()
    cam = Camera.look_at(eye=(0.0, 0.0, 3.4), target=(0.0, 0.0, 0.0),
                         fov_y_deg=50.0)
    cfg = RenderConfig(width=24, height=24, spp=1, max_bounces=3,
                       intersector="pallas")
    cam_s, bounce_s = make_sample_arrays(jax.random.key(0), cfg.n_rays,
                                         cfg.max_bounces)
    ref = np.asarray(render_with_samples(scene, cam, cfg, cam_s,
                                         bounce_s))
    cfg2 = dataclasses.replace(cfg, reuse_bounce_order=True)
    img = np.asarray(render_with_samples(scene, cam, cfg2, cam_s,
                                         bounce_s))
    np.testing.assert_allclose(img, ref, atol=1e-4)


@pytest.mark.parametrize("kw", [
    dict(cull_impl="xla"),
    dict(cull_impl="pallas", recull="tn"),
    dict(cull_impl="pallas", recull="kernel"),
    dict(cull_impl="pallas", sort_mode="packed"),
    dict(cull_impl="pallas", sort_mode="group"),
    dict(cull_impl="pallas", strategy="single"),
    dict(cull_impl="pallas", strategy="rounds", k_round=4),
    dict(cull_impl="xla", strategy="rounds", k_round=4),
    dict(cull_impl="pallas2"),
    dict(cull_impl="pallas2", strategy="single"),
    dict(cull_impl="pallas2", strategy="rounds", k_round=4),
    dict(cull_impl="pallas2", strategy="rounds", k_round=4,
         stale_round_masks=True),
    dict(cull_impl="pallas2", near_frac=0.4),
    dict(cull_impl="pallas2", order="identity"),
])
def test_pallas_variants_match_brute(kw):
    """Every cull/sort/strategy variant must produce identical hits:
    they all re-schedule the same exact tests (one- vs two-level cull;
    packed/group sorts are just different valid permutations)."""
    from prismarine_core_tpu.accel.packet import (
        intersect_closest_pallas, occluded_pallas)
    n_tris, r = 700, 2048   # r: group-sort needs >= 2048 rays
    soup = _random_soup(n_tris, capacity=n_tris + 9, seed=21)
    bvh = build_bvh(soup, leaf_size=4)
    ps = build_packet_set(bvh)
    o, d = _rand_rays(r, seed=22)

    hb = intersect_closest_brute(soup, o, d, block=64)
    hp = intersect_closest_pallas(bvh, ps, soup, o, d, **kw)
    np.testing.assert_array_equal(np.asarray(hp.tri), np.asarray(hb.tri))
    m = np.asarray(hb.tri) >= 0
    np.testing.assert_allclose(np.asarray(hp.t)[m], np.asarray(hb.t)[m],
                               rtol=1e-5)

    rng = np.random.default_rng(23)
    t_max = jnp.asarray(rng.uniform(0.5, 20, (r,)).astype(np.float32))
    ob = occluded_brute(soup, o, d, t_max, block=64)
    op = occluded_pallas(bvh, ps, soup, o, d, t_max, **kw)
    np.testing.assert_array_equal(np.asarray(op), np.asarray(ob))


def test_pallas_dead_lanes_culled():
    """Lanes with t_cap == 0 must produce no hits under every cull
    path (the live-tile-prefix bound must not clip live work)."""
    from prismarine_core_tpu.accel.packet import _run_packet_pallas
    soup = _random_soup(500, capacity=512, seed=31)
    bvh = build_bvh(soup, leaf_size=4)
    ps = build_packet_set(bvh)
    o, d = _rand_rays(1024, seed=32)
    rng = np.random.default_rng(33)
    alive = jnp.asarray(rng.random(1024) < 0.4)
    t_cap = jnp.where(alive, jnp.float32(1e4), 0.0)

    hb = intersect_closest_brute(soup, o, d, block=64)
    for impl in ("pallas", "pallas2", "xla"):
        t, slot, _ = _run_packet_pallas(
            bvh.lo[0], bvh.hi[0], ps, o, d, t_cap, cull_impl=impl)
        tri = np.where(np.asarray(slot) >= 0,
                       np.asarray(bvh.orig)[np.maximum(slot, 0)], -1)
        exp = np.where(np.asarray(alive), np.asarray(hb.tri), -1)
        np.testing.assert_array_equal(tri, exp)


def test_primary_identity_order_matches():
    """cfg.primary_identity traces bounce 0 in scanline (identity)
    order; any order is valid, so the image must match the sorted
    render exactly (up to coplanar-edge tie-breaks)."""
    import dataclasses

    from prismarine_core_tpu.models.camera import Camera
    from prismarine_core_tpu.models.scene import make_cornell_scene
    from prismarine_core_tpu.ops.sampling import make_sample_arrays
    from prismarine_core_tpu.render.integrator import render_with_samples
    from prismarine_core_tpu.utils.config import RenderConfig

    scene = make_cornell_scene()
    cam = Camera.look_at(eye=(0.0, 0.0, 3.4), target=(0.0, 0.0, 0.0),
                         fov_y_deg=50.0)
    for extra in (dict(), dict(cull_impl="pallas2"),
                  dict(max_bounces=1)):
        cfg = RenderConfig(width=24, height=24, spp=1,
                           intersector="pallas",
                           **{"max_bounces": 3, **extra})
        cam_s, bounce_s = make_sample_arrays(
            jax.random.key(0), cfg.n_rays, cfg.max_bounces)
        ref = np.asarray(render_with_samples(scene, cam, cfg, cam_s,
                                             bounce_s))
        cfg2 = dataclasses.replace(cfg, primary_identity=True)
        img = np.asarray(render_with_samples(scene, cam, cfg2, cam_s,
                                             bounce_s))
        np.testing.assert_allclose(img, ref, atol=1e-4)


def test_near_frac_round1_matches_brute():
    """Threshold-based round-1 selection (near_frac) must keep exact
    closest-hit results (it only changes execution ORDER)."""
    from prismarine_core_tpu.accel.packet import intersect_closest_pallas
    soup = _random_soup(800, capacity=1024, seed=51)
    bvh = build_bvh(soup, leaf_size=4)
    ps = build_packet_set(bvh)
    o, d = _rand_rays(1024, seed=52)
    hb = intersect_closest_brute(soup, o, d, block=64)
    for nf in (0.25, 0.5):
        hp = intersect_closest_pallas(bvh, ps, soup, o, d,
                                      near_frac=nf)
        np.testing.assert_array_equal(np.asarray(hp.tri),
                                      np.asarray(hb.tri))


def test_primary_tile_order_matches():
    """cfg.primary_tile_order regroups lanes into 16x8-pixel tiles and
    runs bounce 0 sort-free; with lane-constant samples the image must
    match the scanline render exactly (the remap only changes
    EXECUTION grouping, and the final unpermute restores pixels)."""
    import dataclasses

    from prismarine_core_tpu.models.camera import Camera
    from prismarine_core_tpu.models.scene import make_cornell_scene
    from prismarine_core_tpu.render.integrator import render_with_samples
    from prismarine_core_tpu.utils.config import RenderConfig

    scene = make_cornell_scene()
    cam = Camera.look_at(eye=(0.0, 0.0, 3.4), target=(0.0, 0.0, 0.0),
                         fov_y_deg=50.0)
    cfg = RenderConfig(width=32, height=24, spp=1, max_bounces=3,
                       intersector="pallas")
    cam_s = jnp.full((cfg.n_rays, 4), 0.5)
    bounce_s = jnp.full((cfg.max_bounces, cfg.n_rays, 11), 0.37)
    ref = np.asarray(render_with_samples(scene, cam, cfg, cam_s,
                                         bounce_s))
    cfg2 = dataclasses.replace(cfg, primary_tile_order=True)
    img = np.asarray(render_with_samples(scene, cam, cfg2, cam_s,
                                         bounce_s))
    np.testing.assert_allclose(img, ref, atol=1e-5)

    # coherent sampling path: block ids must follow the remap (smoke +
    # finite)
    from prismarine_core_tpu.ops.sampling import (
        make_coherent_sample_arrays)
    cfg3 = dataclasses.replace(cfg2, coherent_bounce_sampling=True)
    cs, bs = make_coherent_sample_arrays(jax.random.key(1), cfg3,
                                         block=(8, 16))
    img3 = np.asarray(render_with_samples(scene, cam, cfg3, cs, bs))
    assert np.isfinite(img3).all() and img3.mean() > 1e-2
