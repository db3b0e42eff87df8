"""Benchmark: rays/s on the sponza-class hall scene (720p, 4 bounces).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
The reference publishes no numbers (BASELINE.md) — vs_baseline is the
ratio against a fixed 100 Mrays/s figure that was never measured (a
guess at interactive RX-Vega-class wavefront tracing at 720p, the
reference's demonstrated config).  Runs on a GPU only: it prints the
device and the card's power limit first and exits non-zero without one.

Ray accounting is HONEST (live-lane counted): the integrator's
per-bounce counters report how many lanes actually entered each
closest-hit query and how many NEE shadow lanes were issued; dead /
terminated lanes are not counted (the r1 bench counted
n_rays * bounces * 2 regardless of liveness — an overcount).

Secondary configs (reported to stderr only, keeping the one-line stdout
contract): BASELINE config 2 (teapot-class OBJ at 512x512, flat
traversal scene) and the main hall WITH an equirect HDR sky through
``Environment.from_image`` (exercising the image-based envmap path at
bench scale).
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import jax

#: NOT a measurement: an RX-Vega-class guess (BASELINE.md) kept only as
#: the fixed denominator of ``vs_baseline``
REFERENCE_CLASS_RAYS_PER_S = 100e6


def _run_config(name, scene, camera, cfg, n_frames=3):
    import numpy as np

    from prismarine_core_tpu.ops.sampling import (
        make_coherent_sample_arrays, make_sample_arrays)
    from prismarine_core_tpu.render.integrator import render_with_samples

    if cfg.coherent_bounce_sampling:
        # 64x64 screen blocks (an earlier device's sweep; not re-swept
        # on the GPU)
        cam_s, bounce_s = make_coherent_sample_arrays(
            jax.random.key(0), cfg, block=(64, 64))
    else:
        cam_s, bounce_s = make_sample_arrays(
            jax.random.key(0), cfg.n_rays, cfg.max_bounces)

    t0 = time.perf_counter()
    img, stats = render_with_samples(scene, camera, cfg, cam_s, bounce_s,
                                     with_stats=True)
    mean = float(img.mean())
    compile_s = time.perf_counter() - t0
    assert bool(jax.numpy.isfinite(img).all()), "non-finite image"
    stats = np.asarray(stats)
    # honest ray count: live lanes entering each closest-hit query plus
    # issued NEE shadow lanes (lanes already span all spp planes —
    # cfg.n_rays = W*H*spp — so no spp factor)
    rays = int(stats[:, 0].sum() + stats[:, 4].sum())

    # Warm the EXACT timed callable: with_stats=False is a different jit
    # cache entry than the stats call above; without this the timed
    # loop's first iteration pays a full recompile.
    render_with_samples(scene, camera, cfg, cam_s, bounce_s
                        ).block_until_ready()

    t0 = time.perf_counter()
    for i in range(n_frames):
        render_with_samples(scene, camera, cfg, cam_s, bounce_s
                            ).block_until_ready()
    dt = (time.perf_counter() - t0) / n_frames

    rays_per_s = rays / dt
    live_frac = rays / (cfg.n_rays * cfg.max_bounces * 2)
    print(f"[bench] {name}: {dt*1e3:.1f} ms/frame, {rays:,} live rays "
          f"({live_frac:.0%} of nominal) -> {rays_per_s/1e6:.2f} Mrays/s "
          f"(mean={mean:.4f}, compile {compile_s:.1f}s)", file=sys.stderr)
    return rays_per_s


def main():
    from prismarine_core_tpu.models.camera import Camera
    from prismarine_core_tpu.models.procedural import (
        make_hall_scene, make_sky_environment, make_teapot_scene)
    from prismarine_core_tpu.utils.config import RenderConfig

    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    n_tris = int(args[0]) if args else 100_000
    # secondary configs are default-ON (stderr only) so every committed
    # bench artifact records hall + teapot; --fast skips them
    full = "--fast" not in sys.argv[1:]

    from prismarine_core_tpu.utils.compile_cache import (
        configure_compile_cache)
    from prismarine_core_tpu.utils.device import (
        card_name_and_power_limit, require_gpu)
    dev = require_gpu()
    configure_compile_cache()
    print(f"[bench] device={dev} card={card_name_and_power_limit()}",
          file=sys.stderr)

    # main metric: sponza-class hall, 720p, 4 bounces, HDR equirect sky.
    # The main config uses COHERENT bounce sampling (cfg flag below):
    # block-correlated bounce uniforms — an unbiased estimator (tested,
    # tests/test_transport.py::test_coherent_bounce_sampling_unbiased)
    # whose secondary rays form direction-tight packets, the analog
    # of the reference's wavefront ray sorting.  The independent-
    # sampling variant is reported to stderr for comparison.
    cfg = RenderConfig(width=1280, height=720, spp=1, max_bounces=4,
                       intersector="pallas", bvh_leaf_size=4,
                       coherent_bounce_sampling=True,
                       stale_round_masks=True,
                       anyhit_strategy="single",
                       # two-level cull, K=16 round-1 selection
                       cull_impl="pallas2", closest_k=16)
    scene = make_hall_scene(target_tris=n_tris)
    scene = dataclasses.replace(
        scene, environment=make_sky_environment(resolution=128))
    scene = jax.device_put(scene)
    print(f"[bench] scene tris={int(scene.triangles.num_valid())} "
          f"bvh nodes={scene.bvh.n_nodes} envmap="
          f"{tuple(scene.environment.image.shape)}", file=sys.stderr)
    camera = Camera.look_at(eye=(-10.0, 2.2, 0.0), target=(6.0, 1.6, 0.0),
                            fov_y_deg=60.0)
    rays_per_s = _run_config("hall-720p-hdr-sky(coherent)", scene,
                             camera, cfg)

    if full:
        # the same config with fully independent per-ray sampling
        _run_config("hall-720p-hdr-sky(independent)", scene, camera,
                    dataclasses.replace(cfg,
                                        coherent_bounce_sampling=False))
        # TEXTURED hall: same geometry/config with real diffuse + bump
        # textures (512^2, corner-packed) — exercises the full per-hit
        # fetch cost of surface.comp:102-195 that the texture-less hall
        # skips via the stub fast path (VERDICT r4 item 4)
        tex_scene = make_hall_scene(target_tris=n_tris, textured=True)
        tex_scene = dataclasses.replace(
            tex_scene, environment=make_sky_environment(resolution=128))
        tex_scene = jax.device_put(tex_scene)
        _run_config("hall-720p-textured(coherent)", tex_scene, camera,
                    cfg)
        # BASELINE config 2: teapot-class object at 512^2
        tcfg = RenderConfig(width=512, height=512, spp=1, max_bounces=4,
                            intersector="pallas",
                            stale_round_masks=True,
                            anyhit_strategy="single",
                            cull_impl="pallas2", closest_k=16)
        tscene = jax.device_put(make_teapot_scene())
        tcam = Camera.look_at(eye=(5.0, 3.2, 6.0), target=(0.0, 1.0, 0.0),
                              fov_y_deg=45.0)
        _run_config("teapot-512", tscene, tcam, tcfg)
        # the same teapot INGESTED through the OBJ loader (native
        # parser + mesh assembly path in a bench artifact — the
        # geometry-ingest layer timed on the same config)
        import os
        import tempfile

        import numpy as np
        from prismarine_core_tpu.models.obj_loader import load_obj
        soup = tscene.triangles
        nv = int(soup.num_valid())
        v = np.concatenate([np.asarray(soup.v0)[:nv],
                            np.asarray(soup.v1)[:nv],
                            np.asarray(soup.v2)[:nv]])
        with tempfile.NamedTemporaryFile("w", suffix=".obj",
                                         delete=False) as f:
            f.write("".join(f"v {x:.6f} {y:.6f} {z:.6f}\n"
                            for x, y, z in v))
            f.write("".join(f"f {i+1} {i+1+nv} {i+1+2*nv}\n"
                            for i in range(nv)))
            obj_path = f.name
        from prismarine_core_tpu.models.scene import Scene
        try:
            t0 = time.perf_counter()
            osoup, omats, otex = load_obj(obj_path)
            oscene = jax.device_put(Scene.assemble(
                osoup, omats, tscene.lights, tscene.environment,
                textures=otex))
            ingest_s = time.perf_counter() - t0
            print(f"[bench] obj ingest: {nv} tris in {ingest_s:.2f}s",
                  file=sys.stderr)
            _run_config("teapot-512-obj-ingested", oscene, tcam, tcfg)
        finally:
            os.unlink(obj_path)

    print(json.dumps({
        "metric": "rays_per_second_sponza_class_720p_4bounce_live",
        "value": rays_per_s,
        "unit": "rays/s",
        "vs_baseline": rays_per_s / REFERENCE_CLASS_RAYS_PER_S,
    }))


if __name__ == "__main__":
    main()
