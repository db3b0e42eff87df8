"""Headless render CLI — the viewer analog.

Mirrors the reference glTF viewer's flags (``Viewer.cpp:22-50``:
``-m/--model -s/--scale -d/--depth`` plus ``-di/--dir``) with additions
for resolution, sample count and output path.  There is no window;
progressive frames accumulate and the result is written as PNG + HDR.

    python -m prismarine_core_tpu.cli --model cow.obj --scale 1.0 \
        --depth 4 --res 640x480 --frames 16 --out render.png
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="prismarine-render",
        description="differentiable path tracer (headless)")
    p.add_argument("-m", "--model", help="OBJ file (default: built-in "
                   "cornell scene)")
    p.add_argument("-s", "--scale", type=float, default=1.0,
                   help="model scale (Viewer.cpp -s)")
    p.add_argument("-d", "--depth", type=int, default=4,
                   help="bounce depth (Viewer.cpp -d)")
    p.add_argument("--res", default="512x512", help="WxH")
    p.add_argument("--spp", type=int, default=1,
                   help="samples per pixel per frame")
    p.add_argument("--frames", type=int, default=8,
                   help="progressive frames to accumulate")
    p.add_argument("--out", default="render.png",
                   help="output (.png; .hdr and .npy written alongside)")
    p.add_argument("--scene", default="cornell",
                   choices=["cornell", "sunplane", "hall"],
                   help="built-in scene when no --model given")
    p.add_argument("--hall-tris", type=int, default=100_000)
    p.add_argument("--eye", default=None,
                   help="camera eye 'x,y,z' (scene default otherwise)")
    p.add_argument("--target", default=None, help="camera target 'x,y,z'")
    p.add_argument("--fov", type=float, default=60.0)
    p.add_argument("--env", default=None,
                   help="equirect background image (reference "
                   "loadCubemap analog)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--camera-360", action="store_true")
    p.add_argument("--env-nee", action="store_true",
                   help="importance-sample the environment map's bright "
                        "texels (MIS; recommended with HDR sun skies)")
    p.add_argument("--intersector", default="pallas",
                   choices=["brute", "bvh", "packet", "pallas"],
                   help="intersection backend (default: the packet "
                        "fast path with its Pallas pair kernel)")
    # --- production performance knobs (the bench configuration) ---
    p.add_argument("--coherent", action="store_true",
                   help="coherent bounce sampling (Sadeghi et al. 2009): "
                        "block-correlated bounce uniforms; unbiased, "
                        "direction-tight secondary packets — the bench's "
                        "main-metric configuration")
    p.add_argument("--reuse-order", action="store_true",
                   help="reuse bounce 1's coherence sort for later "
                        "bounces (saves one u32 sort per bounce)")
    p.add_argument("--sort-mode", default="full",
                   choices=["full", "packed", "group"],
                   help="ray coherence sort variant (packet.py:"
                        "_sort_pad_rays)")
    p.add_argument("--cull-impl", default="pallas2",
                   choices=["pallas2", "pallas", "xla"],
                   help="dense cull scheme (pallas2 = two-level "
                        "superblock cull + pair-driven block refine, "
                        "the production default; pallas = one-level "
                        "block-granular cull; xla = same as pallas2)")
    p.add_argument("--strategy", default="",
                   choices=["", "single", "two_round", "rounds"],
                   help="closest-hit execution strategy override "
                        "(default: per-query-type choices)")
    p.add_argument("--strategy-k", type=int, default=16,
                   help="per-round superblock budget K for the "
                        "two_round/rounds strategies (0 = default 8; "
                        "the bench runs 16)")
    p.add_argument("--anyhit-strategy", default="",
                   choices=["", "single", "two_round", "rounds"],
                   help="any-hit (shadow) execution strategy override "
                        "(the bench runs single)")
    p.add_argument("--stale-round-masks", action="store_true",
                   help="keep round-0 block masks across any-hit "
                        "rounds (faster for coherent workloads)")
    p.add_argument("--rr-start-bounce", type=int, default=0,
                   help="Russian-roulette start bounce (0 = off): "
                        "unbiased stochastic termination of "
                        "low-throughput paths from this bounce on")
    p.add_argument("--rr-min-q", type=float, default=0.05,
                   help="Russian-roulette survival-probability floor")
    return p


def _vec(s):
    return tuple(float(x) for x in s.split(","))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import numpy as np

    from prismarine_core_tpu.utils.compile_cache import (
        configure_compile_cache)
    configure_compile_cache()

    from prismarine_core_tpu.models.camera import Camera
    from prismarine_core_tpu.models.scene import (
        Scene, make_cornell_scene, make_sun_plane_scene)
    from prismarine_core_tpu.render.pipeline import ProgressiveRenderer
    from prismarine_core_tpu.utils.config import RenderConfig
    from prismarine_core_tpu.utils.image import save_hdr, save_npy, save_png

    w, h = (int(x) for x in args.res.lower().split("x"))

    if args.model:
        from prismarine_core_tpu.models.lights import SphereLights
        from prismarine_core_tpu.models.textures import Environment
        if args.model.lower().endswith((".gltf", ".glb")):
            from prismarine_core_tpu.models.gltf_loader import load_gltf
            soup, mats, texs = load_gltf(args.model, scale=args.scale)
        else:
            from prismarine_core_tpu.models.obj_loader import load_obj
            soup, mats, texs = load_obj(args.model, scale=args.scale)
        env = Environment.constant((0.4, 0.55, 0.75))
        if args.env:
            from prismarine_core_tpu.utils.image import load_image_rgba
            env = Environment.from_image(load_image_rgba(args.env)[..., :3])
        scene = Scene.assemble(soup, mats, SphereLights.suns(), env, texs)
        default_eye, default_target = (3.0, 2.0, 5.0), (0.0, 0.5, 0.0)
    elif args.scene == "cornell":
        scene = make_cornell_scene()
        default_eye, default_target = (0.0, 0.0, 3.4), (0.0, 0.0, 0.0)
    elif args.scene == "sunplane":
        scene = make_sun_plane_scene()
        default_eye, default_target = (3.0, 2.0, 5.0), (0.0, 0.5, 0.0)
    else:
        from prismarine_core_tpu.models.procedural import make_hall_scene
        scene = make_hall_scene(target_tris=args.hall_tris)
        default_eye, default_target = (-10.0, 2.2, 0.0), (6.0, 1.6, 0.0)

    camera = Camera.look_at(
        eye=_vec(args.eye) if args.eye else default_eye,
        target=_vec(args.target) if args.target else default_target,
        fov_y_deg=args.fov)
    cfg = RenderConfig(width=w, height=h, spp=args.spp,
                       max_bounces=args.depth,
                       camera_360=args.camera_360,
                       env_nee=args.env_nee,
                       intersector=args.intersector,
                       coherent_bounce_sampling=args.coherent,
                       reuse_bounce_order=args.reuse_order,
                       sort_mode=args.sort_mode,
                       cull_impl=args.cull_impl,
                       closest_strategy=args.strategy,
                       closest_k=args.strategy_k,
                       anyhit_strategy=args.anyhit_strategy,
                       stale_round_masks=args.stale_round_masks,
                       rr_start_bounce=args.rr_start_bounce,
                       rr_min_q=args.rr_min_q)

    renderer = ProgressiveRenderer(scene, camera, cfg, seed=args.seed)
    t0 = time.perf_counter()
    for i in range(args.frames):
        renderer.step()
        if i == 0:
            print(f"[render] first frame {time.perf_counter()-t0:.1f}s "
                  f"(incl. compile)", file=sys.stderr)
    img = renderer.snapshot()
    dt = time.perf_counter() - t0
    print(f"[render] {args.frames} frames ({renderer.sample_count} spp) "
          f"in {dt:.1f}s; mean={img.mean():.4f}", file=sys.stderr)

    base = args.out.rsplit(".", 1)[0]
    save_png(args.out, img)
    save_hdr(base + ".hdr", img)
    save_npy(base + ".npy", img)
    print(f"[render] wrote {args.out}, {base}.hdr, {base}.npy",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
