"""Multi-host (multi-process) harness test: 2 local CPU processes under
`jax.distributed` render a data-sharded frame over the global mesh and
agree on the result.

This validates the exact wiring `__graft_entry__.dryrun_multihost` uses
on real hosts (coordinator env -> jax.distributed.initialize ->
global mesh -> GSPMD collectives across processes); locally the
collectives ride gloo over localhost.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

_WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
pid = int(sys.argv[1]); n = int(sys.argv[2]); port = sys.argv[3]
jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=n, process_id=pid)
import numpy as np
import jax.numpy as jnp
from prismarine_core_tpu.models.camera import Camera
from prismarine_core_tpu.models.scene import make_cornell_scene
from prismarine_core_tpu.ops.sampling import make_sample_arrays
from prismarine_core_tpu.parallel.mesh import (
    make_mesh, make_sharded_renderer, shard_scene)
from prismarine_core_tpu.utils.config import RenderConfig

assert jax.device_count() == 2 * n, jax.device_count()
mesh = make_mesh(jax.device_count(), model_parallel=1)
cfg = RenderConfig(width=16, height=16, spp=1, max_bounces=2,
                   intersector="brute", tri_block=16)
scene = shard_scene(make_cornell_scene(capacity=64), mesh)
camera = Camera.look_at(eye=(0.0, 0.0, 3.4), target=(0.0, 0.0, 0.0),
                        fov_y_deg=50.0)
cam_s, bounce_s = make_sample_arrays(jax.random.key(0), cfg.n_rays,
                                     cfg.max_bounces)
renderer = make_sharded_renderer(mesh, cfg)
img = renderer(scene, camera,
               jax.device_put(cam_s), jax.device_put(bounce_s))
print(f"RESULT {pid} {float(jnp.mean(img)):.6f}", flush=True)

# PRODUCTION path across processes: the fused Pallas packet intersector
# on a TEXTURED scene with superblock ranges AND the texture stack
# sharded over 'model' (spanning both hosts), rays over 'data', soup
# reduced to the husk — the cross-host form of dryrun_multichip part 1.
import dataclasses
from prismarine_core_tpu.models.procedural import make_hall_scene
from prismarine_core_tpu.parallel.shard_intersect import distribute_scene
mesh2 = make_mesh(jax.device_count(), model_parallel=2)
cfg2 = RenderConfig(width=16, height=16, spp=1, max_bounces=2,
                    intersector="pallas_sharded", mesh=mesh2)
hall = make_hall_scene(target_tris=1500, textured=True,
                       texture_resolution=32)
dscene = distribute_scene(hall, mesh2)
assert dscene.textures.mesh is mesh2
camera2 = Camera.look_at(eye=(-10.0, 2.2, 0.0), target=(6.0, 1.6, 0.0),
                         fov_y_deg=60.0)
renderer2 = make_sharded_renderer(mesh2, cfg2)
img2 = renderer2(dscene, camera2,
                 jax.device_put(cam_s), jax.device_put(bounce_s))
print(f"RESULT2 {pid} {float(jnp.mean(img2)):.6f}", flush=True)
"""


def test_two_process_distributed_render(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.getcwd() + os.pathsep + env.get("PYTHONPATH", "")
    port = "49741"
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(pid), "2", port],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        text=True) for pid in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        outs.append(out)
        assert p.returncode == 0, out[-2000:]
    means = []
    means2 = []
    for out in outs:
        lines = [l for l in out.splitlines()
                 if l.startswith("RESULT ")]
        lines2 = [l for l in out.splitlines()
                  if l.startswith("RESULT2 ")]
        assert lines and lines2, out[-2000:]
        means.append(float(lines[0].split()[2]))
        means2.append(float(lines2[0].split()[2]))
    # both processes hold the same replicated result
    assert abs(means[0] - means[1]) < 1e-6
    assert means[0] > 1e-3  # not a black image
    # production (pallas_sharded) path agrees across processes too
    assert abs(means2[0] - means2[1]) < 1e-6
    assert means2[0] > 1e-3
