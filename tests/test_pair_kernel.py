"""The pair executors (ops/pallas_intersect.py) and the XLA culls
(ops/cull.py) against each other and against plain numpy references.

The Triton kernel runs in interpret mode here; ``gpu``-marked tests
compile it for the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from prismarine_core_tpu.ops import pallas_intersect as pi
from prismarine_core_tpu.ops.cull import box_entry, pair_block_masks
from prismarine_core_tpu.utils.config import INF_DIST

NT, NSB = 3, 3
W = pi.SB * pi.BLOCK


def _planes(rng, nsb=NSB, dup_of=None):
    """f32[nsb+1, 16, W] planes of random triangles in a slab in front
    of the rays; ``dup_of`` = {dst_sb: src_sb} copies geometry so the
    two superblocks tie exactly; ~5% of slots are invalid padding."""
    v0 = rng.uniform([-2, -2, 0], [2, 2, 4], (nsb, W, 3))
    e1 = rng.uniform(-1.5, 1.5, (nsb, W, 3))
    e2 = rng.uniform(-1.5, 1.5, (nsb, W, 3))
    valid = (rng.random((nsb, W)) > 0.05).astype(np.float32)
    for dst, src in (dup_of or {}).items():
        v0[dst], e1[dst], e2[dst], valid[dst] = (v0[src], e1[src],
                                                  e2[src], valid[src])
    planes = np.zeros((nsb + 1, 16, W), np.float32)
    for base, arr in ((pi.TC_V0X, v0), (pi.TC_E1X, e1), (pi.TC_E2X, e2)):
        planes[:nsb, base:base + 3] = arr.transpose(0, 2, 1)
    planes[:nsb, pi.TC_VALID] = valid
    return planes


def _rays(rng, nt=NT, dead_frac=0.1):
    """f32[(nt+1)*TILE, RAY_COLS] rays from z = -5 toward +z (some dead,
    t_cap 0), plus the all-zero sentinel tile."""
    n = nt * pi.TILE
    o = np.concatenate([rng.uniform(-2, 2, (n, 2)),
                        np.full((n, 1), -5.0)], axis=1)
    d = np.concatenate([rng.normal(0, 0.2, (n, 2)), np.ones((n, 1))],
                       axis=1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = np.zeros(((nt + 1) * pi.TILE, pi.RAY_COLS), np.float32)
    rays[:n, pi.RC_OX:pi.RC_OX + 3] = o
    rays[:n, pi.RC_DX:pi.RC_DX + 3] = d
    rays[:n, pi.RC_TCAP] = np.where(rng.random(n) < dead_frac, 0.0,
                                    INF_DIST)
    rays[:n, pi.RC_IVX:pi.RC_IVX + 3] = 1.0 / d
    return rays


def _pairs(spec, n_pad=0, pad_entry=(NT, NSB, 0)):
    """[(tile, sb, mask)] -> pair arrays + n_real, padded with
    ``n_pad`` copies of ``pad_entry``."""
    ent = list(spec) + [pad_entry] * n_pad
    pt, psb, pm = (jnp.asarray(np.array(c, np.int32)) for c in zip(*ent))
    return pt, psb, pm, jnp.int32(len(spec))


FULL = 0xFF
CASES = {
    # tile 1 has no pair at all
    "empty_tiles": [(0, 0, FULL), (0, 2, 0x0F), (2, 1, FULL)],
    # one tile's run spans every superblock and sub-block: many more
    # (pair, sub-block, chunk) steps than one loop chunk
    "long_run": [(0, 0, FULL), (0, 1, FULL), (0, 2, FULL),
                 (1, 1, 0x81), (2, 0, FULL), (2, 2, FULL)],
    # entries past n_real carry a REAL tile and superblock: ignored
    "sentinel_padding": [(0, 1, FULL), (1, 0, 0x3C)],
    # every mask is zero: the prior comes back untouched
    "zero_masks": [(0, 0, 0), (1, 1, 0), (2, 2, 0)],
    # superblock 2 duplicates superblock 0 and runs FIRST: equal t,
    # the lowest slot (superblock 0) must win
    "equal_t_ties": [(0, 2, FULL), (0, 0, FULL), (1, 2, FULL),
                     (1, 0, FULL), (2, 0, FULL)],
}


def _case(name):
    rng = np.random.default_rng(sorted(CASES).index(name))
    planes = _planes(rng, dup_of={2: 0} if name == "equal_t_ties"
                     else None)
    rays = _rays(rng)
    if name == "sentinel_padding":
        pairs = _pairs(CASES[name], n_pad=5, pad_entry=(2, 2, FULL))
    else:
        pairs = _pairs(CASES[name], n_pad=3)
    return pairs, jnp.asarray(rays), jnp.asarray(planes)


@pytest.mark.parametrize("name", sorted(CASES))
def test_pair_kernel_matches_xla_executor(name):
    (pt, psb, pm, n_real), rays, planes = _case(name)
    tk, sk = pi.pallas_execute_pairs(pt, psb, pm, n_real, rays, planes,
                                     rb=32, tc=32)
    tx, sx = pi.xla_execute_pairs(pt, psb, pm, n_real, rays, planes,
                                  window=4)
    tk, sk, tx, sx = (np.asarray(a) for a in (tk, sk, tx, sx))
    np.testing.assert_array_equal(sk, sx)
    np.testing.assert_allclose(tk, tx, rtol=1e-6)

    cap = np.asarray(rays[:, pi.RC_TCAP])
    hit = sk >= 0
    untouched = np.ones(cap.shape, bool)
    for t, _, m in CASES[name]:
        if m:
            untouched[t * pi.TILE:(t + 1) * pi.TILE] = False
    # rows without a live pair keep the prior (t_cap, -1) exactly
    np.testing.assert_array_equal(tk[untouched], cap[untouched])
    assert (sk[untouched] == -1).all()
    assert not hit[cap == 0.0].any()              # dead lanes never hit
    if name in ("long_run", "empty_tiles", "equal_t_ties"):
        assert hit.sum() > 50                     # the case has hits
    if name == "equal_t_ties":
        assert (sk[hit] < W).all()                # superblock 0 won


def test_pair_kernel_prior_and_shapes():
    """The wrapper returns (f32[rows], i32[rows]), seeds from a prior,
    and a prior hit closer than anything in the pairs survives."""
    (pt, psb, pm, n_real), rays, planes = _case("long_run")
    rows = rays.shape[0]
    t0, s0 = pi.pallas_execute_pairs(pt, psb, pm, n_real, rays, planes)
    assert t0.shape == (rows,) and t0.dtype == jnp.float32
    assert s0.shape == (rows,) and s0.dtype == jnp.int32
    prior_t = jnp.where(jnp.arange(rows) % 2 == 0, 1e-3, t0)
    prior_s = jnp.where(jnp.arange(rows) % 2 == 0, 7, s0)
    t1, s1 = pi.pallas_execute_pairs(pt, psb, pm, n_real, rays, planes,
                                     prior=(prior_t, prior_s))
    np.testing.assert_array_equal(np.asarray(s1), np.asarray(prior_s))
    np.testing.assert_array_equal(np.asarray(t1), np.asarray(prior_t))


def test_pair_kernel_block_configs_agree():
    """Rays per program and triangle chunk only re-tile the work."""
    (pt, psb, pm, n_real), rays, planes = _case("long_run")
    ref = pi.pallas_execute_pairs(pt, psb, pm, n_real, rays, planes)
    for rb, tc in ((64, 16), (16, 64)):
        got = pi.pallas_execute_pairs(pt, psb, pm, n_real, rays, planes,
                                      rb=rb, tc=tc)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("n_real", [0, 4, 9])
def test_tile_offsets(n_real):
    pair_tile = jnp.asarray([0, 0, 2, 2, 2, 3, 5, 5, 5, 6, 6, 6],
                            jnp.int32)
    start, end = pi.tile_offsets(pair_tile, jnp.int32(n_real), 7)
    ptn = np.asarray(pair_tile)[:n_real]
    for t in range(7):
        idx = np.nonzero(ptn == t)[0]
        if len(idx):
            assert (int(start[t]), int(end[t])) == (idx[0], idx[-1] + 1)
        else:
            assert int(start[t]) == int(end[t])


def _slab_ref(rays, lo, hi):
    """numpy per-ray slab test -> f32[rays, boxes] entry distance."""
    o = rays[:, pi.RC_OX:pi.RC_OX + 3]
    inv = rays[:, pi.RC_IVX:pi.RC_IVX + 3]
    tc = rays[:, pi.RC_TCAP]
    t0 = (lo[None] - o[:, None]) * inv[:, None]
    t1 = (hi[None] - o[:, None]) * inv[:, None]
    tn = np.minimum(t0, t1).max(-1)
    tf = np.maximum(t0, t1).min(-1)
    tn0 = np.maximum(tn, 0.0)
    hit = (tf >= tn0) & (tn <= tc[:, None]) & (tc[:, None] > 0)
    return np.where(hit, tn0, INF_DIST)


def _boxes(rng, n):
    lo = rng.uniform([-3, -3, -1], [3, 3, 5], (n, 3)).astype(np.float32)
    return lo, lo + rng.uniform(0.1, 1.5, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("n_live", [5, 3, 0])
def test_box_entry_matches_slab_reference(n_live):
    """Per-(tile, box) entry distance = min over the tile's rays of the
    per-ray slab reference; tiles at or beyond n_live read INF_DIST."""
    rng = np.random.default_rng(71)
    nt = 5
    rays = _rays(rng, nt=nt, dead_frac=0.3)
    lo, hi = _boxes(rng, 40)
    got = np.asarray(box_entry(jnp.asarray(rays), jnp.asarray(lo),
                               jnp.asarray(hi), jnp.int32(n_live),
                               chunk=2))
    assert got.shape == (nt, 40)
    ref = _slab_ref(rays[:nt * pi.TILE], lo, hi).reshape(
        nt, pi.TILE, 40).min(axis=1)
    ref[n_live:] = INF_DIST
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    if n_live:
        assert (got[:n_live] < INF_DIST).any()


def test_pair_block_masks_codes():
    """Bit k of a pair's code is set iff some ray of the pair's tile
    passes block sb*SB + k; entries past n_pairs read 0."""
    rng = np.random.default_rng(72)
    nt, nsb = 3, 4
    rays = _rays(rng, nt=nt, dead_frac=0.3)
    lo, hi = _boxes(rng, nsb * pi.SB)
    pt = np.array([0, 0, 1, 2, 2, 2, 1], np.int32)
    psb = np.array([0, 3, 1, 0, 2, 3, 2], np.int32)
    n_pairs = 6
    got = np.asarray(pair_block_masks(
        jnp.asarray(rays), jnp.asarray(pt), jnp.asarray(psb),
        jnp.int32(n_pairs), jnp.asarray(lo), jnp.asarray(hi), window=4))
    tn = _slab_ref(rays[:nt * pi.TILE], lo, hi).reshape(
        nt, pi.TILE, nsb, pi.SB).min(axis=1)
    ref = np.zeros_like(got)
    for i in range(n_pairs):
        bits = tn[pt[i], psb[i]] < INF_DIST
        ref[i] = int(np.sum(bits << np.arange(pi.SB)))
    np.testing.assert_array_equal(got, ref)
    assert got[:n_pairs].any() and got[n_pairs] == 0


def test_pallas_gradient_matches_bvh():
    """Visibility is detached on both paths, so the vertex and material
    gradients of an image loss through the "pallas" path equal the
    "bvh" path's on the same samples."""
    from prismarine_core_tpu.models.camera import Camera
    from prismarine_core_tpu.models.scene import make_cornell_scene
    from prismarine_core_tpu.ops.sampling import make_sample_arrays
    from prismarine_core_tpu.render.integrator import render_with_samples
    from prismarine_core_tpu.utils.config import RenderConfig
    import dataclasses

    scene = make_cornell_scene()
    cam = Camera.look_at(eye=(0.0, 0.0, 3.4), target=(0.0, 0.0, 0.0),
                         fov_y_deg=50.0)
    cfg = RenderConfig(width=16, height=16, spp=1, max_bounces=2,
                       intersector="pallas")
    cam_s, bounce_s = make_sample_arrays(jax.random.key(3), cfg.n_rays,
                                         cfg.max_bounces)

    def grads(c):
        def loss(v0, diffuse):
            s = dataclasses.replace(
                scene, triangles=dataclasses.replace(scene.triangles,
                                                     v0=v0),
                materials=dataclasses.replace(scene.materials,
                                              diffuse=diffuse))
            img = render_with_samples(s, cam, c, cam_s, bounce_s)
            return jnp.mean((img - 0.3) ** 2)
        return jax.grad(loss, argnums=(0, 1))(scene.triangles.v0,
                                              scene.materials.diffuse)

    gp = grads(cfg)
    gb = grads(cfg.replace(intersector="bvh"))
    for a, b in zip(gp, gb):
        a, b = np.asarray(a), np.asarray(b)
        assert np.isfinite(a).all() and np.abs(a).sum() > 0
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


@pytest.mark.gpu
def test_pair_kernel_compiled_matches_xla_executor(gpu):
    """On the card: the compiled Triton kernel against the XLA
    executor, every case."""
    for name in sorted(CASES):
        (pt, psb, pm, n_real), rays, planes = _case(name)
        tk, sk = pi.pallas_execute_pairs(pt, psb, pm, n_real, rays,
                                         planes)
        tx, sx = pi.xla_execute_pairs(pt, psb, pm, n_real, rays, planes)
        np.testing.assert_array_equal(np.asarray(sk), np.asarray(sx))
        np.testing.assert_allclose(np.asarray(tk), np.asarray(tx),
                                   rtol=1e-6)
