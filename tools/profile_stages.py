"""Per-stage timing of the online pipeline on the accelerator.

Times each stage of fusion.step in isolation (jitted separately, blocked),
plus the fused step, plus a trivial op to measure the dispatch floor.
Run:  python tools/profile_stages.py [HxW] [preset]
"""
import sys
import time

sys.path.insert(0, ".")

from vulcan_tpu.utils.runtime import setup_cache

setup_cache()

import jax
import jax.numpy as jnp
import numpy as np

from vulcan_tpu.config import TINY, Config
from vulcan_tpu.core.camera import PinholeCamera
from vulcan_tpu.core.frame import Frame
from vulcan_tpu.io.synthetic import orbit_poses, render_scene_depth
from vulcan_tpu.ops import allocate, icp, raycast, sparse
from vulcan_tpu.ops.preprocess import build_pyramid
from vulcan_tpu.pipeline import fusion


def timeit(name, fn, *args, n=10, **kw):
    out = fn(*args, **kw)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args, **kw)
    jax.block_until_ready(out)
    ms = (time.perf_counter() - t0) / n * 1e3
    print(f"{name:32s} {ms:9.2f} ms")
    return out


def main():
    shape = sys.argv[1] if len(sys.argv) > 1 else "120x160"
    preset = sys.argv[2] if len(sys.argv) > 2 else "tiny"
    h, w = (int(x) for x in shape.split("x"))
    config = TINY if preset == "tiny" else Config()
    print(f"devices: {jax.devices()}  shape {h}x{w}  preset {preset}")

    camera = PinholeCamera.create(0.8 * w, 0.8 * w, w / 2 - 0.5, h / 2 - 0.5)
    spheres = (((0.0, 0.0, 0.0), 0.5), ((0.6, 0.3, 0.2), 0.25))
    poses = orbit_poses(3, radius=1.6, height=0.3, span=0.1)
    depth, color = render_scene_depth(camera, poses[0], h, w, spheres, -0.6)
    depth = jnp.asarray(depth)
    color = jnp.asarray(color)

    # dispatch floor
    x = jnp.ones((8, 128))
    f_triv = jax.jit(lambda x: x + 1.0)
    timeit("dispatch floor (x+1)", f_triv, x, n=50)

    # Build a fused state to run stages against.
    state = fusion.init_state(config, camera, h, w, init_pose=poses[0])
    for p in poses:
        d, c = render_scene_depth(camera, p, h, w, spheres, -0.6)
        state = fusion.step(state, jnp.asarray(d), jnp.asarray(c), config)
    jax.block_until_ready(state.model.depth)
    volume = state.volume
    pose = state.model.pose
    frame = Frame(depth, color, camera, pose)

    pyr_fn = jax.jit(lambda f: build_pyramid(f, config))
    pyr = timeit("preprocess (pyramid)", pyr_fn, frame)

    model_pyr_fn = jax.jit(
        lambda m: icp.model_pyramid(m, config.pyramid_levels)
    )
    model_pyr = timeit("model pyramid", model_pyr_fn, state.model)

    track_fn = jax.jit(
        lambda lp, mp, p0: icp.track(lp, mp, p0, config)
    )
    timeit("track (ICP all levels)", track_fn, pyr, model_pyr, pose)

    alloc_fn = jax.jit(
        lambda v, d, p: allocate.allocate_for_frame(v, d, camera, p, config)[0]
    )
    volume = timeit("allocate", alloc_fn, volume, pyr[0].depth, pose)

    vis_fn = jax.jit(
        lambda v, p: allocate.update_visibility(v, camera, p, h, w, config)
    )
    volume = timeit("visibility", vis_fn, volume, pose)

    integ_fn = jax.jit(lambda v, f: sparse.integrate_sparse(v, f, config))
    volume = timeit("integrate", integ_fn, volume, frame)

    ray_fn = jax.jit(
        lambda v, p: raycast.raycast(v, camera, p, h, w, config)
    )
    timeit("raycast", ray_fn, volume, pose)

    range_fn = jax.jit(
        lambda v, p: raycast.compute_range_image(v, camera, p, h, w, config)
    )
    timeit("  (range image alone)", range_fn, volume, pose)

    # fused step (non-donated copy to keep state reusable)
    import copy

    def run_step(s, d, c):
        return fusion.step(s, d, c, config)

    s2 = jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), state)
    t0 = time.perf_counter()
    n = 10
    for _ in range(n):
        s2 = run_step(s2, depth, color)
    jax.block_until_ready(s2.model.depth)
    print(f"{'FUSED step':32s} {(time.perf_counter()-t0)/n*1e3:9.2f} ms")


if __name__ == "__main__":
    main()
