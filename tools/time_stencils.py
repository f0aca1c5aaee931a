"""Device time of the image stencils beside the production step (GPU).

    python tools/time_stencils.py

Times ``preprocess.bilateral_filter`` and ``splat._fill_and_smooth`` on
their own, jitted at 640x480 after a warm-up, and the production
``fusion.step`` (``Config()``, the CLI's synthetic orbit) in depth and
combined mode, all in one process on one card.  Each number is the union
of the GPU's kernel intervals in a profiler trace divided by the calls
traced (bench.device_busy_ns), with the host-clock time per call beside
it.  Prints one JSON line.
"""
from __future__ import annotations

import json
import os
import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench import traced_device_ms  # noqa: E402
from vulcan_tpu.config import Config  # noqa: E402
from vulcan_tpu.core.camera import PinholeCamera  # noqa: E402
from vulcan_tpu.io.synthetic import orbit_poses, render_scene_depth  # noqa: E402
from vulcan_tpu.ops import preprocess, splat  # noqa: E402
from vulcan_tpu.pipeline import fusion  # noqa: E402
from vulcan_tpu.utils.runtime import device_record, setup_cache  # noqa: E402

H, W = 480, 640
SPHERES = (
    ((0.0, 0.0, 0.0), 0.5),
    ((0.6, 0.3, 0.2), 0.25),
    ((-0.5, 0.4, -0.1), 0.3),
)


def time_calls(fn, n):
    """(device ms per call, host ms per call) of ``n`` calls of ``fn()``."""
    jax.block_until_ready(fn())

    def run():
        out = None
        for _ in range(n):
            out = fn()
        jax.block_until_ready(out)

    t0 = time.perf_counter()
    run()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    return traced_device_ms(run, n), host_ms


def main():
    setup_cache()
    out = {"device": device_record()}
    config = Config()
    camera = PinholeCamera.create(0.8 * W, 0.8 * W, W / 2 - 0.5, H / 2 - 0.5)
    poses = orbit_poses(25, radius=1.6, height=0.35, span=1.25)
    render = jax.jit(
        lambda p: render_scene_depth(camera, p, H, W, SPHERES, -0.6)
    )
    frames = [render(p) for p in poses]

    depth = frames[3][0]
    holes = jnp.where(depth > 0, depth, jnp.inf)
    bil = jax.jit(preprocess.bilateral_filter, static_argnums=1)
    fill = jax.jit(splat._fill_and_smooth, static_argnums=1)
    for name, fn in (
        ("bilateral_filter", lambda: bil(depth, config)),
        ("fill_and_smooth", lambda: fill(holes, config)),
    ):
        dev, host = time_calls(fn, 200)
        out[name] = {"device_ms": round(dev, 4), "host_ms": round(host, 4)}

    for mode in ("depth", "combined"):
        state = fusion.init_state(config, camera, H, W, init_pose=poses[0])
        for d, c in frames[:5]:
            state = fusion.step(state, d, c, config, mode)
        jax.block_until_ready(state)
        bench = frames[5:]

        def run():
            nonlocal state
            for d, c in bench:
                state = fusion.step(state, d, c, config, mode)
            jax.block_until_ready(state)

        dev = traced_device_ms(run, len(bench))
        out[f"step_{mode}"] = {
            "device_ms": round(dev, 4),
            "track_inliers": int(state.track_inliers),
        }
    for name in ("bilateral_filter", "fill_and_smooth"):
        out[name]["share_of_depth_step"] = round(
            out[name]["device_ms"] / out["step_depth"]["device_ms"], 4
        )
    print(json.dumps(out))


if __name__ == "__main__":
    main()
