"""Stage-ablation timing of the fused step on the accelerator.

Renders the bench frames ONCE, then times fusion.step variants with
individual stages compiled out (Config.ablate) -- the difference against
the full step is that stage's true marginal cost inside the fused
program (isolated-stage timing overstates: it pays its own dispatch and
loses cross-stage fusion).

Run:  python tools/bench_ablate.py [n_frames]
"""
import sys
import time

sys.path.insert(0, ".")
from vulcan_tpu.utils.runtime import setup_cache

setup_cache()

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from vulcan_tpu.config import Config
from vulcan_tpu.core.camera import PinholeCamera
from vulcan_tpu.io.synthetic import orbit_poses, render_scene_depth
from vulcan_tpu.pipeline import fusion
from vulcan_tpu.utils.runtime import prefetch_to_device


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    h, w = 480, 640
    camera = PinholeCamera.tum_default()
    spheres = (
        ((0.0, 0.0, 0.0), 0.5),
        ((0.6, 0.3, 0.2), 0.25),
        ((-0.5, 0.4, -0.1), 0.3),
        ((0.2, -0.5, 0.3), 0.2),
    )
    poses = orbit_poses(n + 5, radius=1.6, height=0.35, span=(n + 5) * 0.05)
    print("rendering frames...", file=sys.stderr)
    frames = []
    for pose in poses:
        depth, color = render_scene_depth(camera, pose, h, w, spheres, -0.6)
        d16 = np.clip(np.asarray(depth) * 5000.0, 0, 65535).astype(np.uint16)
        c8 = np.clip(np.asarray(color) * 255.0, 0, 255).astype(np.uint8)
        frames.append((d16, c8))

    base = None
    for ablate in ("", "track", "alloc,integrate", "integrate", "vis",
                   "render"):
        config = Config(ablate=ablate)
        state = fusion.init_state(config, camera, h, w, init_pose=poses[0])
        for d, c in prefetch_to_device(frames[:5]):
            state = fusion.step(state, d, c, config)
        jnp.sum(state.model.depth).block_until_ready()
        t0 = time.perf_counter()
        for d, c in prefetch_to_device(frames[5:]):
            state = fusion.step(state, d, c, config)
        jnp.sum(state.model.depth).block_until_ready()
        ms = (time.perf_counter() - t0) / n * 1e3
        if ablate == "":
            base = ms
        delta = f"  (stage ~{base - ms:6.2f} ms)" if ablate else ""
        print(f"ablate=[{ablate:16s}] {ms:8.2f} ms/frame{delta}",
              flush=True)


if __name__ == "__main__":
    main()
