"""Long-run drift characterization on the accelerator.

A full 2-pi orbit (120 frames, 640x480) with Kinect-class sensor noise,
tracked online by the production pipeline (no ground-truth poses).
Reports ATE RMSE over the whole run and end-of-revolution drift (the
translation error after returning to the start view -- the number that
grows with accumulated pose error, where ATE can hide it).

Run: python tools/bench_drift.py [n_frames=120] [--scene=desk|orbit]
     [--mode=depth|combined]
"""
import json
import sys
import time

sys.path.insert(0, ".")
from vulcan_tpu.utils.runtime import setup_cache

setup_cache()

import jax
import jax.numpy as jnp
import numpy as np

from vulcan_tpu.config import Config
from vulcan_tpu.core.camera import PinholeCamera
from vulcan_tpu.io.synthetic import (
    add_depth_noise,
    orbit_poses,
    render_desk_depth,
    render_scene_depth,
)
from vulcan_tpu.pipeline import fusion
from vulcan_tpu.utils.evaluate import ate_rmse
from vulcan_tpu.utils.runtime import prefetch_to_device


def main():
    n = 120
    scene = "orbit"
    mode = "depth"
    for a in sys.argv[1:]:
        if a.startswith("--scene="):
            scene = a.split("=", 1)[1]
        elif a.startswith("--mode="):
            mode = a.split("=", 1)[1]
        elif a.isdigit():
            n = int(a)
    h, w = 480, 640
    config = Config()
    camera = PinholeCamera.tum_default()
    rng = np.random.default_rng(11)

    if scene == "desk":
        poses = orbit_poses(
            n, center=(0.0, 0.0, -0.25), radius=1.5, height=0.55,
            span=2.0 * np.pi,
        )
    else:
        poses = orbit_poses(n, radius=1.6, height=0.35, span=2.0 * np.pi)
    spheres = (
        ((0.0, 0.0, 0.0), 0.5),
        ((0.6, 0.3, 0.2), 0.25),
        ((-0.5, 0.4, -0.1), 0.3),
        ((0.2, -0.5, 0.3), 0.2),
    )

    print(f"rendering {n} noisy frames...", file=sys.stderr)
    frames = []
    for pose in poses:
        if scene == "desk":
            depth, color = render_desk_depth(camera, pose, h, w)
        else:
            depth, color = render_scene_depth(
                camera, pose, h, w, spheres, -0.6
            )
        depth = add_depth_noise(np.asarray(depth), rng)
        d16 = np.clip(
            np.asarray(depth) * config.depth_raw_scale, 0, 65535
        ).astype(np.uint16)
        c8 = np.clip(np.asarray(color) * 255.0, 0, 255).astype(np.uint8)
        frames.append((d16, c8))

    state = fusion.init_state(config, camera, h, w, init_pose=poses[0])
    est = []
    print("tracking...", file=sys.stderr)
    t0 = time.perf_counter()
    for d, c in prefetch_to_device(frames):
        state = fusion.step(state, d, c, config, mode)
        est.append(jnp.array(state.pose.translation))
    jnp.sum(est[-1]).block_until_ready()
    dt = time.perf_counter() - t0

    est = np.stack([np.asarray(e) for e in est])
    gt = np.stack([np.asarray(p.translation) for p in poses])
    # Unaligned per-frame translation error (drift curve).
    frame_err = np.linalg.norm(est - gt, axis=1)
    out = {
        "scene": scene,
        "mode": mode,
        "frames": n,
        "fps_incl_compile": round((n - 1) / dt, 2),
        "ate_rmse_m": round(float(ate_rmse(est, gt)), 5),
        "drift_end_m": round(float(frame_err[-1]), 5),
        "drift_max_m": round(float(frame_err.max()), 5),
        "track_failures": int(state.track_failures),
        "alloc_overflow": int(state.volume.alloc_overflow),
        "allocated_blocks": int(state.volume.free_count) - 1,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
