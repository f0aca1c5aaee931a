"""Benchmark: track+fuse+render FPS of the online step at 640x480.

Runs the production configuration (``Config()``: 8 mm voxels, 4 cm
truncation band, 65,536-block hashed volume, splat renderer) through the
same jitted ``fusion.step_seq`` / ``fusion.step`` the CLI uses, on
synthetic 640x480 sequences whose geometry mirrors a TUM fr1_desk-style
handheld scan (no dataset is reachable here, SURVEY.md §0).  Input frames
are rendered on the device from fixed scene definitions at start-up.

Two measurements:
  * device-bound (default): the benchmark sequence is staged on the
    device and the timed region is ONE ``step_seq`` dispatch (a lax.scan
    of the per-frame step, bit-equal to per-frame ``step`` calls --
    test_step_seq_matches_step) plus a readback.  A profiler trace of one
    more such dispatch gives ``device_ms_per_frame``: the union of the
    GPU's kernel intervals divided by the frames traced.
  * ``--streaming``: the per-frame ``step`` loop with the host feeding
    frames, as a live camera does.  ``--mesh-every=N`` adds the
    incremental mesh update every N frames (``--mesh-full``: full
    re-extraction instead).

Scenes (``--scene=``):
  * ``orbit`` (default): four spheres + floor, 30 frames, ~1.75 rad arc.
  * ``desk``: cluttered tabletop (18 primitives at varied depths,
    io/synthetic.DESK_*), 120 frames (``--frames=N``) over a full 2-pi
    orbit.

Modes (``--mode=``): ``depth`` (geometric ICP, default), ``combined``
(geometric + photometric, the CLI default) or ``light`` (combined + SH
illumination-gain estimation, ops/light.py).

The argument-less run also measures a ``modes`` block: depth, combined
and light on the 240-frame desk sequence, with device time and ATE.

Needs a GPU: without one it exits with an error and measures nothing.
Prints ONE JSON line: {"metric", "value" (fps), "unit", "vs_baseline"
(fps / 30, the real-time target of BASELINE.md), "device": {platform,
device_kind, count, card name and power limit}, ...}.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

from vulcan_tpu.config import Config
from vulcan_tpu.core.camera import PinholeCamera
from vulcan_tpu.pipeline import fusion
from vulcan_tpu.utils.runtime import device_record, prefetch_to_device

_SPHERES = (
    ((0.0, 0.0, 0.0), 0.5),
    ((0.6, 0.3, 0.2), 0.25),
    ((-0.5, 0.4, -0.1), 0.3),
    ((0.2, -0.5, 0.3), 0.2),
)


def _parse_args(argv):
    a = {
        "ablate": "",
        "scene": "orbit",
        "mode": "depth",
        "frames": 0,
        "mesh_every": 0,
        "reps": 0,
        "render": "",
        "overrides": {},
    }
    for arg in argv:
        for key in ("ablate", "scene", "mode", "render"):
            if arg.startswith(f"--{key}="):
                a[key] = arg.split("=", 1)[1]
        for key in ("frames", "mesh-every", "reps"):
            if arg.startswith(f"--{key}="):
                a[key.replace("-", "_")] = int(arg.split("=", 1)[1])
        if arg.startswith("--set="):
            k, v = arg.split("=", 1)[1].split(":", 1)
            if "," in v:  # tuple fields (icp_iters, icp_assoc, icp_stride)
                v = tuple(int(x) for x in v.split(","))
            else:
                for cast in (int, float):
                    try:
                        v = cast(v)
                        break
                    except ValueError:
                        pass
                if v in ("true", "false"):
                    v = v == "true"
            a["overrides"][k] = v
    return a


def make_scene(scene, n_frames, config, camera, noisy, h=480, w=640):
    """Returns (frames, poses, n_warm, n_bench): input frames in raw
    sensor dtypes (uint16 depth at TUM scale, uint8 color -- what a real
    camera feed uploads; converted on device) plus ground-truth poses."""
    from vulcan_tpu.io.synthetic import (
        add_depth_noise,
        orbit_poses,
        render_desk_depth,
        render_scene_depth,
    )

    rng = np.random.default_rng(7)
    if scene == "desk":
        # 120 frames over the full 2-pi orbit: ~7.9 cm / 3 deg per frame,
        # ~4x harsher than TUM fr1_desk's inter-frame motion at 30 Hz.
        # --frames=240 gives ~2x-fr1 motion for the accuracy rows.
        n_warm, n_bench = 5, n_frames or 120
        poses = orbit_poses(
            n_warm + n_bench, center=(0.0, 0.0, -0.25), radius=1.5,
            height=0.55, span=2.0 * np.pi,
        )
        render = jax.jit(lambda p: render_desk_depth(camera, p, h, w))
    else:
        n_warm, n_bench = 5, n_frames or 30
        n_total = n_warm + n_bench
        poses = orbit_poses(
            n_total, radius=1.6, height=0.35, span=min(6.28, n_total * 0.05)
        )
        render = jax.jit(
            lambda p: render_scene_depth(camera, p, h, w, _SPHERES, -0.6)
        )
    print(f"rendering {len(poses)} input frames...", file=sys.stderr)
    frames = []
    for pose in poses:
        depth, color = (np.asarray(x) for x in render(pose))
        if noisy:
            depth = add_depth_noise(depth, rng)
        d16 = np.clip(depth * config.depth_raw_scale, 0, 65535).astype(
            np.uint16
        )
        c8 = np.clip(color * 255.0, 0, 255).astype(np.uint8)
        frames.append((d16, c8))
    return frames, poses, n_warm, n_bench


def device_busy_ns(profile) -> float:
    """GPU busy time in a profiler trace: the union of the event intervals
    on each ``/device:GPU:*`` plane (its kernel streams), summed over
    cards.  Raises when the trace holds no GPU plane or no event on one
    -- a measurement that saw no device work is an error, not a zero."""
    planes = [p for p in profile.planes if p.name.startswith("/device:GPU:")]
    if not planes:
        names = [p.name for p in profile.planes]
        raise RuntimeError(f"trace has no GPU device plane (planes: {names})")
    busy = 0.0
    for plane in planes:
        spans = sorted(
            (ev.start_ns, ev.end_ns)
            for line in plane.lines
            for ev in line.events
        )
        end = -float("inf")
        for s, e in spans:
            if s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
    if busy <= 0.0:
        raise RuntimeError("GPU device planes hold no events")
    return busy


def traced_device_ms(run, n_frames):
    """Device ms per frame from a profiler trace of ``run()`` (which does
    ``n_frames`` frames of pipeline work and blocks on its result)."""
    with tempfile.TemporaryDirectory(prefix="vulcan_trace_") as outdir:
        with jax.profiler.trace(outdir):
            run()
        paths = glob.glob(
            os.path.join(outdir, "**", "*.xplane.pb"), recursive=True
        )
        if not paths:
            raise RuntimeError(f"profiler wrote no xplane file in {outdir}")
        profile = jax.profiler.ProfileData.from_file(
            max(paths, key=os.path.getmtime)
        )
    return device_busy_ns(profile) / 1e6 / n_frames


def _check_tracked(state):
    """The tracked pipeline must actually have fused and tracked."""
    alloc = int(state.volume.free_count)
    inl = int(state.track_inliers)
    fails = int(state.track_failures)
    if alloc <= 100 or inl <= 1000 or fails != 0:
        raise RuntimeError(
            f"pipeline did not track: free_count={alloc} "
            f"track_inliers={inl} track_failures={fails}"
        )


def _ate(est, poses):
    from vulcan_tpu.utils.evaluate import ate_rmse

    gt = np.stack([np.asarray(p.translation) for p in poses])
    return round(float(ate_rmse(np.asarray(est), gt)), 5)


def oneshot_measure(
    config, camera, frames, poses, n_warm, n_bench, mode,
    reps=3, trace=True, want_ate=False,
):
    """Device-bound measurement: the sequence staged on the device, ONE
    ``step_seq`` dispatch in the timed region.  Returns the result-dict
    fragment."""
    h, w = frames[0][0].shape
    bench = frames[n_warm:n_warm + n_bench]
    D = jax.device_put(np.stack([d for d, _ in bench]))
    C = jax.device_put(np.stack([c for _, c in bench]))
    Dw = jax.device_put(np.stack([d for d, _ in frames[:n_warm]]))
    Cw = jax.device_put(np.stack([c for _, c in frames[:n_warm]]))
    jax.block_until_ready((D, C, Dw, Cw))

    def warm_state():
        state = fusion.init_state(config, camera, h, w, init_pose=poses[0])
        state, _ = fusion.step_seq(state, Dw, Cw, config, mode)
        return jax.block_until_ready(state)

    def one_run():
        state = warm_state()
        t0 = time.perf_counter()
        state, tr = fusion.step_seq(state, D, C, config, mode)
        jax.block_until_ready((state, tr))
        return n_bench / (time.perf_counter() - t0), tr, state

    print(f"  compiling one-shot ({mode}, {n_bench}f)...", file=sys.stderr)
    t0 = time.perf_counter()
    one_run()
    setup_s = time.perf_counter() - t0

    rep_fps = []
    tr = state = None
    for r in range(max(1, reps)):
        fps_r, tr_r, state_r = one_run()
        rep_fps.append(round(fps_r, 2))
        print(f"  rep {r + 1}: {rep_fps[-1]} FPS", file=sys.stderr)
        if r == 0:
            tr, state = tr_r, state_r

    out = {
        "value": max(rep_fps),
        "rep_fps": rep_fps,
        "fps_mean": round(sum(rep_fps) / len(rep_fps), 2),
        "setup_s": round(setup_s, 1),
    }
    if trace:
        st = warm_state()

        def traced():
            nonlocal st
            st, tr_t = fusion.step_seq(st, D, C, config, mode)
            jax.block_until_ready((st, tr_t))

        dev_ms = traced_device_ms(traced, n_bench)
        out["device_ms_per_frame"] = round(dev_ms, 3)
        out["device_bound_fps"] = round(1000.0 / dev_ms, 2)
        del st
    if want_ate:
        out["ate_rmse_m"] = _ate(tr, poses[n_warm:n_warm + n_bench])
    _check_tracked(state)
    return out


def streaming_measure(
    config, camera, frames, poses, n_warm, n_bench, mode,
    reps=2, mesh_every=0, mesh_full=False, trace=True, want_ate=False,
):
    """Served-path measurement: one ``step`` dispatch per frame with the
    host feeding frames (prefetched one or two frames ahead)."""
    from vulcan_tpu.ops import mcubes

    h, w = frames[0][0].shape

    def mesh_make():
        """A fresh per-rep mesh function (each rep rebuilds its volume)."""
        if mesh_full:
            extract = jax.jit(mcubes.extract_mesh, static_argnames=("config",))
            return lambda state: (state, extract(state.volume, config))
        # Incremental per-block triangle cache: only blocks integration
        # dirtied since the last update re-mesh.  Donation avoids copying
        # the whole voxel volume just to clear the dirty flags.
        update = jax.jit(
            mcubes.update_mesh_cache, static_argnums=2, donate_argnums=(0, 1)
        )
        decode = jax.jit(mcubes.cache_to_mesh, static_argnums=2)
        cache = [mcubes.create_mesh_cache(config)]

        def fn(state):
            vol, cache[0] = update(state.volume, cache[0], config)
            state = dataclasses.replace(state, volume=vol)
            return state, decode(vol, cache[0], config)

        return fn

    def run_frames(state, fs, mesh_fn, est=None):
        mesh, meshed = None, 0
        for i, (d, c) in enumerate(prefetch_to_device(fs)):
            state = fusion.step(state, d, c, config, mode)
            if est is not None:
                # A device copy: the pose buffer is donated to the next step.
                est.append(jnp.array(state.pose.translation))
            if mesh_fn is not None and (i + 1) % mesh_every == 0:
                state, mesh = mesh_fn(state)
                meshed += 1
        jax.block_until_ready((state, mesh))
        return state, mesh, meshed

    def warm_state(mesh_fn):
        state = fusion.init_state(config, camera, h, w, init_pose=poses[0])
        state, _, _ = run_frames(state, frames[:n_warm], None)
        if mesh_fn is not None:
            # Compile and run the mesh update outside the timed loop.
            state, mesh = mesh_fn(state)
            jax.block_until_ready(mesh)
        return state

    bench = frames[n_warm:n_warm + n_bench]

    def one_rep():
        mesh_fn = mesh_make() if mesh_every else None
        state = warm_state(mesh_fn)
        est = []
        t0 = time.perf_counter()
        state, mesh, meshed = run_frames(state, bench, mesh_fn, est)
        fps = n_bench / (time.perf_counter() - t0)
        return fps, est, state, mesh, meshed

    print("compiling + warmup...", file=sys.stderr)
    t0 = time.perf_counter()
    one_rep()
    setup_s = time.perf_counter() - t0

    rep_fps = []
    for r in range(max(1, reps)):
        fps_r, est_r, state_r, mesh_r, meshed_r = one_rep()
        rep_fps.append(round(fps_r, 2))
        print(f"  rep {r + 1}: {rep_fps[-1]} FPS", file=sys.stderr)
        if r == 0:
            est, state, mesh, meshed = est_r, state_r, mesh_r, meshed_r

    out = {
        "value": max(rep_fps),
        "rep_fps": rep_fps,
        "fps_mean": round(sum(rep_fps) / len(rep_fps), 2),
        "setup_s": round(setup_s, 1),
    }
    if trace:
        mesh_fn = mesh_make() if mesh_every else None
        st = warm_state(mesh_fn)

        def traced():
            nonlocal st
            st, _, _ = run_frames(st, bench, mesh_fn)

        dev_ms = traced_device_ms(traced, n_bench)
        out["device_ms_per_frame"] = round(dev_ms, 3)
        out["device_bound_fps"] = round(1000.0 / dev_ms, 2)
        del st
    if mesh_every:
        out["mesh_extractions"] = meshed
        out["mesh_triangles"] = int(mesh.count) if mesh is not None else 0
    if want_ate:
        out["ate_rmse_m"] = _ate(
            np.stack([np.asarray(e) for e in est]),
            poses[n_warm:n_warm + n_bench],
        )
    _check_tracked(state)
    return out


def main(argv=None):
    from vulcan_tpu.utils.runtime import setup_cache

    argv = sys.argv[1:] if argv is None else argv
    setup_cache()
    device = device_record()

    args = _parse_args(argv)
    noisy = "--noise" in argv
    streaming = "--streaming" in argv or args["mesh_every"] > 0
    trace = "--no-trace" not in argv
    overrides = dict(args["overrides"])
    if args["render"]:
        overrides["render_mode"] = args["render"]
    config = Config(ablate=args["ablate"])
    if overrides:
        config = dataclasses.replace(config, **overrides)
    camera = PinholeCamera.tum_default()

    frames, poses, n_warm, n_bench = make_scene(
        args["scene"], args["frames"], config, camera, noisy
    )
    want_ate = noisy or args["scene"] == "desk"

    # A default (argument-less) invocation also measures the modes block;
    # any explicit scene/mode/ablation/override focuses the run.
    default_run = not (
        streaming or noisy or args["ablate"] or args["render"]
        or args["overrides"] or args["frames"]
        or args["scene"] != "orbit" or args["mode"] != "depth"
        or "--no-modes" in argv
    )

    if streaming:
        body = streaming_measure(
            config, camera, frames, poses, n_warm, n_bench, args["mode"],
            reps=args["reps"] or 2, mesh_every=args["mesh_every"],
            mesh_full="--mesh-full" in argv, trace=trace, want_ate=want_ate,
        )
    else:
        body = oneshot_measure(
            config, camera, frames, poses, n_warm, n_bench, args["mode"],
            reps=args["reps"] or 3, trace=trace, want_ate=want_ate,
        )

    name = "track+fuse+render FPS @ 640x480"
    name += " (desk scene, full 2pi orbit" if args["scene"] == "desk" else (
        " (synthetic orbit"
    )
    name += {
        "depth": ", full ICP)",
        "combined": ", combined-mode ICP)",
        "light": ", light-mode ICP + SH illumination)",
    }[args["mode"]]
    if args["mesh_every"]:
        name += f" + mesh every {args['mesh_every']}"
    if streaming:
        name += " [streaming]"
    if noisy:
        name += " [Kinect-noise depth]"
    fps = body.pop("value")
    result = {
        "metric": name,
        "value": fps,
        "unit": "fps",
        "vs_baseline": round(fps / 30.0, 3),
        "device": device,
        "overrides": {k: str(v) for k, v in overrides.items()},
        **body,
        "peak_bytes_in_use": (jax.devices()[0].memory_stats() or {}).get(
            "peak_bytes_in_use"
        ),
    }

    if default_run:
        # Every shipped tracking mode's speed and desk accuracy.  The
        # 240-frame desk sequence is the accuracy workload (~2x-fr1
        # inter-frame motion, full 2-pi orbit).
        result["modes"] = {}
        dframes, dposes, dw, dbn = make_scene(
            "desk", 240, config, camera, noisy=False
        )
        for m in ("depth", "combined", "light"):
            print(f"modes block: {m} on desk/240...", file=sys.stderr)
            r = oneshot_measure(
                config, camera, dframes, dposes, dw, dbn, m,
                reps=2, trace=trace, want_ate=True,
            )
            r["wall_fps"] = r.pop("value")
            result["modes"][m] = r

    print(json.dumps(result))


if __name__ == "__main__":
    main()
