"""The fused online reconstruction step.

This is the rebuild of the reference's per-frame app loop (SURVEY.md §2 L8,
§4: track -> allocate -> integrate -> raycast), with the crucial
difference (SURVEY.md §4 "rebuild goal"): the entire per-frame pipeline is
ONE jitted, donated function ``step(state, depth, color) -> state`` with
zero device->host syncs -- the reference launches ~dozens of kernels per
frame and reads back the ICP system every GN iteration.

Stages inside one ``step``:
  1. preprocess: bilateral filter + vertex/normal lift + pyramids (L2);
  2. track: coarse-to-fine projective ICP against the previous raycast
     (L6; skips cleanly when the model is empty -- frame 0 keeps its init
     pose);
  3. allocate + visibility: batched block allocation for the tracked pose
     (L3);
  4. integrate: visible-block TSDF+color fusion (L4);
  5. raycast: render the new model maps for the next frame's tracker (L5).
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..config import Config
from ..core.camera import PinholeCamera
from ..core.frame import Frame
from ..core.se3 import SE3
from ..ops import allocate, icp, raycast, sparse
from ..ops import blocks as B
from ..ops.preprocess import build_pyramid
from ..utils.pytree import pytree_dataclass


@pytree_dataclass
class PipelineState:
    """State carried across frames.

    The current pose estimate lives in ``model.pose`` (the raycast pose is
    always the tracked pose of the same frame); storing it twice would
    alias buffers and break jit donation.
    """

    volume: B.VolumeState
    model: raycast.Render      # last rendered model maps (pose = current)
    prev_pose: SE3             # pose of the frame BEFORE model.pose's
                               # (constant-velocity tracker init)
    frame_idx: jax.Array       # () int32
    track_error: jax.Array     # () f32, last ICP robust rms
    track_inliers: jax.Array   # () int32
    track_failures: jax.Array  # () int32, frames skipped by the fusion gate
    track_level_error: jax.Array    # (levels,) per-level robust rms
    track_level_inliers: jax.Array  # (levels,) int32
    track_level_degen: jax.Array    # (levels,) f32 observability score
                                    # (icp._min_eig_normalized; ~0 =
                                    # unobservable pose direction)
    track_degen_frames: jax.Array   # () int32, frames tracked under a
                                    # detected degeneracy (fusion held)
    photo_cnt: jax.Array            # () int32 auto-photo escalation
                                    # countdown: > 0 = photometric rows
                                    # armed for this many more frames
                                    # (Config.auto_photo; re-armed to
                                    # auto_photo_hold while the geometric
                                    # conditioning stays weak)

    @property
    def pose(self) -> SE3:
        return self.model.pose


def init_state(
    config: Config,
    camera: PinholeCamera,
    height: int,
    width: int,
    init_pose: SE3 | None = None,
) -> PipelineState:
    pose = init_pose if init_pose is not None else SE3.identity()
    zc = jnp.zeros((height, width))
    empty = raycast.Render(
        depth=zc,
        vx=zc, vy=zc, vz=zc, nx=zc, ny=zc, nz=zc,
        color=jnp.zeros((height, width, 3)),
        valid=jnp.zeros((height, width), bool),
        camera=camera,
        pose=pose,
    )
    state = PipelineState(
        volume=B.create_volume(config),
        model=empty,
        prev_pose=pose,
        frame_idx=jnp.asarray(0, jnp.int32),
        track_error=jnp.asarray(0.0, jnp.float32),
        track_inliers=jnp.asarray(0, jnp.int32),
        track_failures=jnp.asarray(0, jnp.int32),
        track_level_error=jnp.zeros((config.pyramid_levels,), jnp.float32),
        track_level_inliers=jnp.zeros((config.pyramid_levels,), jnp.int32),
        track_level_degen=jnp.ones((config.pyramid_levels,), jnp.float32),
        track_degen_frames=jnp.asarray(0, jnp.int32),
        photo_cnt=jnp.asarray(0, jnp.int32),
    )
    # Deep-copy every leaf: jax caches small constants, so identical zeros
    # would alias one buffer and `donate_argnames` would see the same
    # buffer twice.
    return jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), state)


def _fuse_and_render(
    volume, frame: Frame, filtered_depth, config, h, w, with_color=True
):
    skip = set(config.ablate.split(",")) if config.ablate else set()
    band_ids = None
    n_band = jnp.asarray(0, jnp.int32)
    if "alloc" not in skip:
        volume, band_ids, n_band = allocate.allocate_for_frame(
            volume, filtered_depth, frame.camera, frame.pose, config
        )
    if "vis" not in skip:
        volume = allocate.update_visibility(
            volume, frame.camera, frame.pose, h, w, config
        )
    # Integrate the truncation-band blocks only (see integrate_sparse).
    if "integrate" not in skip and "alloc" not in skip:
        volume = sparse.integrate_sparse(
            volume, frame, config, ids=band_ids, count=n_band
        )
    if "render" not in skip:
        def _render(wc: bool):
            return raycast.render(
                volume, frame.camera, frame.pose, h, w, config,
                with_color=wc,
                # The online pipeline's model render is consumed by the
                # photometric tracker as INTENSITY only; the packed luma
                # splat renders it in one scatter pass (ops/splat.py).
                color_space=config.model_color,
            )

        if isinstance(with_color, bool):
            render = _render(with_color)
        else:
            # Traced condition (auto-photo escalation): both renders
            # return the identical Render pytree (color is a zeros plane
            # when off), so lax.cond executes only the armed variant.
            render = jax.lax.cond(
                with_color,
                lambda: _render(True),
                lambda: _render(False),
            )
    else:
        render = None
    return volume, render


def predict_pose(state: PipelineState, config: Config) -> SE3:
    """DAMPED constant-velocity tracker initialization.

    Extrapolates a fraction ``a = motion_prediction`` of the last
    inter-frame motion: ``init = exp(a * log(pose @ prev_pose^-1)) @
    pose``.  Damping is a STABILITY requirement, not a tuning nicety:
    the tracked pose feeds the next prediction, so with per-frame ICP
    error gain k (fraction of init error surviving refinement) the
    error obeys e_{t+1} = k((1+a) e_t - a e_{t-1}).  Pure extrapolation
    (a=1) is unstable as k -> 1 -- on the 640x480 orbit bench the
    weakly-observable pose modes (sliding along the floor/spheres) have
    k near 1, and a=1 blew up at the predicted ~2x/frame rate into
    tracking collapse at frame ~13 (round-3 bisect).  a <= 0.5 keeps
    both roots inside the unit circle for every k < 1 while still
    halving the motion the coarse level must recover.
    Identity-safe: frame 0 and gate-held frames have prev_pose == pose.
    """
    a = float(config.motion_prediction)
    if a == 0.0:
        return state.pose
    delta = state.pose @ state.prev_pose.inverse()
    if a != 1.0:
        # Sanitize: log() of a degenerate delta (accumulated f32
        # non-orthogonality once NaN'd here via the small-angle branch,
        # see core/se3._SERIES_T2) must never poison the predicted
        # pose -- a NaN init zeroes every ICP level and costs a whole
        # tracked frame.  Fall back to no extrapolation.
        xi = a * delta.log()
        xi = jnp.where(jnp.all(jnp.isfinite(xi)), xi, jnp.zeros_like(xi))
        delta = SE3.exp(xi)
    return delta @ state.pose


def _to_metric(depth, color, config):
    """Accept raw sensor dtypes and convert ON DEVICE: uint16 depth (TUM
    1/depth_raw_scale meters) and uint8 color upload 3.2x less data than
    f32 -- host->device transfer is a real per-frame cost."""
    if depth.dtype == jnp.uint16:
        depth = depth.astype(jnp.float32) * (1.0 / config.depth_raw_scale)
    if color.dtype == jnp.uint8:
        color = color.astype(jnp.float32) * (1.0 / 255.0)
    return depth, color


@partial(
    jax.jit,
    static_argnames=("config", "mode"),
    donate_argnames=("state",),
)
def step_seq(
    state: PipelineState,
    depths: jax.Array,
    colors: jax.Array,
    config: Config,
    mode: str = "depth",
) -> tuple[PipelineState, jax.Array]:
    """Process a short frame SEQUENCE (k, H, W[,3]) in one dispatch.

    Identical per-frame math to ``step`` (a lax.scan of it), but one
    host->device dispatch per k frames: the benchmark's device-bound
    measurement stages a whole sequence this way, and a streaming
    pipeline naturally has the next frames in flight.

    Returns ``(state, translations)`` with ``translations`` of shape
    (k, 3): the tracked pose translation after each frame, scanned out
    so trajectory evaluation (ATE) does not force the caller back to
    per-frame dispatches.
    """

    def body(st, dc):
        d, c = dc
        st = _step_impl(st, d, c, config, mode)
        return st, st.pose.translation

    return jax.lax.scan(body, state, (depths, colors))


@partial(
    jax.jit,
    static_argnames=("config", "mode"),
    donate_argnames=("state",),
)
def step(
    state: PipelineState,
    depth: jax.Array,
    color: jax.Array,
    config: Config,
    mode: str = "depth",
) -> PipelineState:
    """One online frame: track, fuse, raycast.  Fully on device."""
    return _step_impl(state, depth, color, config, mode)


def _step_impl(
    state: PipelineState,
    depth: jax.Array,
    color: jax.Array,
    config: Config,
    mode: str = "depth",
) -> PipelineState:
    depth, color = _to_metric(depth, color, config)
    h, w = depth.shape
    camera = state.model.camera
    frame = Frame(depth, color, camera, state.pose)
    # Auto-photo escalation (round-5, VERDICT item 4): in depth mode,
    # when the GEOMETRIC conditioning sits in the measured weak band
    # (desk slide: geo scores 0.1-0.2 compound the harsh orbit motion
    # into wrong-basin convergence, ATE 0.995 m; photometric rows fix
    # it -- round-4 study), arm combined-mode
    # tracking for the next auto_photo_hold frames.  Both track variants
    # sit in a lax.cond, so a well-conditioned run (orbit) executes the
    # pure-depth branch and pays nothing but the intensity pyramids.
    # One-frame latency by design: arming at frame t renders the model
    # WITH luma at t, so frame t+1 has both sides of the photometric
    # term.
    auto = (
        mode == "depth"
        and config.auto_photo
        and config.degen_min_eig > 0.0
        and "track" not in (config.ablate or "").split(",")
    )
    armed = state.photo_cnt > 0
    with_int = (mode != "depth") or auto
    live_pyr = build_pyramid(frame, config, with_intensity=with_int)

    # --- track against the previous model (no-op when model is empty) ---
    if "track" in (config.ablate or "").split(","):
        result = icp.TrackResult(
            pose=state.pose,
            error=jnp.zeros(()),
            inliers=jnp.asarray(10**6, jnp.int32),
            valid=jnp.asarray(True),
            level_error=jnp.zeros((config.pyramid_levels,), jnp.float32),
            level_inliers=jnp.full(
                (config.pyramid_levels,), 10**6, jnp.int32
            ),
            level_degen=jnp.ones((config.pyramid_levels,), jnp.float32),
            min_degen=jnp.ones(()),
            geo_degen=jnp.ones(()),
        )
    else:
        model_pyr = icp.model_pyramid(
            state.model, config.pyramid_levels,
            with_intensity=with_int,
            # Silhouette erosion threshold for the photometric mask,
            # scaled so coarse-voxel configs (whose surfaces carry
            # voxel-size depth quantization) do not erode everything.
            flat_thresh=max(0.05, 6.0 * config.voxel_size),
        )
        init_pose = predict_pose(state, config)
        if auto:
            result = jax.lax.cond(
                armed,
                lambda lp, mp, ip: icp.track(lp, mp, ip, config, "combined"),
                lambda lp, mp, ip: icp.track(lp, mp, ip, config, "depth"),
                live_pyr, model_pyr, init_pose,
            )
        else:
            result = icp.track(live_pyr, model_pyr, init_pose, config, mode)

    # --- fusion gate (InfiniTAM-style tracking-quality gating) ----------
    # A diverged or starved track (occlusion, blur, all-invalid depth)
    # must NOT be fused: a single bad frame permanently corrupts the TSDF.
    # On failure the previous pose is kept and the frame's depth is masked
    # to invalid, so allocation finds no candidates and integration fuses
    # nothing -- the model re-renders from the held pose and the camera
    # re-localizes against it when tracking returns.  (Masking instead of
    # lax.cond keeps one traced path: a cond around the fuse branch breaks
    # donation aliasing and copies the hash table + volume every frame.)
    # Frame 0 (and any empty model) bypasses the gate: nothing to track.
    model_empty = ~jnp.any(state.model.valid)
    # Coarse-level sanity: a track that diverged at a coarse level and
    # "re-converged" onto wrong geometry at the finest reports a healthy
    # finest error; its coarse levels do not.  3x headroom over the
    # finest threshold accounts for the naturally larger coarse rms.
    levels_sane = jnp.all(
        result.level_error < 3.0 * config.icp_max_error
    )
    trusted = model_empty | (
        result.valid & (result.error < config.icp_max_error) & levels_sane
    )
    pose = jax.tree_util.tree_map(
        lambda a, b: jnp.where(trusted, a, b), result.pose, state.pose
    )
    # Degeneracy hold (SURVEY §4.2 gating; the desk-scene analysis):
    # an unobservable pose direction (dominant parallel planes) lets the
    # pose slide while error/inliers stay perfect.  The tracked pose is
    # KEPT (its observable DoF beat holding), but the frame is NOT fused
    # -- geometry observed under a slid pose would compound the drift
    # into the map and poison re-localization.  Counted separately from
    # track_failures: the track did not fail, the scene under-constrains
    # it; the durable fix is photometric tracking (mode="combined").
    degenerate = (
        (~model_empty)
        & trusted
        & (result.min_degen < config.degen_min_eig)
    )
    fuse_ok = trusted & ~degenerate
    fused_depth = jnp.where(fuse_ok, depth, 0.0)
    filtered = jnp.where(fuse_ok, live_pyr[0].depth, 0.0)

    # --- auto-photo countdown (decided BEFORE this frame's render so the
    # model luma is available the moment the next frame needs it) -------
    if auto:
        weak = (~model_empty) & (result.geo_degen < config.auto_photo_enter)
        photo_cnt = jnp.where(
            weak,
            jnp.asarray(config.auto_photo_hold, jnp.int32),
            jnp.maximum(state.photo_cnt - 1, 0),
        )
    else:
        photo_cnt = state.photo_cnt

    # --- fuse + render with the tracked pose ----------------------------
    # Depth-only tracking never reads model color; skip its render cost.
    # Under auto-photo the color render is a traced condition (armed).
    tracked = Frame(fused_depth, color, camera, pose)
    volume, render = _fuse_and_render(
        state.volume, tracked, filtered, config, h, w,
        with_color=(photo_cnt > 0) if auto else (mode != "depth"),
    )
    return dataclasses.replace(
        state,
        volume=volume,
        model=render if render is not None else state.model,
        prev_pose=state.pose,
        frame_idx=state.frame_idx + 1,
        track_error=result.error,
        track_inliers=result.inliers,
        track_failures=state.track_failures + (1 - trusted.astype(jnp.int32)),
        track_level_error=result.level_error,
        track_level_inliers=result.level_inliers,
        track_level_degen=result.level_degen,
        track_degen_frames=(
            state.track_degen_frames + degenerate.astype(jnp.int32)
        ),
        photo_cnt=photo_cnt,
    )


@partial(
    jax.jit,
    static_argnames=("config",),
    donate_argnames=("state",),
)
def step_known_pose(
    state: PipelineState,
    depth: jax.Array,
    color: jax.Array,
    pose: SE3,
    config: Config,
) -> PipelineState:
    """Fusion-only frame with an externally supplied pose (BASELINE.json
    configs 2-3 and evaluation with ground-truth trajectories)."""
    depth, color = _to_metric(depth, color, config)
    h, w = depth.shape
    camera = state.model.camera
    frame = Frame(depth, color, camera, pose)
    pyr = build_pyramid(frame, config)
    volume, render = _fuse_and_render(
        state.volume, frame, pyr[0].depth, config, h, w
    )
    return dataclasses.replace(
        state,
        volume=volume,
        model=render,
        prev_pose=state.pose,
        frame_idx=state.frame_idx + 1,
    )
