"""Config-4 tests (BASELINE.json): projective ICP pose recovery.

Reference test pattern (SURVEY.md §5): perturb a pose, check ICP recovers it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from vulcan_tpu.config import TINY
from vulcan_tpu.core.camera import PinholeCamera
from vulcan_tpu.core.frame import make_frame
from vulcan_tpu.core.se3 import SE3
from vulcan_tpu.io.synthetic import look_at, render_scene_depth
from vulcan_tpu.ops import icp
from vulcan_tpu.ops.preprocess import build_pyramid

CFG = dataclasses.replace(TINY, icp_iters=(6, 6, 10))
CAM = PinholeCamera.create(160.0, 160.0, 99.5, 74.5)
H, W = 150, 200
# A scene with enough geometry to constrain all 6 DoF.
SPHERES = (
    ((0.0, 0.0, 0.0), 0.5),
    ((0.6, 0.3, 0.2), 0.25),
    ((-0.5, 0.4, -0.1), 0.3),
)
FLOOR = -0.6


def scene_frame(pose):
    depth, color = render_scene_depth(CAM, pose, H, W, SPHERES, FLOOR)
    return make_frame(depth, color, CAM, pose)


def run_track(true_pose, init_pose, mode="depth"):
    frame_model = scene_frame(true_pose)
    # Model maps from the ground-truth pose'd frame (simulating a perfect
    # raycast of the fused volume).
    pyr_model = build_pyramid(frame_model, CFG)
    model_pyr = tuple(
        icp.model_from_frame_maps(m, true_pose) for m in pyr_model
    )
    # The live frame IS the same view; tracking starts from a wrong pose
    # and must converge back to true_pose.
    live_pyr = build_pyramid(frame_model, CFG)
    fn = jax.jit(icp.track, static_argnums=(3, 4))
    return fn(live_pyr, model_pyr, init_pose, CFG, mode)


def pose_error(a: SE3, b: SE3):
    """(rot_deg, trans_m) between two poses."""
    d = a.inverse() @ b
    xi = np.asarray(d.log())
    return (
        np.linalg.norm(xi[:3]) * 180 / np.pi,
        np.linalg.norm(np.asarray(a.translation) - np.asarray(b.translation)),
    )


def test_icp_recovers_small_perturbation():
    true_pose = look_at((1.4, 0.3, 0.5), (0.0, 0.0, 0.0))
    rng = np.random.default_rng(0)
    for i in range(3):
        xi = np.concatenate(
            [rng.uniform(-0.03, 0.03, 3), rng.uniform(-0.02, 0.02, 3)]
        )
        init = SE3.exp(jnp.asarray(xi, jnp.float32)) @ true_pose
        res = run_track(true_pose, init)
        rot_err, t_err = pose_error(res.pose, true_pose)
        assert rot_err < 0.15, f"case {i}: rot {rot_err}"
        assert t_err < 0.003, f"case {i}: trans {t_err}"
        assert bool(res.valid)


def test_icp_recovers_larger_perturbation():
    """SURVEY §5: converges from perturbations up to ~(5 deg, 5 cm)."""
    true_pose = look_at((1.5, -0.2, 0.4), (0.0, 0.0, 0.0))
    xi = np.asarray([0.05, -0.06, 0.04, 0.03, -0.04, 0.03])  # ~5 deg, 6 cm
    init = SE3.exp(jnp.asarray(xi, jnp.float32)) @ true_pose
    res = run_track(true_pose, init)
    rot_err, t_err = pose_error(res.pose, true_pose)
    assert rot_err < 0.3
    assert t_err < 0.01


def test_icp_identity_stays_put():
    true_pose = look_at((1.4, 0.3, 0.5), (0.0, 0.0, 0.0))
    res = run_track(true_pose, true_pose)
    rot_err, t_err = pose_error(res.pose, true_pose)
    assert rot_err < 0.05
    assert t_err < 0.001


def test_icp_combined_mode_converges():
    true_pose = look_at((1.4, 0.2, 0.6), (0.0, 0.0, 0.0))
    xi = np.asarray([0.02, -0.02, 0.02, 0.02, -0.02, 0.01])
    init = SE3.exp(jnp.asarray(xi, jnp.float32)) @ true_pose
    res = run_track(true_pose, init, mode="combined")
    rot_err, t_err = pose_error(res.pose, true_pose)
    assert rot_err < 0.3
    assert t_err < 0.005


def test_icp_reports_invalid_without_data():
    true_pose = look_at((1.4, 0.3, 0.5), (0.0, 0.0, 0.0))
    empty = make_frame(jnp.zeros((H, W)), camera=CAM, pose=true_pose)
    live_pyr = build_pyramid(empty, CFG)
    model_pyr = tuple(
        icp.model_from_frame_maps(m, true_pose) for m in live_pyr
    )
    res = icp.track(live_pyr, model_pyr, true_pose, CFG)
    assert not bool(res.valid)
    # Pose unchanged when there are no constraints.
    rot_err, t_err = pose_error(res.pose, true_pose)
    assert rot_err < 1e-5 and t_err < 1e-6


def test_model_map_packing_roundtrips():
    """Quantization contracts of the bit-packed ICP model maps: 21-bit
    fixed-point vertices (15 um over +-16 m) and 10-bit normals with the
    validity bit (regression guard for the pack layouts)."""
    rng = np.random.default_rng(1)
    v = rng.uniform(-15.9, 15.9, (3, 5000)).astype(np.float32)
    p1, p2 = icp._pack_vertices(*(jnp.asarray(x) for x in v))
    out = icp._unpack_vertices(p1, p2)
    for a, b in zip(v, out):
        assert np.abs(np.asarray(b) - a).max() < 1.0 / 65536.0

    # Camera-relative packing: vertices far from the WORLD origin (well
    # beyond the raw +-16 m span) roundtrip exactly as long as they stay
    # within range of the model camera -- the long-trajectory regression
    # the absolute packing had.
    origin = jnp.asarray([103.0, -77.5, 250.25], np.float32)
    v_far = np.asarray(origin)[:, None] + rng.uniform(
        -5.0, 5.0, (3, 5000)
    ).astype(np.float32)
    p1, p2 = icp._pack_vertices(
        *(jnp.asarray(x) for x in v_far), origin
    )
    out = icp._unpack_vertices(p1, p2, origin)
    for a, b in zip(v_far, out):
        # Absolute error grows with the origin's own f32 rounding; 0.1 mm
        # is still 100x tighter than the association distance gate.
        assert np.abs(np.asarray(b) - a).max() < 1e-4

    n = rng.normal(size=(3, 5000)).astype(np.float32)
    n /= np.linalg.norm(n, axis=0, keepdims=True)
    valid = rng.random(5000) < 0.7
    p = icp._pack_normals(*(jnp.asarray(x) for x in n), jnp.asarray(valid))
    nx, ny, nz, ok = icp._unpack_normals(p)
    assert np.array_equal(np.asarray(ok), valid)
    for a, b in zip(n, (nx, ny, nz)):
        assert np.abs(np.asarray(b) - a).max() < 2.0 / 511.5


def test_starved_coarse_level_invalidates_track():
    """Per-level health (VERDICT round-2 item 4): a coarse level with no
    usable model data must invalidate the whole track, even though the
    finest level alone would pass the inlier threshold."""
    true_pose = look_at((1.4, 0.3, 0.5), (0.0, 0.0, 0.0))
    frame = scene_frame(true_pose)
    pyr_model = build_pyramid(frame, CFG)
    model_pyr = list(
        icp.model_from_frame_maps(m, true_pose) for m in pyr_model
    )
    # Starve the coarsest level: kill every valid bit in its packed maps.
    coarse = model_pyr[-1]
    model_pyr[-1] = dataclasses.replace(
        coarse,
        npack=jnp.zeros_like(coarse.npack),
        valid=jnp.zeros_like(coarse.valid),
    )
    live_pyr = build_pyramid(frame, CFG)
    res = icp.track(live_pyr, tuple(model_pyr), true_pose, CFG)
    assert int(res.level_inliers[-1]) == 0
    # The finest level still tracked fine on its own...
    assert int(res.inliers) > CFG.icp_min_inliers
    # ...but the per-level gate declares the track invalid.
    assert not bool(res.valid)

    # Control: the intact pyramid is valid and reports healthy levels.
    res_ok = icp.track(
        live_pyr,
        tuple(
            icp.model_from_frame_maps(m, true_pose) for m in pyr_model
        ),
        true_pose, CFG,
    )
    assert bool(res_ok.valid)
    assert all(int(x) > 0 for x in res_ok.level_inliers)
    assert all(
        float(e) < CFG.icp_max_error for e in res_ok.level_error
    )


def test_patched_association_matches_flat():
    """The one-hot patch association must return EXACTLY the flat
    path's packed model values wherever it associates, and cover ~all
    of the flat associations for a smooth small warp."""
    true_pose = look_at((1.4, 0.3, 0.5), (0.0, 0.0, 0.0))
    frame = scene_frame(true_pose)
    pyr = build_pyramid(frame, CFG)
    live = pyr[0]
    model = icp.model_from_frame_maps(pyr[0], true_pose)
    # A small warp: a few degrees / cm off the model pose.
    xi = np.asarray([0.02, -0.03, 0.02, 0.02, -0.01, 0.02], np.float32)
    pose = SE3.exp(jnp.asarray(xi)) @ true_pose

    v_f, n_f, ok_f = icp.associate_depth(live, model, pose, CFG)
    assoc = icp._PatchAssoc(model)
    v_p, n_p, ok_p = icp.associate_depth_patched(
        live, model, pose, CFG, assoc
    )
    okf = np.asarray(ok_f)
    okp = np.asarray(ok_p)
    assert okf.sum() > 5000
    # Patched associations are a subset of flat ones (window drops only).
    assert (okp & ~okf).sum() == 0
    assert okp.sum() / okf.sum() > 0.99, okp.sum() / okf.sum()
    both = okp & okf
    np.testing.assert_array_equal(
        np.asarray(v_p)[both], np.asarray(v_f)[both]
    )
    np.testing.assert_array_equal(
        np.asarray(n_p)[both], np.asarray(n_f)[both]
    )

    # Window reuse across rounds: a slightly moved pose still associates
    # against the frozen windows.
    pose2 = SE3.exp(jnp.asarray(0.3 * xi)) @ true_pose
    v_f2, n_f2, ok_f2 = icp.associate_depth(live, model, pose2, CFG)
    v_p2, n_p2, ok_p2 = icp.associate_depth_patched(
        live, model, pose2, CFG, assoc
    )
    both2 = np.asarray(ok_p2) & np.asarray(ok_f2)
    assert both2.sum() / np.asarray(ok_f2).sum() > 0.98
    np.testing.assert_array_equal(
        np.asarray(v_p2)[both2], np.asarray(v_f2)[both2]
    )


def test_track_with_patched_association():
    """Full coarse-to-fine track with assoc_patch forced on recovers a
    perturbed pose like the flat path (fine levels patch-gather, the
    coarsest stays flat)."""
    cfg = dataclasses.replace(CFG, assoc_patch="on")
    true_pose = look_at((1.4, 0.3, 0.5), (0.0, 0.0, 0.0))
    frame = scene_frame(true_pose)
    pyr_model = build_pyramid(frame, cfg)
    model_pyr = tuple(
        icp.model_from_frame_maps(m, true_pose) for m in pyr_model
    )
    live_pyr = build_pyramid(frame, cfg)
    xi = np.asarray([0.03, -0.03, 0.02, 0.02, -0.02, 0.02])
    init = SE3.exp(jnp.asarray(xi, jnp.float32)) @ true_pose
    res = icp.track(live_pyr, model_pyr, init, cfg)
    rot_err, t_err = pose_error(res.pose, true_pose)
    assert bool(res.valid)
    assert rot_err < 0.2, rot_err
    assert t_err < 0.005, t_err


def test_patched_photometric_samples_match_flat():
    """Combined-mode fused patch gather: at an integer-pixel warp (pose ==
    model pose, same camera) the nearest sample IS the bilinear sample, so
    the fused i_m0/gu/gv must match color_assoc's to the 16-bit
    quantization step wherever both associate."""
    true_pose = look_at((1.4, 0.3, 0.5), (0.0, 0.0, 0.0))
    frame = scene_frame(true_pose)
    pyr = build_pyramid(frame, CFG)
    live = pyr[0]
    model = icp.model_from_frame_maps(pyr[0], true_pose)
    grads = icp.intensity_grads(model.intensity)

    assoc = icp._PatchAssoc(model, photo=True)
    v_p, n_p, ok_p, samples = icp.associate_depth_patched(
        live, model, true_pose, CFG, assoc
    )
    i_p, gu_p, gv_p, u0, v0, ok_s = samples
    i_f, gu_f, gv_f, uf, vf, ok_f = icp.color_assoc(
        live, model, grads, true_pose, CFG
    )
    both = np.asarray(ok_s) & np.asarray(ok_f)
    assert both.sum() > 5000
    for got, want, name in (
        (i_p, i_f, "intensity"), (gu_p, gu_f, "gu"), (gv_p, gv_f, "gv")
    ):
        np.testing.assert_allclose(
            np.asarray(got)[both], np.asarray(want)[both],
            atol=3e-4, err_msg=name,
        )
    # The geometric outputs are untouched by the photometric columns.
    v_f2, n_f2, ok_f2 = icp.associate_depth(live, model, true_pose, CFG)
    g_both = np.asarray(ok_p) & np.asarray(ok_f2)
    np.testing.assert_array_equal(
        np.asarray(v_p)[g_both], np.asarray(v_f2)[g_both]
    )

    # NON-integer warp (a small pose perturbation): the hat-weight blend
    # of the gathered 3x3 must still reproduce the flat path's bilinear
    # samples exactly up to quantization -- sub-pixel offsets exercise
    # every branch of the 2x2-inside-3x3 footprint.  (Cheaper fused
    # estimators matched at integer warps but diverged here, and that
    # 10% per-frame bias tripled the desk-orbit ATE; see _PatchAssoc.)
    xi = np.asarray([0.004, -0.006, 0.005, 0.003, -0.004, 0.006],
                    np.float32)
    pose2 = SE3.exp(jnp.asarray(xi)) @ true_pose
    assoc2 = icp._PatchAssoc(model, photo=True)
    _, _, _, samples2 = icp.associate_depth_patched(
        live, model, pose2, CFG, assoc2
    )
    i_p2, gu_p2, gv_p2, _, _, ok_s2 = samples2
    i_f2, gu_f2, gv_f2, _, _, ok_fl2 = icp.color_assoc(
        live, model, grads, pose2, CFG
    )
    both2 = np.asarray(ok_s2) & np.asarray(ok_fl2)
    assert both2.sum() > 5000
    for got, want, name in (
        (i_p2, i_f2, "intensity"), (gu_p2, gu_f2, "gu"),
        (gv_p2, gv_f2, "gv"),
    ):
        np.testing.assert_allclose(
            np.asarray(got)[both2], np.asarray(want)[both2],
            atol=3e-4, err_msg=name,
        )


def test_track_combined_with_patched_association():
    """Full combined-mode coarse-to-fine track with assoc_patch forced on
    (photometric samples ride the one-hot patch gather)
    recovers a perturbed pose."""
    cfg = dataclasses.replace(CFG, assoc_patch="on")
    true_pose = look_at((1.4, 0.3, 0.5), (0.0, 0.0, 0.0))
    frame = scene_frame(true_pose)
    pyr_model = build_pyramid(frame, cfg)
    model_pyr = tuple(
        icp.model_from_frame_maps(m, true_pose) for m in pyr_model
    )
    live_pyr = build_pyramid(frame, cfg)
    xi = np.asarray([0.03, -0.03, 0.02, 0.02, -0.02, 0.02])
    init = SE3.exp(jnp.asarray(xi, jnp.float32)) @ true_pose
    res = icp.track(live_pyr, model_pyr, init, cfg, "combined")
    rot_err, t_err = pose_error(res.pose, true_pose)
    assert bool(res.valid)
    assert rot_err < 0.2, rot_err
    assert t_err < 0.005, t_err


def test_depth_flat_mask_cuts_silhouettes_and_keeps_interiors():
    """_depth_flat_mask: silhouette-adjacent and invalid-adjacent pixels
    are photometrically invalid; flat interiors survive (the splat
    renderer's color is untrustworthy near depth discontinuities --
    hole-fill diffusion + mixed fore/background winner voxels)."""
    h, w = 32, 48
    depth = jnp.full((h, w), 2.0)
    # A foreground square 1 m closer.
    depth = depth.at[10:20, 12:24].set(1.0)
    valid = jnp.ones((h, w), bool)
    # An invalid hole.
    valid = valid.at[25, 40].set(False)
    m = np.asarray(icp._depth_flat_mask(depth, valid, reach=2, thresh=0.05))
    # Interior of the foreground square and the far background survive.
    assert m[15, 18] and m[5, 5] and m[28, 10]
    # Pixels within reach=2 of the depth step are cut, on BOTH sides.
    assert not m[10, 18] and not m[9, 18] and not m[11, 18]
    assert not m[20, 18] and not m[19, 18] and not m[21, 18]
    # Pixels within reach of the invalid hole are cut; the hole itself too.
    assert not m[25, 40] and not m[25, 39] and not m[24, 40] and not m[27, 40]
    # But 3+ pixels away from the hole survive.
    assert m[25, 36] and m[21, 40]
    # Image border (half-window out of bounds) is conservative-invalid.
    assert not m[0, 20] and not m[20, 0]


def test_model_pyramid_photometric_mask_erodes_only_intensity_path():
    """model_pyramid with intensity erodes ModelMaps.valid near depth
    steps but leaves the packed geometric valid bit (npack) untouched."""
    true_pose = look_at((1.4, 0.3, 0.5), (0.0, 0.0, 0.0))
    frame = scene_frame(true_pose)
    pyr = build_pyramid(frame, CFG)
    m0 = icp.model_from_frame_maps(pyr[0], true_pose)
    # A Render-like object via the splat Render class is heavyweight;
    # drive model_pyramid directly with a fake Render built from maps.
    from vulcan_tpu.ops.raycast import Render

    fm = pyr[0]
    ok = fm.depth > 0
    v = true_pose.apply(fm.vertices)
    n = true_pose.rotate(fm.normals)
    render = Render(
        depth=fm.depth,
        vx=v[..., 0], vy=v[..., 1], vz=v[..., 2],
        nx=n[..., 0], ny=n[..., 1], nz=n[..., 2],
        color=frame.color,
        valid=ok,
        camera=fm.camera,
        pose=true_pose,
    )
    mp = icp.model_pyramid(render, CFG.pyramid_levels, with_intensity=True)
    n_geo = int(np.asarray((mp[0].npack >> 30) > 0).sum())
    n_photo = int(np.asarray(mp[0].valid).sum())
    n_raw = int(np.asarray(ok).sum())
    assert n_geo == n_raw                  # geometric bit not eroded
    assert 0 < n_photo < n_raw             # photometric mask eroded
    # Erosion is bounded: this scene's silhouettes are a small fraction.
    assert n_photo > 0.5 * n_raw


def _track_self(depth, color, pose, mode="depth"):
    """Track a frame against an ideal model of itself from the true pose
    (isolates the 6x6 system's conditioning from convergence effects)."""
    frame = make_frame(depth, color, CAM, pose)
    pyr = build_pyramid(frame, CFG, with_intensity=(mode != "depth"))
    model_pyr = tuple(
        icp.model_from_frame_maps(m, pose) for m in pyr
    )
    return icp.track(pyr, model_pyr, pose, CFG, mode)


def test_degeneracy_detector_fires_on_dominant_plane():
    """The demonstrated silent failure (the desk-scene analysis):
    point-to-plane ICP on a plane-dominated view has a 3-DoF null space
    and SLIDES while error/inliers look perfect.  The observability
    score (smallest normalized eigenvalue of the 6x6, TrackResult
    .level_degen) must drop orders of magnitude below healthy scenes --
    it is the only diagnostic that can see this failure mode.

    Measured calibration (this scene setup): bare floor finest level
    ~0.0018; sphere scene >= 0.39; combined-mode floor (procedural
    texture) ~0.076.  Config.degen_min_eig sits between."""
    pose = look_at((1.2, 0.2, 0.4), (0.0, 0.0, -0.6))
    depth, color = render_scene_depth(CAM, pose, H, W, (), FLOOR)
    res = _track_self(depth, color, pose)
    # Every magnitude health metric reads PERFECT...
    assert int(res.inliers) > 3000
    assert float(res.error) < 0.001
    assert bool(res.valid)
    # ...but the spectrum exposes the null space.
    assert float(jnp.min(res.level_degen)) < 0.005
    assert float(jnp.min(res.level_degen)) < CFG.degen_min_eig


def test_degeneracy_healthy_on_constrained_scene():
    pose = look_at((1.4, 0.3, 0.5), (0.0, 0.0, 0.0))
    depth, color = render_scene_depth(CAM, pose, H, W, SPHERES, FLOOR)
    res = _track_self(depth, color, pose)
    assert float(jnp.min(res.level_degen)) > 0.05
    assert float(jnp.min(res.level_degen)) > 5 * CFG.degen_min_eig


def test_degeneracy_rescued_by_photometric_term():
    """Combined-mode tracking on the SAME degenerate floor view is
    observable again (the textured photometric rows constrain the
    in-plane DoF) -- the GATE score must say so, since mode="combined"
    is the documented fix for the desk slide.  With the default
    photo_levels=2 the finest level is geometric-only BY CONFIG: its
    per-level score correctly reads ~0 on a plane, but it is excluded
    from the gate (TrackResult.min_degen) because the coarse
    photometric levels anchor the pose and damping keeps the finest
    level off its null space."""
    pose = look_at((1.2, 0.2, 0.4), (0.0, 0.0, -0.6))
    depth, color = render_scene_depth(CAM, pose, H, W, (), FLOOR)
    res = _track_self(depth, color, pose, mode="combined")
    assert float(res.min_degen) > 0.02
    assert float(res.min_degen) > 2 * CFG.degen_min_eig
    # The photometric (gated) levels are all healthy...
    for level in range(1, CFG.pyramid_levels):
        assert float(res.level_degen[level]) > 0.02
    # ...and the config-skipped finest level reports its honest
    # geometric-only collapse in the diagnostics.
    assert float(res.level_degen[0]) < 0.005


def test_min_eig_estimator_matches_eigvalsh():
    """The fixed-iteration inverse-power estimator inside
    _min_eig_normalized must agree with a dense eigensolve across the
    regimes the detector must separate: degenerate (planes), healthy,
    and in-between.  Tolerance is loose in the healthy regime (the
    estimator may err HIGH there -- see its docstring) but the
    decision band around degen_min_eig must be exact."""
    rng = np.random.default_rng(5)

    def ref_min_eig(H):
        d = np.sqrt(np.maximum(np.diagonal(H), 1e-20))
        Hn = H / (d[:, None] * d[None, :])
        return float(np.min(np.linalg.eigvalsh(Hn)))

    def make_spd(eigs):
        q, _ = np.linalg.qr(rng.normal(size=(6, 6)))
        return (q * eigs) @ q.T

    for eigs in (
        [1e-7, 0.5, 0.8, 1.0, 1.2, 1.5],     # hard degenerate
        [1e-4, 1e-4, 1e-3, 0.9, 1.0, 1.1],   # 3-DoF null space
        [5e-3, 0.4, 0.6, 0.9, 1.0, 1.2],     # just below threshold
        [0.05, 0.3, 0.6, 0.9, 1.0, 1.2],     # healthy
        [0.9, 0.95, 1.0, 1.0, 1.05, 1.1],    # perfectly conditioned
    ):
        H = make_spd(np.asarray(eigs)) * rng.uniform(1e2, 1e6)
        got = float(icp._min_eig_normalized(jnp.asarray(H, jnp.float32)))
        want = ref_min_eig(H)
        if want < 0.02:
            assert abs(got - want) < 0.3 * max(want, 1e-6) + 2e-4, (
                eigs, got, want
            )
        else:
            # Healthy regime: never reads degenerate.
            assert got > 0.02, (eigs, got, want)
    # Zero system reports 0 (maximally degenerate).
    assert float(icp._min_eig_normalized(jnp.zeros((6, 6)))) == 0.0
