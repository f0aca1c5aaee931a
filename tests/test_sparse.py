"""Config-3 tests (BASELINE.json): voxel-block hashing with sparse
allocation + visible-block-only integration/raycast."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vulcan_tpu.config import TINY
from vulcan_tpu.core.camera import PinholeCamera
from vulcan_tpu.core.frame import make_frame
from vulcan_tpu.io.synthetic import orbit_poses, render_sphere_depth, sphere_sdf
from vulcan_tpu.ops import allocate, blocks, raycast, sparse

CFG = dataclasses.replace(
    TINY, voxel_size=0.02, trunc_dist=0.08, alloc_subsample=2
)
CAM = PinholeCamera.create(120.0, 120.0, 79.5, 59.5)
H, W = 120, 160
CENTER = (0.0, 0.0, 0.0)
RADIUS = 0.5


def sphere_frame(pose):
    depth, color = render_sphere_depth(CAM, pose, H, W, CENTER, RADIUS)
    return make_frame(depth, color, CAM, pose)


def fuse(volume, frame):
    return fuse_cfg(volume, frame, CFG)


def fuse_cfg(volume, frame, cfg):
    volume, _, _ = allocate.allocate_for_frame(
        volume, frame.depth, frame.camera, frame.pose, cfg
    )
    volume = allocate.update_visibility(
        volume, frame.camera, frame.pose, H, W, cfg
    )
    return sparse.integrate_sparse(volume, frame, cfg)


def test_allocation_covers_truncation_band():
    vol = blocks.create_volume(CFG)
    pose = orbit_poses(1, CENTER, radius=1.6, height=0.0)[0]
    frame = sphere_frame(pose)
    vol = fuse(vol, frame)
    n_alloc = int(vol.free_count) - 1
    assert n_alloc > 50, f"too few blocks allocated: {n_alloc}"
    assert int(vol.alloc_overflow) == 0
    assert int(vol.num_visible) == n_alloc  # all allocated blocks visible

    # Every allocated block must intersect the truncation band of the
    # sphere surface (|sdf at center| <= band + half block diagonal).
    coords = np.asarray(vol.block_coords[1:n_alloc + 1])
    centers = (coords + 0.5) * CFG.block_extent
    d = np.abs(
        np.linalg.norm(centers - np.asarray(CENTER), axis=-1) - RADIUS
    )
    slack = CFG.trunc_dist + CFG.block_extent * np.sqrt(3) / 2
    assert np.all(d <= slack + 1e-6)


def test_sparse_matches_analytic_sdf():
    vol = blocks.create_volume(CFG)
    pose = orbit_poses(1, CENTER, radius=1.6, height=0.0)[0]
    vol = fuse(vol, sphere_frame(pose))

    n_alloc = int(vol.free_count) - 1
    coords = np.asarray(vol.block_coords[1 : n_alloc + 1])
    w = np.asarray(vol.weight[1 : n_alloc + 1])          # (n, 512)
    f = np.asarray(vol.tsdf[1 : n_alloc + 1])
    # World position of every voxel (flat local order matches storage).
    local = np.stack(
        np.meshgrid(np.arange(8), np.arange(8), np.arange(8), indexing="ij"),
        -1,
    ).reshape(-1, 3)
    g = coords[:, None, :] * 8 + local                    # (n, 512, 3)
    world = g * CFG.voxel_size
    true_sdf = np.asarray(
        sphere_sdf(jnp.asarray(world.reshape(-1, 3)), CENTER, RADIUS)
    ).reshape(w.shape)
    band = (w > 0) & (np.abs(true_sdf) < 0.5 * CFG.trunc_dist)
    assert band.sum() > 300
    err = np.abs(f[band] * CFG.trunc_dist - true_sdf[band])
    assert np.median(err) < CFG.voxel_size


def test_sparse_fuse_raycast_roundtrip():
    vol = blocks.create_volume(CFG)
    poses = orbit_poses(8, CENTER, radius=1.6, height=0.3)
    fuse_j = jax.jit(fuse)
    for pose in poses:
        vol = fuse_j(vol, sphere_frame(pose))

    test_pose = orbit_poses(16, CENTER, radius=1.6, height=0.3)[1]
    # Visibility for the *render* pose.
    vol = allocate.update_visibility(vol, CAM, test_pose, H, W, CFG)
    out = jax.jit(
        raycast.raycast, static_argnums=(3, 4, 5, 6)
    )(vol, CAM, test_pose, H, W, CFG, "cross")
    true_depth, _ = render_sphere_depth(CAM, test_pose, H, W, CENTER, RADIUS)

    got = np.asarray(out.depth)
    valid = np.asarray(out.valid) & (np.asarray(true_depth) > 0)
    assert valid.mean() > 0.1, "raycast found almost no surface"
    err = np.abs(got[valid] - np.asarray(true_depth)[valid])
    assert np.median(err) < 0.5 * CFG.voxel_size
    assert np.mean(err) < CFG.trunc_dist

    # No hits where the analytic scene has no surface (beyond the band).
    false_hits = np.asarray(out.valid) & (np.asarray(true_depth) == 0)
    assert false_hits.mean() < 0.02

    p = np.asarray(out.vertex_world)[valid]
    n_got = np.asarray(out.normal_world)[valid]
    n_true = p - np.asarray(CENTER)
    n_true /= np.maximum(np.linalg.norm(n_true, axis=-1, keepdims=True), 1e-9)
    assert np.mean(np.sum(n_got * n_true, axis=-1)) > 0.9

    from vulcan_tpu.io.synthetic import procedural_color

    c_got = np.asarray(out.color)[valid]
    c_true = np.asarray(procedural_color(jnp.asarray(p)))
    assert np.mean(np.abs(c_got - c_true)) < 0.15


def test_gradient_normals_match_analytic():
    vol = blocks.create_volume(CFG)
    for pose in orbit_poses(8, CENTER, radius=1.6, height=0.3):
        vol = fuse(vol, sphere_frame(pose))
    test_pose = orbit_poses(16, CENTER, radius=1.6, height=0.3)[3]
    vol = allocate.update_visibility(vol, CAM, test_pose, H, W, CFG)
    out = raycast.raycast(vol, CAM, test_pose, H, W, CFG, normals="gradient")
    valid = np.asarray(out.valid)
    assert valid.mean() > 0.05
    p = np.asarray(out.vertex_world)[valid]
    n_got = np.asarray(out.normal_world)[valid]
    n_true = p - np.asarray(CENTER)
    n_true /= np.maximum(np.linalg.norm(n_true, axis=-1, keepdims=True), 1e-9)
    assert np.mean(np.sum(n_got * n_true, axis=-1)) > 0.93


def test_range_image_bounds_surface():
    vol = blocks.create_volume(CFG)
    pose = orbit_poses(1, CENTER, radius=1.6, height=0.0)[0]
    vol = fuse(vol, sphere_frame(pose))
    vol = allocate.update_visibility(vol, CAM, pose, H, W, CFG)
    t_min, _, t_max = raycast.compute_range_image(vol, CAM, pose, H, W, CFG)
    depth, _ = render_sphere_depth(CAM, pose, H, W, CENTER, RADIUS)
    d = np.asarray(depth)
    lo = np.asarray(t_min)
    hi = np.asarray(t_max)
    surf = d > 0
    # Where there is a surface, the range must bracket it.
    frac_ok = np.mean((lo[surf] <= d[surf] + 1e-3) & (hi[surf] >= d[surf] - 1e-3))
    assert frac_ok > 0.99


def test_visibility_culls_behind_camera():
    vol = blocks.create_volume(CFG)
    pose = orbit_poses(1, CENTER, radius=1.6, height=0.0)[0]
    vol = fuse(vol, sphere_frame(pose))
    # Opposite side of the orbit, looking away: nothing should be visible
    # ... actually looking at the sphere from the other side still sees it.
    # Instead: move the camera far away looking outward.
    from vulcan_tpu.io.synthetic import look_at

    away = look_at((10.0, 0.0, 0.0), (20.0, 0.0, 0.0))
    vol2 = allocate.update_visibility(vol, CAM, away, H, W, CFG)
    assert int(vol2.num_visible) == 0


def test_splat_renderer_roundtrip():
    """The surfel-splatting renderer (render_mode='splat') reproduces the
    fused sphere nearly as well as the hierarchical march."""
    cfg = dataclasses.replace(CFG, render_mode="splat")
    vol = blocks.create_volume(cfg)
    for pose in orbit_poses(8, CENTER, radius=1.6, height=0.3):
        depth, color = render_sphere_depth(CAM, pose, H, W, CENTER, RADIUS)
        frame = make_frame(depth, color, CAM, pose)
        vol, _, _ = allocate.allocate_for_frame(vol, frame.depth, CAM, pose, cfg)
        vol = allocate.update_visibility(vol, CAM, pose, H, W, cfg)
        vol = sparse.integrate_sparse(vol, frame, cfg)

    test_pose = orbit_poses(16, CENTER, radius=1.6, height=0.3)[1]
    vol = allocate.update_visibility(vol, CAM, test_pose, H, W, cfg)
    out = raycast.render(vol, CAM, test_pose, H, W, cfg)
    true_depth, _ = render_sphere_depth(CAM, test_pose, H, W, CENTER, RADIUS)

    got = np.asarray(out.depth)
    valid = np.asarray(out.valid) & (np.asarray(true_depth) > 0)
    assert valid.mean() > 0.1, "splat found almost no surface"
    err = np.abs(got[valid] - np.asarray(true_depth)[valid])
    assert np.median(err) < cfg.voxel_size
    assert np.mean(err) < 2 * cfg.trunc_dist

    false_hits = np.asarray(out.valid) & (np.asarray(true_depth) == 0)
    assert false_hits.mean() < 0.05

    p = np.asarray(out.vertex_world)[valid]
    n_got = np.asarray(out.normal_world)[valid]
    n_true = p - np.asarray(CENTER)
    n_true /= np.maximum(np.linalg.norm(n_true, axis=-1, keepdims=True), 1e-9)
    assert np.mean(np.sum(n_got * n_true, axis=-1)) > 0.85


def test_band_integration_matches_visible():
    """Band-list integration (the online pipeline's fast path) renders the
    same surface as reference-style full visible-list integration."""
    poses = orbit_poses(3, CENTER, radius=1.6, height=0.2, span=0.3)
    vol_a = blocks.create_volume(CFG)   # visible-list (reference semantics)
    vol_b = blocks.create_volume(CFG)   # truncation-band list
    for pose in poses:
        frame = sphere_frame(pose)
        vol_a, _, _ = allocate.allocate_for_frame(
            vol_a, frame.depth, CAM, pose, CFG
        )
        vol_a = allocate.update_visibility(vol_a, CAM, pose, H, W, CFG)
        vol_a = sparse.integrate_sparse(vol_a, frame, CFG)

        vol_b, ids, n_band = allocate.allocate_for_frame(
            vol_b, frame.depth, CAM, pose, CFG
        )
        vol_b = allocate.update_visibility(vol_b, CAM, pose, H, W, CFG)
        vol_b = sparse.integrate_sparse(
            vol_b, frame, CFG, ids=ids, count=n_band
        )
    assert int(vol_a.free_count) == int(vol_b.free_count)
    r_a = raycast.render(vol_a, CAM, poses[0], H, W, CFG, with_color=False)
    r_b = raycast.render(vol_b, CAM, poses[0], H, W, CFG, with_color=False)
    va, vb = np.asarray(r_a.valid), np.asarray(r_b.valid)
    both = va & vb
    # Same coverage and (weights differ where blocks leave the band, so
    # depths may differ slightly) near-identical surface.
    assert both.sum() > 0.95 * va.sum()
    d_err = np.abs(np.asarray(r_a.depth) - np.asarray(r_b.depth))[both]
    assert np.percentile(d_err, 95) < CFG.voxel_size


def test_splat_silhouette_bias():
    """Quantify the splat renderer at silhouettes (round-1 VERDICT item 7):
    hole-fill dilation must not bleed depth beyond ~fill_rounds+1 px past
    the true silhouette, and near-edge depth must stay accurate."""
    from scipy.ndimage import binary_dilation, binary_erosion

    cfg = dataclasses.replace(CFG, render_mode="splat")
    vol = blocks.create_volume(cfg)
    for pose in orbit_poses(8, CENTER, radius=1.6, height=0.3):
        frame = sphere_frame(pose)
        vol, _, _ = allocate.allocate_for_frame(
            vol, frame.depth, CAM, pose, cfg
        )
        vol = allocate.update_visibility(vol, CAM, pose, H, W, cfg)
        vol = sparse.integrate_sparse(vol, frame, cfg)

    pose = orbit_poses(16, CENTER, radius=1.6, height=0.3)[1]
    vol = allocate.update_visibility(vol, CAM, pose, H, W, cfg)
    out = raycast.render(vol, CAM, pose, H, W, cfg, with_color=False)
    true_depth, _ = render_sphere_depth(CAM, pose, H, W, CENTER, RADIUS)
    true_depth = np.asarray(true_depth)
    true_valid = true_depth > 0
    got_valid = np.asarray(out.valid)
    got = np.asarray(out.depth)

    # 1. Bleed bound: at a silhouette (normal _|_ ray) voxel surfels sit
    #    laterally up to splat_band*mu + one voxel off the exact surface
    #    (here (0.375*0.08 + 0.02) * fx/z ~ 4 px), and hole-fill dilates
    #    by fill_rounds more.  Beyond that: zero pixels (measured profile
    #    drops to 0 at fill_rounds + 4).
    allowed = binary_dilation(
        true_valid, iterations=cfg.splat_fill_rounds + 4
    )
    bleed = got_valid & ~allowed
    assert bleed.sum() == 0, f"{bleed.sum()} px bled past the silhouette"

    # 2. Near-edge accuracy: within a 3-px band inside the silhouette the
    #    splatted depth stays within ~2 voxels of analytic (the foreground
    #    -biased fill must not drag edge depth to the background).
    edge_band = true_valid & ~binary_erosion(true_valid, iterations=3)
    sel = edge_band & got_valid & true_valid
    assert sel.sum() > 100
    err = np.abs(got - true_depth)[sel]
    assert np.median(err) < 2 * cfg.voxel_size, np.median(err)


def test_fill_and_smooth_matches_numpy_reference():
    """The splat hole-fill/smooth pass against the NumPy loop reference
    that chip_smoke.py checks on the GPU at 640x480: the same pixels are
    filled, and values agree to 1e-5 m."""
    from chip_smoke import fill_smooth_reference
    from vulcan_tpu.ops.splat import _fill_and_smooth

    rng = np.random.default_rng(5)
    d = np.cumsum(rng.uniform(-0.01, 0.01, (48, 128)), axis=1) + 1.5
    d[:, 64:] += 0.5                          # a silhouette step
    d[rng.random((48, 128)) < 0.25] = np.inf  # holes to fill
    d = d.astype(np.float32)
    got = np.asarray(_fill_and_smooth(jnp.asarray(d), TINY))
    ref = fill_smooth_reference(d, TINY)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    fin = np.isfinite(ref)
    assert fin.sum() > 0.8 * d.size
    np.testing.assert_allclose(got[fin], ref[fin], rtol=0, atol=1e-5)


def test_pack_surfels_matches_take_along_axis():
    """The one-hot matmul surfel placement is bit-exact against the
    take_along_axis reference (chip_smoke.py runs the same check at the
    production chunk of 1024 rows on the GPU)."""
    from chip_smoke import pack_surfels_mismatches

    assert pack_surfels_mismatches(64, TINY, seed=1) == 0


def test_select_voxel_rgb_matches_take_along_axis():
    """The splat color-byte select (one-hot matmul) is bit-exact against
    take_along_axis (chip_smoke.py: 2048 x 96 on the GPU)."""
    from chip_smoke import select_rgb_mismatches

    assert select_rgb_mismatches(64, 96, seed=2) == 0


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_gather_auto_is_the_same_on_every_backend(backend, monkeypatch):
    """``auto`` resolves to one fixed choice whatever the backend: flat
    integration gathers and flat ICP association."""
    from vulcan_tpu.ops import icp

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert CFG.integrate_gather == "auto" and CFG.assoc_patch == "auto"
    assert sparse.resolve_integrate_gather(CFG) == "flat"
    assert not icp.patch_assoc_enabled(CFG)
    onehot = dataclasses.replace(CFG, integrate_gather="onehot")
    assert sparse.resolve_integrate_gather(onehot) == "onehot"
    assert icp.patch_assoc_enabled(dataclasses.replace(CFG, assoc_patch="on"))


def test_onehot_patch_gather_matches_flat_exactly():
    """The one-hot matmul patch-gather integrate path must agree with the
    flat per-element gather path.  At this scene's range every block's
    projection fits the mip-0 patch budget, so the nearest-sample is
    IDENTICAL and the paths must match bit-for-bit."""
    cfg_flat = dataclasses.replace(CFG, integrate_gather="flat")
    cfg_onehot = dataclasses.replace(CFG, integrate_gather="onehot")
    pose = orbit_poses(1, CENTER, radius=1.6, height=0.2)[0]
    frame = sphere_frame(pose)

    def run(cfg):
        vol = blocks.create_volume(cfg)
        vol, band_ids, n_band = allocate.allocate_for_frame(
            vol, frame.depth, CAM, pose, cfg
        )
        vol = allocate.update_visibility(vol, CAM, pose, H, W, cfg)
        return sparse.integrate_sparse(
            vol, frame, cfg, ids=band_ids, count=n_band
        )

    va = run(cfg_flat)
    vb = run(cfg_onehot)
    assert int(jnp.sum(va.weight > 0)) > 1000
    np.testing.assert_array_equal(np.asarray(va.tsdf), np.asarray(vb.tsdf))
    np.testing.assert_array_equal(
        np.asarray(va.weight), np.asarray(vb.weight)
    )
    np.testing.assert_array_equal(
        np.asarray(va.colorpack), np.asarray(vb.colorpack)
    )


def test_onehot_patch_gather_close_range_mips():
    """Close-range blocks overflow the mip-0 patch and select coarser
    mips; the sampled depth then differs from the full-res nearest
    sample by at most the surface variation across the mip stride --
    sub-voxel at any range by construction.  Fused TSDF must stay close
    to the flat path's."""
    cfg_flat = dataclasses.replace(CFG, integrate_gather="flat")
    cfg_onehot = dataclasses.replace(CFG, integrate_gather="onehot")
    # Camera 0.75 m from the sphere surface: blocks project ~26-60 px.
    from vulcan_tpu.io.synthetic import look_at

    pose = look_at((1.25, 0.0, 0.1), CENTER)
    frame = sphere_frame(pose)

    def run(cfg):
        vol = blocks.create_volume(cfg)
        vol, band_ids, n_band = allocate.allocate_for_frame(
            vol, frame.depth, CAM, pose, cfg
        )
        vol = allocate.update_visibility(vol, CAM, pose, H, W, cfg)
        return sparse.integrate_sparse(
            vol, frame, cfg, ids=band_ids, count=n_band
        )

    va = run(cfg_flat)
    vb = run(cfg_onehot)
    obs = (np.asarray(va.weight) > 0) & (np.asarray(vb.weight) > 0)
    assert obs.sum() > 1000
    # Observed sets agree almost everywhere (mip sampling may flip
    # validity only at depth discontinuities).
    both = np.asarray(va.weight > 0) == np.asarray(vb.weight > 0)
    assert both.mean() > 0.99
    dt = np.abs(np.asarray(va.tsdf) - np.asarray(vb.tsdf))[obs]
    # TSDF is mu-normalized; 0.25 mu = 2 cm at this config's mu=8cm,
    # and the 99th percentile must be far tighter.
    assert np.quantile(dt, 0.99) < 0.25, np.quantile(dt, 0.99)
    assert dt.mean() < 0.02, dt.mean()


def test_persistent_surfels_match_tsdf():
    """Integration maintains the per-block surfel lists incrementally;
    they must equal a fresh recomputation from the fused TSDF."""
    vol = blocks.create_volume(CFG)
    for pose in orbit_poses(3, CENTER, radius=1.6, height=0.2, span=0.3):
        frame = sphere_frame(pose)
        vol, band_ids, n_band = allocate.allocate_for_frame(
            vol, frame.depth, CAM, pose, CFG
        )
        vol = allocate.update_visibility(vol, CAM, pose, H, W, CFG)
        vol = sparse.integrate_sparse(
            vol, frame, CFG, ids=band_ids, count=n_band
        )
    surf, count, _ = blocks.pack_surfels(
        vol.tsdf, vol.weight, blocks.surfel_band(CFG), CFG.surfel_slots
    )
    assert int(jnp.sum(count)) > 500
    np.testing.assert_array_equal(
        np.asarray(vol.surfpack), np.asarray(surf)
    )
    np.testing.assert_array_equal(
        np.asarray(vol.surf_count), np.asarray(count)
    )


def test_splat_surfels_matches_direct():
    """With enough surfel slots (no overflow possible at 512), the
    persistent-surfel z-buffer renders EXACTLY the direct path's output:
    both scatter the same voxel set under the same projective model."""
    cfg = dataclasses.replace(CFG, surfel_slots=512)
    vol = blocks.create_volume(cfg)
    poses = orbit_poses(3, CENTER, radius=1.6, height=0.2, span=0.3)
    for pose in poses:
        frame = sphere_frame(pose)
        vol, band_ids, n_band = allocate.allocate_for_frame(
            vol, frame.depth, CAM, pose, cfg
        )
        vol = allocate.update_visibility(vol, CAM, pose, H, W, cfg)
        vol = sparse.integrate_sparse(
            vol, frame, cfg, ids=band_ids, count=n_band
        )
    from vulcan_tpu.ops import splat

    pose = poses[-1]
    assert int(vol.surf_overflow) == 0
    za = splat._splat_zbuf_direct(vol, CAM, pose, H, W, cfg)
    zb = splat._splat_zbuf_surfels(vol, CAM, pose, H, W, cfg)
    hit = np.isfinite(np.asarray(za))
    assert hit.sum() > 2000
    assert (hit == np.isfinite(np.asarray(zb))).all()
    # 15-bit surfel tsdf quantization: |dz| <= mu * 2/32767 ~ 5 um.
    dz = np.abs(np.asarray(za)[hit] - np.asarray(zb)[hit])
    assert dz.max() < 1e-5, dz.max()


def test_splat_luma_matches_rgb():
    """The single-pass packed z+luma surfel render agrees with the
    two-pass rgb path: depth to the 19-bit quantization step, intensity
    to the 12-bit step wherever the winning surfel is unambiguous (a
    shared 9.5 um depth bin may resolve to a different same-surface
    surfel; the rgb path itself accepts either winner within 1e-5 m)."""
    cfg = dataclasses.replace(CFG, surfel_slots=512)
    vol = blocks.create_volume(cfg)
    poses = orbit_poses(3, CENTER, radius=1.6, height=0.2, span=0.3)
    for pose in poses:
        vol = fuse_cfg(vol, sphere_frame(pose), cfg)
    from vulcan_tpu.ops import splat

    pose = poses[-1]
    zb, cb = splat._splat_zbuf_surfels(
        vol, CAM, pose, H, W, cfg, with_color=True
    )
    word = splat._splat_zbuf_surfels(vol, CAM, pose, H, W, cfg, luma=True)
    zl, il = splat._decode_luma_zbuf(word, cfg)

    hit = np.isfinite(np.asarray(zb))
    assert hit.sum() > 2000
    assert (hit == np.isfinite(np.asarray(zl))).all()
    zstep = cfg.ray_far / float(splat._ZQ_MAX)
    dz = np.abs(np.asarray(zb)[hit] - np.asarray(zl)[hit])
    assert dz.max() < zstep + 1e-6, dz.max()

    c = np.asarray(cb)[hit]
    lum_rgb = (
        0.299 * ((c >> 16) & 0xFF)
        + 0.587 * ((c >> 8) & 0xFF)
        + 0.114 * (c & 0xFF)
    ) / 255.0
    dl = np.abs(np.asarray(il)[hit] - lum_rgb)
    # Unambiguous winners agree to the 12-bit step; allow a tiny tail of
    # same-bin ties resolving to a different same-surface surfel.
    assert np.quantile(dl, 0.99) < 1.5 / 4095.0, np.quantile(dl, 0.99)
    assert dl.max() < 0.1, dl.max()


def test_pipeline_luma_model_render():
    """fusion.step with mode="combined" and model_color="luma" produces a
    grey model.color whose intensity equals the packed render, and the
    tracker consumes it (inliers accumulate)."""
    from vulcan_tpu.pipeline import fusion

    cfg = dataclasses.replace(CFG, model_color="luma")
    poses = orbit_poses(4, CENTER, radius=1.6, height=0.2, span=0.2)
    state = fusion.init_state(cfg, CAM, H, W, init_pose=poses[0])
    for pose in poses[:1]:
        d, c = render_sphere_depth(CAM, pose, H, W, CENTER, RADIUS)
        state = fusion.step_known_pose(state, d, c, pose, cfg)
    for pose in poses[1:]:
        d, c = render_sphere_depth(CAM, pose, H, W, CENTER, RADIUS)
        state = fusion.step(state, d, c, cfg, mode="combined")
    col = np.asarray(state.model.color)
    assert (col[..., 0] == col[..., 1]).all()
    assert (col[..., 1] == col[..., 2]).all()
    assert int(state.track_inliers) > 500
    assert int(state.track_failures) == 0
