"""Depth preprocessing: bilateral filter, vertex/normal lift, pyramids.

Rebuild of SURVEY.md components #7-#9 (reference: one CUDA thread per pixel
in ``filter.cu`` / ``frame.cu`` [M]).  Here these are pure vectorized XLA ops
over whole (H, W) images: the fixed-radius bilateral window unrolls into
shifted adds that XLA fuses into a single loop, which is exactly the fusion
the CUDA kernels do by hand.

Invalid depth is 0.0 everywhere; every op preserves that convention.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from ..config import Config
from ..core.camera import PinholeCamera
from ..core.frame import Frame, FrameMaps


def _shift2d(img: jax.Array, dy: int, dx: int, fill=0.0) -> jax.Array:
    """Shift an (H, W[,C]) image so out[y, x] = img[y+dy, x+dx]; fill OOB."""
    pad_y = (max(-dy, 0), max(dy, 0))
    pad_x = (max(-dx, 0), max(dx, 0))
    pad = [pad_y, pad_x] + [(0, 0)] * (img.ndim - 2)
    padded = jnp.pad(img, pad, constant_values=fill)
    h, w = img.shape[0], img.shape[1]
    return jax.lax.dynamic_slice_in_dim(
        jax.lax.dynamic_slice_in_dim(padded, pad_y[0] + dy, h, axis=0),
        pad_x[0] + dx,
        w,
        axis=1,
    )


def _shift_concat(d: jax.Array, dy: int, dx: int, fill=0.0) -> jax.Array:
    """Static shift of an (H, W) image via concatenate: out[y, x] =
    d[y+dy, x+dx], ``fill`` outside."""
    h, w = d.shape
    if dy > 0:
        d = jnp.concatenate([d[dy:], jnp.full((dy, w), fill, d.dtype)], 0)
    elif dy < 0:
        d = jnp.concatenate([jnp.full((-dy, w), fill, d.dtype), d[:dy]], 0)
    if dx > 0:
        d = jnp.concatenate([d[:, dx:], jnp.full((h, dx), fill, d.dtype)], 1)
    elif dx < 0:
        d = jnp.concatenate([jnp.full((h, -dx), fill, d.dtype), d[:, :dx]], 1)
    return d


def bilateral_filter(depth: jax.Array, config: Config) -> jax.Array:
    """Edge-preserving depth denoise (reference component #8).

    Gaussian in pixel space x Gaussian in depth difference; invalid (0)
    neighbors are excluded; invalid centers stay invalid.  The
    (2r+1)^2-tap window is a chain of static shifted adds that XLA fuses
    into one elementwise loop.
    """
    r = config.bilateral_radius
    inv_2ss = 1.0 / (2.0 * config.bilateral_sigma_space**2)
    inv_2sd = 1.0 / (2.0 * config.bilateral_sigma_depth**2)
    valid_center = depth > 0.0

    acc = jnp.zeros_like(depth)
    wacc = jnp.zeros_like(depth)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            d = _shift_concat(depth, dy, dx)
            w_space = math.exp(-(dy * dy + dx * dx) * inv_2ss)
            diff = d - depth
            w = w_space * jnp.exp(-(diff * diff) * inv_2sd)
            w = jnp.where(d > 0.0, w, 0.0)
            acc = acc + w * d
            wacc = wacc + w
    out = jnp.where(wacc > 0.0, acc / jnp.maximum(wacc, 1e-12), 0.0)
    return jnp.where(valid_center, out, 0.0)


def compute_vertex_map(depth: jax.Array, camera: PinholeCamera) -> jax.Array:
    """Back-project depth -> camera-space vertex map (H, W, 3); 0 invalid."""
    h, w = depth.shape
    uv = camera.pixel_grid(h, w, depth.dtype)
    verts = camera.unproject(uv, depth)
    return jnp.where((depth > 0.0)[..., None], verts, 0.0)


def compute_normal_map(vertices: jax.Array) -> jax.Array:
    """Normals from forward differences of the vertex map (component #9).

    n = normalize((v[y, x+1] - v) x (v[y+1, x] - v)), flipped to face the
    camera (n . v < 0).  Zero where any participating vertex is invalid.
    """
    v = vertices
    valid = jnp.any(v != 0.0, axis=-1)
    vr = _shift2d(v, 0, 1)
    vd = _shift2d(v, 1, 0)
    valid_r = jnp.any(vr != 0.0, axis=-1)
    valid_d = jnp.any(vd != 0.0, axis=-1)
    n = jnp.cross(vr - v, vd - v)
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    n = n / jnp.maximum(norm, 1e-12)
    # Face the camera: viewing ray is +v (camera at origin, z forward).
    flip = jnp.sum(n * v, axis=-1, keepdims=True) > 0.0
    n = jnp.where(flip, -n, n)
    ok = valid & valid_r & valid_d & (norm[..., 0] > 1e-12)
    return jnp.where(ok[..., None], n, 0.0)


def intensity_from_color(color: jax.Array) -> jax.Array:
    """(H, W, 3) RGB in [0,1] -> (H, W) luma for photometric tracking."""
    return (
        0.299 * color[..., 0] + 0.587 * color[..., 1] + 0.114 * color[..., 2]
    )


def downsample_depth(depth: jax.Array, config: Config) -> jax.Array:
    """Half-resolution depth: 2x2 average of valid pixels near the top-left
    reference value (KinectFusion-style discontinuity-aware subsampling)."""
    h, w = depth.shape
    d = depth[: h - h % 2, : w - w % 2].reshape(h // 2, 2, w // 2, 2)
    d = jnp.transpose(d, (0, 2, 1, 3)).reshape(h // 2, w // 2, 4)
    ref = d[..., 0]
    thresh = 3.0 * config.bilateral_sigma_depth
    ok = (d > 0.0) & (jnp.abs(d - ref[..., None]) < thresh)
    s = jnp.sum(jnp.where(ok, d, 0.0), axis=-1)
    c = jnp.sum(ok, axis=-1)
    out = jnp.where((ref > 0.0) & (c > 0), s / jnp.maximum(c, 1), 0.0)
    return out


def downsample_intensity(img: jax.Array) -> jax.Array:
    """Half-resolution plain 2x2 box average (for photometric pyramids)."""
    h, w = img.shape
    x = img[: h - h % 2, : w - w % 2].reshape(h // 2, 2, w // 2, 2)
    return jnp.mean(x, axis=(1, 3))


def build_frame_maps(
    depth: jax.Array,
    intensity: jax.Array,
    camera: PinholeCamera,
    config: Config,
    filter_depth: bool = True,
) -> FrameMaps:
    d = bilateral_filter(depth, config) if filter_depth else depth
    verts = compute_vertex_map(d, camera)
    normals = compute_normal_map(verts)
    return FrameMaps(d, verts, normals, intensity, camera)


def build_pyramid(
    frame: Frame, config: Config, with_intensity: bool = True
) -> tuple[FrameMaps, ...]:
    """Coarse-to-fine pyramid of FrameMaps; index 0 = full resolution.

    Reference component #7 (``Pyramid`` [M]); the bilateral filter runs once
    at full resolution, coarser levels subsample the filtered depth.
    ``with_intensity=False`` (geometric-only tracking) skips the luma image
    and its pyramid entirely.
    """
    depth = (
        bilateral_filter(frame.depth, config)
        if config.bilateral_enabled
        else frame.depth
    )
    intensity = intensity_from_color(frame.color) if with_intensity else None
    camera = frame.camera
    levels = []
    for level in range(config.pyramid_levels):
        if level > 0:
            depth = downsample_depth(depth, config)
            if intensity is not None:
                intensity = downsample_intensity(intensity)
            camera = camera.scaled(0.5)
        levels.append(
            build_frame_maps(depth, intensity, camera, config, filter_depth=False)
        )
    return tuple(levels)
