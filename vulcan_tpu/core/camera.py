"""Pinhole camera model.

JAX equivalent of the reference's ``Projection`` (SURVEY.md component
#4, ``projection.h`` [M]): intrinsics as a tiny pytree with vectorized
project / unproject over whole images.  Pixel coordinates use the plain
TUM/OpenCV convention: a 3D point (x, y, z) in camera space projects to
u = fx * x / z + cx, v = fy * y / z + cy, and integer pixel (u, v) samples
at exactly those coordinates.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils.pytree import pytree_dataclass


@pytree_dataclass
class PinholeCamera:
    """Intrinsics. Scalars are 0-d jnp arrays so the camera is a pytree."""

    fx: jax.Array
    fy: jax.Array
    cx: jax.Array
    cy: jax.Array

    @staticmethod
    def create(fx, fy, cx, cy, dtype=jnp.float32) -> "PinholeCamera":
        return PinholeCamera(
            jnp.asarray(fx, dtype),
            jnp.asarray(fy, dtype),
            jnp.asarray(cx, dtype),
            jnp.asarray(cy, dtype),
        )

    @staticmethod
    def tum_default(dtype=jnp.float32) -> "PinholeCamera":
        """TUM RGB-D freiburg1 default intrinsics at 640x480."""
        return PinholeCamera.create(517.3, 516.5, 318.6, 255.3, dtype)

    def project(self, points: jax.Array) -> jax.Array:
        """Camera-space points (...,3) -> pixel coords (...,2) = (u, v).

        z <= 0 points project to large out-of-bounds coordinates so callers
        can bounds-check uniformly instead of branching.
        """
        z = points[..., 2]
        safe_z = jnp.where(z > 1e-12, z, 1.0)
        u = self.fx * points[..., 0] / safe_z + self.cx
        v = self.fy * points[..., 1] / safe_z + self.cy
        bad = z <= 1e-12
        big = jnp.asarray(-1e9, points.dtype)
        return jnp.stack(
            [jnp.where(bad, big, u), jnp.where(bad, big, v)], axis=-1
        )

    def unproject(self, uv: jax.Array, depth: jax.Array) -> jax.Array:
        """Pixels (...,2) + depth (...,) -> camera-space points (...,3)."""
        x = (uv[..., 0] - self.cx) / self.fx * depth
        y = (uv[..., 1] - self.cy) / self.fy * depth
        return jnp.stack([x, y, depth], axis=-1)

    def pixel_grid(self, height: int, width: int, dtype=jnp.float32) -> jax.Array:
        """(H, W, 2) array of (u, v) pixel coordinates."""
        v = jnp.arange(height, dtype=dtype)
        u = jnp.arange(width, dtype=dtype)
        uu, vv = jnp.meshgrid(u, v)
        return jnp.stack([uu, vv], axis=-1)

    def rays(self, height: int, width: int, dtype=jnp.float32) -> jax.Array:
        """(H, W, 3) camera-space ray directions with z=1 (not normalized)."""
        uv = self.pixel_grid(height, width, dtype)
        return self.unproject(uv, jnp.ones((height, width), dtype))

    def subsampled(self, step: int) -> "PinholeCamera":
        """Intrinsics for nearest ``[::step, ::step]`` subsampling.

        Output pixel i maps to input pixel ``step * i`` exactly, so
        u' = u / step with NO half-pixel shift -- unlike :meth:`scaled`,
        whose convention matches 2x2-average pooling.  Using scaled() for
        a nearest-subsampled pyramid biases projective association by
        0.25 px per level (advisor finding, round 1).
        """
        s = jnp.asarray(1.0 / step, self.fx.dtype)
        return PinholeCamera(
            self.fx * s, self.fy * s, self.cx * s, self.cy * s
        )

    def scaled(self, factor: float) -> "PinholeCamera":
        """Intrinsics for an image downsampled by ``factor`` (e.g. 0.5).

        Matches 2x2-average downsampling where output pixel i covers input
        pixels 2i and 2i+1: u' = (u - 0.5) * s + 0.5... For the common
        half-scale pyramid used by ICP the standard approximation
        (fx' = fx * s, cx' = (cx + 0.5) * s - 0.5) is used.
        """
        s = jnp.asarray(factor, self.fx.dtype)
        half = jnp.asarray(0.5, self.fx.dtype)
        return PinholeCamera(
            self.fx * s,
            self.fy * s,
            (self.cx + half) * s - half,
            (self.cy + half) * s - half,
        )
