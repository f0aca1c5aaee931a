"""Frame and pyramid containers.

JAX equivalent of the reference's ``Frame`` / ``Image`` /
``ColorImage`` / ``Pyramid`` device containers (SURVEY.md components #5-#7):
a Frame is a pytree of (H, W[,C]) jnp arrays plus camera + pose, so whole
pyramids trace through one jitted step.

Conventions:
  * ``depth``: (H, W) float32 meters; 0.0 marks invalid pixels.
  * ``color``: (H, W, 3) float32 in [0, 1].
  * ``pose``: camera-to-world SE3.
  * vertex/normal maps are camera-space unless stated otherwise; invalid
    entries are all-zero (callers mask on ``depth > 0`` / norm > 0).
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..utils.pytree import pytree_dataclass
from .camera import PinholeCamera
from .se3 import SE3


@pytree_dataclass
class Frame:
    depth: jax.Array
    color: jax.Array
    camera: PinholeCamera
    pose: SE3

    @property
    def height(self) -> int:
        return self.depth.shape[-2]

    @property
    def width(self) -> int:
        return self.depth.shape[-1]


@pytree_dataclass
class FrameMaps:
    """Derived per-pixel geometry for one pyramid level (camera space)."""

    depth: jax.Array        # (H, W)
    vertices: jax.Array     # (H, W, 3) camera-space vertex map
    normals: jax.Array      # (H, W, 3) camera-space unit normals (0 invalid)
    intensity: jax.Array    # (H, W) grayscale for photometric tracking
    camera: PinholeCamera


def make_frame(
    depth: jax.Array,
    color: Optional[jax.Array] = None,
    camera: Optional[PinholeCamera] = None,
    pose: Optional[SE3] = None,
) -> Frame:
    depth = jnp.asarray(depth, jnp.float32)
    if color is None:
        color = jnp.zeros(depth.shape + (3,), jnp.float32)
    if camera is None:
        camera = PinholeCamera.tum_default()
    if pose is None:
        pose = SE3.identity()
    return Frame(depth, jnp.asarray(color, jnp.float32), camera, pose)
