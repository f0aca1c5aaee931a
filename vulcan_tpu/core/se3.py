"""SE(3) rigid transforms as pytrees.

JAX equivalent of the reference's host+device ``Transform`` /
``Matrix3f``/``Vector3f`` math core (SURVEY.md component #3, ``transform.h``
[M]): instead of fixed-size structs usable inside CUDA kernels, poses are tiny
pytrees of jnp arrays that trace through jit/vmap/scan and live on device, so
the ICP pose update never leaves the device.

Conventions:
  * ``SE3`` maps points from its *source* frame to its *target* frame:
    ``x_target = R @ x_source + t``.
  * Camera poses are camera-to-world; ``pose.inverse()`` is world-to-camera.
  * ``SE3.exp(xi)`` with twist ``xi = (omega, v)`` (rotation first) matches the
    standard se(3) exponential used by point-to-plane ICP solvers.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.lax import Precision

from ..utils.pytree import pytree_dataclass

_EPS = 1e-8
# Small-angle series threshold on theta^2.  In f32, the closed forms
# (1-cos t)/t^2 and (t-sin t)/t^3 are catastrophically cancelled for
# small t -- cos(1e-4) rounds to exactly 1.0f, so b=0, a/(2b)=inf and
# SE3.log returns NaN (hit in production: a near-identity inter-frame
# delta in fusion.predict_pose NaN'd the predicted pose and zeroed two
# frames of tracking on the desk bench).  The 2nd-order series carries
# relative error ~t^2/20 < 5e-7 below t=1e-2, already finer than f32
# eps, so t^2 < 1e-4 takes the series exactly where it is the MORE
# accurate branch.  (1e-8 was a correct threshold only for f64.)
_SERIES_T2 = 1e-4


def skew(w: jax.Array) -> jax.Array:
    """(...,3) -> (...,3,3) cross-product matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([zero, -wz, wy], axis=-1),
            jnp.stack([wz, zero, -wx], axis=-1),
            jnp.stack([-wy, wx, zero], axis=-1),
        ],
        axis=-2,
    )


def so3_exp(omega: jax.Array) -> jax.Array:
    """Rodrigues: (...,3) axis-angle -> (...,3,3) rotation matrix.

    Uses series expansions near theta=0 so it is safe under jit/grad.
    """
    theta2 = jnp.sum(omega * omega, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    # sin(t)/t and (1-cos(t))/t^2 with small-angle series fallbacks.
    use_series = theta2 < _SERIES_T2
    a = jnp.where(use_series, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(use_series, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    K = skew(omega)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=omega.dtype), K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * jnp.matmul(K, K, precision=Precision.HIGHEST)


def so3_log(R: jax.Array) -> jax.Array:
    """(...,3,3) rotation -> (...,3) axis-angle. Accurate away from theta=pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos_theta)
    w = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    theta2 = theta * theta
    use_series = theta2 < _SERIES_T2
    sin_theta = jnp.sin(theta)
    scale = jnp.where(
        use_series,
        0.5 + theta2 / 12.0,
        theta / jnp.where(use_series, 1.0, 2.0 * sin_theta + _EPS),
    )
    return scale[..., None] * w


@pytree_dataclass
class SE3:
    """Rigid transform: rotation (...,3,3) + translation (...,3)."""

    rotation: jax.Array
    translation: jax.Array

    @staticmethod
    def identity(dtype=jnp.float32, batch_shape: tuple[int, ...] = ()) -> "SE3":
        R = jnp.broadcast_to(jnp.eye(3, dtype=dtype), batch_shape + (3, 3))
        t = jnp.zeros(batch_shape + (3,), dtype=dtype)
        return SE3(R, t)

    @staticmethod
    def from_matrix(T: jax.Array) -> "SE3":
        """(...,4,4) or (...,3,4) homogeneous matrix -> SE3."""
        return SE3(T[..., :3, :3], T[..., :3, 3])

    def as_matrix(self) -> jax.Array:
        """-> (...,4,4) homogeneous matrix."""
        batch = self.translation.shape[:-1]
        bottom = jnp.broadcast_to(
            jnp.array([0.0, 0.0, 0.0, 1.0], dtype=self.translation.dtype),
            batch + (1, 4),
        )
        top = jnp.concatenate(
            [self.rotation, self.translation[..., :, None]], axis=-1
        )
        return jnp.concatenate([top, bottom], axis=-2)

    def apply(self, points: jax.Array) -> jax.Array:
        """Transform points (...,3)."""
        return (
            jnp.einsum("...ij,...j->...i", self.rotation, points, precision=Precision.HIGHEST)
            + self.translation
        )

    def rotate(self, vectors: jax.Array) -> jax.Array:
        """Rotate direction vectors (...,3) (no translation)."""
        return jnp.einsum("...ij,...j->...i", self.rotation, vectors, precision=Precision.HIGHEST)

    def compose(self, other: "SE3") -> "SE3":
        """self ∘ other: first apply ``other``, then ``self``."""
        return SE3(
            jnp.matmul(self.rotation, other.rotation, precision=Precision.HIGHEST),
            self.rotate(other.translation) + self.translation,
        )

    def __matmul__(self, other: "SE3") -> "SE3":
        return self.compose(other)

    def inverse(self) -> "SE3":
        Rt = jnp.swapaxes(self.rotation, -1, -2)
        return SE3(Rt, -jnp.einsum("...ij,...j->...i", Rt, self.translation, precision=Precision.HIGHEST))

    @staticmethod
    def exp(xi: jax.Array) -> "SE3":
        """se(3) exponential. ``xi=(...,6)`` = (omega, v), rotation first."""
        omega, v = xi[..., :3], xi[..., 3:]
        theta2 = jnp.sum(omega * omega, axis=-1)
        theta = jnp.sqrt(theta2 + _EPS * _EPS)
        use_series = theta2 < _SERIES_T2
        R = so3_exp(omega)
        # Left Jacobian V: t = V @ v.
        b = jnp.where(
            use_series, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2
        )
        c = jnp.where(
            use_series,
            1.0 / 6.0 - theta2 / 120.0,
            (theta - jnp.sin(theta)) / (theta2 * theta),
        )
        K = skew(omega)
        eye = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), K.shape)
        V = eye + b[..., None, None] * K + c[..., None, None] * jnp.matmul(K, K, precision=Precision.HIGHEST)
        return SE3(R, jnp.einsum("...ij,...j->...i", V, v, precision=Precision.HIGHEST))

    def log(self) -> jax.Array:
        """-> twist (...,6) = (omega, v) with SE3.exp(log(T)) == T."""
        omega = so3_log(self.rotation)
        theta2 = jnp.sum(omega * omega, axis=-1)
        theta = jnp.sqrt(theta2 + _EPS * _EPS)
        use_series = theta2 < _SERIES_T2
        K = skew(omega)
        eye = jnp.broadcast_to(jnp.eye(3, dtype=omega.dtype), K.shape)
        # V^{-1} = I - K/2 + (1/theta^2)(1 - a/(2b)) K^2,  a=sin/theta, b=(1-cos)/th^2
        a = jnp.where(use_series, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
        b = jnp.where(
            use_series, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2
        )
        coef = jnp.where(
            use_series,
            1.0 / 12.0 + theta2 / 720.0,
            (1.0 - a / (2.0 * b)) / jnp.where(use_series, 1.0, theta2),
        )
        Vinv = eye - 0.5 * K + coef[..., None, None] * jnp.matmul(K, K, precision=Precision.HIGHEST)
        v = jnp.einsum("...ij,...j->...i", Vinv, self.translation, precision=Precision.HIGHEST)
        return jnp.concatenate([omega, v], axis=-1)
