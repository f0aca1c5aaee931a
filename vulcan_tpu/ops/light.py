"""Scene illumination model + light-aware photometric tracking support.

Rebuild of the reference's light model / ``LightTracker`` (SURVEY.md
component #20 [M]: light estimation + shading for photometric tracking,
recalled as ``light.h/.cu`` + ``light_tracker.*``; the reference mount
was empty so the recalled point-light form could not be verified).

Design: instead of an iteratively solved point light, the
illumination is a low-order real **spherical-harmonics gain field over
surface normals** -- the standard 9-coefficient Lambertian lighting
basis (Ramamoorthi & Hanrahan, "An Efficient Representation for
Irradiance Environment Maps", 2001), which subsumes ambient +
directional light (its order-0/1 subset) and is LINEAR in its
coefficients.  That linearity is the whole point: estimation is
one dense planar elementwise+reduce pass building a (9,9) normal matrix
(no per-pixel scatter, no inner iteration) and a 9x9 Cholesky solve on
device, so it fuses into the jitted tracking step with zero host syncs.

The photometric measurement model in ``mode="light"`` tracking is

    I_live(warp(x)) ~ gain(n_m(x)) * I_model(x),
    gain(n) = b(n) . ell,      b = 9 SH basis values of the unit normal

where ``I_model`` is the raycast model intensity (fused voxel color,
which bakes in the lighting of the frames that WROTE it) and ``gain``
absorbs what changed since: exposure/white-balance shifts (order 0) and
moving/anisotropic illumination (orders 1-2).  With unchanged lighting
the estimate collapses to ``ell ~ e0`` (unit gain) and light tracking
degrades gracefully to plain combined-mode photometric tracking.

``ell`` is re-estimated at every association round with the pose frozen
(the warp tightens as pose converges, so each refit is less biased by
misalignment), then held fixed across the inner GN iterations so the
pose solve never alternates against a moving lighting estimate.  A
ridge prior toward unit gain keeps the solve well-posed when the
visible normals span a degenerate cone (e.g. a wall filling the view)
and anchors the 9 lighting DoF so they cannot absorb pose error (gain
and image motion are locally ambiguous).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils.pytree import pytree_dataclass

#: Gain clip range: a Lambertian gain is non-negative, and anything
#: above 4x means the correspondence is junk, not lighting.
_GAIN_LO = 0.0
_GAIN_HI = 4.0

#: Minimum weighted sample count below which estimation returns unit
#: gain (an almost-empty model cannot constrain 9 coefficients).
_MIN_SAMPLES = 64.0


def sh_basis(nx: jax.Array, ny: jax.Array, nz: jax.Array):
    """The 9 order-2 real SH basis values of a unit normal, planar.

    Unnormalized monomial form (constant factors fold into the estimated
    coefficients, since the same basis is used for estimation and
    shading): ``[1, ny, nz, nx, nx*ny, ny*nz, 3nz^2-1, nx*nz, nx^2-ny^2]``.
    """
    one = jnp.ones_like(nx)
    return (
        one,
        ny, nz, nx,
        nx * ny, ny * nz,
        3.0 * nz * nz - 1.0,
        nx * nz,
        nx * nx - ny * ny,
    )


def unit_coeffs() -> jax.Array:
    """Coefficients of the identity gain field (gain(n) == 1)."""
    return jnp.zeros((9,)).at[0].set(1.0)


def estimate_gain(
    n_m: jax.Array,
    model_i: jax.Array,
    live_i: jax.Array,
    weight: jax.Array,
    ridge: float = 3e-2,
) -> jax.Array:
    """Weighted linear LSQ for the 9 SH gain coefficients.

    Minimizes ``sum w * (model_i * b(n_m).ell - live_i)^2 +
    lam * |ell - e0|^2`` with ``lam = ridge * tr(M)/9`` (scale-free
    Tikhonov toward unit gain).  All inputs planar ``(H, W)`` except
    ``n_m`` ``(H, W, 3)``; returns ``(9,)`` f32.

    The 45+9 normal-equation entries come from ONE stacked reduction
    (the `_fused_normal_eqs` trick from ops/icp.py: building A as an
    (N, 9) array would force a minor-dim-9 relayout).
    """
    b = sh_basis(n_m[..., 0], n_m[..., 1], n_m[..., 2])
    a = [model_i * bk for bk in b]
    w = weight.astype(jnp.float32)

    parts = []
    for j in range(9):
        wa = w * a[j]
        for k in range(j, 9):
            parts.append(wa * a[k])
        parts.append(wa * live_i)
    parts.append(w)
    sums = jnp.sum(jnp.stack(parts).reshape(len(parts), -1), axis=1)

    pos = {}
    k = 0
    for j in range(9):
        for c in range(j, 9):
            pos[(j, c)] = k
            k += 1
        k += 1  # the rhs entry interleaved after row j's triangle
    mmap = [[pos[(min(j, c), max(j, c))] for c in range(9)] for j in range(9)]
    ymap = [pos[(j, 8)] + 1 for j in range(9)]
    M = sums[jnp.asarray(mmap)]
    y = sums[jnp.asarray(ymap)]
    cnt = sums[-1]

    e0 = unit_coeffs()
    lam = ridge * (jnp.trace(M) / 9.0) + 1e-12
    Mr = M + lam * jnp.eye(9)
    yr = y + lam * e0
    L = jnp.linalg.cholesky(Mr)
    ell = jax.scipy.linalg.cho_solve((L, True), yr)
    good = jnp.all(jnp.isfinite(ell)) & (cnt >= _MIN_SAMPLES)
    return jnp.where(good, ell, e0)


def gain(n_m: jax.Array, coeffs: jax.Array) -> jax.Array:
    """Planar gain field ``clip(b(n_m).ell)`` for ``(H, W, 3)`` normals."""
    b = sh_basis(n_m[..., 0], n_m[..., 1], n_m[..., 2])
    g = sum(ck * bk for ck, bk in zip(coeffs, b))
    return jnp.clip(g, _GAIN_LO, _GAIN_HI)


def scale_photo_samples(samples, n_m: jax.Array, coeffs: jax.Array):
    """Apply the gain field to fixed photometric samples.

    ``samples`` is the warp-once tuple ``(i_m0, gu, gv, u0, v0, ok)``
    (ops/icp.py color_rows_fixed): the predicted model intensity becomes
    ``g * (i_m0 + gu du + gv dv)``, i.e. all three value channels scale
    by the per-correspondence gain.  (The image-space gradient of g
    itself is dropped -- g varies on the scale of surface curvature,
    which is far below the photometric linearization scale except at
    normal discontinuities, where the geometric gates dominate anyway.)
    """
    i_m0, gu, gv, u0, v0, ok = samples
    g = gain(n_m, coeffs)
    return (g * i_m0, g * gu, g * gv, u0, v0, ok)


@pytree_dataclass
class Light:
    """Public illumination-model API object (reference parity: `Light`).

    Wraps the 9 SH gain coefficients with estimate/shade entry points so
    offline users (relighting checks, LightTracker diagnostics) get the
    same math the tracker uses internally.
    """

    coeffs: jax.Array  # (9,) f32

    @classmethod
    def identity(cls) -> "Light":
        return cls(coeffs=unit_coeffs())

    @classmethod
    def estimate(
        cls,
        normals: jax.Array,
        model_intensity: jax.Array,
        live_intensity: jax.Array,
        valid: jax.Array,
        ridge: float = 3e-2,
    ) -> "Light":
        """Fit the gain field mapping model to live intensity.

        ``normals`` (H, W, 3) world-space unit normals, intensities
        (H, W), ``valid`` (H, W) bool.
        """
        return cls(
            coeffs=estimate_gain(
                normals, model_intensity, live_intensity, valid, ridge
            )
        )

    def shade(self, normals: jax.Array, albedo: jax.Array) -> jax.Array:
        """Predicted intensity ``albedo * gain(normals)``."""
        return albedo * gain(normals, self.coeffs)
