"""Voxel-block volume state and sparse TSDF sampling.

JAX rebuild of the reference's ``Volume`` / ``Block`` / ``Voxel``
(SURVEY.md components #10, #14; ``volume.h/.cu``, ``block.h`` [M];
InfiniTAM 8^3 voxel blocks [P:1410.0925]).  All storage is static-shape
device-resident arrays:

  * voxel data: (num_blocks, 512[,3]) float32 -- block b, flat local index
    lidx = (lx*8 + ly)*8 + lz.  Flat 2D storage pins XLA to one natural
    layout: 4D (NB,8,8,8) arrays let the compiler pick exotic layouts per
    consumer and insert full-volume relayout copies inside the integrate
    loop;
  * hash table: see ``ops/hashing.py`` (open addressing, packed codes);
  * visible list: fixed capacity with a valid count (CUDA stream compaction
    becomes sort-based compaction, ``ops/allocate.py``).

Geometry conventions:
  * global voxel index g (int), world position = g * voxel_size (voxel
    "centers" sit on the metric lattice);
  * block coord = floor_div(g, 8); local = g - 8*block (always in [0,8));
  * block coords are bounded to [-512, 512) per axis so a block key packs
    into one int32 for sort-based dedup (scene extent limit: +-512 *
    block_extent, i.e. +-32.7 m at the default 8 mm voxels).

Block index 0 is a *sentinel null block* (weight forever 0); hash misses
gather from it harmlessly, which removes all bounds branches from the hot
sampling paths.  Real blocks start at index 1.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import Config
from ..utils.pytree import pytree_dataclass
from . import hashing

COORD_BOUND = 512  # per-axis block coord in [-COORD_BOUND, COORD_BOUND)


@pytree_dataclass
class VolumeState:
    """Sparse voxel-block TSDF volume (the reference's ``Volume`` state)."""

    # hash table (packed-code open addressing)
    hash_codes: jax.Array     # (hash_size,) int32, INVALID_CODE = empty
    hash_values: jax.Array    # (hash_size,) int32 block index
    free_count: jax.Array     # () int32, next free block index (starts at 1)
    # voxel storage
    block_coords: jax.Array   # (num_blocks, 3) int32 coord of each block
    tsdf: jax.Array           # (num_blocks, 512) float32 in [-1, 1]
    weight: jax.Array         # (num_blocks, 512) float32
    colorpack: jax.Array      # (num_blocks, 512) int32 w8|r8|g8|b8: 8-bit
                              # rgb (InfiniTAM stores u8 color too) + 8-bit
                              # integer color weight.  One flat array
                              # instead of (nb,512,3)+(nb,512) f32: voxel
                              # color costs ONE gather/DMA lane, avoids
                              # the minor-dim-3 T(4,128) layout, and is
                              # 4x smaller (128 MB vs 512 MB at capacity)
    # per-frame visible set (compacted; entries beyond num_visible are 0)
    visible_ids: jax.Array    # (max_visible,) int32 block indices
    num_visible: jax.Array    # () int32
    # persistent per-block surfel lists (maintained incrementally by
    # integration: only truncation-band blocks can change TSDF, so every
    # other block's list stays valid by construction).  One surfel per
    # near-surface voxel (|tsdf| < splat band, observed), packed
    # ``lidx<<16 | tsdf_q15`` and sorted to a row prefix; EMPTY_SURFEL
    # fills the tail.  The splat renderer scatters these compacted rows
    # instead of all 512 voxels of every surface block (~4x fewer
    # scatter lanes).
    surfpack: jax.Array       # (num_blocks, surfel_slots) int32
    surf_count: jax.Array     # (num_blocks,) int32 live surfels per block
    surf_overflow: jax.Array  # () int32 surfels dropped by slot capacity
    # diagnostics (never silently dropped work -- SURVEY.md §6)
    alloc_overflow: jax.Array    # () int32 candidates dropped by capacity
    visible_overflow: jax.Array  # () int32 visible blocks beyond capacity
    # incremental-mesh dirty flags: block b is flagged when ITS voxel data
    # changed (integrate_sparse scatters its work list here; ~free).  The
    # mesh of b depends on b plus its 7 +direction halo neighbors, so the
    # mesh updater expands flags by the 7 MINUS-neighbor lookups at
    # extraction time (once per mesh cadence) rather than per frame
    # (ops/mcubes.update_mesh_cache), then clears them.
    mesh_dirty: jax.Array        # (num_blocks,) bool


EMPTY_SURFEL = jnp.int32(0x7FFFFFFF)


def surfel_band(config: Config) -> float:
    """|tsdf| gate (mu units) for voxel surfels: wide enough for a
    continuous >=1.5-voxel shell, tight enough to stay in the linear
    TSDF region (shared by the splat renderer and the integrate-time
    surfel maintenance, which must agree)."""
    return min(
        1.0,
        max(config.splat_band, 1.5 * config.voxel_size / config.trunc_dist),
    )


def create_volume(config: Config, dtype=jnp.float32) -> VolumeState:
    nb = config.num_blocks
    bv = config.block_volume
    return VolumeState(
        hash_codes=jnp.full((config.hash_size,), hashing.EMPTY_CODE, jnp.int32),
        hash_values=jnp.zeros((config.hash_size,), jnp.int32),
        free_count=jnp.asarray(1, jnp.int32),  # block 0 = null sentinel
        block_coords=jnp.zeros((nb, 3), jnp.int32),
        tsdf=jnp.ones((nb, bv), dtype),
        weight=jnp.zeros((nb, bv), dtype),
        colorpack=jnp.zeros((nb, bv), jnp.int32),
        visible_ids=jnp.zeros((config.max_visible,), jnp.int32),
        num_visible=jnp.asarray(0, jnp.int32),
        surfpack=jnp.full((nb, config.surfel_slots), EMPTY_SURFEL, jnp.int32),
        surf_count=jnp.zeros((nb,), jnp.int32),
        surf_overflow=jnp.asarray(0, jnp.int32),
        alloc_overflow=jnp.asarray(0, jnp.int32),
        visible_overflow=jnp.asarray(0, jnp.int32),
        mesh_dirty=jnp.zeros((nb,), bool),
    )


def quantized_orientation(tsdf_rows):
    """Per-voxel quantized TSDF-gradient direction, (gx, gy, gz) int32
    in {-1, 0, 1}: the outward surface orientation (TSDF grows toward
    free space).  Central differences within the block (one-sided at
    block faces -- the neighbor block is out of reach here, and only
    the SIGN pattern matters); components below a quarter of the
    dominant one quantize to 0 so near-tangent axes don't flip the
    back-face culling test.  Shared by ``pack_surfels`` (stored in bits
    24-29 of the surfel word) and the direct splat path, which computes
    it on the fly -- the two renderers must cull identically."""
    t3 = tsdf_rows.reshape(-1, 8, 8, 8)

    def _grad(axis):
        lo = jnp.concatenate(
            [
                jax.lax.slice_in_dim(t3, 0, 1, axis=axis),
                jax.lax.slice_in_dim(t3, 0, 7, axis=axis),
            ],
            axis=axis,
        )
        hi = jnp.concatenate(
            [
                jax.lax.slice_in_dim(t3, 1, 8, axis=axis),
                jax.lax.slice_in_dim(t3, 7, 8, axis=axis),
            ],
            axis=axis,
        )
        return (hi - lo).reshape(tsdf_rows.shape)

    gx, gy, gz = _grad(1), _grad(2), _grad(3)
    gm = 0.25 * jnp.maximum(
        jnp.abs(gx), jnp.maximum(jnp.abs(gy), jnp.abs(gz))
    )

    def _q(g):
        return jnp.where(g > gm, 1, jnp.where(g < -gm, -1, 0)).astype(
            jnp.int32
        )

    return _q(gx), _q(gy), _q(gz)


def pack_surfels(tsdf_rows, weight_rows, band: float, slots: int):
    """Rows (C, 512) -> compacted surfel rows (C, slots) + counts.

    A voxel is a surfel iff observed and |tsdf| < band.  Packed value
    (30 bits, < EMPTY_SURFEL)::

        qgz+1 << 28 | qgy+1 << 26 | qgx+1 << 24 |
        |tsdf|_q14 << 10 | sign(tsdf) << 9 | lidx

    where (qgx, qgy, qgz) in {-1,0,1}^3 is the quantized TSDF-gradient
    direction (the outward surface orientation).  The renderer culls
    surfels whose orientation faces AWAY from the viewing ray:
    without it, any hole in the front shell at a novel viewpoint lets
    BACK-face surfels win the z-buffer (measured: 35% of pixels off by
    up to the full sphere diameter on the novel-view sphere test).

    Rows are filled inner-half-band first (|tsdf| < band/2) so that when
    a block's shell exceeds ``slots`` (an axis-aligned plane's shell is
    8x8x3 = 192 voxels -- exactly the default budget -- and oblique
    shells run thicker), overflow sheds only OUTER-shell voxels, never
    carving coverage holes in the surface-crossing set.  (A first
    version compacted in plain lidx order; its overflow dropped whole
    +x slabs of every overflowing block, which striped the floor out of
    the rendered model and sent the 640x480 bench into tracking
    collapse at frame ~12.)  Returns (surf (C,slots), count (C,),
    dropped (C,)).
    """
    val, pos, count = _surfel_slots(tsdf_rows, weight_rows, band, slots)
    out = place_surfels(val, pos, slots)
    kept = jnp.minimum(count, slots)
    slot_live = jax.lax.broadcasted_iota(
        jnp.int32, (1, slots), 1
    ) < kept[:, None]
    out = jnp.where(slot_live, out, EMPTY_SURFEL)
    return out, kept, count - kept


def _surfel_slots(tsdf_rows, weight_rows, band: float, slots: int):
    """Packed surfel words (C, n), their slot (C, n; -1 = not kept) and
    the live count (C,) of each row (see ``pack_surfels``)."""
    n = tsdf_rows.shape[1]
    lidx = jnp.arange(n, dtype=jnp.int32)[None, :]
    mag = jnp.clip(
        jnp.round(jnp.abs(tsdf_rows) * 16383.0), 0, 16383
    ).astype(jnp.int32)
    sign = (tsdf_rows < 0.0).astype(jnp.int32)
    live = (jnp.abs(tsdf_rows) < band) & (weight_rows > 0.0)

    gx, gy, gz = quantized_orientation(tsdf_rows)
    val = (
        ((gz + 1) << 28) | ((gy + 1) << 26) | ((gx + 1) << 24)
        | (mag << 10) | (sign << 9) | lidx
    )                                                      # 30 bits

    # Two-priority compaction instead of a per-row SORT: all the priority
    # has to guarantee is "overflow sheds OUTER-shell voxels first".  The
    # inner half-band (|tsdf| < band/2, the surface-crossing voxels;
    # worst-case oblique-plane shell ~8*8*2.6 < slots) is placed first,
    # the outer half-band after it -- two cumsums.
    inner = live & (jnp.abs(tsdf_rows) < 0.5 * band)
    outer = live & ~inner
    n_inner = jnp.sum(inner, axis=1, keepdims=True)
    pos = jnp.where(
        inner,
        jnp.cumsum(inner, axis=1) - 1,
        n_inner + jnp.cumsum(outer, axis=1) - 1,
    )
    pos = jnp.where(live & (pos < slots), pos, -1)
    count = jnp.sum(live, axis=1).astype(jnp.int32)
    return val, pos, count


def place_surfels(val, pos, slots: int):
    """Scatter each row's words into their slots: ``out[c, pos[c, i]] =
    val[c, i]`` for ``pos >= 0``; slots nobody claims read 0.

    A one-hot matmul over byte columns: every product is 0/1 times a
    byte, bf16 holds bytes exactly, each slot receives at most one hit
    (slots are unique per row) and the sum accumulates in f32, so the
    result is exact -- checked against a ``take_along_axis`` reference at
    full size by ``chip_smoke.py`` on the GPU and at small size by the
    CPU tests."""
    iota = jax.lax.broadcasted_iota(jnp.int32, (1, 1, slots), 2)
    onehot = (pos[:, :, None] == iota).astype(jnp.bfloat16)
    rhs = jnp.stack(
        [
            (val >> 24) & 0xFF,
            (val >> 16) & 0xFF,
            (val >> 8) & 0xFF,
            val & 0xFF,
        ],
        axis=-1,
    ).astype(jnp.bfloat16)                                 # (C, n, 4)
    cols = jax.lax.dot_general(
        onehot, rhs,
        dimension_numbers=(((1,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
    ).astype(jnp.int32)                                    # (C, slots, 4)
    return (
        (cols[..., 0] << 24) | (cols[..., 1] << 16)
        | (cols[..., 2] << 8) | cols[..., 3]
    )


def unpack_surfels(surf_rows):
    """(..., S) int32 -> (lidx int32, tsdf f32, valid bool,
    (gx, gy, gz) f32 quantized outward-orientation components)."""
    valid = surf_rows != EMPTY_SURFEL
    lidx = jnp.where(valid, surf_rows & 0x1FF, 0)
    mag = (surf_rows >> 10) & 0x3FFF
    sign = jnp.where((surf_rows >> 9) & 1 == 1, -1.0, 1.0)
    tsdf = sign * mag.astype(jnp.float32) * (1.0 / 16383.0)
    gx = (((surf_rows >> 24) & 3) - 1).astype(jnp.float32)
    gy = (((surf_rows >> 26) & 3) - 1).astype(jnp.float32)
    gz = (((surf_rows >> 28) & 3) - 1).astype(jnp.float32)
    return lidx, jnp.where(valid, tsdf, 1.0), valid, (gx, gy, gz)


# ---------------------------------------------------------------------------
# coordinate packing (sort-based dedup currency)
# ---------------------------------------------------------------------------


def pack_block_coords(coords: jax.Array) -> jax.Array:
    """(...,3) int32 block coords -> (...,) int32 sortable code."""
    c = coords + COORD_BOUND
    return (c[..., 0] << 20) | (c[..., 1] << 10) | c[..., 2]


def unpack_block_coords(codes: jax.Array) -> jax.Array:
    x = (codes >> 20) & 0x3FF
    y = (codes >> 10) & 0x3FF
    z = codes & 0x3FF
    return jnp.stack([x, y, z], axis=-1) - COORD_BOUND


def coords_in_bounds(coords: jax.Array) -> jax.Array:
    return jnp.all(
        (coords >= -COORD_BOUND) & (coords < COORD_BOUND), axis=-1
    )


INVALID_CODE = jnp.int32(0x7FFFFFFF)


# ---------------------------------------------------------------------------
# sparse voxel access
# ---------------------------------------------------------------------------


def world_to_voxel(p: jax.Array, config: Config) -> jax.Array:
    """World points (...,3) -> continuous voxel coords."""
    return p / config.voxel_size


def voxel_block_local(g: jax.Array, config: Config):
    """Integer voxel indices (...,3) -> (block_coords, local_idx)."""
    bs = config.block_size
    block = jnp.floor_divide(g, bs)
    local = g - block * bs
    return block, local


def lookup_blocks(volume: VolumeState, block_coords: jax.Array, config: Config):
    """Hash-lookup block coords (...,3) -> block index (0 = null/missing)."""
    idx, found = hashing.lookup(
        volume.hash_codes, volume.hash_values, block_coords, config
    )
    return jnp.where(found, idx, 0)


def local_flat(local: jax.Array, config: Config) -> jax.Array:
    """Local voxel coords (...,3) -> flat index (lx*8 + ly)*8 + lz."""
    bs = config.block_size
    return (local[..., 0] * bs + local[..., 1]) * bs + local[..., 2]


def read_voxels(volume: VolumeState, g: jax.Array, config: Config):
    """Gather TSDF/weight at integer voxel coords g (...,3).

    Returns (tsdf, weight); unallocated voxels read the null block:
    tsdf=1, weight=0.
    """
    block, local = voxel_block_local(g, config)
    b = lookup_blocks(volume, block, config)
    li = local_flat(local, config)
    return volume.tsdf[b, li], volume.weight[b, li]


def sample_tsdf_nearest(volume: VolumeState, p_world: jax.Array, config: Config):
    """Nearest-voxel TSDF at world points: the cheap raycast march sample."""
    g = jnp.round(world_to_voxel(p_world, config)).astype(jnp.int32)
    return read_voxels(volume, g, config)


def sample_tsdf_trilinear(
    volume: VolumeState, p_world: jax.Array, config: Config
):
    """Trilinear TSDF at world points (...,3) -> (value, all_observed).

    8 hash lookups per point (one per corner, InfiniTAM-style cross-block
    interpolation); ok requires every corner observed (weight > 0).
    """
    q = world_to_voxel(p_world, config)
    q0 = jnp.floor(q)
    frac = q - q0
    q0 = q0.astype(jnp.int32)
    val = jnp.zeros(q.shape[:-1], volume.tsdf.dtype)
    ok = jnp.ones(q.shape[:-1], bool)
    for dx in (0, 1):
        wx = frac[..., 0] if dx else 1.0 - frac[..., 0]
        for dy in (0, 1):
            wy = frac[..., 1] if dy else 1.0 - frac[..., 1]
            for dz in (0, 1):
                wz = frac[..., 2] if dz else 1.0 - frac[..., 2]
                g = q0 + jnp.asarray([dx, dy, dz], jnp.int32)
                f, w = read_voxels(volume, g, config)
                val = val + (wx * wy * wz) * f
                ok = ok & (w > 0.0)
    return val, ok


def pack_voxel_color(rgb: jax.Array, cweight: jax.Array) -> jax.Array:
    """(..., 3) f32 rgb in [0,1] + (...,) f32 weight -> (...) int32."""
    c = jnp.clip(jnp.round(rgb * 255.0), 0, 255).astype(jnp.int32)
    w = jnp.clip(jnp.round(cweight), 0, 255).astype(jnp.int32)
    return (w << 24) | (c[..., 0] << 16) | (c[..., 1] << 8) | c[..., 2]


def unpack_voxel_color(packed: jax.Array):
    """(...) int32 -> ((..., 3) f32 rgb, (...) f32 color weight)."""
    r = ((packed >> 16) & 0xFF).astype(jnp.float32)
    g = ((packed >> 8) & 0xFF).astype(jnp.float32)
    b = (packed & 0xFF).astype(jnp.float32)
    cw = ((packed >> 24) & 0xFF).astype(jnp.float32)
    return jnp.stack([r, g, b], axis=-1) * (1.0 / 255.0), cw


def sample_color_trilinear(
    volume: VolumeState, p_world: jax.Array, config: Config
):
    """Trilinear color at world points (...,3) -> (rgb, any_observed).

    Color uses weights as soft interpolation (unobserved corners contribute
    zero weight) so color bleeds less at boundaries.
    """
    q = world_to_voxel(p_world, config)
    q0 = jnp.floor(q)
    frac = q - q0
    q0 = q0.astype(jnp.int32)
    rgb = jnp.zeros(q.shape[:-1] + (3,), jnp.float32)
    wsum = jnp.zeros(q.shape[:-1], jnp.float32)
    for dx in (0, 1):
        wx = frac[..., 0] if dx else 1.0 - frac[..., 0]
        for dy in (0, 1):
            wy = frac[..., 1] if dy else 1.0 - frac[..., 1]
            for dz in (0, 1):
                wz = frac[..., 2] if dz else 1.0 - frac[..., 2]
                g = q0 + jnp.asarray([dx, dy, dz], jnp.int32)
                block, local = voxel_block_local(g, config)
                b = lookup_blocks(volume, block, config)
                li = local_flat(local, config)
                c, cw = unpack_voxel_color(volume.colorpack[b, li])
                w = (wx * wy * wz) * jnp.where(cw > 0.0, 1.0, 0.0)
                rgb = rgb + w[..., None] * c
                wsum = wsum + w
    ok = wsum > 1e-6
    rgb = rgb / jnp.maximum(wsum, 1e-6)[..., None]
    return jnp.where(ok[..., None], rgb, 0.0), ok


def allocated_mask(volume: VolumeState, config: Config) -> jax.Array:
    """(num_blocks,) bool -- which block slots hold real allocated blocks."""
    n = volume.tsdf.shape[0]
    ids = jnp.arange(n, dtype=jnp.int32)
    return (ids >= 1) & (ids < volume.free_count)
