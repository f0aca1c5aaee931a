"""Colored marching-cubes mesh extraction from the sparse TSDF volume.

JAX rebuild of the reference ``Extractor`` (SURVEY.md component #18,
``extractor.cu`` [M]; per-voxel-cube classify + prefix-scan compaction +
emit kernels [B]).  Structure:

  1. **Chunked halo construction**: instead of per-corner hash lookups (the
     CUDA pattern), each block gathers its 7 (+x/+y/+z/...) neighbor blocks
     once and builds an extended (9,9,9) halo; every cube corner read is
     then a static slice -- no gathers in the inner loop, missing neighbors
     read the null block (weight 0) so boundary cubes mask out cleanly.
     Blocks are processed ``mesh_chunk`` at a time in a while_loop whose
     trip count follows the actual work-list length, so halo temporaries
     stay ~15 MB regardless of capacity (round-1 VERDICT item 5).
  2. **Classify**: per-cube config bits + triangle counts from the lookup
     table (tables derived + validated in tools/gen_mc_tables.py).
  3. **Compact**: exclusive cumsum of counts + a running total carried
     across chunks -> global output offsets (replaces the CUDA prefix-scan
     + atomic emit).
  4. **Edge-major emit** (round 5): each active cube interpolates its 12
     edges ONCE with STATIC corner indexing (edge endpoints are
     compile-time constants), then every triangle-vertex slot selects
     across the 12 precomputed edges -- ~2x fewer elementwise passes than
     the round-4 per-vertex 8-corner select loops, and the whole chunk
     lands in ONE scatter instead of five.

**Incremental extraction** (round 5, BASELINE config 5): a persistent
per-block triangle cache (``MeshCache``) maintained like the persistent
surfel lists.  Integration flags changed blocks in ``volume.mesh_dirty``
(one scatter per frame); ``update_mesh_cache`` expands the flags by the 7
minus-neighbor lookups (a block's mesh halo reads its +direction
neighbors, so a changed block re-meshes up to 8 dependents), re-meshes
ONLY those blocks into quantized per-block triangle slots, and clears the
flags; ``cache_to_mesh`` decodes the whole cache into a triangle soup in
a few fixed passes.  A full-session online mesh then costs
O(changed blocks) per cadence instead of O(allocated blocks).

Triangle cache encoding (per vertex, 29 bits): ``lidx<<20 | edge<<16 |
t16`` -- the cube's flat index in its block (9b), the crossed edge (4b)
and the interpolation parameter quantized to 16 bits (~0.1 um at 8 mm
voxels); vertex colors are rgb888.  Quantization error is far below
voxel noise; ``test_incremental_matches_full_extraction`` pins the
cache path to the direct extractor.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..config import Config
from ..utils.pytree import pytree_dataclass
from . import blocks as B
from . import mc_tables as T

# The 7 +direction halo neighbors of a block (and, negated, the blocks
# whose halos read a given block).
_HALO_OFFSETS = (
    (1, 0, 0), (0, 1, 0), (0, 0, 1),
    (1, 1, 0), (1, 0, 1), (0, 1, 1), (1, 1, 1),
)


@pytree_dataclass
class Mesh:
    """Triangle soup with per-vertex colors (fixed capacity + count)."""

    positions: jax.Array   # (capacity, 3, 3) world-space triangle vertices
    colors: jax.Array      # (capacity, 3, 3) rgb in [0,1]
    count: jax.Array       # () int32 valid triangles
    overflow: jax.Array    # () int32 triangles dropped for ANY reason
                           # (buffer capacity + active-cube compaction +
                           # per-block cache slots) -- never silent
    compact_dropped: jax.Array  # () int32 the subset of ``overflow`` lost
                                # to active-cube compaction / per-block
                                # slot capacity (vs. the output buffer cap)


@pytree_dataclass
class MeshCache:
    """Persistent per-block triangle cache (incremental extraction).

    Triangle k of block b lives in slot ``(b, k)``; slots are filled
    contiguously in cube order, so ``counts[b]`` delimits the live
    prefix.  ``dropped[b]`` counts that block's triangles lost to the
    per-block slot capacity or active-cube compaction at its last
    re-mesh (replaced, not accumulated, on the next re-mesh).
    """

    va: jax.Array       # (num_blocks, mesh_slots) int32 vertex word A
    vb: jax.Array       # (num_blocks, mesh_slots) int32 vertex word B
    vc: jax.Array       # (num_blocks, mesh_slots) int32 vertex word C
    ca: jax.Array       # (num_blocks, mesh_slots) int32 rgb888 color A
    cb: jax.Array       # (num_blocks, mesh_slots) int32 rgb888 color B
    cc: jax.Array       # (num_blocks, mesh_slots) int32 rgb888 color C
    counts: jax.Array   # (num_blocks,) int32 live triangles per block
    dropped: jax.Array  # (num_blocks,) int32 triangles lost per block


def create_mesh_cache(config: Config) -> MeshCache:
    nb, ts = config.num_blocks, config.mesh_slots
    z = jnp.zeros((nb, ts), jnp.int32)
    return MeshCache(
        va=z, vb=z + 0, vc=z + 0, ca=z + 0, cb=z + 0, cc=z + 0,
        counts=jnp.zeros((nb,), jnp.int32),
        dropped=jnp.zeros((nb,), jnp.int32),
    )


def _halos_for_ids(volume: B.VolumeState, ids, row_valid, config: Config):
    """Build (CB, 9, 9, 9[,3]) halo arrays for the given block rows.

    Own-block data comes from row gathers (invalid rows read the null
    block 0); the 7 face/edge/corner neighbors resolve through the hash
    once per block.  Unallocated rows carry weight 0 everywhere, so no
    explicit row masking is needed in the voxel data -- the observed
    mask covers it.
    """
    safe_ids = jnp.where(row_valid, ids, 0)
    coords = volume.block_coords[safe_ids]

    def neighbor_idx(offset):
        idx = B.lookup_blocks(
            volume, coords + jnp.asarray(offset, jnp.int32), config
        )
        return jnp.where(row_valid, idx, 0)

    neighbors = {off: neighbor_idx(off) for off in _HALO_OFFSETS}
    CB = ids.shape[0]

    def extend(flat_arr):
        """(NB,512[,C]) -> (CB,9,9,9[,C]) using neighbor faces."""
        tail = flat_arr.shape[2:]
        own = flat_arr[safe_ids]
        arr = own.reshape((CB, 8, 8, 8) + tail)
        ext = jnp.zeros((CB, 9, 9, 9) + tail, arr.dtype)
        ext = ext.at[:, :8, :8, :8].set(arr)

        def rows(off):
            return flat_arr[neighbors[off]].reshape((-1, 8, 8, 8) + tail)

        ext = ext.at[:, 8, :8, :8].set(rows((1, 0, 0))[:, 0, :, :])
        ext = ext.at[:, :8, 8, :8].set(rows((0, 1, 0))[:, :, 0, :])
        ext = ext.at[:, :8, :8, 8].set(rows((0, 0, 1))[:, :, :, 0])
        ext = ext.at[:, 8, 8, :8].set(rows((1, 1, 0))[:, 0, 0, :])
        ext = ext.at[:, 8, :8, 8].set(rows((1, 0, 1))[:, 0, :, 0])
        ext = ext.at[:, :8, 8, 8].set(rows((0, 1, 1))[:, :, 0, 0])
        ext = ext.at[:, 8, 8, 8].set(rows((1, 1, 1))[:, 0, 0, 0])
        return ext

    # Halos are gathered in the packed int32 color form (one lane per
    # voxel instead of 3) and unpacked once at the end.
    return (
        extend(volume.tsdf),
        extend(volume.weight),
        B.unpack_voxel_color(extend(volume.colorpack))[0],
        coords,
    )


def _chunk_surface(volume, ids, row_valid, config: Config, act_frac: float):
    """Halo + classify + active-cube compaction + per-edge interpolation
    for one chunk of block rows.

    Only a few percent of cubes carry triangles, but a dense emit would
    interpolate edges for EVERY cube; active cubes are compacted to
    ``ACT = act_frac * CB * 512`` lanes first (cumsum + gather).  Actives
    beyond the capacity have their triangles COUNTED (never silently
    lost) and excluded so downstream output stays dense.

    Returns a dict of compacted arrays (see keys below); ``t12``/``c12``
    hold every cube's 12 edge interpolation parameters and colors,
    computed once with STATIC corner indexing.
    """
    bs = config.block_size
    CB = ids.shape[0]
    ext_tsdf, ext_weight, ext_color, coords = _halos_for_ids(
        volume, ids, row_valid, config
    )

    # --- classify: per-cube config over (CB, 8, 8, 8) cubes ---
    num_tris = jnp.asarray(T.NUM_TRIS)
    corner_vals = []
    corner_obs = []
    for ci in range(8):
        ox, oy, oz = (int(v) for v in T.CORNER_OFFSETS[ci])
        v = ext_tsdf[:, ox : ox + bs, oy : oy + bs, oz : oz + bs]
        w = ext_weight[:, ox : ox + bs, oy : oy + bs, oz : oz + bs]
        corner_vals.append(v)
        corner_obs.append(w > 0.0)
    observed = corner_obs[0]
    cfg_bits = jnp.zeros_like(corner_vals[0], dtype=jnp.int32)
    for ci in range(8):
        observed = observed & corner_obs[ci]
        cfg_bits = cfg_bits | ((corner_vals[ci] < 0.0).astype(jnp.int32) << ci)
    active = observed & row_valid[:, None, None, None]
    counts = jnp.where(active, num_tris[cfg_bits], 0)       # (CB,8,8,8)

    # --- compact ACTIVE cubes ---
    N = CB * bs ** 3
    ACT = max(4096, min(N, int(N * act_frac)))
    flat_counts = counts.reshape(-1)
    keep = flat_counts > 0
    order = jnp.cumsum(keep.astype(jnp.int32)) - 1
    kept = keep & (order < ACT)
    elig = jnp.where(kept, flat_counts, 0)
    dropped = jnp.sum(flat_counts) - jnp.sum(elig)

    cube_ids = jnp.full((ACT,), N, jnp.int32)
    cube_ids = cube_ids.at[jnp.where(kept, order, ACT)].set(
        jnp.arange(N, dtype=jnp.int32), mode="drop"
    )
    live = cube_ids < N
    safe = jnp.minimum(cube_ids, N - 1)

    def g(x):
        """Dense (flattens to (N,)) -> compacted (ACT,)."""
        return x.reshape((N,) + x.shape[4:])[safe]

    cfg_c = g(cfg_bits)
    counts_c = jnp.where(live, g(counts), 0)
    vals_c = [g(v) for v in corner_vals]                    # 8 x (ACT,)
    # CHANNEL-PLANAR everywhere (3 x (ACT, ...) instead of (ACT, ..., 3)):
    # minor-dim-3 f32 intermediates invite padded tiled layouts and
    # relayout copies -- the splat renderer's planar-channel lesson.
    cols_c = []
    for ox, oy, oz in (
        (int(a), int(b), int(c)) for a, b, c in T.CORNER_OFFSETS
    ):
        win = ext_color[:, ox : ox + bs, oy : oy + bs, oz : oz + bs]
        cols_c.append([g(win[..., ch]) for ch in range(3)])  # 3 x (ACT,)

    # --- per-edge interpolation, static corner indexing ---
    t12 = []
    c12 = [[], [], []]
    for e in range(12):
        a, b = (int(v) for v in T.EDGE_ENDPOINTS[e])
        va, vb = vals_c[a], vals_c[b]
        t = va / jnp.where(jnp.abs(va - vb) > 1e-12, va - vb, 1.0)
        t = jnp.clip(t, 0.0, 1.0)
        t12.append(t)
        for ch in range(3):
            c12[ch].append(
                cols_c[a][ch] + t * (cols_c[b][ch] - cols_c[a][ch])
            )
    t12 = jnp.stack(t12, axis=-1)                           # (ACT, 12)
    c12 = [jnp.stack(c, axis=-1) for c in c12]              # 3 x (ACT,12)

    block_of = safe // (bs ** 3)
    lidx_c = safe % (bs ** 3)
    return dict(
        flat_counts=flat_counts, elig=elig, dropped=dropped,
        live=live, cfg_c=cfg_c, counts_c=counts_c, safe=safe, g=g,
        t12=t12, c12=c12, block_of=block_of, lidx_c=lidx_c,
        coords=coords,
    )


def _edge_positions(s, config: Config):
    """3 x (ACT, 12) world-lattice edge-vertex position components
    (voxel units) -- channel-planar (see layout note above)."""
    bs = config.block_size
    local = (
        s["lidx_c"] // (bs * bs),
        (s["lidx_c"] // bs) % bs,
        s["lidx_c"] % bs,
    )
    ends = jnp.asarray(T.EDGE_ENDPOINTS)
    out = []
    for k in range(3):
        offs_k = jnp.asarray(T.CORNER_OFFSETS[:, k], jnp.float32)
        a = offs_k[ends[:, 0]]                              # (12,)
        b = offs_k[ends[:, 1]]
        base = (
            s["coords"][s["block_of"], k] * bs + local[k]
        ).astype(jnp.float32)                               # (ACT,)
        out.append(base[:, None] + a[None] + s["t12"] * (b - a)[None])
    return out                                              # 3 x (ACT,12)


def _select_edges(tri_all, per_edge):
    """Select per-vertex values across the 12 precomputed edges.

    ``tri_all`` (ACT, 15) holds edge ids (-1 pads); ``per_edge``
    (ACT, 12) the edge-major values.  12 where-passes over the full
    (ACT, 15) tensor -- fewer, larger ops than per-slot loops.
    """
    out = jnp.zeros(tri_all.shape, per_edge.dtype)
    for e in range(12):
        out = jnp.where(tri_all == e, per_edge[:, None, e], out)
    return out                                              # (ACT, 15)


def extract_mesh(volume: B.VolumeState, config: Config) -> Mesh:
    """Extract the zero isosurface of every allocated block."""
    nb = volume.tsdf.shape[0]
    vs = config.voxel_size
    cap = config.max_mesh_triangles
    CB = min(config.mesh_chunk, nb)
    # Rows [0, free_count) cover the null sentinel + every allocated block.
    n_chunks = (volume.free_count + CB - 1) // CB
    tri_table = jnp.asarray(T.TRI_TABLE)

    # Output buffers are CHANNEL-PLANAR (cap*3,) during accumulation
    # (see the layout note in _chunk_surface); one stack at the end
    # produces the (cap, 3, 3) Mesh arrays.
    zeros = jnp.zeros((cap * 3,), jnp.float32)

    def chunk_body(carry):
        i, total, dropped, px, py, pz, cr, cg, cb = carry
        start = i * CB
        ids = start + jnp.arange(CB, dtype=jnp.int32)
        row_valid = (ids >= 1) & (ids < volume.free_count)
        s = _chunk_surface(volume, ids, row_valid, config,
                           config.mesh_active_frac)

        offsets = total + jnp.cumsum(s["elig"]) - s["elig"]  # excl, (N,)
        chunk_total = jnp.sum(s["elig"])
        off_c = s["g"](offsets)                              # (ACT,)

        pos12 = _edge_positions(s, config)                   # 3 x (ACT,12)
        tri_all = tri_table[s["cfg_c"]]                      # (ACT, 15)

        # One scatter per component for all 5 triangle slots x 3
        # vertices: vertex slot v of cube -> flat vertex
        # (off + v//3)*3 + v%3; out-of-bounds (masked or beyond cap)
        # indices drop.
        v = jnp.arange(15, dtype=jnp.int32)
        tri_idx = off_c[:, None] + v[None] // 3              # (ACT, 15)
        ok = (
            s["live"][:, None]
            & ((v[None] // 3) < s["counts_c"][:, None])
            & (tri_idx < cap)
        )
        tgt = jnp.where(ok, tri_idx * 3 + v[None] % 3, cap * 3).reshape(-1)

        def put(dst, per_edge):
            sel = _select_edges(tri_all, per_edge)
            return dst.at[tgt].set(sel.reshape(-1), mode="drop")

        px = put(px, pos12[0] * vs)
        py = put(py, pos12[1] * vs)
        pz = put(pz, pos12[2] * vs)
        cr = put(cr, s["c12"][0])
        cg = put(cg, s["c12"][1])
        cb = put(cb, s["c12"][2])
        return (i + 1, total + chunk_total, dropped + s["dropped"],
                px, py, pz, cr, cg, cb)

    def cond(carry):
        return carry[0] < n_chunks

    _, total, dropped, px, py, pz, cr, cg, cb = jax.lax.while_loop(
        cond,
        chunk_body,
        (jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32),
         jnp.asarray(0, jnp.int32),
         zeros, zeros + 0, zeros + 0, zeros + 0, zeros + 0, zeros + 0),
    )

    def pack(x, y, z):
        return jnp.stack([x, y, z], axis=-1).reshape(cap, 3, 3)

    return Mesh(
        positions=pack(px, py, pz),
        colors=jnp.clip(pack(cr, cg, cb), 0.0, 1.0),
        count=jnp.minimum(total, cap).astype(jnp.int32),
        overflow=(jnp.maximum(total - cap, 0) + dropped).astype(jnp.int32),
        compact_dropped=dropped.astype(jnp.int32),
    )


def _compact_flags(flags):
    """(NB,) bool -> ((NB,) int32 padded index list, () int32 count)."""
    nb = flags.shape[0]
    order = jnp.cumsum(flags.astype(jnp.int32)) - 1
    lst = jnp.zeros((nb,), jnp.int32)
    lst = lst.at[jnp.where(flags, order, nb)].set(
        jnp.arange(nb, dtype=jnp.int32), mode="drop"
    )
    return lst, jnp.sum(flags.astype(jnp.int32))


def update_mesh_cache(
    volume: B.VolumeState, cache: MeshCache, config: Config
):
    """Re-mesh every block whose triangles may have changed; clear flags.

    The dirty set is ``volume.mesh_dirty`` (blocks whose voxel data
    changed, flagged by integration) expanded by the 7 minus-neighbor
    lookups: block b's mesh halo reads b's +direction neighbors, so a
    change to t re-meshes {t - off}.  The expansion runs once per mesh
    cadence (not per frame) over the compacted flag list; both loops'
    trip counts follow the actual dirty count.  Returns
    ``(volume, cache)`` with flags cleared -- the WHOLE expanded set is
    processed, so clearing every flag is exact, and a block whose
    surface vanished rewrites to count 0.
    """
    nb = volume.tsdf.shape[0]
    bs = config.block_size
    ts = config.mesh_slots
    tri_table = jnp.asarray(T.TRI_TABLE)

    # --- expand dirty flags by minus-neighbors -------------------------
    flag_list, n_flagged = _compact_flags(volume.mesh_dirty)
    CE = min(4096, nb)
    n_ech = (n_flagged + CE - 1) // CE

    def expand_body(carry):
        i, exp = carry
        ids = jax.lax.dynamic_slice_in_dim(flag_list, i * CE, CE)
        valid = (i * CE + jnp.arange(CE, dtype=jnp.int32)) < n_flagged
        coords = volume.block_coords[jnp.where(valid, ids, 0)]
        for off in _HALO_OFFSETS:
            t = B.lookup_blocks(
                volume, coords - jnp.asarray(off, jnp.int32), config
            )
            exp = exp.at[jnp.where(valid, t, 0)].set(True)
        return i + 1, exp

    _, expanded = jax.lax.while_loop(
        lambda c: c[0] < n_ech,
        expand_body,
        (jnp.asarray(0, jnp.int32), volume.mesh_dirty),
    )
    expanded = expanded.at[0].set(False)

    # --- re-mesh the expanded set --------------------------------------
    work_list, n_work = _compact_flags(expanded)
    CB = min(config.mesh_chunk, nb)
    n_wch = (n_work + CB - 1) // CB

    def work_body(carry):
        i, va, vb, vc, ca, cb, cc, counts, dropped = carry
        ids = jax.lax.dynamic_slice_in_dim(work_list, i * CB, CB)
        row_valid = (
            ((i * CB + jnp.arange(CB, dtype=jnp.int32)) < n_work)
            & (ids >= 1) & (ids < volume.free_count)
        )
        s = _chunk_surface(volume, ids, row_valid, config,
                           config.mesh_cache_active_frac)

        elig2 = s["elig"].reshape(CB, bs ** 3)
        cube_off = jnp.cumsum(elig2, axis=1) - elig2    # excl per block
        placed = jnp.sum(elig2, axis=1)                 # (CB,)
        full = jnp.sum(s["flat_counts"].reshape(CB, bs ** 3), axis=1)
        kept = jnp.minimum(placed, ts)

        # Quantize: t -> 16 bits, color -> rgb888.
        t16 = jnp.clip(
            jnp.round(s["t12"] * 65535.0), 0, 65535
        ).astype(jnp.int32)                              # (ACT, 12)
        c888 = (
            (jnp.clip(jnp.round(s["c12"][0] * 255.0), 0, 255)
             .astype(jnp.int32) << 16)
            | (jnp.clip(jnp.round(s["c12"][1] * 255.0), 0, 255)
               .astype(jnp.int32) << 8)
            | jnp.clip(jnp.round(s["c12"][2] * 255.0), 0, 255)
            .astype(jnp.int32)
        )                                                # (ACT, 12)

        tri_all = tri_table[s["cfg_c"]]                  # (ACT, 15)
        t_sel = _select_edges(tri_all, t16)              # (ACT, 15)
        c_sel = _select_edges(tri_all, c888)
        word = (
            (s["lidx_c"][:, None] << 20)
            | (jnp.maximum(tri_all, 0) << 16)
            | t_sel
        )                                                # (ACT, 15)

        rows = jnp.where(
            row_valid[s["block_of"]], ids[s["block_of"]], nb
        )                                                # (ACT,)
        off_c = s["g"](cube_off.reshape(-1))             # (ACT,)

        def put(dst, src_col):
            """Scatter one vertex column (ACT, 5) into (NB, ts) slots."""
            k = jnp.arange(T.MAX_TRIS, dtype=jnp.int32)
            slot = off_c[:, None] + k[None]              # (ACT, 5)
            ok = (
                s["live"][:, None]
                & (k[None] < s["counts_c"][:, None])
                & (slot < ts)
            )
            tgt = jnp.where(ok, rows[:, None] * ts + slot, nb * ts)
            return dst.reshape(-1).at[tgt.reshape(-1)].set(
                src_col.reshape(-1), mode="drop"
            ).reshape(nb, ts)

        va = put(va, word[:, 0::3])
        vb = put(vb, word[:, 1::3])
        vc = put(vc, word[:, 2::3])
        ca = put(ca, c_sel[:, 0::3])
        cb = put(cb, c_sel[:, 1::3])
        cc = put(cc, c_sel[:, 2::3])
        tgt_rows = jnp.where(row_valid, ids, nb)
        counts = counts.at[tgt_rows].set(kept, mode="drop")
        dropped = dropped.at[tgt_rows].set(full - kept, mode="drop")
        return i + 1, va, vb, vc, ca, cb, cc, counts, dropped

    carry = (
        jnp.asarray(0, jnp.int32), cache.va, cache.vb, cache.vc,
        cache.ca, cache.cb, cache.cc, cache.counts, cache.dropped,
    )
    _, va, vb, vc, ca, cb, cc, counts, dropped = jax.lax.while_loop(
        lambda c: c[0] < n_wch, work_body, carry
    )

    volume = dataclasses.replace(
        volume, mesh_dirty=jnp.zeros_like(volume.mesh_dirty)
    )
    cache = MeshCache(
        va=va, vb=vb, vc=vc, ca=ca, cb=cb, cc=cc,
        counts=counts, dropped=dropped,
    )
    return volume, cache


def cache_to_mesh(
    volume: B.VolumeState, cache: MeshCache, config: Config
) -> Mesh:
    """Decode the per-block triangle cache into a compact triangle soup.

    The compaction map (slot -> output lane) is built in ROW CHUNKS
    whose loop trip count follows ``free_count``: a fixed full-capacity
    pass swept all num_blocks * mesh_slots = 16.7M slots regardless of
    allocation (~half the measured 508 ms decode at 25k allocated
    blocks).  Output triangle order matches ``extract_mesh`` (ascending
    block row, cube order within the block).
    """
    nb, ts = cache.counts.shape[0], cache.va.shape[1]
    bs = config.block_size
    vs = config.voxel_size
    cap = config.max_mesh_triangles

    offsets = jnp.cumsum(cache.counts) - cache.counts       # (NB,) excl
    total = jnp.sum(cache.counts)

    RC_ = min(8192, nb)
    n_rch = (jnp.minimum(volume.free_count, nb) + RC_ - 1) // RC_
    sl = jnp.arange(RC_ * ts, dtype=jnp.int32) % ts
    rrel = jnp.arange(RC_ * ts, dtype=jnp.int32) // ts

    def gmap_body(carry):
        i, gmap = carry
        base = i * RC_
        rows = base + rrel                                  # (RC_*ts,)
        cnt = jax.lax.dynamic_slice_in_dim(cache.counts, base, RC_)[rrel]
        off = jax.lax.dynamic_slice_in_dim(offsets, base, RC_)[rrel]
        valid = sl < cnt
        dst = jnp.where(valid, off + sl, cap)
        return i + 1, gmap.at[dst].set(rows * ts + sl, mode="drop")

    _, gmap = jax.lax.while_loop(
        lambda c: c[0] < n_rch,
        gmap_body,
        (jnp.asarray(0, jnp.int32), jnp.zeros((cap,), jnp.int32)),
    )

    lane = jnp.arange(cap, dtype=jnp.int32)
    lane_ok = lane < jnp.minimum(total, cap)
    rb = gmap // ts                                         # (cap,)

    # The whole decode runs CHANNEL-PLANAR ((cap,) per component), as
    # the splat renderer's planar vertex channels do: no (cap, 3)
    # minor-dim-3 intermediate at cap=2M.
    offs = [
        jnp.asarray(T.CORNER_OFFSETS[:, k], jnp.float32) for k in range(3)
    ]
    ends = jnp.asarray(T.EDGE_ENDPOINTS)
    off_a = [offs[k][ends[:, 0]] for k in range(3)]         # 3 x (12,)
    off_b = [offs[k][ends[:, 1]] for k in range(3)]

    def decode(vword, cword):
        """-> (3 x (cap,) position comps, 3 x (cap,) color comps)."""
        lidx = (vword >> 20) & 0x1FF
        edge = (vword >> 16) & 0xF
        t = (vword & 0xFFFF).astype(jnp.float32) * (1.0 / 65535.0)
        local = (lidx // (bs * bs), (lidx // bs) % bs, lidx % bs)
        pos = []
        for k in range(3):
            base = (
                volume.block_coords[rb, k] * bs + local[k]
            ).astype(jnp.float32)
            a = off_a[k][edge]
            p = (base + a + t * (off_b[k][edge] - a)) * vs
            pos.append(jnp.where(lane_ok, p, 0.0))
        col = [
            jnp.where(
                lane_ok,
                ((cword >> s) & 0xFF).astype(jnp.float32) * (1.0 / 255.0),
                0.0,
            )
            for s in (16, 8, 0)
        ]
        return pos, col

    pos = []
    col = []
    for v, c in ((cache.va, cache.ca), (cache.vb, cache.cb),
                 (cache.vc, cache.cc)):
        p3, c3 = decode(v.reshape(-1)[gmap], c.reshape(-1)[gmap])
        pos.append(p3)
        col.append(c3)

    def pack(rows):
        """3 vertices x 3 comps of (cap,) -> (cap, 3, 3), one relayout."""
        flat = jnp.stack([comp for vtx in rows for comp in vtx], axis=0)
        return jnp.transpose(flat.reshape(3, 3, cap), (2, 0, 1))

    dropped = jnp.sum(cache.dropped)
    return Mesh(
        positions=pack(pos),
        colors=jnp.clip(pack(col), 0.0, 1.0),
        count=jnp.minimum(total, cap).astype(jnp.int32),
        overflow=(jnp.maximum(total - cap, 0) + dropped).astype(jnp.int32),
        compact_dropped=dropped.astype(jnp.int32),
    )
