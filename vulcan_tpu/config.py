"""Pipeline configuration.

The reference scatters its constants across setter methods
(``Volume::SetTruncationLength``, tracker iteration counts, ... SURVEY.md §6
"Config / flag system").  Here everything is one frozen, hashable dataclass of
plain Python numbers so it can be a *static* argument to jitted functions:
changing the config recompiles, using it never retraces.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Config:
    # --- volume geometry ---
    voxel_size: float = 0.008          # meters per voxel
    trunc_dist: float = 0.04           # TSDF truncation band mu (meters)
    max_weight: float = 128.0          # running-average weight clamp W_max

    # --- voxel-block hashing (InfiniTAM-style, SURVEY.md components #10-13) ---
    block_size: int = 8                # voxels per block edge (8^3 blocks)
    num_blocks: int = 65536            # capacity of voxel-block storage
    hash_size: int = 262144            # open-addressed table slots (power of 2)
    max_probes: int = 8                # linear-probe bound for lookup/insert
    max_visible: int = 16384           # capacity of the visible-block list
    alloc_samples: int = 4             # ray samples in [d-mu, d+mu] per pixel
                                       # (spacing 2mu/3 = 2.7cm << 6.4cm block
                                       #  edge; InfiniTAM strides a full block.
                                       #  Halves the allocation sort size.)
    alloc_subsample: int = 4           # allocate from every Nth pixel (x and y)
                                       # (a block projects >= block_extent *
                                       #  fx / depth_max ~ 6.7 px, so a 4 px
                                       #  grid cannot miss one; 4x smaller
                                       #  allocation sort)
    alloc_capacity: int = 8192         # max new+touched unique blocks per frame
    range_scale: int = 16              # coarse min/max range image downscale
    range_stamp: int = 6               # per-block stamp size in coarse cells
    render_grid_size: int = 128        # dense block-coord grid for raycast
                                       # (covers render_grid_size*block_extent
                                       #  meters of visible scene per axis)

    # --- integration ---
    integrate_gather: str = "auto"     # depth-image sampling: "onehot"
                                       # (per-block mip patches + one-hot
                                       # matmul gather), "flat" (per-
                                       # element gathers), or "auto" (=
                                       # flat on every backend, the GPU
                                       # measurement in PERF.md;
                                       # sparse.resolve_integrate_gather)
    integrate_chunk: int = 1024        # visible blocks fused per loop round
    depth_raw_scale: float = 5000.0    # uint16 depth units per meter (TUM)
    depth_min: float = 0.1             # valid depth range (meters)
    depth_max: float = 5.0

    # --- raycast ---
    ray_near: float = 0.1
    ray_far: float = 5.0
    raycast_steps: int = 192           # total sample budget along each ray
    raycast_chunk: int = 64            # coarse-march samples per round
    raycast_fine_chunk: int = 8        # fine-march samples per round
    raycast_coarse: int = 4            # coarse march at 1/N resolution
    raycast_step_scale: float = 0.75   # sample spacing in units of mu
    raycast_coarse_compact: int = 2    # survivor-compaction divisor for the
                                       # coarse march (0 = off): the
                                       # compaction's lax.cond copies
                                       # branch tuples but halves the
                                       # coarse sample work (not yet
                                       # measured on the GPU)
    raycast_fine_compact: int = 4      # same for the full-res fine march
                                       # (307200 rays)
    refine_steps: int = 1              # trilinear secant polish rounds
    render_mode: str = "splat"         # "splat" (surfel scatter renderer,
                                       #   equal tracking ATE) or "march"
                                       #   (hierarchical raycast)
    splat_fill_rounds: int = 2         # hole-fill dilation rounds
    splat_band: float = 0.3            # |tsdf| gate (mu units) for voxel
                                       # surfels: wide enough for a
                                       # continuous shell (>=1.5 voxels),
                                       # tight enough that z + tsdf*mu
                                       # stays in the linear TSDF region
    splat_source: str = "surfels"      # depth-path z-buffer source:
                                       # "surfels" (persistent compacted
                                       # surfel lists, ~4x fewer scatter
                                       # lanes) or "direct" (all 512
                                       # voxels of each surface block,
                                       # masked -- the pre-r3 path)
    surfel_slots: int = 192            # persistent surfel-list slots per
                                       # block: covers an axis-aligned
                                       # plane's worst case (8x8x3-voxel
                                       # shell); oblique planes can emit
                                       # more -- overflow is counted, and
                                       # dropped surfels only cost
                                       # hole-fill work downstream
    splat_backface_cull: bool = True   # cull surfels whose quantized
                                       # TSDF-gradient orientation faces
                                       # away from the viewing ray.
                                       # Required for NOVEL-view renders
                                       # (holes in the front shell let
                                       # back-shell surfels win the
                                       # z-buffer: 35% of pixels wrong on
                                       # the novel-view sphere test);
                                       # measurable ATE cost on tracking
                                       # (views near the fused
                                       # trajectory see no leakage, and
                                       # culling thins silhouettes)
    model_color: str = "luma"          # online-pipeline model-render color:
                                       # "luma" (grey intensity via the
                                       # single-pass packed z+luma surfel
                                       # scatter -- the photometric tracker
                                       # reduces color to intensity anyway;
                                       # half the color-splat scatter lanes,
                                       # no z-buffer re-gather) or "rgb"
                                       # (two-pass rgb888 winner scatter;
                                       # use when inspecting state.model
                                       # .color as a real color image).
                                       # Explicit Tracer.trace calls always
                                       # render rgb.
    splat_polish: int = 0              # trilinear snap rounds (0 = off:
                                       #   one linear secant over a +-2
                                       #   voxel bracket MOVES depth wrong
                                       #   where tsdf is nonlinear; >=2 is
                                       #   safe but costs a gather round)

    # --- bilateral filter ---
    bilateral_enabled: bool = True     # disable to measure the filter's value
    bilateral_radius: int = 2
    bilateral_sigma_space: float = 2.0
    bilateral_sigma_depth: float = 0.05

    # --- ICP tracking (coarse-to-fine; level 0 = full res) ---
    pyramid_levels: int = 3            # (a 4th 60x80 level was tried for
                                       # large-motion robustness and
                                       # REVERTED: at tiny test scales its
                                       # ~300-px systems yield confident
                                       # wrong coarse inits)
    icp_iters: tuple[int, ...] = (3, 5, 16)     # per level, fine -> coarse
    icp_assoc: tuple[int, ...] = (2, 2, 8)      # association (gather) rounds:
                                       # the coarse level re-associates 8x --
                                       # its gathers are 1/16 of full res, and
                                       # extra rounds there buy large-motion
                                       # basin width for ~free
                                       # per level; GN re-linearizes densely
                                       # between gathers (warp-once: the
                                       # random-access association gathers
                                       # dominate ICP cost)
    icp_stride: tuple[int, ...] = (2, 1, 1)
                                       # live-pixel stride per level (fine ->
                                       # coarse): 4x fewer association
                                       # gathers where >1; the model side
                                       # stays full-res.  Striding level 1
                                       # was tried and REVERTED: it hard-
                                       # diverges the 12 deg/frame large-
                                       # motion canary (five-class test)
    assoc_patch: str = "auto"          # ICP association gathers on the
                                       # non-coarsest levels: "on" (one-
                                       # hot matmul patch gather), "off"
                                       # (flat), "auto" (= off on every
                                       # backend, the GPU measurement in
                                       # PERF.md), "geom" (patch the
                                       # geometric maps but keep the
                                       # photometric samples on the
                                       # flat bilinear path).  See
                                       # ops/icp.py _PatchAssoc.
    coarse_patch_after: int = 2        # at the COARSEST level, flat
                                       # association rounds before
                                       # switching to frozen-window
                                       # patch gathers: the first
                                       # rounds absorb global motion
                                       # (windows would clip it), the
                                       # rest re-associate a nearly
                                       # converged warp.  Large value =
                                       # always flat.  Only read when
                                       # assoc_patch enables patches.
    motion_prediction: float = 0.5     # damped constant-velocity tracker
                                       # init: extrapolate this fraction
                                       # of the last inter-frame motion
                                       # (0 = previous-pose init).  MUST
                                       # stay <= 0.5: the prediction
                                       # feeds back through the tracked
                                       # pose, and full extrapolation
                                       # (1.0) is unstable whenever ICP
                                       # corrects weakly -- see
                                       # pipeline/fusion.predict_pose
                                       # for the stability analysis (it
                                       # collapsed the 640x480 bench at
                                       # frame ~13, round 3)
    icp_dist_thresh: float = 0.1       # association gates (meters / cos angle)
    icp_normal_thresh: float = 0.8
    icp_damping: float = 1e-4          # relative Levenberg damping on the 6x6
    icp_huber_delta: float = 0.03      # Huber width for point-to-plane (m)
    icp_min_inliers: int = 100         # fewer associated pixels => track invalid
    icp_max_error: float = 0.05        # robust rms (m) above which the track
                                       # is distrusted and fusion is skipped
    degen_min_eig: float = 0.01        # degeneracy detector threshold: if the
                                       # smallest eigenvalue of any level's
                                       # diagonally normalized 6x6 system
                                       # falls below this, the pose has an
                                       # unobservable direction (dominant-
                                       # plane scenes: point-to-plane ICP
                                       # slides along the plane while error/
                                       # inlier health stays perfect --
                                       # the desk-scene analysis).  The
                                       # frame still TRACKS (the observable
                                       # DoF remain better than holding) but
                                       # is NOT fused (slid geometry must not
                                       # compound into the map) and
                                       # track_degen_frames counts it.
                                       # Calibration (tests/test_icp.py,
                                       # /tmp ideal-model study): sphere
                                       # scene 0.39, desk views 0.6-0.75,
                                       # combined-mode floor 0.076 -- vs
                                       # bare-floor depth-mode 0.0018.
                                       # 0 disables.
    rgb_weight: float = 0.1            # photometric term weight ("combined")
    rgb_huber_delta: float = 0.1       # Huber width for intensity residuals
    auto_photo: bool = True            # depth mode COLLAPSE RESCUE: when
                                       # the geometric conditioning
                                       # (TrackResult.geo_degen) falls into
                                       # the rank-collapse band, arm
                                       # photometric tracking for the next
                                       # auto_photo_hold frames (lax.cond:
                                       # the combined-mode machinery costs
                                       # nothing while disarmed).  A
                                       # collapsed view (bare floor/wall:
                                       # geo ~1e-5..2e-3) arms next frame;
                                       # if the scene has texture the
                                       # photometric rows restore
                                       # observability and fusion RESUMES
                                       # instead of holding forever.
                                       # NOT a weak-band detector: the
                                       # round-5 640x480 replays measured
                                       # the desk slide happening at
                                       # HEALTHY scores 0.38-0.73 (the
                                       # 0.1-0.2 readings appear only
                                       # after the basin exit), and the
                                       # orbit's floor-heavy views dip to
                                       # 0.07-0.2 while tracking at 6 mm --
                                       # no frame-local spectrum threshold
                                       # separates them (round-5 replay
                                       # timelines).  The desk-
                                       # class fix is mode="combined", the
                                       # CLI default.  Requires
                                       # degen_min_eig > 0.  Only affects
                                       # mode="depth".
    auto_photo_enter: float = 0.02     # arm when geo_degen < this: 2x the
                                       # hold threshold, 10x above any
                                       # measured healthy-scene minimum
                                       # (orbit 0.07), 10-100x below
                                       # measured collapse (2e-3..1e-5)
    auto_photo_hold: int = 60          # armed frames per weak reading
                                       # (re-armed while weakness persists;
                                       # the ~2 s tail covers the basin
                                       # re-entry after the view recovers)
    photo_levels: int = 2              # combined/light: photometric rows on
                                       # this many COARSEST pyramid levels
                                       # (pyramid_levels = all).  Default 2
                                       # = skip the finest level: measured
                                       # on the 240-frame desk orbit this is
                                       # more accurate (ATE 0.0244 ->
                                       # 0.0216 -- the full-res splat color
                                       # that feeds the finest photometric
                                       # rows is the noisiest) and cheaper.
                                       # The finest level's
                                       # photometric machinery is the most
                                       # expensive piece of combined mode
                                       # (full-res model-side 3x3 intensity/
                                       # gradient maps + 56 extra patch-dot
                                       # byte columns) -- see ops/icp.py
                                       # track() for the knob's
                                       # mechanics.  Ignored
                                       # by mode="color" (no geometric term
                                       # to fall back on).

    # --- profiling ---
    ablate: str = ""                   # comma-separated stages to skip in
                                       # fusion.step for perf bisection:
                                       # track,alloc,vis,integrate,render
                                       # (static: zero cost when empty)

    # --- mesh extraction ---
    max_mesh_triangles: int = 2_000_000
    mesh_chunk: int = 1024             # blocks meshed per loop round (bounds
                                       # halo temporaries to ~15 MB; the loop
                                       # trip count follows free_count)
    mesh_active_frac: float = 0.25     # active-cube compaction capacity as a
                                       # fraction of the chunk's cubes (full
                                       # extractor); 0.25 covers a two-layer
                                       # axis-aligned plane through every
                                       # block -- raise it for dense/noisy
                                       # volumes (beyond-capacity actives are
                                       # counted in Mesh.compact_dropped,
                                       # never silently lost)
    mesh_cache_active_frac: float = 0.3  # same, for incremental cache
                                       # updates: dirty blocks are band
                                       # blocks (surface-dense by
                                       # construction), so the compaction
                                       # budget doubles
    mesh_dirty_eps: float = 8e-3       # integration marks a block mesh-
                                       # dirty only when its TSDF moved by
                                       # more than this (tsdf units; at the
                                       # production trunc/voxel ratio a
                                       # just-below-eps delta moves an
                                       # interpolated vertex ~5% of a voxel
                                       # = 0.4 mm) or
                                       # its stored rgb888 bytes changed.
                                       # Cuts the per-cadence re-mesh set
                                       # from the whole visible band to the
                                       # truly-changed blocks.  Caveat: a
                                       # pathological stream of sub-eps
                                       # deltas could accumulate unmeshed
                                       # drift up to ~eps per observation
                                       # burst -- bounded far below voxel
                                       # noise at the default.  0 restores
                                       # blanket marking of every
                                       # integrated block.
    mesh_slots: int = 256              # per-block triangle-cache slots
                                       # (incremental extraction; a worst-
                                       # case oblique plane cuts ~220
                                       # triangles per block; overflow is
                                       # counted per block in
                                       # MeshCache.dropped)

    def __post_init__(self):
        assert self.block_size == 8, "voxel blocks are 8^3 (InfiniTAM layout)"
        assert self.hash_size & (self.hash_size - 1) == 0, "hash_size must be a power of 2"
        assert len(self.icp_iters) == self.pyramid_levels
        assert len(self.icp_assoc) == self.pyramid_levels
        if not isinstance(self.icp_stride, int):
            assert len(self.icp_stride) == self.pyramid_levels
        # The chunked visible-block loops (sparse.integrate_sparse,
        # render_cache.build, splat.render_splat) slice at start=i*chunk
        # with chunk=min(pow2, max_visible); if the chunk did not divide
        # max_visible, the last dynamic_slice start would clamp and pair
        # shifted ids/halo rows with unshifted row_valid masks -- silent
        # double integration.  Powers of two make every min() divide.
        assert self.max_visible & (self.max_visible - 1) == 0, (
            "max_visible must be a power of 2 (chunked-loop divisibility)"
        )
        assert self.integrate_chunk & (self.integrate_chunk - 1) == 0, (
            "integrate_chunk must be a power of 2 (chunked-loop divisibility)"
        )
        assert self.num_blocks & (self.num_blocks - 1) == 0, (
            "num_blocks must be a power of 2 (chunked-loop divisibility)"
        )
        assert self.alloc_capacity & (self.alloc_capacity - 1) == 0, (
            "alloc_capacity must be a power of 2 (chunked-loop divisibility)"
        )
        assert self.mesh_chunk & (self.mesh_chunk - 1) == 0, (
            "mesh_chunk must be a power of 2 (chunked-loop divisibility)"
        )
        assert self.model_color in ("luma", "rgb"), self.model_color
        assert 0.0 <= float(self.motion_prediction) <= 1.0, (
            "motion_prediction is an extrapolation fraction in [0, 1] "
            "(values above 0.5 risk tracking instability -- see "
            "pipeline/fusion.predict_pose)"
        )
        # The ICP model maps pack vertices as 21-bit fixed point spanning
        # +-16 m around the model camera (ops/icp.py _VERTEX_SCALE).
        # Camera-relative distance of any rendered vertex is bounded by
        # range * sec(FOV corner) < ~1.3 * range; enforce a safe margin so
        # a large-range config cannot silently wrap the packed vertices.
        assert max(self.ray_far, self.depth_max) <= 12.0, (
            "ray_far/depth_max above 12 m would overflow the 21-bit "
            "camera-relative vertex packing in the ICP model maps "
            "(+-16 m span); lower the range or widen _VERTEX_SCALE"
        )

    @property
    def block_volume(self) -> int:
        return self.block_size ** 3

    @property
    def block_extent(self) -> float:
        """World-space edge length of one voxel block (meters)."""
        return self.block_size * self.voxel_size


# Small configs for tests / CI on CPU.
TINY = Config(
    refine_steps=2,
    num_blocks=2048,
    hash_size=8192,
    max_visible=1024,
    raycast_steps=96,
    max_mesh_triangles=200_000,
)
