"""Spatial hashing for voxel blocks.

JAX rebuild of SURVEY.md components #11-#12 (reference: ``hash.h`` /
``volume.cu`` [M], InfiniTAM bucket+excess-list hash with CUDA atomics
[P:1410.0925]).  Design differences, deliberate:

  * **Packed-key open addressing**: block coords pack into one int32 code
    (``blocks.pack_block_coords``), so the table is two flat int32 arrays
    and a probe costs ONE gather (the CUDA reference chases bucket+excess
    pointers; a naive SoA key table would gather 3 coords per probe).
  * **Triangular probing** (slot0 + p(p+1)/2): visits every slot of a
    power-of-two table, no primary clustering (bounded linear probing
    overflowed at ~0.25 load).
  * **Deterministic parallel insertion** instead of CUDA atomics: each
    probe round resolves slot contention with a scatter-min (lowest
    candidate index wins), claims winners, and re-checks -- a fixed number
    of vectorized rounds.  Same-coordinate duplicates must be removed by
    the caller first (see ``ops/allocate.py``).

Table layout (static shapes):
  * ``codes``  (hash_size,) int32 -- packed block coord; EMPTY_CODE = empty.
  * ``values`` (hash_size,) int32 -- block storage index.

The hash function is the InfiniTAM spatial hash
``(x * 73856093 ^ y * 19349669 ^ z * 83492791) mod hash_size``
[P:1410.0925], with hash_size a power of two so the mod is a mask.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import Config

EMPTY_CODE = jnp.int32(0x7FFFFFFF)  # == blocks.INVALID_CODE

_P1 = jnp.uint32(73856093)
_P2 = jnp.uint32(19349669)
_P3 = jnp.uint32(83492791)


def hash_coords(coords: jax.Array, hash_size: int) -> jax.Array:
    """Block coords (..., 3) int32 -> slot (...,) int32 in [0, hash_size)."""
    c = coords.astype(jnp.uint32)
    h = (c[..., 0] * _P1) ^ (c[..., 1] * _P2) ^ (c[..., 2] * _P3)
    return (h & jnp.uint32(hash_size - 1)).astype(jnp.int32)


def probe_slot(slot0: jax.Array, p: int, hash_size: int) -> jax.Array:
    """p-th probe position: triangular probing, full-cycle on 2^k tables."""
    return (slot0 + (p * (p + 1)) // 2) & (hash_size - 1)


def lookup_codes(
    table_codes: jax.Array,
    values: jax.Array,
    qcodes: jax.Array,
    slot0: jax.Array,
    config: Config,
):
    """Batched lookup by packed code.

    Returns (block_idx, found); block_idx is -1 where absent.  One int32
    gather per probe round, plus a single final values gather -- this is
    the hot path inside raycast.
    """
    hs = config.hash_size
    live = jnp.ones(qcodes.shape, bool)
    hit_slot = jnp.zeros(qcodes.shape, jnp.int32)
    found = jnp.zeros(qcodes.shape, bool)
    for p in range(config.max_probes):
        slot = probe_slot(slot0, p, hs)
        c = table_codes[slot]
        match = c == qcodes
        hit = live & match
        hit_slot = jnp.where(hit, slot, hit_slot)
        found = found | hit
        # An empty slot terminates the probe chain (no deletions ever).
        live = live & ~match & (c != EMPTY_CODE)
    idx = jnp.where(found, values[hit_slot], -1)
    return idx, found


def lookup(
    table_codes: jax.Array,
    values: jax.Array,
    coords: jax.Array,
    config: Config,
):
    """Lookup by coords (packs + bounds-checks, then ``lookup_codes``)."""
    from . import blocks as B

    inb = B.coords_in_bounds(coords)
    qcodes = jnp.where(
        inb, B.pack_block_coords(coords), EMPTY_CODE
    )
    slot0 = hash_coords(coords, config.hash_size)
    idx, found = lookup_codes(table_codes, values, qcodes, slot0, config)
    found = found & inb
    return jnp.where(found, idx, -1), found


def insert_unique(
    table_codes: jax.Array,
    values: jax.Array,
    free_count: jax.Array,
    coords: jax.Array,
    want: jax.Array,
    config: Config,
):
    """Insert up to N *unique* block coords; allocate block slots in order.

    Args:
      table_codes/values: the table (see module docstring).
      free_count: scalar int32, number of block slots already allocated;
        new blocks get indices free_count, free_count+1, ...
      coords: (N, 3) int32 candidate coords (duplicates NOT allowed, must
        be within blocks.COORD_BOUND).
      want: (N,) bool, which rows are real candidates.

    Returns (table_codes, values, free_count, inserted_idx, ok):
      inserted_idx (N,) int32 -- block index for each wanted coord (new or
      pre-existing), -1 where not inserted; ok (N,) bool -- False where the
      probe bound or block capacity was exhausted (surfaced as an overflow
      counter by the caller, never silent).

    Deterministic contention rule: within one probe round, the lowest
    candidate row index targeting a slot wins it (scatter-min over slots).
    """
    from . import blocks as B

    n = coords.shape[0]
    hs = config.hash_size
    cap = config.num_blocks

    qcodes = jnp.where(want, B.pack_block_coords(coords), EMPTY_CODE)
    slot0 = hash_coords(coords, hs)

    # Resolve pre-existing entries first.
    existing_idx, exists = lookup_codes(
        table_codes, values, qcodes, slot0, config
    )
    exists = exists & want
    pending = want & ~exists
    assigned = jnp.where(exists, existing_idx, -1)

    row_ids = jnp.arange(n, dtype=jnp.int32)

    # Capacity gate BEFORE probing: rows whose pending-order exceeds the free
    # block slots never claim a hash slot, so no rollback is ever needed (a
    # rollback would punch an EMPTY hole into other keys' probe chains).
    remaining = cap - free_count
    order_pending = jnp.cumsum(pending.astype(jnp.int32)) - 1
    in_capacity = order_pending < remaining
    pending = pending & in_capacity

    # Phase 1: claim hash slots (codes only).  max_probes is small and
    # static, so a Python loop of vectorized scatter rounds keeps XLA happy.
    claimed_slot = jnp.full((n,), -1, jnp.int32)
    for p in range(config.max_probes):
        slot = probe_slot(slot0, p, hs)
        slot_empty = table_codes[slot] == EMPTY_CODE
        # Occupied-by-our-own-coord can't happen: caller deduped + we
        # resolved pre-existing keys above.
        claimable = pending & slot_empty
        # Contention: the lowest candidate row targeting a slot wins it.
        winner = jnp.full((hs,), n, jnp.int32)
        winner = winner.at[jnp.where(claimable, slot, hs)].min(
            row_ids, mode="drop"
        )
        is_winner = claimable & (winner[slot] == row_ids)
        table_codes = table_codes.at[jnp.where(is_winner, slot, hs)].set(
            qcodes, mode="drop"
        )
        claimed_slot = jnp.where(is_winner, slot, claimed_slot)
        pending = pending & ~is_winner

    # Phase 2: dense, gap-free block-index assignment over actual winners.
    success = claimed_slot >= 0
    order = jnp.cumsum(success.astype(jnp.int32)) - 1
    new_block_idx = jnp.where(success, free_count + order, -1)
    values = values.at[jnp.where(success, claimed_slot, hs)].set(
        new_block_idx, mode="drop"
    )
    assigned = jnp.where(success, new_block_idx, assigned)

    ok = ~want | exists | success
    return table_codes, values, free_count + jnp.sum(success), assigned, ok
