"""Active map state — PyTorch port of ``chad_tsdf_tpu/core/state.py``.

The reference's active map is a pointer-linked octree with a hashmap
accelerator (reference: include/chad/detail/octree.hpp:12-188).  As in the
JAX package, the port keeps a dense block pool instead:

* ``pool_sd`` / ``pool_w``: f32[block_capacity, 512] accumulated signed
  distance sum and weight (sample count) per voxel of each 8x8x8 block;
* ``dir_keys`` / ``dir_slots``: a sorted directory from local block Morton
  key (int32) to pool row, INT32_MAX-padded; rows never move;
* ``origin_blocks``: world block coordinate of local block (0,0,0).

Overflow of any static capacity increments a counter, never silently.  All
fields live on one device; the insert functions update the pool in place.
:func:`state_from_numpy` / :func:`state_to_numpy` carry a state across
packages as numpy arrays named like the JAX state's fields, so a map
built by the JAX package can be loaded here and keep integrating.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from chad_tsdf_tpu.config import MapConfig

INT32_MAX = 2**31 - 1


@dataclasses.dataclass
class ActiveMapState:
    dir_keys: torch.Tensor         # i32[Cb] sorted local block keys
    dir_slots: torch.Tensor        # i32[Cb] pool row per directory entry
    n_blocks: torch.Tensor         # i32[] allocated blocks
    pool_sd: torch.Tensor          # f32[Cb, 512] signed-distance sums
    pool_w: torch.Tensor           # f32[Cb, 512] weights (sample counts)
    origin_blocks: torch.Tensor    # i32[3] world block of local (0,0,0)
    point_overflow: torch.Tensor   # i32[] points outside the local extent
    sample_overflow: torch.Tensor  # i32[] ray samples outside the extent
    block_overflow: torch.Tensor   # i32[] blocks dropped (pool full)
    touched_overflow: torch.Tensor  # i32[] touched blocks beyond capacity
    tile_overflow: torch.Tensor    # i32[] samples beyond a tile's list

    @property
    def device(self) -> torch.device:
        return self.pool_sd.device


_FIELDS = tuple(f.name for f in dataclasses.fields(ActiveMapState))


def create_state(config: MapConfig, origin_blocks=None,
                 device="cpu") -> ActiveMapState:
    cb = config.block_capacity
    if origin_blocks is None:
        origin_blocks = np.zeros((3,), np.int32)

    def zero():
        return torch.zeros((), dtype=torch.int32, device=device)

    return ActiveMapState(
        dir_keys=torch.full((cb,), INT32_MAX, dtype=torch.int32,
                            device=device),
        dir_slots=torch.zeros((cb,), dtype=torch.int32, device=device),
        n_blocks=zero(),
        pool_sd=torch.zeros((cb, 512), dtype=torch.float32, device=device),
        pool_w=torch.zeros((cb, 512), dtype=torch.float32, device=device),
        origin_blocks=torch.as_tensor(
            np.asarray(origin_blocks, np.int32)).to(device),
        point_overflow=zero(),
        sample_overflow=zero(),
        block_overflow=zero(),
        touched_overflow=zero(),
        tile_overflow=zero(),
    )


def state_to_numpy(state: ActiveMapState) -> dict:
    """Every field as a numpy array, keyed by the JAX state's field names."""
    return {name: getattr(state, name).cpu().numpy() for name in _FIELDS}


def state_from_numpy(d, device="cpu") -> ActiveMapState:
    """Inverse of :func:`state_to_numpy`.  ``d`` maps field names to array
    likes — e.g. ``{f: np.asarray(getattr(jax_state, f)) ...}`` — so a
    state built by the JAX package keeps integrating here."""
    missing = [name for name in _FIELDS if name not in d]
    if missing:
        raise KeyError(f"state fields missing: {missing}")
    out = {}
    for name in _FIELDS:
        a = np.asarray(d[name])
        want = np.float32 if name.startswith("pool_") else np.int32
        if a.dtype != want:
            raise TypeError(f"{name}: dtype {a.dtype}, expected "
                            f"{np.dtype(want)}")
        # a copy: the port updates the pool in place
        out[name] = torch.from_numpy(np.array(a)).to(device)
    return ActiveMapState(**out)


def warn_on_overflow(state: ActiveMapState) -> dict:
    """Surface non-zero lossy overflow counters as a RuntimeWarning (a host
    read of four counters; called at finalize, a sync point anyway)."""
    counts = {
        "point_overflow": int(state.point_overflow),
        "sample_overflow": int(state.sample_overflow),
        "block_overflow": int(state.block_overflow),
        "touched_overflow": int(state.touched_overflow),
    }
    hit = {k: v for k, v in counts.items() if v > 0}
    if hit:
        warnings.warn(
            f"map capacity overflow — dropped data: {hit}; raise the "
            "corresponding MapConfig capacities (block_capacity/"
            "touched_capacity/max_points) or shrink the scan extent",
            RuntimeWarning, stacklevel=3)
    return counts


def origin_blocks_for_position(position, config: MapConfig) -> np.ndarray:
    """World block coordinate of the local frame corner for a submap
    starting at ``position``, so the scanner sits at the extent's centre."""
    half = config.blocks_per_axis // 2
    block_size = 8.0 * config.sdf_res
    centre_block = np.floor(np.asarray(position, np.float64) / block_size)
    return (centre_block - half).astype(np.int32)
