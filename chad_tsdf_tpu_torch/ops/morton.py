"""Morton (Z-order) codes — PyTorch port of ``chad_tsdf_tpu/ops/morton.py``.

Two key domains, exactly as in the JAX package:

* **Device (int32 tensors)**: submap-local block keys interleave three
  ``block_bits``-wide block coordinates into one int32; the 9-bit
  intra-block offset interleaves three 3-bit voxel coordinates.  Every hot
  sort and search stays on int32 keys.
* **Host (numpy uint64)**: the reference's global 63-bit voxel code, 21 bits
  per axis, signed coordinates biased by ``1 << 20`` (reference
  include/chad/detail/morton.hpp:24-28).  ``encode63(block*8 + offset) ==
  encode_block21(block + 2**17) << 9 | encode_offset(offset)``, so the
  device split nests inside the global code.

The device functions take int32 tensors and use only shifts, masks and ors,
so they give the same bits on the CPU and on the card.
"""

from __future__ import annotations

import numpy as np
import torch

# ---------------------------------------------------------------------------
# device-side int32 codes
# ---------------------------------------------------------------------------


def spread3_10(x):
    """Spread the low 10 bits of ``x`` to bits 0,3,6,...,27 (int32)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def compact3_10(x):
    """Inverse of :func:`spread3_10`."""
    x = x & 0x09249249
    x = (x | (x >> 2)) & 0x030C30C3
    x = (x | (x >> 4)) & 0x0300F00F
    x = (x | (x >> 8)) & 0x030000FF
    x = (x | (x >> 16)) & 0x000003FF
    return x


def encode_block(bx, by, bz):
    """Interleave three <=10-bit non-negative block coords into one int32."""
    return spread3_10(bx) | (spread3_10(by) << 1) | (spread3_10(bz) << 2)


def decode_block(key):
    """Inverse of :func:`encode_block` -> (bx, by, bz)."""
    return compact3_10(key), compact3_10(key >> 1), compact3_10(key >> 2)


def spread3_3(x):
    """Spread the low 3 bits of ``x`` to bits 0,3,6."""
    x = x & 0x7
    return (x & 1) | ((x & 2) << 2) | ((x & 4) << 4)


def compact3_3(x):
    return (x & 1) | ((x >> 2) & 2) | ((x >> 4) & 4)


def encode_offset(ox, oy, oz):
    """Interleave three 3-bit intra-block coords into a 9-bit offset code."""
    return spread3_3(ox) | (spread3_3(oy) << 1) | (spread3_3(oz) << 2)


def decode_offset(off):
    return compact3_3(off), compact3_3(off >> 1), compact3_3(off >> 2)


def points_to_local_voxels(points, origin_voxel, extent_voxels: int,
                           sdf_res: float):
    """Discretize (N, 3) f32 world points to local voxel coordinates.

    ``floor(p / res)`` as the reference (morton.hpp:71), clamped to
    ``[0, extent)``; returns ``(local i32 (N, 3), in_range bool (N,))``.
    """
    vox_world = torch.floor(points * (1.0 / sdf_res)).to(torch.int32)
    local = vox_world - origin_voxel[None, :]
    in_range = ((local >= 0) & (local < extent_voxels)).all(dim=-1)
    local = torch.clamp(local, 0, extent_voxels - 1)
    return local, in_range


# ---------------------------------------------------------------------------
# host-side uint64 codes (global 63-bit, reference morton.hpp semantics)
# ---------------------------------------------------------------------------


def np_spread3_21(x: np.ndarray) -> np.ndarray:
    """Spread low 21 bits to bits 0,3,...,60 (numpy uint64)."""
    x = x.astype(np.uint64) & np.uint64(0x1FFFFF)
    x = (x | (x << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    x = (x | (x << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    x = (x | (x << np.uint64(2))) & np.uint64(0x1249249249249249)
    return x


def np_compact3_21(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64) & np.uint64(0x1249249249249249)
    x = (x | (x >> np.uint64(2))) & np.uint64(0x10C30C30C30C30C3)
    x = (x | (x >> np.uint64(4))) & np.uint64(0x100F00F00F00F00F)
    x = (x | (x >> np.uint64(8))) & np.uint64(0x1F0000FF0000FF)
    x = (x | (x >> np.uint64(16))) & np.uint64(0x1F00000000FFFF)
    x = (x | (x >> np.uint64(32))) & np.uint64(0x1FFFFF)
    return x


def np_encode63(coords: np.ndarray) -> np.ndarray:
    """Signed int32 voxel coords (N,3) -> 63-bit Morton codes (N,) uint64
    (reference MortonCode::encode, morton.hpp:24-28)."""
    c = coords.astype(np.int64) + np.int64(1 << 20)
    x = np_spread3_21(c[..., 0].astype(np.uint64))
    y = np_spread3_21(c[..., 1].astype(np.uint64))
    z = np_spread3_21(c[..., 2].astype(np.uint64))
    return x | (y << np.uint64(1)) | (z << np.uint64(2))


def np_decode63(codes: np.ndarray) -> np.ndarray:
    """Inverse of :func:`np_encode63` -> signed int32 coords (N,3)."""
    x = np_compact3_21(codes)
    y = np_compact3_21(codes >> np.uint64(1))
    z = np_compact3_21(codes >> np.uint64(2))
    out = np.stack([x, y, z], axis=-1).astype(np.int64) - np.int64(1 << 20)
    return out.astype(np.int32)


def np_block_key_to_world63(block_keys: np.ndarray, origin_block: np.ndarray,
                            block_bits: int) -> np.ndarray:
    """Local int32 block keys -> 54-bit world *block* Morton codes (uint64).

    ``origin_block`` is the world block coordinate of local block (0,0,0).
    Shifted left by 9 and or-ed with an offset code, the result equals the
    reference's 63-bit voxel Morton code.
    """
    k = block_keys.astype(np.int64)
    bx = _np_compact3_10(k)
    by = _np_compact3_10(k >> 1)
    bz = _np_compact3_10(k >> 2)
    world = np.stack([bx, by, bz], axis=-1) + \
        origin_block[None, :].astype(np.int64)
    # bias in block space: 2**20 voxels == 2**17 blocks
    b = world + np.int64(1 << 17)
    x = np_spread3_21(b[..., 0].astype(np.uint64))
    y = np_spread3_21(b[..., 1].astype(np.uint64))
    z = np_spread3_21(b[..., 2].astype(np.uint64))
    return x | (y << np.uint64(1)) | (z << np.uint64(2))


def _np_compact3_10(x):
    x = np.asarray(x, dtype=np.int64) & 0x09249249
    x = (x | (x >> 2)) & 0x030C30C3
    x = (x | (x >> 4)) & 0x0300F00F
    x = (x | (x >> 8)) & 0x030000FF
    x = (x | (x >> 16)) & 0x000003FF
    return x
