"""8-bit TSDF / weight quantization codec — PyTorch port of
``chad_tsdf_tpu/ops/codec.py``.

Bit-for-bit the reference LeafCluster codec (reference:
include/chad/cluster.hpp:13-69): the signed distance is normalized by the
truncation distance into [-1, 1], scaled by 127, offset by +127 and
truncated to [0, 254]; ``0xff`` is the "empty leaf" sentinel; the weight is
clamped to [0, 254] (254, not 255, so it never collides with the sentinel).

The JAX module is generic over an ``xp`` namespace with numpy's API; torch
has another API, so the device side here takes tensors and the host side
(cluster words, decoding for meshing) keeps numpy.
"""

from __future__ import annotations

import numpy as np
import torch

SD_RANGE_ABS = 127          # std::numeric_limits<uint8_t>::max() / 2
EMPTY = 255                 # 0xff sentinel


def encode_sd(signed_distance: torch.Tensor, sdf_trunc: float) -> torch.Tensor:
    """f32 signed distance -> uint8 code in [0, 254] (cluster.hpp:20-27).
    The value is non-negative before the cast, so truncation equals floor."""
    sd = torch.clamp(signed_distance * (1.0 / sdf_trunc), -1.0, 1.0)
    q = torch.floor(sd * float(SD_RANGE_ABS) + float(SD_RANGE_ABS))
    return q.to(torch.uint8)


def decode_sd(q: torch.Tensor, sdf_trunc: float) -> torch.Tensor:
    """uint8 code -> f32 signed distance (cluster.hpp:41-50).  EMPTY is not
    special-cased: mask with ``q != EMPTY`` at the call site."""
    sd = q.to(torch.float32) - float(SD_RANGE_ABS)
    return sd * (1.0 / float(SD_RANGE_ABS)) * sdf_trunc


def encode_weight(weight: torch.Tensor) -> torch.Tensor:
    """Accumulated weight -> uint8, clamped to [0, 254]."""
    return torch.clamp(weight, 0, 254).to(torch.uint8)


def np_decode_sd(q: np.ndarray, sdf_trunc: float) -> np.ndarray:
    """Host form of :func:`decode_sd` for numpy uint8 codes."""
    sd = q.astype(np.float32) - np.float32(SD_RANGE_ABS)
    return sd * np.float32(1.0 / float(SD_RANGE_ABS)) * np.float32(sdf_trunc)


def pack_cluster_u64(bytes8: np.ndarray) -> np.ndarray:
    """(..., 8) uint8 leaf values -> (...,) uint64 cluster words (host).
    Leaf ``i`` occupies bits [8i, 8i+8) (cluster.hpp:28,33)."""
    v = bytes8.astype(np.uint64)
    out = np.zeros(bytes8.shape[:-1], dtype=np.uint64)
    for i in range(8):
        out |= v[..., i] << np.uint64(8 * i)
    return out


def unpack_cluster_u64(words: np.ndarray) -> np.ndarray:
    """(...,) uint64 cluster words -> (..., 8) uint8 leaf values (host)."""
    out = np.empty(words.shape + (8,), dtype=np.uint8)
    for i in range(8):
        out[..., i] = ((words >> np.uint64(8 * i)) &
                       np.uint64(0xFF)).astype(np.uint8)
    return out
