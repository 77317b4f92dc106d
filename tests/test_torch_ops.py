"""Parity of the PyTorch port's framework-level ops with the JAX package:
Morton codes, the 8-bit codec, segment operations, the payload packing and
the DDA — bit-exact, except signed distances (f32, within 1e-6)."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from chad_tsdf_tpu.config import MapConfig as JaxMapConfig
from chad_tsdf_tpu.core import integrate as j_integrate
from chad_tsdf_tpu.ops import codec as j_codec
from chad_tsdf_tpu.ops import dda as j_dda
from chad_tsdf_tpu.ops import morton as j_morton
from chad_tsdf_tpu.ops import segops as j_segops
from chad_tsdf_tpu_torch.config import MapConfig
from chad_tsdf_tpu_torch.core import integrate as t_integrate
from chad_tsdf_tpu_torch.ops import codec as t_codec
from chad_tsdf_tpu_torch.ops import dda as t_dda
from chad_tsdf_tpu_torch.ops import morton as t_morton
from chad_tsdf_tpu_torch.ops import segops as t_segops


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(jax_out, torch_out):
    np.testing.assert_array_equal(np.asarray(jax_out), torch_out.numpy())


@pytest.mark.parametrize("fn", ["encode_block", "encode_offset"])
def test_morton_encode_matches(fn):
    rng = np.random.default_rng(0)
    hi = 1024 if fn == "encode_block" else 8
    c = rng.integers(0, hi, (3, 4096)).astype(np.int32)
    j = getattr(j_morton, fn)(*(jnp.asarray(x) for x in c))
    t = getattr(t_morton, fn)(*(_t(x) for x in c))
    _eq(j, t)
    dec = "decode_block" if fn == "encode_block" else "decode_offset"
    for a, b in zip(getattr(j_morton, dec)(j), getattr(t_morton, dec)(t)):
        _eq(a, b)


def test_points_to_local_voxels_matches():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-300.0, 300.0, (4096, 3)).astype(np.float32)
    origin = np.asarray([-4096, -4096, -4096], np.int32)
    jl, jr = j_morton.points_to_local_voxels(jnp.asarray(pts),
                                             jnp.asarray(origin), 8192, 0.05)
    tl, tr = t_morton.points_to_local_voxels(_t(pts), _t(origin), 8192, 0.05)
    _eq(jl, tl)
    _eq(jr, tr)
    assert not tr.all() and tr.any()


def test_host_morton_codes_match():
    rng = np.random.default_rng(2)
    keys = rng.integers(0, 1 << 30, 1000).astype(np.int32)
    origin = np.asarray([-512, 3, 70], np.int32)
    np.testing.assert_array_equal(
        t_morton.np_block_key_to_world63(keys, origin, 10),
        j_morton.np_block_key_to_world63(keys, origin, 10))
    coords = rng.integers(-2**19, 2**19, (1000, 3)).astype(np.int32)
    codes = t_morton.np_encode63(coords)
    np.testing.assert_array_equal(codes, j_morton.np_encode63(coords))
    np.testing.assert_array_equal(t_morton.np_decode63(codes), coords)


@pytest.mark.parametrize("trunc", [0.1, 0.3])
def test_codec_matches(trunc):
    rng = np.random.default_rng(3)
    sd = rng.uniform(-2 * trunc, 2 * trunc, 8192).astype(np.float32)
    _eq(j_codec.encode_sd(jnp, jnp.asarray(sd), trunc),
        t_codec.encode_sd(_t(sd), trunc))
    q = rng.integers(0, 255, 4096).astype(np.uint8)
    _eq(j_codec.decode_sd(jnp, jnp.asarray(q), trunc),
        t_codec.decode_sd(_t(q), trunc))
    np.testing.assert_array_equal(t_codec.np_decode_sd(q, trunc),
                                  j_codec.decode_sd(np, q, trunc))
    w = rng.uniform(0, 400, 4096).astype(np.float32)
    _eq(j_codec.encode_weight(jnp, jnp.asarray(w)), t_codec.encode_weight(_t(w)))
    words = rng.integers(0, 2**63, 512, dtype=np.uint64)
    b = t_codec.unpack_cluster_u64(words)
    np.testing.assert_array_equal(b, j_codec.unpack_cluster_u64(np, words))
    np.testing.assert_array_equal(t_codec.pack_cluster_u64(b), words)


def _segments(n, n_seg, seed):
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, n_seg, n)).astype(np.int32)
    vals = rng.normal(size=(10, n)).astype(np.float32)
    return keys, vals


@pytest.mark.parametrize("n,n_seg", [(1024, 37), (1024, 900), (1024, 1)])
def test_segops_match(n, n_seg):
    keys, vals = _segments(n, n_seg, n)
    jf = j_segops.boundary_flags(jnp.asarray(keys))
    tf = t_segops.boundary_flags(_t(keys))
    _eq(jf, tf)
    for name in ("segmented_sum_scan", "segment_broadcast_first",
                 "segment_broadcast_last"):
        for v in (vals, vals[0]):
            _eq(getattr(j_segops, name)(jf, jnp.asarray(v)),
                getattr(t_segops, name)(tf, _t(v)))
    for cap in (16, n_seg + 5, 2 * n):
        for a, b in zip(j_segops.compact_flag_positions(jf, cap),
                        t_segops.compact_flag_positions(tf, cap)):
            _eq(a, b)


def test_payload_roundtrip_matches():
    rng = np.random.default_rng(4)
    okey = rng.integers(0, 512, 8192).astype(np.int32)
    sd = rng.uniform(-0.1, 0.1, 8192).astype(np.float32)
    jp = j_integrate.pack_payload(jnp.asarray(okey), jnp.asarray(sd), 0.1)
    tp = t_integrate.pack_payload(_t(okey), _t(sd), 0.1)
    _eq(jp, tp)
    for a, b in zip(j_integrate.unpack_payload(jp, 0.1),
                    t_integrate.unpack_payload(tp, 0.1)):
        _eq(a, b)


def _cloud(n, r, seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (d * r * rng.uniform(0.5, 1.5, (n, 1))).astype(np.float32)


@pytest.mark.parametrize("res,trunc,r", [(0.05, 0.1, 5.0), (0.05, 0.1, 0.3),
                                         (0.1, 0.35, 20.0)])
def test_dda_matches(res, trunc, r):
    cfg = MapConfig(sdf_res=res, sdf_trunc=trunc)
    pts = _cloud(4096, r, 5)
    pts[:3] = 0.0                          # rays of length 0: not traversed
    pos = np.asarray([0.0, 0.0, 0.0], np.float32)
    j = j_dda.traverse(*(jnp.asarray(pts[:, i]) for i in range(3)),
                       jnp.asarray(pos), res, trunc, cfg.dda_steps)
    t = t_dda.traverse(*(_t(pts[:, i]) for i in range(3)), _t(pos), res,
                       trunc, cfg.dda_steps)
    _eq(j[3], t[3])
    valid = t[3].numpy()
    assert valid.any() and not valid[:, :3].any()
    # voxels of slots that were never traversed (NaN rays) are unspecified
    for a, b in zip(j[:3], t[:3]):
        np.testing.assert_array_equal(np.asarray(a)[valid], b.numpy()[valid])
    nrm = _cloud(4096, 1.0, 6)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    args_j = [jnp.asarray(pts[:, i]) for i in range(3)] + \
        [jnp.asarray(nrm[:, i]) for i in range(3)]
    args_t = [_t(pts[:, i]) for i in range(3)] + \
        [_t(nrm[:, i]) for i in range(3)]
    sj = j_dda.signed_distances(*j[:3], *args_j, res, trunc)
    st = t_dda.signed_distances(*t[:3], *args_t, res, trunc)
    np.testing.assert_allclose(st.numpy()[valid], np.asarray(sj)[valid],
                               rtol=0, atol=1e-6)


def test_point_keys_and_sort_match():
    cfg = MapConfig(max_points=4096)
    pts = _cloud(4096, 3.0, 7)
    origin = np.asarray([-512, -512, -512], np.int32)
    jk = j_integrate.point_keys_soa(*(jnp.asarray(pts[:, i]) for i in range(3)),
                                    jnp.int32(4000), jnp.asarray(origin),
                                    JaxMapConfig(**dataclasses.asdict(cfg)))
    tk = t_integrate.point_keys_soa(*(_t(pts[:, i]) for i in range(3)), 4000,
                                    _t(origin), cfg)
    for a, b in zip(jk, tk):
        _eq(a, b)
    js = j_integrate.sort_points_soa(*(jnp.asarray(pts[:, i])
                                       for i in range(3)), *jk[:2])
    ts = t_integrate.sort_points_soa(*(_t(pts[:, i]) for i in range(3)),
                                     *tk[:2])
    _eq(js[0], ts[0])
    _eq(js[1], ts[1])
    # equal keys may order their points differently: compare as sets
    pj = np.stack([np.asarray(a) for a in js[2:]], 1)
    pt = np.stack([a.numpy() for a in ts[2:]], 1)
    assert sorted(map(tuple, pj)) == sorted(map(tuple, pt))
