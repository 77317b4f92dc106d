"""Marching-cubes case tables, generated — not transcribed.  A numpy copy
of ``chad_tsdf_tpu/mesh/tables.py`` (importing that module would import
jax through its package).

The reference delegates per-cell triangulation to LVR2's ``BilinearFastBox``
(reference: src/chad/detail/lvr2.cpp:246-250), which embeds the classic
Lorensen–Cline tables.  Instead of hand-typing a 256x16 table (and risking a
silent typo), the table is *derived* at import time by walking the oriented
isosurface boundary polygons on the cube's faces:

* corners/edges use the standard (Bourke) layout, identical to LVR2's,
* a face with 2 sign crossings yields one oriented segment; the 4-crossing
  ambiguous faces are resolved with a fixed, consistent rule,
* each case's segments close into loops which are fan-triangulated with the
  interior kept to the left — giving consistently wound triangles.

Invariants (each case's patch separates inside from outside corners, shared
faces agree between neighbouring cells) are asserted by tests/test_mesh.py.
"""

from __future__ import annotations

import numpy as np

# corner i at offset CORNERS[i]; bit i of a case = "corner i inside (sd<0)"
CORNERS = np.array([(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
                    (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)], np.int32)
# edge e connects corners EDGES[e]
EDGES = np.array([(0, 1), (1, 2), (2, 3), (3, 0),
                  (4, 5), (5, 6), (6, 7), (7, 4),
                  (0, 4), (1, 5), (2, 6), (3, 7)], np.int32)
# faces as corner quads, CCW viewed from outside the cube
_FACES = [(0, 3, 2, 1), (4, 5, 6, 7), (0, 1, 5, 4),
          (2, 3, 7, 6), (0, 4, 7, 3), (1, 2, 6, 5)]

_EDGE_OF = {}
for _ei, (_a, _b) in enumerate(EDGES):
    _EDGE_OF[(_a, _b)] = _ei
    _EDGE_OF[(_b, _a)] = _ei


def _face_segments(case: int, face) -> list:
    c = list(face)
    pts = []
    for i in range(4):
        a, b = c[i], c[(i + 1) % 4]
        ai, bi = (case >> a) & 1, (case >> b) & 1
        if ai != bi:
            pts.append((_EDGE_OF[(a, b)], ai == 1))  # True = inside->outside
    if not pts:
        return []
    if len(pts) == 2:
        (e1, io1), (e2, _) = pts
        return [(e1, e2)] if io1 else [(e2, e1)]
    # ambiguous face (4 crossings): connect each inside->outside crossing to
    # the next crossing along the quad walk — fixed, orientation-consistent
    return [(pts[i][0], pts[(i + 1) % 4][0])
            for i in range(4) if pts[i][1]]


def _build_tables():
    tri = np.full((256, 16), -1, np.int32)
    edge_mask = np.zeros(256, np.int32)
    for case in range(256):
        segs = []
        for f in _FACES:
            segs += _face_segments(case, f)
        nxt: dict[int, list] = {}
        for a, b in segs:
            nxt.setdefault(a, []).append(b)
        tris = []
        used: set[int] = set()
        for a0 in list(nxt):
            if a0 in used:
                continue
            loop = [a0]
            used.add(a0)
            cur = a0
            while True:
                chosen = None
                for cnd in nxt[cur]:
                    if cnd == a0 and len(loop) >= 3:
                        chosen = a0
                        break
                    if cnd not in used:
                        chosen = cnd
                        break
                if chosen is None or chosen == a0:
                    break
                loop.append(chosen)
                used.add(chosen)
                cur = chosen
            for i in range(1, len(loop) - 1):
                tris.append((loop[0], loop[i], loop[i + 1]))
        flat = [e for t in tris for e in t]
        tri[case, :len(flat)] = flat
        for e in flat:
            edge_mask[case] |= 1 << e
    return tri, edge_mask


TRI_TABLE, EDGE_MASK = _build_tables()
N_TRIS = (TRI_TABLE != -1).sum(axis=1) // 3
