"""Sphere traffic: the reference demo's cloud (chad_tsdf src/chad/main.cpp:
7-39), ``points`` directions drawn uniformly in a cube and normalized onto a
sphere of ``radius_m`` around the scanner at the origin (the
configuration's ``cloud`` block), as the repo's ``bench.py`` draws it.
``templates`` clouds, each from its own stream of the seed; step ``i``
inserts cloud ``i % templates`` from the origin, so no submap ever
rotates.
"""

from __future__ import annotations

import numpy as np


def cloud(n: int, radius: float, rng) -> np.ndarray:
    d = rng.uniform(-1.0, 1.0, (n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (d * radius).astype(np.float32)


class Traffic:
    """``step(i)`` -> (points f32[N, 3], position f32[3], template index)."""

    def __init__(self, conf: dict, params: dict, seed: int):
        seed = seed % (1 << 63)
        spec = conf["cloud"]
        n, r = int(spec["points"]), float(spec["radius_m"])
        self.templates = [cloud(n, r, np.random.default_rng([seed, k]))
                          for k in range(int(params["templates"]))]
        self._origin = np.zeros(3, np.float32)

    def position(self, i: int) -> np.ndarray:
        return self._origin

    def points(self, i: int) -> np.ndarray:
        return self.templates[i % len(self.templates)]

    def step(self, i: int):
        k = i % len(self.templates)
        return self.templates[k], self._origin, k
