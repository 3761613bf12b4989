"""The plain reference scene of ``final_scene.json``: The Next Week's final
scene as the reference repository builds it (``src/main.cu:498-562``)."""

from __future__ import annotations

import math

import numpy as np

from portbench.reference.scene import SceneDraft, add_spheres, camera_from, load_image


def unit_cube_point(j: int) -> np.ndarray:
    """The repository's hashed point in the unit cube (``src/util.cuh:3-11``):
    an LCG seed, then three xorshift rounds, 24 bits each."""
    s = (1103515245 * (j + 1) + 12345) & 0xFFFFFFFF
    out = []
    for _ in range(3):
        s ^= (s << 13) & 0xFFFFFFFF
        s ^= s >> 17
        s ^= (s << 5) & 0xFFFFFFFF
        out.append((s & 0xFFFFFF) / 16777216.0)
    return np.array(out)


def build(cfg: dict, root, nx: int, ny: int):
    images = {name: load_image(root, path) for name, path in cfg["images"].items()}
    b = SceneDraft()
    g = cfg["ground"]
    ground = b.lambertian(tuple(g["albedo"]))
    for i in range(g["cells"]):
        for j in range(g["cells"]):
            x0, z0 = g["x0"] + i * g["width"], g["z0"] + j * g["width"]
            y1 = 1.0 + 100.0 * ((i * 13 + j * 37) % 100) / 100.0
            b.box((x0, 0.0, z0), (x0 + g["width"], y1, z0 + g["width"]), ground)
    li = cfg["light"]
    b.quad(tuple(li["q"]), tuple(li["u"]), tuple(li["v"]), b.light(tuple(li["emit"])))
    add_spheres(b, cfg["spheres"], images)
    for m in cfg["media"]:
        b.medium(tuple(m["center"]), m["radius"], m["density"], tuple(m["albedo"]))
    bc = cfg["ball_cluster"]
    white = b.lambertian(tuple(bc["albedo"]))
    ang = math.radians(bc["rotate_y"])
    c, s = math.cos(ang), math.sin(ang)
    for j in range(bc["count"]):
        p = unit_cube_point(j) * bc["side"]
        p = np.array([c * p[0] + s * p[2], p[1], -s * p[0] + c * p[2]]) + bc["offset"]
        b.sphere(tuple(p), bc["radius"], white)
    return b.finish(camera_from(cfg["camera"]), cfg["background"], nx, ny, cfg["max_depth"])
