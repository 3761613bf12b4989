"""The plain reference scene of ``bouncing_spheres.json``: One Weekend's
final scene with moving and emissive small spheres, as the reference
repository draws it from one cuRAND XORWOW stream (``src/main.cu:160-244``)."""

from __future__ import annotations

from portbench.reference.scene import CHECKER, SceneDraft, Texture, add_spheres, camera_from
from portbench.reference.xorwow import Xorwow


def build(cfg: dict, root, nx: int, ny: int):
    b = SceneDraft()
    g = cfg["ground"]
    checker = b.texture(Texture(CHECKER, scale=g["checker"], even=b.solid(g["even"]),
                                odd=b.solid(g["odd"])))
    b.sphere(tuple(g["center"]), g["radius"], b.lambertian(checker))
    gr = cfg["grid"]
    rnd = Xorwow(gr["seed"]).uniform
    palette = [tuple(c) for c in gr["palette"]]

    def pick(r):
        return palette[min(int(r * 4.0), 3)] if r < 1.0 else palette[3]

    lo, hi = gr["range"]
    for a in range(lo, hi):
        for c in range(lo, hi):
            choose = rnd()
            cx = a + 0.9 * rnd()
            cz = c + 0.9 * rnd()
            center = (cx, gr["radius"], cz)
            if choose < gr["p_moving"]:
                vy = 0.5 * rnd()
                vz = 0.25 * (rnd() - 0.5)
                center2 = (cx, gr["radius"] + vy, cz + vz)
                if rnd() < gr["p_emissive"]:
                    mat = b.light(tuple(gr["emit_power"] * x for x in palette[1]))
                else:
                    mat = b.lambertian(pick(rnd()))
                b.sphere(center, gr["radius"], mat, center2)
            elif choose < gr["p_metal"]:
                albedo = pick(rnd())
                if sum(albedo) < 1e-5:
                    albedo = (0.15, 0.15, 0.15)
                b.sphere(center, gr["radius"], b.metal(albedo, 0.5 * rnd()))
            else:
                b.sphere(center, gr["radius"], b.dielectric(1.5))
    add_spheres(b, cfg["spheres"], {})
    return b.finish(camera_from(cfg["camera"]), cfg["background"], nx, ny, cfg["max_depth"])
