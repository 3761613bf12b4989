"""The plain reference's scene: primitives, materials and textures as numpy
arrays, built by each configuration's ``configs/<config>.py`` from the
published description.  Nothing here is taken from the program under test.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

# material kinds
LAMBERTIAN, METAL, DIELECTRIC, LIGHT, ISOTROPIC = range(5)
# texture kinds
SOLID, CHECKER, IMAGE, NOISE = range(4)


@dataclasses.dataclass
class Texture:
    kind: int
    rgb: tuple = (0.0, 0.0, 0.0)
    scale: float = 1.0  # checker: tile size; noise: frequency
    even: int = -1  # checker children (texture ids)
    odd: int = -1
    image: np.ndarray | None = None  # (H, W, 3) uint8


@dataclasses.dataclass
class Material:
    kind: int
    tex: int = -1  # lambertian, light and isotropic read their colour here
    albedo: tuple = (0.0, 0.0, 0.0)  # metal
    fuzz: float = 0.0
    ref_idx: float = 1.0


@dataclasses.dataclass
class Camera:
    lookfrom: tuple
    lookat: tuple
    vup: tuple
    vfov: float
    aperture: float
    focus_dist: float
    time0: float = 0.0
    time1: float = 1.0

    def frame(self, nx: int, ny: int) -> dict:
        """Shirley's thin-lens camera basis (Ray Tracing in One Weekend §12)."""
        lf = np.asarray(self.lookfrom, np.float64)
        la = np.asarray(self.lookat, np.float64)
        vup = np.asarray(self.vup, np.float64)
        half_h = math.tan(math.radians(self.vfov) / 2.0)
        half_w = nx / ny * half_h
        w = (lf - la) / np.linalg.norm(lf - la)
        u = np.cross(vup, w)
        u /= np.linalg.norm(u)
        v = np.cross(w, u)
        f = self.focus_dist
        return dict(origin=lf, llc=lf - half_w * f * u - half_h * f * v - f * w,
                    horizontal=2 * half_w * f * u, vertical=2 * half_h * f * v, u=u, v=v,
                    lens_radius=self.aperture / 2.0, time0=self.time0, time1=self.time1)


class SceneDraft:
    """Collects primitives in scene order, then ``finish`` packs them."""

    def __init__(self):
        self.textures: list[Texture] = []
        self.materials: list[Material] = []
        self.spheres: list = []  # (center0, center1, radius, mat)
        self.quads: list = []  # (Q, u, v, mat)
        self.boxes: list = []  # (min, max, mat)
        self.media: list = []  # (center, radius, density, mat)

    def texture(self, tex: Texture) -> int:
        self.textures.append(tex)
        return len(self.textures) - 1

    def solid(self, rgb) -> int:
        return self.texture(Texture(SOLID, rgb=tuple(rgb)))

    def material(self, mat: Material) -> int:
        self.materials.append(mat)
        return len(self.materials) - 1

    def lambertian(self, rgb_or_tex) -> int:
        tex = rgb_or_tex if isinstance(rgb_or_tex, int) else self.solid(rgb_or_tex)
        return self.material(Material(LAMBERTIAN, tex=tex))

    def metal(self, rgb, fuzz: float) -> int:
        return self.material(Material(METAL, albedo=tuple(rgb), fuzz=min(fuzz, 1.0)))

    def dielectric(self, ref_idx: float) -> int:
        return self.material(Material(DIELECTRIC, ref_idx=ref_idx))

    def light(self, rgb) -> int:
        return self.material(Material(LIGHT, tex=self.solid(rgb)))

    def sphere(self, center, radius, mat, center2=None):
        self.spheres.append((center, center if center2 is None else center2, radius, mat))

    def quad(self, q, u, v, mat):
        self.quads.append((q, u, v, mat))

    def box(self, lo, hi, mat):
        self.boxes.append((lo, hi, mat))

    def medium(self, center, radius, density, rgb):
        mat = self.material(Material(ISOTROPIC, tex=self.solid(rgb)))
        self.media.append((center, radius, density, mat))

    def finish(self, camera: Camera, background, nx: int, ny: int, max_depth: int):
        def arr(rows, k, width):
            return np.array([r[k] for r in rows], np.float64).reshape(-1, width)

        s, q, b = self.spheres, self.quads, self.boxes
        return RefScene(
            sph_c0=arr(s, 0, 3), sph_vel=arr(s, 1, 3) - arr(s, 0, 3),
            sph_r=arr(s, 2, 1)[:, 0], sph_mat=np.array([r[3] for r in s], np.int64),
            quad_q=arr(q, 0, 3), quad_u=arr(q, 1, 3), quad_v=arr(q, 2, 3),
            quad_mat=np.array([r[3] for r in q], np.int64),
            box_min=arr(b, 0, 3), box_max=arr(b, 1, 3),
            box_mat=np.array([r[2] for r in b], np.int64),
            media=list(self.media), materials=list(self.materials),
            textures=list(self.textures), camera=camera,
            background=tuple(float(c) for c in background), nx=nx, ny=ny,
            max_depth=max_depth)


@dataclasses.dataclass
class RefScene:
    sph_c0: np.ndarray
    sph_vel: np.ndarray
    sph_r: np.ndarray
    sph_mat: np.ndarray
    quad_q: np.ndarray
    quad_u: np.ndarray
    quad_v: np.ndarray
    quad_mat: np.ndarray
    box_min: np.ndarray
    box_max: np.ndarray
    box_mat: np.ndarray
    media: list
    materials: list
    textures: list
    camera: Camera
    background: tuple
    nx: int
    ny: int
    max_depth: int

    def counts(self) -> dict:
        """Sizes of the scene's tables, for the roofline's least bytes."""
        return dict(spheres=len(self.sph_r), moving=int((np.abs(self.sph_vel).sum(1) > 0).sum()),
                    quads=len(self.quad_mat), boxes=len(self.box_mat), media=len(self.media),
                    materials=len(self.materials))


def camera_from(spec: dict) -> Camera:
    lf, la = np.asarray(spec["lookfrom"], float), np.asarray(spec["lookat"], float)
    return Camera(lookfrom=tuple(lf), lookat=tuple(la), vup=tuple(spec["vup"]),
                  vfov=spec["vfov"], aperture=spec["aperture"],
                  focus_dist=float(np.linalg.norm(lf - la)), time0=spec["time0"],
                  time1=spec["time1"])


def load_image(root, path: str) -> np.ndarray:
    """An (H, W, 3) uint8 texture from a raw ``.npz`` (key ``rgb``) under the
    checkout ``root``: an input that the harness and the program both read."""
    with np.load(root / path) as z:
        return np.asarray(z["rgb"], np.uint8)


def add_spheres(draft: SceneDraft, specs: list, images: dict) -> None:
    """Spheres from the configuration's list, each with one material key."""
    for sp in specs:
        if "lambertian" in sp:
            mat = draft.lambertian(tuple(sp["lambertian"]))
        elif "dielectric" in sp:
            mat = draft.dielectric(sp["dielectric"])
        elif "metal" in sp:
            mat = draft.metal(tuple(sp["metal"]), sp["fuzz"])
        elif "image" in sp:
            mat = draft.lambertian(draft.texture(Texture(IMAGE, image=images[sp["image"]])))
        elif "noise" in sp:
            mat = draft.lambertian(draft.texture(Texture(NOISE, scale=sp["noise"])))
        else:
            raise ValueError(f"sphere without a known material: {sp}")
        draft.sphere(tuple(sp["center"]), sp["radius"], mat,
                     tuple(sp["center2"]) if "center2" in sp else None)
