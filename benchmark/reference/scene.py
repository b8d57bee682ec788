"""The reference's own reading of a scene document (the CIS-565 Project 3
JSON schema): materials, boxes and spheres, OBJ triangle meshes baked to
world space, and the render camera the reference tracer derives from the
document (and from an orbit of it).

Plain NumPy in float64, cast to float32 where the tracer takes its
constants.  It reads the materials as the reference tracer's loader does
(``src/scene.cpp:59-100``): "Diffuse" (which ignores a ``ROUGHNESS`` key),
"Emitting", "Reflective", "Transmissive", "Glass" and "Microfacet", with
``RGB``, ``EMITTANCE``, ``IOR``, ``ROUGHNESS`` and ``METALLIC``; and
"cube", "sphere" and "obj" objects whose OBJ files hold triangles of
positions, with or without vertex normals (``f v`` or ``f v//vn``; a face
without them is shaded flat).  Texture coordinates, textures, bump maps,
polygons, a material ``TYPE`` it does not know and anything else raise,
so a configuration the reference cannot follow is refused rather than
judged by a different scene.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field

import numpy as np

PI = 3.1415926535897932384626422832795028841971

CUBE, SPHERE = 0, 1


def _rotation(angle_deg: float, axis: int) -> np.ndarray:
    a = angle_deg * PI / 180.0
    c, s = math.cos(a), math.sin(a)
    m = np.eye(4)
    i, j = [(1, 2), (2, 0), (0, 1)][axis]
    m[i, i], m[i, j], m[j, i], m[j, j] = c, -s, s, c
    return m


def transformation(trans, rot_deg, scale) -> np.ndarray:
    """T * Rx * Ry * Rz * S (degrees), the reference's object transform."""
    t = np.eye(4)
    t[:3, 3] = trans
    s = np.diag([scale[0], scale[1], scale[2], 1.0])
    return t @ _rotation(rot_deg[0], 0) @ _rotation(rot_deg[1], 1) @ _rotation(rot_deg[2], 2) @ s


def _snap(m: np.ndarray) -> np.ndarray:
    """Round the float dust of a rotation (cos 90 degrees) to 0 and +-1."""
    out = m.copy()
    for target in (0.0, 1.0, -1.0):
        out[np.abs(out - target) < 1e-12] = target
    return out


# The lobes of ``scatterRay`` (``src/interactions.cu:438-542``), in the
# order it tests them: the first that a material's flags select is its lobe.
LOBES = ("glass", "mirror", "transmissive", "microfacet", "diffuse")


@dataclass
class Material:
    color: tuple
    emittance: float = 0.0
    reflective: bool = False
    refractive: bool = False
    ior: float = 0.0
    roughness: float = -1.0
    metallic: float = -1.0

    @property
    def lobe(self) -> str:
        """The lobe that scatters a path off this material: glass where it
        reflects and refracts, then mirror, transmissive, Cook-Torrance
        where roughness and metallic are both set (>= 0), else diffuse."""
        if self.reflective and self.refractive:
            return "glass"
        if self.reflective:
            return "mirror"
        if self.refractive:
            return "transmissive"
        if self.roughness >= 0.0 and self.metallic >= 0.0:
            return "microfacet"
        return "diffuse"


@dataclass
class Prim:
    kind: int  # CUBE or SPHERE
    material: int
    transform: np.ndarray  # 4x4 float64
    inverse: np.ndarray
    inv_transpose: np.ndarray


@dataclass
class Mesh:
    """World-space triangles: vertices [T, 3, 3] and the normals at each
    corner [T, 3, 3] (the file's vertex normals, or the flat normal three
    times on a face without them), float32, in file order; one material for
    the whole mesh."""

    vertices: np.ndarray
    vertex_normals: np.ndarray
    material: int


@dataclass
class Camera:
    position: np.ndarray
    look_at: np.ndarray
    view: np.ndarray
    up: np.ndarray
    right: np.ndarray
    pixel_length: np.ndarray  # [2]
    aperture: float
    focal_dist: float


@dataclass
class Orbit:
    """Spherical rig around LOOKAT (the reference's mouse orbit)."""

    phi: float
    theta: float
    zoom: float
    look_at: np.ndarray

    def move(self, dphi: float, dtheta: float) -> None:
        self.phi -= dphi
        self.theta = min(max(0.001, self.theta - dtheta), PI)


@dataclass
class Scene:
    width: int
    height: int
    depth: int
    camera: Camera  # as loaded
    materials: list
    prims: list
    meshes: list = field(default_factory=list)

    @property
    def pixel_count(self) -> int:
        return self.width * self.height

    @property
    def lobes(self) -> set:
        """The lobes of the scene's materials."""
        return {m.lobe for m in self.materials}

    def orbit(self) -> Orbit:
        """The rig the reference starts from: angles from the loaded view."""
        cam = self.camera
        view = _unit(cam.look_at - cam.position)
        xz = _unit(np.array([view[0], 0.0, view[2]]))
        zy = _unit(np.array([0.0, view[1], view[2]]))
        return Orbit(
            phi=math.acos(float(np.clip(xz @ np.array([0.0, 0.0, -1.0]), -1, 1))),
            theta=math.acos(float(np.clip(zy @ np.array([0.0, 1.0, 0.0]), -1, 1))),
            zoom=float(np.linalg.norm(cam.position - cam.look_at)),
            look_at=cam.look_at.copy(),
        )

    def render_camera(self, orbit: Orbit = None) -> Camera:
        """The camera the reference renders with: re-derived from the rig
        on the first frame and after every orbit (right and up are left
        unnormalised, as the reference leaves them)."""
        o = orbit or self.orbit()
        rel = np.array([
            o.zoom * math.sin(o.phi) * math.sin(o.theta),
            o.zoom * math.cos(o.theta),
            o.zoom * math.cos(o.phi) * math.sin(o.theta),
        ])
        view = -_unit(rel)
        right = np.cross(view, np.array([0.0, 1.0, 0.0]))
        up = np.cross(right, view)
        position = rel + o.look_at
        return Camera(position=position, look_at=o.look_at.copy(), view=view, up=up,
                      right=right, pixel_length=self.camera.pixel_length,
                      aperture=self.camera.aperture,
                      focal_dist=float(np.linalg.norm(o.look_at - position)))


# Each material type's numbers besides ``RGB``, and the fields they set.
MATERIAL_KEYS = {
    "Diffuse": {},
    "Emitting": {"EMITTANCE": "emittance"},
    "Reflective": {},
    "Transmissive": {"IOR": "ior"},
    "Glass": {"IOR": "ior"},
    "Microfacet": {"ROUGHNESS": "roughness", "METALLIC": "metallic", "IOR": "ior"},
}


def _unit(v) -> np.ndarray:
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v)


def _vec3(x) -> np.ndarray:
    return np.array([float(x[0]), float(x[1]), float(x[2])])


def load(doc: dict, base_dir: str, res: tuple = None) -> Scene:
    """The scene of a document; ``res`` = (width, height) replaces the
    camera's resolution (the field of view is kept, as the loader keeps it)."""
    names, materials = {}, []
    for name, p in doc["Materials"].items():
        kind = p["TYPE"]
        if kind not in MATERIAL_KEYS:
            raise NotImplementedError(f"the reference renders no {kind!r} material")
        if "TEXTURE" in p or "BUMP_MAP" in p:
            raise NotImplementedError("the reference renders no textures")
        m = Material(tuple(_vec3(p["RGB"])), reflective=kind in ("Reflective", "Glass"),
                     refractive=kind in ("Transmissive", "Glass"))
        for key, attr in MATERIAL_KEYS[kind].items():
            setattr(m, attr, float(p[key]))
        materials.append(m)
        names[name] = len(materials) - 1

    prims, meshes = [], []
    for p in doc["Objects"]:
        m = transformation(_vec3(p["TRANS"]), _vec3(p["ROTAT"]), _vec3(p["SCALE"]))
        mat = names.get(p["MATERIAL"], 0)
        if p["TYPE"] == "obj":
            meshes.append(load_obj(os.path.join(base_dir, p["PATH"]), m, mat))
        elif p["TYPE"] in ("cube", "sphere"):
            prims.append(Prim(CUBE if p["TYPE"] == "cube" else SPHERE, mat, _snap(m),
                              _snap(np.linalg.inv(m)), _snap(np.linalg.inv(m).T)))
        else:
            raise NotImplementedError(f"the reference renders no {p['TYPE']!r} object")

    c = doc["Camera"]
    width, height = (int(c["RES"][0]), int(c["RES"][1])) if res is None else res
    yscaled = math.tan(float(c["FOVY"]) * (PI / 180.0))  # FOVY is the half-angle
    xscaled = yscaled * width / height
    position, look_at = _vec3(c["EYE"]), _vec3(c["LOOKAT"])
    view = _unit(look_at - position)
    camera = Camera(
        position=position, look_at=look_at, view=view, up=_vec3(c["UP"]),
        right=_unit(np.cross(view, _vec3(c["UP"]))),
        pixel_length=np.array([2.0 * xscaled / width, 2.0 * yscaled / height]),
        aperture=float(c.get("APERTURE", 0.0)),
        focal_dist=float(np.linalg.norm(look_at - position)),
    )
    return Scene(width, height, int(c["DEPTH"]), camera, materials, prims, meshes)


def _unit_rows(a: np.ndarray) -> np.ndarray:
    """Rows over their length; a row of length 0 stays 0."""
    length = np.linalg.norm(a, axis=-1, keepdims=True)
    return np.where(length > 0, a / np.where(length == 0, 1.0, length), a)


def load_obj(path: str, transform: np.ndarray, material: int) -> Mesh:
    """Triangles of an OBJ file of ``v``, ``vn`` and triangular ``f``
    records (``f a b c`` or ``f a//na b//nb c//nc``), baked to world space
    in float64 and rounded to float32.  A vertex normal is carried by the
    inverse transpose of the transform and normalised; a face whose three
    normals are absent or zero takes its flat normal at every corner."""
    verts, normals, faces = [], [], []
    with open(path) as f:
        for line in f:
            tag, _, rest = line.partition(" ")
            if tag == "v":
                verts.append(rest)
            elif tag == "vn":
                normals.append(rest)
            elif tag == "f":
                faces.append(rest)
            elif tag == "vt":
                raise NotImplementedError(f"{path}: the reference reads no 'vt' records")
    v = np.array(" ".join(verts).split(), np.float64).reshape(-1, 3)
    vn = np.array(" ".join(normals).split(), np.float64).reshape(-1, 3)
    parts = [tok.partition("//") for tok in " ".join(faces).split()]
    if len(parts) != 3 * len(faces):
        raise NotImplementedError(f"{path}: the reference reads triangles only")
    if any("/" in a or (sep and not b) for a, sep, b in parts):
        raise NotImplementedError(f"{path}: the reference reads faces 'v' and 'v//vn' only")
    resolve = lambda idx, count: np.where(idx > 0, idx - 1, count + idx)
    idx = resolve(np.array([a for a, _, _ in parts], np.int64), len(v)).reshape(-1, 3)
    has_n = np.array([bool(sep) for _, sep, _ in parts]).reshape(-1, 3)
    nidx = resolve(np.array([b or "1" for _, _, b in parts], np.int64), len(vn)).reshape(-1, 3)
    p = v[idx] @ transform[:3, :3].T + transform[:3, 3]  # [T, 3, 3]
    flat = _unit_rows(np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]))
    corner = np.zeros(p.shape)
    if len(vn):
        inv_t = np.linalg.inv(transform).T[:3, :3]
        corner = np.where(has_n[..., None], _unit_rows(vn[np.where(has_n, nidx, 0)] @ inv_t.T),
                          0.0)
    missing = (np.linalg.norm(corner, axis=-1) <= 1e-6).all(axis=1)
    corner = np.where(missing[:, None, None], flat[:, None, :], corner)
    return Mesh(p.astype(np.float32), corner.astype(np.float32), material)
