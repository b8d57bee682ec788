"""Scenes generated in memory, as reference-format documents.

``many_prims_scene`` stresses what file scenes of this repository do not:
many analytic primitives and many materials at once.  The document goes to
``scene_from_dict`` here, or, written out as JSON, to any loader of the
reference schema.
"""

from __future__ import annotations

import copy
import json


def many_prims_scene(base_path: str, prims: int = 40, materials: int = 40,
                     depth: "int | None" = None) -> dict:
    """The box of the scene at ``base_path`` (its first six objects: the
    light and the five walls of a Cornell box) filled with a grid of small
    spheres and cubes up to ``prims`` objects, each new object with a
    material of its own up to ``materials`` materials (diffuse colors with
    a mirror, a glass and a microfacet every few), then cycling.  ``depth``
    overrides the trace depth.  Deterministic: no random numbers."""
    with open(base_path, "r") as f:
        doc = copy.deepcopy(json.load(f))
    doc["Objects"] = doc["Objects"][:6]
    if depth is not None:
        doc["Camera"]["DEPTH"] = int(depth)
    doc["Camera"]["FILE"] = f"many_prims_{prims}"
    names = list(doc["Materials"])
    new = 0
    while len(doc["Materials"]) < materials:
        i = new
        rgb = [0.25 + 0.7 * ((i * 37) % 11) / 10.0, 0.25 + 0.7 * ((i * 53) % 7) / 6.0,
               0.25 + 0.7 * ((i * 29) % 5) / 4.0]
        if i % 9 == 4:
            mat = {"TYPE": "Reflective", "RGB": rgb}
        elif i % 9 == 7:
            mat = {"TYPE": "Glass", "RGB": rgb, "IOR": 1.5}
        elif i % 9 == 2:
            mat = {"TYPE": "Microfacet", "RGB": rgb, "ROUGHNESS": 0.3, "METALLIC": 0.6,
                   "IOR": 1.5}
        else:
            mat = {"TYPE": "Diffuse", "RGB": rgb}
        name = f"grid_{i}"
        doc["Materials"][name] = mat
        names.append(name)
        new += 1
    first_new = len(names) - new
    cols = 6
    k = 0
    while len(doc["Objects"]) < prims:
        row, col = divmod(k, cols)
        # 96 objects fill the box once; a further layer goes over the same
        # grid, shifted, so the far end of a long table is hit too.
        layer, row = divmod(row, 16)
        pos = [-3.75 + 1.5 * col + 0.19 * (layer % 7), 0.6 + 1.3 * (row % 4) + 0.13 * (layer % 5),
               2.5 - 1.4 * (row // 4) - 0.9 * (row % 2)]
        size = 0.55 + 0.1 * (k % 3)
        pool = names[first_new:] or names
        doc["Objects"].append({
            "TYPE": "sphere" if k % 2 == 0 else "cube",
            "MATERIAL": pool[k % len(pool)],
            "TRANS": pos,
            "ROTAT": [0.0, 15.0 * (k % 5), 0.0],
            "SCALE": [size, size, size],
        })
        k += 1
    return doc
