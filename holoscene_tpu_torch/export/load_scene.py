"""Exported-scene loader / validator (the port's copy of
holoscene_tpu/export/load_scene.py, numpy only; the same results). The
stage's braces are found with one regex scan and the arrays parsed a whole
array at a time, where the reference steps through the text a character
at a time (minutes on a 1.9M-face room's stage).

Reference counterpart: export/load_isaacsim.py (loads the exported USD scene
into Isaac Sim). Without Isaac, this module loads the exported artifacts
back (GLB json + buffers, USDA stage, gaussian PLY/npz), validates their
structure, and returns the scene contents — the round-trip check used by
tests and by downstream consumers.
"""

from __future__ import annotations

import os
import re

import numpy as np

from holoscene_tpu_torch.export.glb import read_glb_json
from holoscene_tpu_torch.models.gom import read_gaussian_ply


_BRACES = re.compile(r"[{}]")


def load_usda(path: str) -> dict:
    """Parse the USDA stage into {prims: {name: {points, faces, dynamic,
    translate}}, gravity}."""
    text = open(path).read()
    prims = {}
    for m in re.finditer(r'def Mesh "(\w+)"[^{]*\{', text):
        name = m.group(1)
        start = m.end()
        depth = 1
        i = len(text)
        for b in _BRACES.finditer(text, start):
            depth += 1 if b.group() == "{" else -1
            if not depth:
                i = b.end()
                break
        body = text[start:i]
        header_and_body = text[m.start():i]  # apiSchemas live in the header
        pts = re.search(r"point3f\[\] points = \[(.*?)\]", body, re.S)
        points = None
        if pts:
            rows = re.findall(r"\(([^)]*)\)", pts.group(1))
            points = (np.array(", ".join(rows).split(","), dtype=np.float64)
                      .reshape(len(rows), -1) if rows else np.array([]))
        idx = re.search(r"int\[\] faceVertexIndices = \[(.*?)\]", body, re.S)
        faces = (
            np.array(idx.group(1).split(","), dtype=np.int64).reshape(-1, 3)
            if idx else None
        )
        tr = re.search(r"xformOp:translate = \(([^)]*)\)", body)
        translate = (
            np.array([float(x) for x in tr.group(1).split(",")]) if tr
            else np.zeros(3)
        )
        prims[name] = {
            "points": points,
            "faces": faces,
            "dynamic": "PhysicsRigidBodyAPI" in header_and_body,
            "translate": translate,
        }
    grav = re.search(r"float physics:gravityMagnitude = ([\d.]+)", text)
    return {
        "prims": prims,
        "gravity": float(grav.group(1)) if grav else None,
    }


def load_scene(out_dir: str) -> dict:
    """Load everything a run exported under out_dir."""
    scene: dict = {"glb": None, "usd": None, "gaussians": {}}
    glb = os.path.join(out_dir, "scene.glb")
    if os.path.exists(glb):
        scene["glb"] = read_glb_json(glb)
    usd = os.path.join(out_dir, "usd", "scene.usda")
    if os.path.exists(usd):
        scene["usd"] = load_usda(usd)
    for f in sorted(os.listdir(out_dir)):
        m = re.match(r"gauss_obj_(\d+)\.ply", f)
        if m:
            scene["gaussians"][int(m.group(1))] = read_gaussian_ply(
                os.path.join(out_dir, f)
            )
    return scene
