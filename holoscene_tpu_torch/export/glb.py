"""GLB (binary glTF 2.0) scene exporter (the port's copy of
holoscene_tpu/export/glb.py, numpy only; it writes the same bytes).

Reference semantics: export/export_glb.py:47-356 — assembles textured
per-object meshes (+ per-object translations from translation_dict.pkl) into
one scene.glb with embedded PNG textures, +Y-up transform. The reference
hand-builds glTF buffers with pygltflib; here the container is written
directly (JSON + BIN chunks per the glTF 2.0 spec) with zero dependencies.
"""

from __future__ import annotations

import json
import struct

import numpy as np

from holoscene_tpu_torch.utils.mesh import Mesh

# glTF expects +Y up, -Z forward; the pipeline's scenes are OpenCV-style
# (+Y down). Rotate 180 deg about X (reference applies an equivalent
# transform, export_glb.py:300-320).
_YUP = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], dtype=np.float64)


def _pad4(b: bytes, pad: bytes = b"\x00") -> bytes:
    return b + pad * ((4 - len(b) % 4) % 4)


def export_glb(
    path: str,
    meshes: list[Mesh],
    textures_png: list[bytes | None] | None = None,
    translations: dict[int, np.ndarray] | None = None,
    y_up: bool = True,
) -> None:
    """Write scene.glb. meshes[i] may carry uvs; textures_png[i] is the raw
    PNG bytes of its baked texture (or None for untextured)."""
    textures_png = textures_png or [None] * len(meshes)
    translations = translations or {}

    bin_parts: list[bytes] = []
    buffer_views = []
    accessors = []
    images = []
    gltf_textures = []
    materials = []
    gltf_meshes = []
    nodes = []

    def add_view(data: bytes, target: int | None = None) -> int:
        offset = sum(len(p) for p in bin_parts)
        bin_parts.append(_pad4(data))
        view = {"buffer": 0, "byteOffset": offset, "byteLength": len(data)}
        if target is not None:
            view["target"] = target
        buffer_views.append(view)
        return len(buffer_views) - 1

    def add_accessor(view: int, comp_type: int, count: int, acc_type: str,
                     vmin=None, vmax=None) -> int:
        acc = {
            "bufferView": view,
            "componentType": comp_type,
            "count": count,
            "type": acc_type,
        }
        if vmin is not None:
            acc["min"] = vmin
            acc["max"] = vmax
        accessors.append(acc)
        return len(accessors) - 1

    for i, mesh in enumerate(meshes):
        if mesh is None:
            continue
        verts = mesh.vertices.copy()
        if i in translations:
            verts = verts + np.asarray(translations[i])[None, :]
        if y_up:
            verts = verts @ _YUP.T
        verts = verts.astype(np.float32)
        faces = mesh.faces.astype(np.uint32)

        v_view = add_view(verts.tobytes(), target=34962)
        v_acc = add_accessor(
            v_view, 5126, len(verts), "VEC3",
            vmin=verts.min(0).tolist(), vmax=verts.max(0).tolist(),
        )
        i_view = add_view(faces.tobytes(), target=34963)
        i_acc = add_accessor(i_view, 5125, faces.size, "SCALAR")

        attributes = {"POSITION": v_acc}
        material_idx = None
        if mesh.uvs is not None:
            uvs = mesh.uvs.astype(np.float32).copy()
            uvs[:, 1] = 1.0 - uvs[:, 1]  # OBJ vt -> glTF uv (v down)
            uv_view = add_view(uvs.tobytes(), target=34962)
            uv_acc = add_accessor(uv_view, 5126, len(uvs), "VEC2")
            attributes["TEXCOORD_0"] = uv_acc

        png = textures_png[i] if i < len(textures_png) else None
        if png is not None and mesh.uvs is not None:
            img_view = add_view(png)
            images.append({"bufferView": img_view, "mimeType": "image/png"})
            gltf_textures.append({"source": len(images) - 1})
            materials.append(
                {
                    "pbrMetallicRoughness": {
                        "baseColorTexture": {"index": len(gltf_textures) - 1},
                        "metallicFactor": 0.0,
                        "roughnessFactor": 1.0,
                    },
                    "doubleSided": True,
                }
            )
            material_idx = len(materials) - 1
        elif mesh.vertex_colors is not None:
            colors = np.asarray(mesh.vertex_colors, dtype=np.float32)
            if colors.max() > 1.5:
                colors = colors / 255.0
            c_view = add_view(colors.astype(np.float32).tobytes(), target=34962)
            c_acc = add_accessor(c_view, 5126, len(colors), "VEC3")
            attributes["COLOR_0"] = c_acc

        prim = {"attributes": attributes, "indices": i_acc, "mode": 4}
        if material_idx is not None:
            prim["material"] = material_idx
        gltf_meshes.append({"primitives": [prim], "name": f"object_{i}"})
        nodes.append({"mesh": len(gltf_meshes) - 1, "name": f"object_{i}"})

    gltf = {
        "asset": {"version": "2.0", "generator": "holoscene_tpu"},
        "scene": 0,
        "scenes": [{"nodes": list(range(len(nodes)))}],
        "nodes": nodes,
        "meshes": gltf_meshes,
        "accessors": accessors,
        "bufferViews": buffer_views,
        "buffers": [{"byteLength": sum(len(p) for p in bin_parts)}],
    }
    if materials:
        gltf["materials"] = materials
    if gltf_textures:
        gltf["textures"] = gltf_textures
        gltf["images"] = images
        gltf["samplers"] = [{}]

    json_bytes = _pad4(json.dumps(gltf, separators=(",", ":")).encode(), b" ")
    bin_bytes = b"".join(bin_parts)

    with open(path, "wb") as f:
        total = 12 + 8 + len(json_bytes) + 8 + len(bin_bytes)
        f.write(struct.pack("<III", 0x46546C67, 2, total))
        f.write(struct.pack("<II", len(json_bytes), 0x4E4F534A))
        f.write(json_bytes)
        f.write(struct.pack("<II", len(bin_bytes), 0x004E4942))
        f.write(bin_bytes)


def read_glb_json(path: str) -> dict:
    """Parse the JSON chunk back (for tests / inspection)."""
    with open(path, "rb") as f:
        magic, version, _ = struct.unpack("<III", f.read(12))
        assert magic == 0x46546C67 and version == 2
        length, ctype = struct.unpack("<II", f.read(8))
        assert ctype == 0x4E4F534A
        return json.loads(f.read(length))
