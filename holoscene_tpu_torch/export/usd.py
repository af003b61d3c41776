"""USD scene exporter with PhysX rigid-body/collider schemas (USDA text):
the port's copy of holoscene_tpu/export/usd.py, numpy only. It writes the
same text; the arrays are formatted a column at a time (one str.format a
row) instead of a Python loop a value, since a baked 1.9M-face room holds
5.7M points.

Reference semantics: utils/sim.py:286-350 / :439-604 + export/export_usd.py —
each object becomes a UsdGeom.Mesh prim with UsdPhysics RigidBodyAPI /
CollisionAPI / MassAPI and PhysxSchema SDF-mesh (dynamic objects) or
triangle-mesh (static background) collider attributes, composed into one
Isaac-Sim-ready stage. The pxr runtime isn't available in this image, so the
stage is emitted as spec-compliant USDA text (ASCII USD) that Isaac Sim /
usdview load directly; texture-mapped materials use UsdPreviewSurface.
"""

from __future__ import annotations

import os

import numpy as np

from holoscene_tpu_torch.utils.mesh import Mesh


def _fmt_float_array(a: np.ndarray, per: int = 1) -> str:
    """Values as "%.6g", comma-separated; rows of a 2-D array in
    parentheses."""
    a = np.asarray(a)
    if a.ndim == 2:
        row = "(" + ", ".join(["{:.6g}"] * a.shape[1]) + ")"
        return ", ".join(map(row.format, *(a[:, j].tolist()
                                           for j in range(a.shape[1]))))
    return ", ".join(map("{:.6g}".format, a.tolist()))


def mesh_prim_usda(
    name: str,
    mesh: Mesh,
    translation=(0.0, 0.0, 0.0),
    dynamic: bool = True,
    texture_path: str | None = None,
    mass: float = 1.0,
) -> str:
    """One mesh prim with physics APIs (reference convert_mesh_to_usd,
    utils/sim.py:286-350: dynamic objects get SDF-mesh colliders + CCD,
    static ones triangle-mesh colliders)."""
    v = mesh.vertices
    f = mesh.faces
    apis = ['"PhysicsCollisionAPI"', '"PhysxCollisionAPI"']
    if dynamic:
        apis = ['"PhysicsRigidBodyAPI"', '"PhysxRigidBodyAPI"',
                '"PhysicsMassAPI"'] + apis

    lines = [
        f'def Mesh "{name}" (',
        f"    prepend apiSchemas = [{', '.join(apis)}]",
        ")",
        "{",
        f"    point3f[] points = [{_fmt_float_array(v)}]",
        f"    int[] faceVertexIndices = [{', '.join(map(str, f.ravel().tolist()))}]",
        f"    int[] faceVertexCounts = [{', '.join(['3'] * len(f))}]",
        f"    double3 xformOp:translate = ({translation[0]:.6g}, "
        f"{translation[1]:.6g}, {translation[2]:.6g})",
        '    uniform token[] xformOpOrder = ["xformOp:translate"]',
    ]
    if mesh.uvs is not None:
        uv_face = mesh.uvs[f.ravel()]
        lines.append(
            f"    texCoord2f[] primvars:st = [{_fmt_float_array(uv_face)}] ("
            'interpolation = "faceVarying")'
        )
    if dynamic:
        lines += [
            "    bool physics:rigidBodyEnabled = 1",
            f"    float physics:mass = {mass}",
            "    bool physxRigidBody:enableCCD = 1",
            "    float physxRigidBody:linearDamping = 0.5",
            "    float physxRigidBody:angularDamping = 0.5",
            '    uniform token physics:approximation = "sdf"',
            "    uniform int physxSDFMeshCollision:sdfResolution = 256",
        ]
    else:
        lines += [
            '    uniform token physics:approximation = "none"',
        ]
    lines.append("    bool physics:collisionEnabled = 1")
    if texture_path:
        lines.append(
            f'    rel material:binding = </World/Materials/{name}_mat>'
        )
    lines.append("}")
    return "\n".join(lines)


def material_usda(name: str, texture_path: str) -> str:
    return f"""def Material "{name}_mat"
{{
    token outputs:surface.connect = </World/Materials/{name}_mat/shader.outputs:surface>
    def Shader "shader"
    {{
        uniform token info:id = "UsdPreviewSurface"
        color3f inputs:diffuseColor.connect = </World/Materials/{name}_mat/tex.outputs:rgb>
        float inputs:roughness = 1.0
        float inputs:metallic = 0.0
        token outputs:surface
    }}
    def Shader "tex"
    {{
        uniform token info:id = "UsdUVTexture"
        asset inputs:file = @{texture_path}@
        float2 inputs:st.connect = </World/Materials/{name}_mat/st.outputs:result>
        color3f outputs:rgb
    }}
    def Shader "st"
    {{
        uniform token info:id = "UsdPrimvarReader_float2"
        token inputs:varname = "st"
        float2 outputs:result
    }}
}}"""


def export_usd(
    out_dir: str,
    meshes: list[Mesh | None],
    translations: dict[int, np.ndarray] | None = None,
    textures: dict[int, str] | None = None,
    static_ids: tuple[int, ...] = (0,),
    gravity: float = -9.81,
    stage_name: str = "scene.usda",
) -> str:
    """Compose the full scene stage (reference compose_usd_from_meshes_texture
    utils/sim.py:566-604 + export_usd_texture :710). Object 0 (background) is
    static; the rest are dynamic rigid bodies."""
    os.makedirs(out_dir, exist_ok=True)
    translations = translations or {}
    textures = textures or {}

    body = []
    mats = []
    for i, mesh in enumerate(meshes):
        if mesh is None:
            continue
        t = translations.get(i, (0.0, 0.0, 0.0))
        tex = textures.get(i)
        body.append(
            mesh_prim_usda(
                f"object_{i}", mesh, translation=t,
                dynamic=i not in static_ids, texture_path=tex,
            )
        )
        if tex:
            mats.append(material_usda(f"object_{i}", tex))

    indent = "\n".join("        " + line for block in body for line in block.splitlines())
    mats_indent = "\n".join(
        "            " + line for block in mats for line in block.splitlines()
    )
    stage = f"""#usda 1.0
(
    defaultPrim = "World"
    metersPerUnit = 1
    upAxis = "Y"
)

def Xform "World"
{{
    def PhysicsScene "physicsScene"
    {{
        vector3f physics:gravityDirection = (0, -1, 0)
        float physics:gravityMagnitude = {abs(gravity)}
    }}

    def Scope "Materials"
    {{
{mats_indent}
    }}

{indent}
}}
"""
    path = os.path.join(out_dir, stage_name)
    with open(path, "w") as f:
        f.write(stage)
    return path


def export_gaussians_usda(path: str, gaussians: dict) -> str:
    """Gaussian-splat USD (counterpart of the vendored 3dgrut ply_to_usd
    exporter, export/export_gs_usd.py:74-125): a UsdGeomPoints prim carrying
    the 3DGS attributes as primvars, loadable by gaussian-aware USD viewers."""
    g = gaussians
    n = len(g["means"])
    rest = g["features_rest"].reshape(n, -1)
    lines = [
        "#usda 1.0",
        '(\n    defaultPrim = "gauss"\n    metersPerUnit = 1\n    upAxis = "Y"\n)',
        'def Points "gauss"',
        "{",
        f"    point3f[] points = [{_fmt_float_array(g['means'])}]",
        f"    float[] primvars:opacity_logit = [{_fmt_float_array(g['opacity_logits'])}]",
        f"    float3[] primvars:log_scale = [{_fmt_float_array(g['log_scales'])}]",
        f"    float4[] primvars:rot_wxyz = [{_fmt_float_array(g['quats'])}]",
        f"    float3[] primvars:sh_dc = [{_fmt_float_array(g['features_dc'])}]",
        f"    float[] primvars:sh_rest = [{_fmt_float_array(rest)}]",
        "}",
    ]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path
