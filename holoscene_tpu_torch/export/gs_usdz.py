"""3DGS -> Omniverse/Isaac-consumable USDZ exporter (3dgrut NuRec schema).

The port's own copy of holoscene_tpu/export/gs_usdz.py: the port
imports nothing of the JAX package.

Reference counterpart: export/export_gs_usd.py:74-125 driving
threedgrut/export/usdz_exporter.py + usd_util.py + nurec_templates.py. The
artifact is a USDZ (stored-zip) with three members:

  * default.usda — root layer referencing gauss.usda;
  * gauss.usda   — a UsdVol Volume prim flagged `omni:nurec:isNuRecVolume`
    with two OmniNuRecFieldAsset prims (density / emissiveColor) pointing at
    the .nurec payload, plus extent/crop bounds and the 3DGRUT->USD axis
    conversion transform;
  * <name>.nurec — gzip-compressed msgpack holding the renderer config and
    an fp16 state dict (positions / rotations / scales / densities /
    features_albedo / features_specular (+shapes), n_active_features).

The schema (key names, prim layout, template defaults) is an interchange
format consumed by Omniverse Kit / Isaac Sim — reproduced here for
compatibility. usda layers are emitted as handwritten ASCII (the `pxr`
package is not required).
"""

from __future__ import annotations

import gzip
import io
import os
import zipfile

import numpy as np


def nurec_template(
    positions: np.ndarray,
    rotations: np.ndarray,
    scales: np.ndarray,
    densities: np.ndarray,
    features_albedo: np.ndarray,
    features_specular: np.ndarray,
    n_active_features: int,
    density_activation: str = "sigmoid",
    scale_activation: str = "exp",
    radiance_sph_degree: int = 3,
) -> dict:
    """The 3DGUT NuRec renderer config + fp16 state dict."""
    sd: dict = {"._extra_state": {"obj_track_ids": {"gaussians": []}}}

    def put(name, arr, dtype=np.float16):
        a = np.ascontiguousarray(arr).astype(dtype)
        sd[f".gaussians_nodes.gaussians.{name}"] = a.tobytes()
        sd[f".gaussians_nodes.gaussians.{name}.shape"] = list(a.shape)

    put("positions", positions)
    put("rotations", rotations)
    put("scales", scales)
    put("densities", densities.reshape(-1, 1))
    put("features_albedo", features_albedo)
    put("features_specular", features_specular)
    extra = np.zeros((positions.shape[0], 0), dtype=np.float16)
    put("extra_signal", extra)
    sd[".gaussians_nodes.gaussians.n_active_features"] = np.asarray(
        [n_active_features], dtype=np.int64
    ).tobytes()
    sd[".gaussians_nodes.gaussians.n_active_features.shape"] = []

    return {
        "nre_data": {
            "version": "0.2.576",
            "model": "nre",
            "config": {
                "layers": {
                    "gaussians": {
                        "name": "sh-gaussians",
                        "device": "cuda",
                        "density_activation": density_activation,
                        "scale_activation": scale_activation,
                        "rotation_activation": "normalize",
                        "precision": 16,
                        "particle": {
                            "density_kernel_planar": False,
                            "density_kernel_degree": 2,
                            "density_kernel_density_clamping": False,
                            "density_kernel_min_response": 0.0113,
                            "radiance_sph_degree": radiance_sph_degree,
                        },
                        "transmittance_threshold": 0.001,
                    }
                },
                "renderer": {
                    "name": "3dgut-nrend",
                    "log_level": 3,
                    "force_update": False,
                    "update_step_train_batch_end": False,
                    "per_ray_features": False,
                    "global_z_order": False,
                    "projection": {
                        "n_rolling_shutter_iterations": 5,
                        "ut_dim": 3,
                        "ut_alpha": 1.0,
                        "ut_beta": 2.0,
                        "ut_kappa": 0.0,
                        "ut_require_all_sigma_points": False,
                        "image_margin_factor": 0.1,
                        "min_projected_ray_radius": 0.5477225575051661,
                    },
                    "culling": {
                        "rect_bounding": True,
                        "tight_opacity_bounding": True,
                        "tile_based": True,
                        "near_clip_distance": 0.2,
                        "far_clip_distance": 3.402823466e38,
                    },
                    "render": {"mode": "kbuffer", "k_buffer_size": 0},
                },
                "name": "gaussians_primitive",
                "appearance_embedding": {
                    "name": "skip-appearance",
                    "embedding_dim": 0,
                    "device": "cuda",
                },
                "background": {
                    "name": "skip-background",
                    "device": "cuda",
                    "composite_in_linear_space": False,
                },
            },
            "state_dict": sd,
        }
    }


def serialize_nurec(template: dict) -> bytes:
    import msgpack

    buf = io.BytesIO()
    with gzip.GzipFile(fileobj=buf, mode="wb", compresslevel=0) as f:
        f.write(msgpack.packb(template))
    return buf.getvalue()


# 3DGRUT -> USD axis conversion (usd_util.py default_conv_tf), row-major
_CONV_TF = (
    (-1.0, 0.0, 0.0, 0.0),
    (0.0, 0.0, -1.0, 0.0),
    (0.0, -1.0, 0.0, 0.0),
    (0.0, 0.0, 0.0, 1.0),
)

_RENDER_SETTINGS = """        dictionary renderSettings = {
            int "rtx:directLighting:sampledLighting:samplesPerPixel" = 8
            bool "rtx:material:enableRefraction" = 0
            bool "rtx:matteObject:visibility:secondaryRays" = 1
            bool "rtx:post:histogram:enabled" = 0
            bool "rtx:post:registeredCompositing:invertColorCorrection" = 1
            bool "rtx:post:registeredCompositing:invertToneMap" = 1
            int "rtx:post:tonemap:op" = 2
            bool "rtx:raytracing:fractionalCutoutOpacity" = 0
            string "rtx:rendermode" = "RaytracedLighting"
        }
"""


def gauss_usda_text(nurec_filename: str, positions: np.ndarray) -> str:
    """Handwritten gauss.usda: UsdVol Volume + NuRec field assets."""
    mn = positions.min(axis=0).astype(float)
    mx = positions.max(axis=0).astype(float)
    # usda matrices are row-major tuples of rows
    m = ", ".join(
        "(" + ", ".join(f"{v}" for v in row) + ")" for row in _CONV_TF
    )
    return f'''#usda 1.0
(
    customLayerData = {{
{_RENDER_SETTINGS}    }}
    defaultPrim = "World"
    metersPerUnit = 1
    upAxis = "Z"
)

def Xform "World"
{{
    def Volume "gauss"
    {{
        float3[] extent = [({mn[0]}, {mn[1]}, {mn[2]}), ({mx[0]}, {mx[1]}, {mx[2]})]
        bool omni:nurec:isNuRecVolume = 1
        bool omni:nurec:useProxyTransform = 0
        float3 omni:nurec:offset = (0, 0, 0)
        float3 omni:nurec:crop:minBounds = ({mn[0]}, {mn[1]}, {mn[2]})
        float3 omni:nurec:crop:maxBounds = ({mx[0]}, {mx[1]}, {mx[2]})
        rel field:density = </World/gauss/density_field>
        rel field:emissiveColor = </World/gauss/emissive_color_field>
        rel proxy
        matrix4d xformOp:transform = ( {m} )
        uniform token[] xformOpOrder = ["xformOp:transform"]

        def OmniNuRecFieldAsset "density_field"
        {{
            asset filePath = @./{nurec_filename}@
            token fieldName = "density"
            token fieldDataType = "float"
            token fieldRole = "density"
        }}

        def OmniNuRecFieldAsset "emissive_color_field"
        {{
            asset filePath = @./{nurec_filename}@
            token fieldName = "emissiveColor"
            token fieldDataType = "float3"
            token fieldRole = "emissiveColor"
            float4 omni:nurec:ccmR = (1, 0, 0, 0)
            float4 omni:nurec:ccmG = (0, 1, 0, 0)
            float4 omni:nurec:ccmB = (0, 0, 1, 0)
        }}
    }}
}}
'''


def default_usda_text() -> str:
    return f'''#usda 1.0
(
    customLayerData = {{
{_RENDER_SETTINGS}    }}
    defaultPrim = "World"
    metersPerUnit = 1
    upAxis = "Z"
)

def Xform "World"
{{
    over "gauss" (
        prepend references = @gauss.usda@
    )
    {{
    }}
}}
'''


def export_gaussians_usdz(
    out_path: str,
    means: np.ndarray,          # [N, 3]
    quats: np.ndarray,          # [N, 4] pre-activation (normalized at load)
    log_scales: np.ndarray,     # [N, 3] pre-activation (exp at load)
    opacity_logits: np.ndarray, # [N] pre-activation (sigmoid at load)
    sh0: np.ndarray,            # [N, 3] DC SH coefficients (albedo)
    shN: np.ndarray,            # [N, M] higher-order SH, channel-flattened
    sh_degree: int = 3,
) -> str:
    """Write a 3dgrut-schema USDZ consumable by Omniverse Kit / Isaac Sim."""
    means = np.asarray(means, np.float32)
    template = nurec_template(
        positions=means,
        rotations=np.asarray(quats, np.float32),
        scales=np.asarray(log_scales, np.float32),
        densities=np.asarray(opacity_logits, np.float32),
        features_albedo=np.asarray(sh0, np.float32),
        features_specular=np.asarray(shN, np.float32).reshape(len(means), -1),
        n_active_features=sh_degree,
        radiance_sph_degree=sh_degree,
    )
    nurec_name = os.path.splitext(os.path.basename(out_path))[0] + ".nurec"
    payload = serialize_nurec(template)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with zipfile.ZipFile(out_path, "w", compression=zipfile.ZIP_STORED) as z:
        # default layer first (USDZ spec: first member is the root layer)
        z.writestr("default.usda", default_usda_text())
        z.writestr(nurec_name, payload)
        z.writestr("gauss.usda", gauss_usda_text(nurec_name, means))
    return out_path


def export_from_gaussian_dict(out_path: str, g: dict,
                              sh_degree: int = 3) -> str:
    """USDZ from a GoM/GS gaussian dict (compose_for_export /
    read_gaussian_ply layout: means, quats, log_scales, opacity_logits,
    features_dc [N,3], features_rest [N,B,3])."""
    n = len(g["means"])
    rest = np.asarray(g["features_rest"])
    shN = rest.transpose(0, 2, 1).reshape(n, -1) if rest.size else \
        np.zeros((n, 0), np.float32)
    return export_gaussians_usdz(
        out_path,
        means=g["means"],
        quats=g["quats"],
        log_scales=g["log_scales"],
        opacity_logits=np.asarray(g["opacity_logits"]).reshape(-1),
        sh0=g["features_dc"],
        shN=shN,
        sh_degree=sh_degree,
    )


def read_gaussians_usdz(path: str) -> dict:
    """Round-trip reader: parse the .nurec state dict back to numpy (for
    tests and pipeline verification)."""
    import msgpack

    with zipfile.ZipFile(path) as z:
        names = z.namelist()
        nurec = [n for n in names if n.endswith(".nurec")]
        assert nurec, f"no .nurec member in {path}"
        assert "default.usda" in names and "gauss.usda" in names
        raw = gzip.decompress(z.read(nurec[0]))
        tpl = msgpack.unpackb(raw, strict_map_key=False)
        usda = z.read("gauss.usda").decode()
    sd = tpl["nre_data"]["state_dict"]

    def get(name, dtype=np.float16):
        buf = sd[f".gaussians_nodes.gaussians.{name}"]
        shape = sd[f".gaussians_nodes.gaussians.{name}.shape"]
        return np.frombuffer(buf, dtype=dtype).reshape(shape)

    return {
        "positions": get("positions"),
        "rotations": get("rotations"),
        "scales": get("scales"),
        "densities": get("densities"),
        "features_albedo": get("features_albedo"),
        "features_specular": get("features_specular"),
        "n_active_features": int(
            np.frombuffer(
                sd[".gaussians_nodes.gaussians.n_active_features"], np.int64
            )[0]
        ),
        "config": tpl["nre_data"]["config"],
        "gauss_usda": usda,
    }


def main(argv=None):
    """PLY -> USDZ CLI (reference threedgrut/export/scripts/ply_to_usd.py).

    Usage: python -m holoscene_tpu_torch.export.gs_usdz input.ply [--output_file x.usdz]
    """
    import argparse

    from holoscene_tpu_torch.models.gom import read_gaussian_ply

    ap = argparse.ArgumentParser(description="Convert 3DGS PLY to USDZ")
    ap.add_argument("input_file")
    ap.add_argument("--output_file", default=None)
    ap.add_argument("--sh_degree", type=int, default=3)
    args = ap.parse_args(argv)
    out = args.output_file or os.path.splitext(args.input_file)[0] + ".usdz"
    g = read_gaussian_ply(args.input_file)
    export_from_gaussian_dict(out, g, sh_degree=args.sh_degree)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
