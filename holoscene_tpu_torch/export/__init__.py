"""Exporters of the port: GLB, USD (+PhysX), gaussian USDZ / PLY / INGP."""

from __future__ import annotations


def export_gaussian_artifact(path: str, g: dict) -> str:
    """Write a gaussian dict (read_gaussian_ply layout) in the format the
    path's extension picks: .ply (3DGS), .usdz (NuRec, Kit/Isaac) or
    .ingp (Instant-NGP) — the reference's three exporter backends
    (threedgrut/export/{ply,usdz,ingp}_exporter.py)."""
    if path.endswith(".usdz"):
        from holoscene_tpu_torch.export import gs_usdz

        gs_usdz.export_from_gaussian_dict(path, g)
    elif path.endswith(".ingp"):
        from holoscene_tpu_torch.export.gs_ingp import export_gaussians_ingp

        export_gaussians_ingp(path, g)
    elif path.endswith(".ply"):
        from holoscene_tpu_torch.models.gom import write_gaussian_ply

        write_gaussian_ply(path, g)
    else:
        raise ValueError(
            f"unknown gaussian artifact extension: {path!r} "
            "(expected .ply, .usdz or .ingp)"
        )
    return path
