"""Run-dir-aware scene export CLI of the port (the port's copy of
holoscene_tpu/export/cli.py, numpy only) — the analog of the reference's
export/export_glb.py, export/export_usd.py and export/export_gs_usd.py
drivers (each takes --conf/--timestamp, collects the trained run's
artifacts from <exps>/<expname>/<timestamp>/plots, and writes the scene
file). One module, three subcommands:

    python -m holoscene_tpu_torch.export.cli glb  --conf confs/replica_room0_tex.conf
    python -m holoscene_tpu_torch.export.cli usd  --conf ... [--timestamp latest]
    python -m holoscene_tpu_torch.export.cli gs   --conf ...   # NuRec USDZ

Artifact discovery (all optional beyond the meshes):
  * meshes: surface_{i}.obj (Stage-3 textured) else coarse_recon_obj_{i}.ply
    (Stage-2) — reference export_glb.py reads the same trail
  * textures: surface_{i}.png baked atlases
  * translations: translation_dict.pkl (Stage-2 solve_intersection)
  * gaussians: gauss_scene.ply (Stage-4 export)
"""
from __future__ import annotations

import argparse
import glob
import os
import pickle

import numpy as np

from holoscene_tpu_torch.config import ConfigFactory
from holoscene_tpu_torch.training import checkpoints as ckpt_lib


def _rundir(args) -> str:
    conf = ConfigFactory.parse_file(args.conf)
    expname = conf.get_string("train.expname", "holoscene")
    expdir = os.path.join(args.exps_folder, expname)
    timestamp = (
        ckpt_lib.latest_timestamp(expdir)
        if args.timestamp == "latest"
        else args.timestamp
    )
    assert timestamp, f"no run found under {expdir}"
    return os.path.join(expdir, timestamp)


def _collect_meshes(plots_dir: str):
    """(meshes, texture_png_bytes, texture_paths) indexed BY OBJECT ID —
    a failed/missing object leaves a None gap so translations (keyed by id
    in translation_dict.pkl) never shift onto the wrong mesh. Textured
    Stage-3 surfaces win over Stage-2 coarse meshes per object."""
    from holoscene_tpu_torch.utils.mesh import read_obj, read_ply

    def obj_id(path: str) -> int:
        return int(os.path.splitext(path)[0].rsplit("_", 1)[1])

    by_id: dict[int, str] = {}
    for p in glob.glob(os.path.join(plots_dir, "coarse_recon_obj_*.ply")):
        by_id[obj_id(p)] = p
    for p in glob.glob(os.path.join(plots_dir, "surface_*.obj")):
        by_id[obj_id(p)] = p
    assert by_id, f"no meshes (surface_*.obj / coarse_recon_obj_*.ply) in {plots_dir}"

    n = max(by_id) + 1
    meshes: list = [None] * n
    pngs: list = [None] * n
    png_paths: dict[int, str] = {}
    for i, p in by_id.items():
        meshes[i] = read_obj(p) if p.endswith(".obj") else read_ply(p)
        png = os.path.splitext(p)[0] + ".png"
        if p.endswith(".obj") and os.path.exists(png):
            pngs[i] = open(png, "rb").read()
            png_paths[i] = png
    return meshes, pngs, png_paths


def _translations(plots_dir: str) -> dict[int, np.ndarray]:
    p = os.path.join(plots_dir, "translation_dict.pkl")
    if not os.path.exists(p):
        return {}
    with open(p, "rb") as f:
        raw = pickle.load(f)
    return {int(k): np.asarray(v, dtype=np.float32) for k, v in raw.items()}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("what", choices=["glb", "usd", "gs"])
    parser.add_argument("--conf", type=str, required=True)
    parser.add_argument("--exps_folder", type=str, default="exps")
    parser.add_argument("--timestamp", type=str, default="latest")
    parser.add_argument("--out", type=str, default=None,
                        help="output path (default: <rundir>/plots/scene.*)")
    args = parser.parse_args(argv)

    plots_dir = os.path.join(_rundir(args), "plots")

    if args.what == "gs":
        from holoscene_tpu_torch.export.gs_usdz import export_from_gaussian_dict
        from holoscene_tpu_torch.models.gom import read_gaussian_ply

        ply = os.path.join(plots_dir, "gauss_scene.ply")
        assert os.path.exists(ply), f"no Stage-4 gaussians at {ply}"
        out = args.out or os.path.join(plots_dir, "scene_gs.usdz")
        export_from_gaussian_dict(out, read_gaussian_ply(ply))
        print(f"wrote {out}")
        return out

    meshes, pngs, png_paths = _collect_meshes(plots_dir)
    translations = _translations(plots_dir)
    if args.what == "glb":
        from holoscene_tpu_torch.export.glb import export_glb

        # export_glb applies translations by list position — compact the
        # id-indexed lists and remap the id-keyed translations accordingly
        keep = [i for i, m in enumerate(meshes) if m is not None]
        glb_meshes = [meshes[i] for i in keep]
        glb_pngs = [pngs[i] for i in keep]
        glb_tr = {pos: translations[i] for pos, i in enumerate(keep)
                  if i in translations}
        out = args.out or os.path.join(plots_dir, "scene.glb")
        export_glb(out, glb_meshes, textures_png=glb_pngs,
                   translations=glb_tr)
        print(f"wrote {out} ({len(glb_meshes)} meshes, "
              f"{sum(p is not None for p in glb_pngs)} textured)")
        return out

    from holoscene_tpu_torch.export.usd import export_usd

    out_dir = args.out or os.path.join(plots_dir, "usd")
    stage = export_usd(out_dir, meshes, translations=translations,
                       textures=png_paths)
    print(f"wrote {stage}")
    return stage


if __name__ == "__main__":
    main()
