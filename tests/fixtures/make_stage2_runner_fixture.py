"""Record what the JAX Stage2Runner writes on the fixture of
tests/test_stage2_runner.py (6 images at 32^2, mesh resolution 32, 2
finetune iterations), so the port's runner test can hold its artifacts to
the reference without running the JAX runner again (it takes minutes on a
CPU). Writes tests/fixtures/stage2_runner_tiny.json:

    JAX_PLATFORMS=cpu python tests/fixtures/make_stage2_runner_fixture.py

Recorded: the artifact file names, the keys of every pickled / JSON
artifact (each vis_info pack's, bg_info's, scene_settle.json's), the
graph, the object order, which objects have a mesh, and the returned
result's keys."""

from __future__ import annotations

import json
import os
import pickle
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from holoscene_tpu.datasets.ns_dataset import NSDataset  # noqa: E402
from holoscene_tpu.datasets.synthetic import generate_scene  # noqa: E402
from holoscene_tpu.losses.holoscene_loss import LossConfig  # noqa: E402
from holoscene_tpu.models.holoscene import init_holoscene  # noqa: E402
from holoscene_tpu.stage2.refine import FinetuneConfig  # noqa: E402
from holoscene_tpu.stage2.runner import Stage2Runner  # noqa: E402
from test_stage2_runner import tiny_cfg  # noqa: E402


def _keys(obj):
    if isinstance(obj, dict):
        return {str(k): _keys(v) for k, v in obj.items()}
    if isinstance(obj, list) and obj and isinstance(obj[0], dict):
        return [sorted(map(str, o)) for o in obj]
    return None


def main():
    with tempfile.TemporaryDirectory() as tmp:
        generate_scene(os.path.join(tmp, "scene_0"), n_images=6,
                       img_res=(32, 32))
        ds = NSDataset(tmp, "scene_0", img_res=(32, 32))
        cfg = tiny_cfg(len(ds.label_mapping))
        params = init_holoscene(jax.random.PRNGKey(0), cfg)
        out = os.path.join(tmp, "s2")
        runner = Stage2Runner(
            params, cfg, ds, out_dir=out,
            loss_cfg=LossConfig(depth_weight=0.1, semantic_weight=0.5),
            finetune_cfg=FinetuneConfig(iters=2, rays_per_step=64,
                                        invis_pixels=64, collision_pts=128),
            mesh_resolution=32, view_render_res=24, candidate_levels=(0.0,),
            quiet=True)
        order = []
        finetune = runner.finetune_object

        def record(obj_i, *a, **kw):
            order.append(obj_i)
            return finetune(obj_i, *a, **kw)

        runner.finetune_object = record
        result = runner.run(finetune_iters=2)
        files = sorted(os.listdir(out))
        artifacts = {}
        for name in files:
            path = os.path.join(out, name)
            if name.endswith(".pkl"):
                with open(path, "rb") as f:
                    artifacts[name] = _keys(pickle.load(f))
            elif name.endswith(".json"):
                with open(path) as f:
                    artifacts[name] = sorted(json.load(f))
        rec = {
            "files": files,
            "artifact_keys": artifacts,
            "graph": {str(k): v for k, v in result["graph"].items()},
            "object_order": order,
            "result_keys": sorted(result),
            "meshes": [m is not None for m in result["meshes"]],
        }
    with open(os.path.join(HERE, "stage2_runner_tiny.json"), "w") as f:
        json.dump(rec, f, indent=1, sort_keys=True)


if __name__ == "__main__":
    main()
