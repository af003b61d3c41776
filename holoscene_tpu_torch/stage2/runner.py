"""Stage-2 runner: generative per-object refinement + physics validation
(port of holoscene_tpu/stage2/runner.py).

Reference semantics: training/holoscene_train_post.py
(`HoloSceneTrainPostRunner`) — the orchestration is:

  run() (:393):
    1. extract + prune instance meshes, per-object bboxes (:405-412)
    2. infer the scene graph from meshes when graph.json is absent (:414)
    3. background: inpaint occluded regions + 500-iter local SDF finetune
       (:446-452)
    4. generative_sampling (:733), per object sorted by distance-to-root:
       a. view-weight analysis over an (azimuth, elevation) grid (:885)
       b. render the object orthographically; inpaint occluder regions
          (LaMa; :1013-1080)
       c. if view coverage is poor: novel views from the provider, with a
          seed-retry ladder (:1591-1595)
       d. per-object SDF finetune under generated-view + parent-collision
          constraints (:3394)
       e. marching-cubes candidates at several prune thresholds; accept the
          first that passes sim_validation (< 8 deg drift) (:1697-1966),
          falling back to the best unstable candidate (:1972-1978)
       f. export coarse_recon_obj_{i}.ply + vis_info_{i}.pkl (:1981-1989)
    5. solve_intersection -> translation_dict.pkl (:2002)
    6. final whole-scene sim_scene (:2003)

The device work (grid evaluations through H2, the finetune steps through
H1 / H2, the object renders, every rasterization) runs on the runner's
`device` (cuda unless the caller asks for the CPU, where the kernels' plain
versions run); meshes, views, physics and remeshing stay on the host. The
finetune steps draw their random numbers from one torch.Generator seeded
by `seed` (JAX splits one key); the host's numpy rng keeps JAX's call
order. `timer` (utils/logging.py::StepTimer) keeps the wall table by part;
`object_report` keeps what the novel views and coarse_recon gave each
object, and the errors that their catch-alls caught.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle

import numpy as np
import torch

from holoscene_tpu_torch import as_tensor, resolve_device
from holoscene_tpu_torch.losses.holoscene_loss import LossConfig
from holoscene_tpu_torch.models.fields import (
    implicit_sdf_raw_grid,
    implicit_shift_sdf_raw,
)
from holoscene_tpu_torch.models.holoscene import (
    HoloSceneConfig,
    HoloSceneModel,
    render_rays_only_multi_obj,
)
from holoscene_tpu_torch.ops.rays import get_orthographic_rays
from holoscene_tpu_torch.physics import (
    provider_report,
    settle_drop,
    sim_scene,
    sim_validation,
)
from holoscene_tpu_torch.stage2.inpaint_views import (
    inpaint_object_view,
    occluded_region,
)
from holoscene_tpu_torch.stage2.providers import default_providers, save_vis_info
from holoscene_tpu_torch.stage2.refine import (
    FinetuneConfig,
    FinetuneDraws,
    finetune_step,
    make_finetune_optimizer,
    sample_collision_points,
)
from holoscene_tpu_torch.stage2.remesh import CoarseReconConfig, coarse_recon
from holoscene_tpu_torch.stage2.scene_graph import (
    create_scene_graph_from_meshes,
    solve_intersection,
)
from holoscene_tpu_torch.stage2.views import (
    integrated_view_coverage,
    select_best_views,
    training_view_vertex_visibility,
    wonder3d_camera_rig,
)
from holoscene_tpu_torch.utils.logging import StepTimer
from holoscene_tpu_torch.utils.mc import evaluate_sdf_grid, marching_tetrahedra
from holoscene_tpu_torch.utils.mesh import Mesh, write_ply
from holoscene_tpu_torch.utils.plots import extract_object_meshes


class Stage2Runner:
    def __init__(
        self,
        model: HoloSceneModel,
        model_cfg: HoloSceneConfig,
        dataset,
        out_dir: str = "stage2_out",
        loss_cfg: LossConfig | None = None,
        finetune_cfg: FinetuneConfig = FinetuneConfig(),
        providers: dict | None = None,
        mesh_resolution: int = 128,
        view_render_res: int = 64,
        coverage_threshold: float = 0.55,
        stability_threshold_deg: float = 8.0,
        candidate_levels: tuple[float, ...] = (0.0, 0.003, 0.006),
        seeds: tuple[int, ...] = (42, 43, 44),
        seed: int = 0,
        quiet: bool = False,
        view_mesh_cap: int = 200_000,
        device: str = "cuda",
    ):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.model = model.to(self.device)
        self.cfg = model_cfg
        self.dataset = dataset
        self.out_dir = out_dir
        self.lcfg = loss_cfg or LossConfig()
        self.fcfg = finetune_cfg
        self.mesh_resolution = mesh_resolution
        self.view_render_res = view_render_res
        self.coverage_threshold = coverage_threshold
        self.stability_threshold = stability_threshold_deg
        self.candidate_levels = candidate_levels
        self.seeds = seeds
        self.quiet = quiet
        # face cap for the VIEW machinery only (view selection, visibility
        # integration, occlusion masks, stability sims) — pixel-level
        # silhouettes at view_render_res don't need res>=256 meshes.
        # Final geometry is never capped.
        self.view_mesh_cap = view_mesh_cap
        self._view_mesh_cache: dict[int, tuple] = {}
        os.makedirs(out_dir, exist_ok=True)
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.failed_object_list: list[int] = []
        self.providers = providers or default_providers(
            render_fn=self._render_view_pack_factory(), device=self.device)
        self._current_obj: int | None = None
        self.timer = StepTimer(sync=(
            (lambda: torch.cuda.synchronize(self.device))
            if self.device.type == "cuda" else None))
        # every finetune step's metrics, tagged with its object
        self.finetune_history: list[dict] = []
        # what each refined object's generative steps gave: novel views
        # (their count; None when coverage did not ask for them),
        # coarse_recon (its candidate's faces; None when it did not run)
        # and the errors that the seed ladder and coarse_recon caught
        self.object_report: dict[int, dict] = {}

    # ------------------------------------------------------------------
    # rendering helpers
    # ------------------------------------------------------------------

    def _view_mesh(self, m: Mesh | None) -> Mesh | None:
        """Decimated stand-in (<= view_mesh_cap faces) for view-selection /
        visibility / occlusion / simulation queries; cached per source mesh.
        The cache holds the source too, so a recycled id() cannot alias."""
        if m is None or len(m.faces) <= self.view_mesh_cap:
            return m
        hit = self._view_mesh_cache.get(id(m))
        if hit is None or hit[0] is not m:
            hit = (m, m.decimate(self.view_mesh_cap))
            self._view_mesh_cache[id(m)] = hit
        return hit[1]

    def _ortho_uv(self, res: int) -> torch.Tensor:
        ys, xs = np.mgrid[0:res, 0:res]
        uv = np.stack(
            [(xs + 0.5) / res * 2 - 1, (ys + 0.5) / res * 2 - 1], axis=-1
        ).reshape(-1, 2)
        return as_tensor(uv.astype(np.float32), self.device)

    def render_object_view(self, obj_i: int, pose: np.ndarray,
                           half_extent: float, res: int | None = None,
                           chunk: int = 4096) -> dict:
        """Isolated orthographic render of one object (reference
        forward_only_multi_obj_rays over ray chunks,
        holoscene_train_post.py:973): eval mode on the device, numpy
        rgb / normal [res, res, 3], depth [res, res], mask (acc > 0.5)."""
        res = res or self.view_render_res
        pose_t = as_tensor(pose, self.device)
        rays_o, rays_d = get_orthographic_rays(self._ortho_uv(res), pose_t,
                                               half_extent)
        keys = ("rgb_values", "normal_map", "depth_values", "acc")
        outs = {k: [] for k in keys}
        with torch.no_grad():
            for i in range(0, rays_o.shape[0], chunk):
                ro = rays_o[i:i + chunk]
                out = render_rays_only_multi_obj(
                    self.model, ro, rays_d[i:i + chunk],
                    torch.ones(ro.shape[0], 1, device=self.device),
                    pose_t[:3, :3].T, (obj_i,), training=False)
                for k in keys:
                    outs[k].append(out[k])
        o = {k: torch.cat(v).cpu().numpy() for k, v in outs.items()}
        return {
            "rgb": o["rgb_values"].reshape(res, res, 3),
            "normal": o["normal_map"].reshape(res, res, 3),
            "depth": o["depth_values"].reshape(res, res),
            "mask": o["acc"].reshape(res, res) > 0.5,
        }

    def _render_view_pack_factory(self):
        def render_fn(pose, seed):
            obj_i = self._current_obj if self._current_obj is not None else 0
            pack = self.render_object_view(obj_i, pose,
                                           self._current_half_extent)
            return {"rgb": pack["rgb"], "normal": pack["normal"],
                    "mask": pack["mask"]}

        return render_fn

    # ------------------------------------------------------------------
    # pipeline steps
    # ------------------------------------------------------------------

    def _shift_sdf_raw(self, pts):
        return implicit_shift_sdf_raw(self.model.implicit, pts)

    def _sdf_raw(self, pts):
        return implicit_sdf_raw_grid(self.model.implicit, pts)

    def extract_meshes(self) -> list[Mesh | None]:
        """Per-object meshes of the disentangled SDF (the grid evaluator,
        H2 packed), at mesh_resolution on the device. The disentangled
        selector can empty an object whose region is not yet won on an
        undertrained model: those objects alone are re-extracted from
        their plain SDF."""
        meshes = extract_object_meshes(
            self._shift_sdf_raw, self.cfg.implicit.d_out,
            resolution=self.mesh_resolution, device=self.device)
        missing = {i for i, m in enumerate(meshes) if m is None}
        if missing:
            plain = extract_object_meshes(
                self._sdf_raw, self.cfg.implicit.d_out,
                resolution=self.mesh_resolution, device=self.device,
                only=missing)
            meshes = [m if m is not None else p
                      for m, p in zip(meshes, plain)]
        return meshes

    def object_mesh_candidates(self, obj_i: int) -> list[Mesh]:
        """Marching-cubes candidates at multiple prune thresholds
        (marching_cubes_from_sdf_center_scale_rm_intersect,
        utils/general.py:3687). The object's grid is evaluated once and
        triangulated at each level (JAX evaluates it again for each level:
        the same values). Candidates stay RAW (floaters included):
        stability_ladder tests the raw mesh first and applies
        largest_component as a rescue re-test on failure."""
        candidates = []
        for fn in (self._shift_sdf_raw, self._sdf_raw):
            # the plain SDF only when the disentangled one gives nothing
            grid, origin, spacing = evaluate_sdf_grid(
                lambda pts: fn(pts)[:, obj_i], self.mesh_resolution,
                device=self.device)
            for level in self.candidate_levels:
                v, f = marching_tetrahedra(grid, level=level, origin=origin,
                                           spacing=spacing)
                if len(f):
                    candidates.append(Mesh(v, f))
            if candidates:
                break
        return candidates

    def stability_ladder(self, obj_i: int, support_meshes: list[Mesh],
                         extra_candidates: list[Mesh] = ()):
        """Try candidates until one passes sim_validation (< 8 deg)
        (holoscene_train_post.py:1697-1978). An unstable candidate gets a
        floater-cleanup re-test (reference clean_mesh_floaters_adjust +
        re-validation, :1835-1850)."""
        best = None
        best_drift = np.inf
        supports_v = [self._view_mesh(s) for s in support_meshes]
        # geometric sanity gate BEFORE physics: a candidate far outside the
        # normalized scene volume is corrupt regardless of its sim drift
        sane_r = self.sanity_radius

        def _sane(c):
            v = np.asarray(c.vertices)
            ok = len(v) > 0 and np.isfinite(v).all() and \
                float(np.abs(v).max()) <= sane_r
            if not ok and not self.quiet:
                print(f"  [obj {obj_i}] candidate REJECTED by sanity gate "
                      f"(extent {float(np.abs(v).max()) if len(v) else 0:.1f}"
                      f" > {sane_r:.1f})", flush=True)
            return ok

        for cand in filter(_sane, [*self.object_mesh_candidates(obj_i),
                                   *extra_candidates]):
            res = sim_validation([*supports_v, self._view_mesh(cand)])
            if not self.quiet:
                print(f"  [obj {obj_i}] candidate drift={res.drift_deg:.1f}deg",
                      flush=True)
            if res.drift_deg < best_drift:
                best, best_drift = cand, res.drift_deg
            if res.drift_deg < self.stability_threshold:
                # ship floater-free when cleanup keeps the mesh stable
                cleaned = cand.largest_component()
                if len(cleaned.faces) < len(cand.faces):
                    res_c = sim_validation(
                        [*supports_v, self._view_mesh(cleaned)])
                    if res_c.drift_deg < self.stability_threshold:
                        return cleaned, res_c.drift_deg, True
                return cand, res.drift_deg, True
            cleaned = cand.largest_component()
            if len(cleaned.faces) < len(cand.faces):
                res2 = sim_validation([*supports_v, self._view_mesh(cleaned)])
                if not self.quiet:
                    print(f"  [obj {obj_i}] floater-cleaned re-test "
                          f"drift={res2.drift_deg:.1f}deg", flush=True)
                if res2.drift_deg < best_drift:
                    best, best_drift = cleaned, res2.drift_deg
                if res2.drift_deg < self.stability_threshold:
                    return cleaned, res2.drift_deg, True
        if best is None:
            self.failed_object_list.append(obj_i)
        return best, best_drift, False

    def _report(self, obj_i: int) -> dict:
        return self.object_report.setdefault(
            obj_i, {"novel_views": None, "coarse_recon": None, "errors": []})

    @property
    def sanity_radius(self) -> float:
        """A candidate with a vertex farther than this (3x the scene's
        bounding sphere) is corrupt, whatever its drift."""
        return 3.0 * float(self.cfg.scene_bounding_sphere)

    def generate_novel_views(self, obj_i: int, mesh: Mesh,
                             half_extent: float) -> list[dict]:
        """Novel views from the provider with the Wonder3D rig + seed-retry
        (holoscene_train_post.py:1591-1595). Returns vis_info-style packs."""
        b = mesh.bounds
        center = (b[0] + b[1]) / 2
        radius = float(np.linalg.norm(b[1] - b[0])) * 1.2
        rig = wonder3d_camera_rig(center, radius)
        front = self.render_object_view(obj_i, rig[0], half_extent)

        provider = self.providers.get("novel_view")
        self._current_obj = obj_i
        self._current_half_extent = half_extent
        views = None
        for seed in self.seeds:
            try:
                views = provider.generate_views(
                    front["rgb"], front["mask"], rig, seed=seed, obj_i=obj_i
                )
                break
            except Exception as e:  # retry ladder
                self._report(obj_i)["errors"].append(
                    f"novel-view seed {seed}: {e!r}")
                if not self.quiet:
                    print(f"  [obj {obj_i}] novel-view seed {seed} failed: {e}")
        if views is None:
            return []
        packs = []
        for vi, (pose, v) in enumerate(zip(rig, views)):
            pack = {
                # recorded packs (CachedArtifactNovelViewProvider) carry
                # their own camera; live providers inherit the rig pose
                "pose": np.asarray(v.get("pose", pose), dtype=np.float32),
                "half_extent": float(v.get("half_extent", half_extent)),
                "rgb": np.asarray(v["rgb"], dtype=np.float32),
                "normal": np.asarray(v["normal"], dtype=np.float32),
                "mask": np.asarray(v["mask"], dtype=bool),
                # rig[0] is the observed FRONT view — its silhouette is
                # trusted 25x (reference lambda_mask boost, :566)
                "front": bool(v.get("front", vi == 0)),
            }
            if v.get("depth") is not None:  # recorded packs may carry depth
                pack["depth"] = np.asarray(v["depth"], dtype=np.float32)
                pack["depth_mask"] = np.asarray(
                    v.get("depth_mask", v["mask"]), dtype=bool
                )
            packs.append(pack)
        return packs

    def object_view_packs(
        self,
        obj_i: int,
        meshes: list[Mesh | None],
        best_views: list[tuple[np.ndarray, float]],
        half_extent: float,
    ) -> list[dict]:
        """Render the object from its best views, inpaint the regions
        occluded by other scene objects, and gate by depth->normal
        consistency (holoscene_train_post.py:1013-1112). Returns
        vis_info-style packs consumed by invisible_view_loss."""
        inpaint = self.providers.get("inpaint")
        obj_mesh = self._view_mesh(meshes[obj_i])
        occluders = [
            self._view_mesh(m)
            for j, m in enumerate(meshes) if j != obj_i and m is not None
        ]
        packs = []
        for pose, weight in best_views:
            view = self.render_object_view(obj_i, pose, half_extent)
            occ, self_vis = occluded_region(
                obj_mesh, occluders, pose, half_extent,
                self.view_render_res, device=self.device,
            )
            if occ.sum() == 0 or inpaint is None:
                gated = {
                    "rgb": view["rgb"], "normal": view["normal"],
                    "depth": view["depth"], "mask": view["mask"],
                    "nm_mask": view["mask"], "depth_mask": view["mask"],
                    "sm_mask": occ, "deviated": False,
                }
            else:
                gated = inpaint_object_view(
                    view, occ, self_vis, inpaint, half_extent
                )
            packs.append(
                {
                    "pose": np.asarray(pose, dtype=np.float32),
                    "half_extent": float(half_extent),
                    "rgb": gated["rgb"].astype(np.float32),
                    "normal": gated["normal"].astype(np.float32),
                    "depth": gated["depth"].astype(np.float32),
                    "mask": gated["mask"].astype(bool),
                    "nm_mask": gated["nm_mask"].astype(bool),
                    "depth_mask": gated["depth_mask"].astype(bool),
                    "sm_mask": gated["sm_mask"].astype(bool),
                    "weight": float(weight),
                    "deviated": bool(gated.get("deviated", False)),
                    "source": "inpaint",
                }
            )
            if not self.quiet and occ.sum() > 0:
                print(
                    f"  [obj {obj_i}] inpainted view: {int(occ.sum())} px "
                    f"occluded, deviated={gated.get('deviated', False)}",
                    flush=True)
        return packs

    def background_packs(self, max_views: int = 4) -> list[dict]:
        """Inpaint background regions occluded by foreground objects in
        training views (background_inpainting_sampling,
        holoscene_train_post.py:2703 + LaMa passes :1013-1080) ->
        bg_info-style supervision packs over PERSPECTIVE training views.
        Each connected occluded region is inpainted on its own, specks
        below 0.2% of the frame skipped."""
        from scipy import ndimage

        inpaint = self.providers.get("inpaint")
        h, w = self.dataset.img_res
        packs = []
        n = min(max_views, self.dataset.n_images)
        frame_ids = np.linspace(0, self.dataset.n_images - 1, n).astype(int)
        for fi in frame_ids:
            sem = self.dataset.semantic_images[fi].reshape(h, w)
            occluded = sem != 0
            if occluded.mean() < 0.01:
                continue
            rgb = self.dataset.rgb_images[fi].reshape(h, w, 3)
            normal = self.dataset.normal_images[fi].reshape(h, w, 3)
            depth = self.dataset.depth_images[fi].reshape(h, w)
            labels, n_comp = ndimage.label(occluded)
            rgb_in, normal_in = rgb.copy(), normal.copy()
            depth_in = depth.copy()
            filled = np.zeros_like(occluded)
            for ci in range(1, n_comp + 1):
                cluster = labels == ci
                if cluster.mean() < 0.002:
                    continue
                rgb_in = np.where(
                    cluster[..., None], inpaint.inpaint(rgb, cluster), rgb_in
                )
                normal_in = np.where(
                    cluster[..., None], inpaint.inpaint(normal, cluster),
                    normal_in,
                )
                depth_in = np.where(
                    cluster,
                    inpaint.inpaint(depth[..., None], cluster)[..., 0],
                    depth_in,
                )
                filled |= cluster
            occluded = filled
            if occluded.mean() < 0.01:
                continue
            packs.append(
                {
                    "frame": int(fi),
                    "pose": self.dataset.pose_all[fi],
                    "rgb": rgb_in.astype(np.float32),
                    "normal": normal_in.astype(np.float32),
                    "depth": depth_in.astype(np.float32),
                    # supervise exactly the regions that WERE occluded
                    "mask": occluded,
                }
            )
        return packs

    def _class_batch(self, m: int, class_id: int) -> dict:
        """A class-targeted ray batch of the dataset on the device."""
        _, sample, gt = self.dataset.sample_rays(m, class_id=class_id)
        batch = {k: as_tensor(sample[k], self.device)
                 for k in ("uv", "pose", "intrinsics")}
        batch.update({k: as_tensor(gt[k], self.device)
                      for k in ("rgb", "depth", "normal", "mask")})
        batch["segs"] = torch.as_tensor(np.asarray(gt["segs"]),
                                        dtype=torch.int64, device=self.device)
        return batch

    def _step(self, obj_i, optimizer, scheduler, lcfg, batch, gen_view,
              coll_pts, coll_sdf, it, total):
        draws = FinetuneDraws.make(
            self.model, batch["uv"].shape[0], self.fcfg.invis_pixels,
            self.generator, self.device, use_invis=gen_view is not None)
        metrics = finetune_step(
            self.model, optimizer, scheduler, lcfg, self.fcfg, obj_i, batch,
            gen_view, 1.0, coll_pts, coll_sdf, draws)
        self.finetune_history.append({"obj": obj_i, "iter": it, **metrics})
        if not self.quiet and (it % 50 == 0 or it == total - 1):
            tag = "bg" if gen_view is None and obj_i == 0 else f"obj {obj_i}"
            print(f"  [{tag}] it {it} loss={float(metrics['loss']):.4f} "
                  f"coll={float(metrics['collision_loss']):.4f}", flush=True)

    def background_reconstruction(self, n_iters: int | None = None,
                                  bg_packs: list[dict] | None = None):
        """Finetune object 0 under inpainted-background supervision
        (background_reconstruction, holoscene_train_post.py:3245).
        n_iters falsy (None or 0) runs the finetune config's iters, as JAX
        does (`n_iters or iters`)."""
        if bg_packs is None:
            bg_packs = self.background_packs()
        if bg_packs:
            save_vis_info(os.path.join(self.out_dir, "bg_info.pkl"), bg_packs)

        # inpainted-bg supervision uses the post conf's bg_nm_l1/bg_nm_cos
        # (and optional bg_depth) weights (calculate_background_recon_loss
        # :668-671)
        bg_lcfg = self.lcfg
        f = self.fcfg
        if bg_packs and any(v is not None
                            for v in (f.bg_nm_l1, f.bg_nm_cos, f.bg_depth)):
            bg_lcfg = dataclasses.replace(
                self.lcfg,
                normal_l1_weight=(f.bg_nm_l1 if f.bg_nm_l1 is not None
                                  else self.lcfg.normal_l1_weight),
                normal_cos_weight=(f.bg_nm_cos if f.bg_nm_cos is not None
                                   else self.lcfg.normal_cos_weight),
                depth_weight=(f.bg_depth if f.bg_depth is not None
                              else self.lcfg.depth_weight),
            )
        optimizer, scheduler = make_finetune_optimizer(self.model, f)
        total = n_iters or f.iters
        m = f.rays_per_step
        dev = self.device
        # the background step has no invisible view and a collision target
        # no point violates (JAX feeds the same zeros)
        coll_pts = torch.zeros(f.collision_pts, 3, device=dev)
        coll_sdf = torch.full((f.collision_pts,), 1e3, device=dev)
        for it in range(total):
            if bg_packs:
                # rays from the training camera supervised by the inpainted
                # rgb/normal/depth of a pack's occluded pixels
                pack = bg_packs[int(self.rng.integers(len(bg_packs)))]
                hh, ww = pack["mask"].shape
                cand = np.flatnonzero(pack["mask"].reshape(-1))
                if len(cand) == 0:
                    continue
                pix = self.rng.choice(cand, m)
                uv = np.stack([pix % ww, pix // ww], -1).astype(np.float32)
                batch = {
                    "uv": as_tensor(uv, dev),
                    "pose": as_tensor(pack["pose"], dev),
                    "intrinsics": as_tensor(self.dataset.intrinsics, dev),
                    "rgb": as_tensor(pack["rgb"].reshape(-1, 3)[pix], dev),
                    "depth": as_tensor(pack["depth"].reshape(-1, 1)[pix],
                                       dev),
                    "normal": as_tensor(pack["normal"].reshape(-1, 3)[pix],
                                        dev),
                    "segs": torch.zeros(m, dtype=torch.int64, device=dev),
                    "mask": torch.ones(m, 1, device=dev),
                }
            else:
                batch = self._class_batch(m, 0)
            self._step(0, optimizer, scheduler, bg_lcfg, batch, None,
                       coll_pts, coll_sdf, it, total)
        return self.model

    def finetune_object(self, obj_i: int, gen_views: list[dict],
                        bbox_center, bbox_scale, parent_ids: tuple[int, ...],
                        n_iters: int | None = None):
        """Refine one object's SDF (holoscene_train_post.py:3394). n_iters
        falsy (None or 0) runs the finetune config's iters, as JAX does."""
        optimizer, scheduler = make_finetune_optimizer(self.model, self.fcfg)
        total = n_iters or self.fcfg.iters
        m = self.fcfg.invis_pixels
        dev = self.device
        for it in range(total):
            batch = self._class_batch(self.fcfg.rays_per_step, obj_i)
            gen_view = None
            if gen_views:
                view = gen_views[int(self.rng.integers(len(gen_views)))]
                res = view["rgb"].shape[0]
                pix = self.rng.integers(0, res * res, m)
                uv_unit = np.stack(
                    [(pix % res + 0.5) / res * 2 - 1,
                     (pix // res + 0.5) / res * 2 - 1], axis=-1
                )
                nm_mask = view.get("nm_mask", view["mask"])
                # sm_mask marks the LaMa-inpainted region; the step weights
                # those pixels with the conf's lambda_lama_* terms
                inp_mask = view.get("sm_mask", np.zeros_like(view["mask"]))
                # depth supervision only where the view provides it; packs
                # without depth get a zeroed mask -> the term vanishes
                depth = view.get("depth")
                dmask = (view.get("depth_mask", view["mask"])
                         if depth is not None
                         else np.zeros_like(view["mask"]))
                if depth is None:
                    depth = np.zeros_like(np.asarray(view["mask"]), np.float32)

                def px(a):
                    return as_tensor(np.asarray(a).reshape(-1)[pix], dev)

                gen_view = {
                    "pose": as_tensor(view["pose"], dev),
                    "half_extent": torch.tensor(float(view["half_extent"]),
                                                device=dev),
                    "rgb": as_tensor(view["rgb"].reshape(-1, 3)[pix], dev),
                    "normal": as_tensor(view["normal"].reshape(-1, 3)[pix],
                                        dev),
                    "mask": px(view["mask"]),
                    "nm_mask": px(nm_mask),
                    "inp_mask": px(inp_mask),
                    "depth": px(np.asarray(depth, np.float32)),
                    "depth_mask": px(dmask),
                    "uv": as_tensor(uv_unit, dev),
                    # observed front views carry a 25x-trusted silhouette
                    # (reference lambda_mask boost, :566)
                    "mask_boost": torch.tensor(
                        25.0 if view.get("front") else 1.0, device=dev),
                }
            coll_pts, coll_sdf = sample_collision_points(
                self.model, bbox_center, bbox_scale, parent_ids,
                self.fcfg.collision_pts, self.rng)
            self._step(obj_i, optimizer, scheduler, self.lcfg, batch,
                       gen_view, coll_pts, coll_sdf, it, total)
        return self.model

    # ------------------------------------------------------------------
    # orchestration
    # ------------------------------------------------------------------

    def run(self, finetune_iters: int | None = None):
        """The whole stage. finetune_iters falsy (None or 0) runs the
        finetune config's iters a finetune (the conf's 500), as JAX does.
        Returns {meshes, graph, translations, scene_settle,
        failed_objects, physics}; the wall table by part is self.timer."""
        timer = self.timer
        if not self.quiet:
            print(f"[stage2] extracting meshes at res {self.mesh_resolution}",
                  flush=True)
        with timer.part("extraction"):
            meshes = self.extract_meshes()
        k = self.cfg.implicit.d_out

        with timer.part("graph"):
            graph = (
                self.dataset.graph_node_dict
                if getattr(self.dataset, "graph_node_dict", None)
                else create_scene_graph_from_meshes(meshes)
            )
        with open(os.path.join(self.out_dir, "graph_node_dict.pkl"),
                  "wb") as f:
            pickle.dump(graph, f)

        # background first (holoscene_train_post.py:446-452)
        with timer.part("background packs"):
            bg_packs = self.background_packs()
        with timer.part("background finetune"):
            self.background_reconstruction(n_iters=finetune_iters,
                                           bg_packs=bg_packs)

        order = sorted(
            (i for i in range(1, k) if meshes[i] is not None),
            key=lambda i: graph.get(i, {}).get("dist_to_root", 1),
        )
        self.object_order = order
        accepted: dict[int, Mesh] = {}
        if meshes[0] is not None:
            accepted[0] = meshes[0]
            write_ply(
                os.path.join(self.out_dir, "coarse_recon_obj_0.ply"), meshes[0]
            )

        for obj_i in order:
            self._refine_object(obj_i, meshes, graph, accepted,
                                finetune_iters)

        mesh_list = [accepted.get(i) for i in range(k)]
        with timer.part("intersection"):
            translations = solve_intersection(mesh_list, graph)
        with timer.part("settle"):
            translations, settle_report = self.scene_settle(mesh_list,
                                                            translations)
        with open(os.path.join(self.out_dir, "translation_dict.pkl"),
                  "wb") as f:
            pickle.dump({i: np.asarray(t) for i, t in translations.items()}, f)

        return {
            "meshes": mesh_list,
            "graph": graph,
            "translations": translations,
            "scene_settle": settle_report,
            "failed_objects": self.failed_object_list,
            "physics": settle_report["physics"],
        }

    def _refine_object(self, obj_i, meshes, graph, accepted, finetune_iters):
        """Steps 4a-4f for one object."""
        timer = self.timer
        mesh = meshes[obj_i]
        b = mesh.bounds
        center = (b[0] + b[1]) / 2
        scale = (b[1] - b[0]) / 2 + 0.05
        half_extent = float(np.linalg.norm(b[1] - b[0]) / 2 * 1.3)
        self._current_obj = obj_i
        self._current_half_extent = half_extent
        tag = f"obj {obj_i} "

        others = [m for j, m in enumerate(meshes)
                  if j != obj_i and m is not None]
        if not self.quiet:
            print(f"[obj {obj_i}] selecting views "
                  f"({len(mesh.faces)} faces)", flush=True)
        with timer.part(tag + "view selection"):
            mesh_v = self._view_mesh(mesh)
            others_v = [self._view_mesh(m) for m in others]
            best_views = select_best_views(
                mesh_v, others_v, n_views=4, img_res=self.view_render_res,
                device=self.device)
        # coverage = training-view visibility integrated over the full
        # (azimuth, phi-limited) direction grid (reference weight-map
        # integration, holoscene_train_post.py:2023-2413)
        with timer.part(tag + "visibility"):
            n_frames = min(8, self.dataset.n_images)
            frame_ids = np.linspace(
                0, self.dataset.n_images - 1, n_frames).astype(int)
            vis = training_view_vertex_visibility(
                mesh_v, others_v,
                [self.dataset.pose_all[f] for f in frame_ids],
                self.dataset.intrinsics[:3, :3],
                tuple(self.dataset.img_res), device=self.device)
            coverage, _ = integrated_view_coverage(mesh_v, vis)
        if not self.quiet:
            print(f"[obj {obj_i}] view coverage {coverage:.2f}", flush=True)

        # occluder-inpainted + consistency-gated object views supervise
        # the finetune ALWAYS; novel views are added when coverage is poor
        with timer.part(tag + "packs"):
            gen_views = self.object_view_packs(
                obj_i, meshes, best_views, half_extent)
        if coverage < self.coverage_threshold \
                and self.providers.get("novel_view"):
            with timer.part(tag + "novel views"):
                novel = self.generate_novel_views(obj_i, mesh, half_extent)
            self._report(obj_i)["novel_views"] = len(novel)
            gen_views = gen_views + novel

        parent = graph.get(obj_i, {}).get("parent", 0)
        parent_ids = (parent if parent >= 0 else 0,)
        with timer.part(tag + "finetune"):
            self.finetune_object(obj_i, gen_views, center, scale, parent_ids,
                                 n_iters=finetune_iters)

        # mesh-from-generated-views fallback candidate (reference
        # coarse_recon after Wonder3D, holoscene_train_post.py:1680) — only
        # hallucinated views feed it, not the inpainted renders
        extra = []
        w3d_views = [v for v in gen_views if v.get("source") != "inpaint"]
        if w3d_views:
            with timer.part(tag + "coarse_recon"):
                try:
                    extra.append(coarse_recon(
                        w3d_views, center,
                        float(np.linalg.norm(b[1] - b[0]) / 2),
                        CoarseReconConfig(iters=120, img_res=64),
                        device=self.device))
                    self._report(obj_i)["coarse_recon"] = len(extra[-1].faces)
                except Exception as e:
                    self._report(obj_i)["errors"].append(
                        f"coarse_recon: {e!r}")
                    if not self.quiet:
                        print(f"  [obj {obj_i}] coarse_recon failed: {e}")

        supports = [accepted.get(parent if parent >= 0 else 0)]
        supports = [s for s in supports if s is not None]
        with timer.part(tag + "ladder"):
            cand, drift, stable = self.stability_ladder(
                obj_i, supports or [mesh], extra_candidates=extra)
        if cand is None:
            # zero candidates at all: ship the pre-refinement stage-1 mesh
            # rather than hole the scene; the failed flag records it
            cand = mesh
            if not self.quiet:
                print(f"  [obj {obj_i}] ladder empty — falling back to "
                      f"the stage-1 mesh", flush=True)
        accepted[obj_i] = cand
        write_ply(
            os.path.join(self.out_dir, f"coarse_recon_obj_{obj_i}.ply"), cand)
        if gen_views:
            save_vis_info(
                os.path.join(self.out_dir, f"vis_info_{obj_i}.pkl"), gen_views)
        if not self.quiet:
            print(f"[obj {obj_i}] accepted drift={drift:.1f} stable={stable}",
                  flush=True)

    def scene_settle(
        self,
        mesh_list: list[Mesh | None],
        translations: dict[int, np.ndarray],
        max_rounds: int = 3,
        verify_uncapped: bool = True,
    ):
        """Final whole-scene physics settle (reference step 6:
        holoscene_train_post.py:2003 calling utils/sim.py:638 sim_scene).

        The composed scene — every accepted mesh at its intersection-
        resolved translation — is re-simulated as a whole; objects that
        drift or tip get their translation updated (quasi-static drop to
        first contact, falling back to the simulator's own settle
        translation) and the scene is re-validated, up to `max_rounds`.
        verify_uncapped (default on) re-simulates the FINAL configuration
        once on the uncapped meshes and records whether it agrees with the
        decimated settle. Writes `scene_settle.json`, whose "physics" names
        the provider that ran, and returns (translations, report)."""
        translations = {i: np.asarray(t, np.float64)
                        for i, t in translations.items()}
        idxs = [i for i, m in enumerate(mesh_list) if m is not None]
        report: dict = {"rounds": [], "stable": True}

        def write():
            report["physics"] = provider_report()
            with open(os.path.join(self.out_dir, "scene_settle.json"),
                      "w") as f:
                json.dump(report, f, indent=1)

        if len(idxs) < 2:
            report["note"] = "fewer than two meshes; nothing to settle"
            write()
            return translations, report

        def composed(i):
            # simulate on the capped stand-ins; translations transfer to the
            # full meshes unchanged
            return self._view_mesh(mesh_list[i]).apply_translation(
                translations.get(i, np.zeros(3)))

        move_eps = 0.01  # settle translation below this = already at rest
        for rnd in range(max_rounds):
            scene = [composed(i) for i in idxs]
            results = sim_scene(scene)  # validates scene[1:] each vs others
            row = []
            needs_settle = []
            for pos, res in enumerate(results, start=1):
                obj_i = idxs[pos]
                moved = float(np.linalg.norm(res.translation)) > move_eps
                row.append(
                    {
                        "obj": int(obj_i),
                        "drift_deg": float(res.drift_deg),
                        "stable": bool(res.stable),
                        "moved": bool(moved),
                        "translation": np.asarray(res.translation, np.float64)
                        .round(6)
                        .tolist(),
                    }
                )
                # a floating object settles by TRANSLATION with near-zero
                # orientation drift — "stable" by the drift<8 deg test but
                # not at rest; the scene settle must move it
                if not res.stable or moved:
                    needs_settle.append((obj_i, res))
            report["rounds"].append(row)
            if not needs_settle:
                report["stable"] = True
                break
            report["stable"] = False
            for obj_i, res in needs_settle:
                if res.stable:
                    # simulator settled it by translation: adopt that pose,
                    # clamped, so a near-free-fall translation cannot
                    # teleport the object out of the scene
                    delta = np.asarray(res.translation, np.float64)
                    nrm = float(np.linalg.norm(delta))
                    if nrm > 0.5:
                        delta = delta * (0.5 / nrm)
                        report.setdefault("clamped", []).append(
                            {"obj": int(obj_i), "raw_norm": round(nrm, 3)})
                else:
                    supports = [composed(j) for j in idxs if j != obj_i]
                    delta = settle_drop(composed(obj_i), supports)
                    if float(np.linalg.norm(delta)) < 1e-6:
                        # no support found below: fall back to where the
                        # simulator itself left the object
                        delta = np.clip(np.asarray(res.translation), -0.2, 0.2)
                translations[obj_i] = translations.get(obj_i, np.zeros(3)) \
                    + delta
            if not self.quiet:
                print(
                    f"[scene_settle] round {rnd}: re-settled "
                    f"{[int(i) for i, _ in needs_settle]}"
                )

        if verify_uncapped:
            # one full-resolution re-sim of the FINAL configuration bounds
            # the decimated-stand-in error
            scene_full = [
                mesh_list[i].apply_translation(
                    translations.get(i, np.zeros(3)))
                for i in idxs
            ]
            results_full = sim_scene(scene_full)
            check = []
            agrees = True
            capped_last = {r["obj"]: r for r in report["rounds"][-1]}
            for pos, res in enumerate(results_full, start=1):
                obj_i = idxs[pos]
                moved = float(np.linalg.norm(res.translation)) > move_eps
                row = {
                    "obj": int(obj_i),
                    "drift_deg": float(res.drift_deg),
                    "stable": bool(res.stable),
                    "moved": bool(moved),
                }
                capped = capped_last.get(obj_i)
                if capped is not None:
                    row["drift_delta_deg"] = float(
                        abs(res.drift_deg - capped["drift_deg"]))
                    if bool(res.stable) != bool(capped["stable"]):
                        agrees = False
                if not res.stable or moved:
                    agrees = False
                check.append(row)
            report["uncapped_check"] = check
            report["uncapped_agrees"] = bool(agrees)
            if not agrees and not self.quiet:
                print("[scene_settle] WARNING: uncapped re-sim disagrees "
                      "with the decimated settle (see scene_settle.json)")

        write()
        return translations, report
