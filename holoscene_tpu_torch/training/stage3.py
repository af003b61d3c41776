"""Stage-3 runner: per-object colour-field training and UV baking (port of
holoscene_tpu/training/stage3.py).

Reference semantics: training/holoscene_train_texture.py
(`HoloSceneTrainTextureRunner`): per object a fresh colour field (hash
grid + 4-layer MLP -> sigmoid RGB) trained with Adam (grid lr x factor,
exponential decay) on the MSE between the field at rasterized per-pixel
world positions and the pixels inside the object's instance mask; the
background gets max_total_iters, objects a tenth; then a UV bake with
nearest-neighbour gutter fill -> surface_{i}.obj/.mtl/.png.

The device work runs on the runner's `device` (cuda unless the caller asks
for the CPU, where the kernels' plain versions run): the colour field's
encode is H2 (packed) forward and H1-bwd (no jacobian term) backward
(models/fields.py::color_field_forward); the rasterizations and the bake's
field queries are on the device too. The atlas (utils/uv_atlas.py), the
gutter fill (scipy cKDTree) and the file writing stay on the host.

Where it differs from the JAX step, and why the results stay the same:
  * JAX re-rasterizes the mesh inside every jitted step. A rasterization
    depends only on the mesh and the pose, which training does not change,
    so the runner rasterizes each frame and each generated view once, on
    first use (`_view`), and keeps world_pos and the valid mask on the
    device. Both JAX rasterizations are traced with a traced pose, which
    skips the screen-size split, so these take auto_subdivide=False.
  * The pixel indices are an argument of `color_step`, drawn with
    replacement by ops/draws.py::draw_by_weight (an exact integer inverse
    CDF, so two runs from one seed draw the same pixels on the card; over
    mask x instance mask, uniform on a frame with no valid pixel, whose
    loss is 0 while Adam still steps) from one torch.Generator seeded by
    `seed`, where JAX draws jax.random.choice. The frame choice keeps
    JAX's numpy stream.
`timer` (utils/logging.py::StepTimer) keeps the wall table by part,
`losses` each object's losses as train_object returns them and `steps`
each object's count of image and invisible-view steps.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from holoscene_tpu_torch import as_tensor, resolve_device
from holoscene_tpu_torch.models.fields import (
    ColorField,
    ColorFieldConfig,
    color_field_forward,
)
from holoscene_tpu_torch.ops import draws
from holoscene_tpu_torch.ops.rasterizer import rasterize_mesh
from holoscene_tpu_torch.utils.logging import StepTimer
from holoscene_tpu_torch.utils.mesh import Mesh, write_obj


def make_color_optimizer(field: ColorField, lr: float,
                         lr_factor_for_grid: float, total_iters: int):
    """(optimizer, scheduler): Adam(0.9, 0.99, eps 1e-15) with the grid at
    lr x lr_factor_for_grid and the MLP at lr, the rate decayed by
    0.1^(1/total_iters) at every update (JAX make_color_optimizer: optax
    scale_by_adam + exponential_decay(transition_steps=1)). Step the
    scheduler after each optimizer step."""
    mlp = [p for n, p in field.named_parameters() if n != "grid"]
    opt = torch.optim.Adam(
        [{"params": [field.grid], "lr": lr * lr_factor_for_grid},
         {"params": mlp, "lr": lr}], betas=(0.9, 0.99), eps=1e-15)
    decay = 0.1 ** (1.0 / max(total_iters, 1))
    return opt, torch.optim.lr_scheduler.ExponentialLR(opt, gamma=decay)


def color_step(field: ColorField, optimizer, scheduler,
               world_pos: torch.Tensor, valid_any: torch.Tensor,
               gt: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """One Adam step of the colour field (JAX Stage3Runner's step and
    invisible-view step): the MSE of the field at world_pos[idx] [M, 3]
    against gt[idx], 0 when valid_any (0-d bool) is False, which leaves
    zero gradients and still steps Adam. Returns the loss, 0-d, without a
    host sync."""
    optimizer.zero_grad(set_to_none=True)
    rgb = color_field_forward(field, world_pos[idx])
    loss = torch.mean((rgb - gt[idx]) ** 2)
    loss = torch.where(valid_any, loss, torch.zeros_like(loss))
    loss.backward()
    optimizer.step()
    scheduler.step()
    return loss.detach()


def _query_color_field(field: ColorField, pts: np.ndarray,
                       chunk: int) -> np.ndarray:
    """The field at pts [P, 3] in chunks of `chunk` points (H2 once a
    chunk, no padding), rgb [P, 3] float32 on the host."""
    dev = field.grid.device
    rgb = np.empty((len(pts), 3), dtype=np.float32)
    with torch.no_grad():
        for i in range(0, len(pts), chunk):
            pc = as_tensor(np.asarray(pts[i:i + chunk], dtype=np.float32),
                           dev)
            rgb[i:i + chunk] = color_field_forward(field, pc).cpu().numpy()
    return rgb


def _knn_fill_gutters(tex: np.ndarray, covered: np.ndarray) -> None:
    """Fill uncovered texels with their nearest covered texel's colour
    (reference xatlas bake gutter fill, holoscene_train_texture.py:779-790).
    In-place on tex."""
    if not covered.any() or covered.all():
        return
    from scipy.spatial import cKDTree

    yx_cov = np.argwhere(covered)
    yx_miss = np.argwhere(~covered)
    tree = cKDTree(yx_cov)
    _, nn = tree.query(yx_miss, k=1)
    tex[yx_miss[:, 0], yx_miss[:, 1]] = tex[yx_cov[nn][:, 0], yx_cov[nn][:, 1]]


class Stage3Runner:
    def __init__(
        self,
        meshes: list[Mesh],
        dataset,
        cfg: ColorFieldConfig = ColorFieldConfig(),
        lr: float = 5e-4,
        lr_factor_for_grid: float = 20.0,
        max_total_iters: int = 5000,
        pixels_per_step: int = 4096,
        out_dir: str = "stage3_out",
        texture_res: int = 2048,
        seed: int = 0,
        quiet: bool = False,
        device: str | torch.device = "cuda",
    ):
        self.meshes = meshes
        self.dataset = dataset
        self.cfg = cfg
        self.lr = lr
        self.lr_grid = lr_factor_for_grid
        self.max_total_iters = max_total_iters
        self.pixels_per_step = pixels_per_step
        self.out_dir = out_dir
        self.texture_res = texture_res
        self.quiet = quiet
        self.device = resolve_device(device)
        os.makedirs(out_dir, exist_ok=True)
        self.rng = np.random.default_rng(seed)
        # the fields' init on the host (the same tables on every device),
        # the pixel draws on the device
        self.init_generator = torch.Generator().manual_seed(seed)
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.color_fields: dict[int, ColorField] = {}
        self.losses: dict[int, list[float]] = {}
        self.steps: dict[int, dict] = {}
        self.timer = StepTimer(sync=(
            (lambda: torch.cuda.synchronize(self.device))
            if self.device.type == "cuda" else None))
        self._views: dict = {}

    def _view(self, obj_i: int, key, pose, intrinsics, res, half_extent,
              target_rgb, target_mask):
        """(world_pos [HW, 3], pixel weights [HW], valid_any, rgb [HW, 3])
        of one view of obj_i's mesh on the device: rasterized on the view's
        first use and kept. valid = rasterized mask x target_mask; the
        weights are valid's, uniform where no pixel is valid."""
        hit = self._views.get((obj_i, key))
        if hit is not None:
            return hit
        mesh = self.meshes[obj_i]
        with self.timer.part(f"obj {obj_i} rasterization"):
            out = rasterize_mesh(
                np.asarray(mesh.vertices, np.float32),
                np.asarray(mesh.faces, np.int64), pose, intrinsics, res,
                ortho_half_extent=half_extent, device=self.device,
                auto_subdivide=False)
            valid = out["mask"].reshape(-1) \
                & as_tensor(target_mask, self.device, torch.bool).reshape(-1)
            valid_any = valid.any()
            weights = torch.where(valid_any, valid.to(torch.float32),
                                  torch.ones_like(valid, dtype=torch.float32))
            hit = (out["world_pos"].reshape(-1, 3).contiguous(), weights,
                   valid_any,
                   as_tensor(target_rgb, self.device).reshape(-1, 3))
        self._views[(obj_i, key)] = hit
        return hit

    def _frame_view(self, obj_i: int, frame: int):
        ds = self.dataset
        h, w = ds.img_res
        return self._view(
            obj_i, ("frame", frame), ds.pose_all[frame],
            ds.intrinsics[:3, :3], (h, w), None,
            ds.rgb_images[frame].reshape(h, w, 3),
            ds.semantic_images[frame].reshape(h, w) == obj_i)

    def _pack_view(self, obj_i: int, pack_i: int, pack: dict):
        res = pack["rgb"].shape[0]
        return self._view(
            obj_i, ("pack", pack_i), np.asarray(pack["pose"], np.float32),
            None, (res, res), float(pack["half_extent"]), pack["rgb"],
            np.asarray(pack["mask"], np.float32) > 0.5)

    def _draw(self, weights: torch.Tensor) -> torch.Tensor:
        return draws.draw_by_weight(weights, self.pixels_per_step,
                                    self.generator)

    def train_object(self, obj_i: int, n_iters: int | None = None,
                     vis_info: list[dict] | None = None):
        """Train one object's colour field (reference :292-414); `vis_info`
        packs add one generated-view step an iteration, which shares the
        optimizer state and the schedule count with the image step.
        Returns the loss at every 50th iteration and the last."""
        total = n_iters or (
            self.max_total_iters if obj_i == 0 else self.max_total_iters // 10
        )
        field = ColorField(self.cfg, self.init_generator).to(self.device)
        optimizer, scheduler = make_color_optimizer(field, self.lr,
                                                    self.lr_grid, total)
        occ = self.dataset.class_id_occurences.get(obj_i, [])
        frames = occ if occ else list(range(self.dataset.n_images))
        counts = self.steps.setdefault(obj_i, {"image": 0, "invisible": 0})
        raster_key = f"obj {obj_i} rasterization"
        raster_before = self.timer.seconds.get(raster_key, 0.0)
        losses = []
        with self.timer.part(f"obj {obj_i} training"):
            for it in range(total):
                frame = int(self.rng.choice(frames))
                wp, weights, valid_any, rgb = self._frame_view(obj_i, frame)
                loss = color_step(field, optimizer, scheduler, wp, valid_any,
                                  rgb, self._draw(weights))
                counts["image"] += 1
                if vis_info:
                    pack_i = int(self.rng.integers(len(vis_info)))
                    wp2, weights2, any2, rgb2 = self._pack_view(
                        obj_i, pack_i, vis_info[pack_i])
                    color_step(field, optimizer, scheduler, wp2, any2, rgb2,
                               self._draw(weights2))
                    counts["invisible"] += 1
                if it % 50 == 0 or it == total - 1:
                    losses.append(float(loss))
                    if not self.quiet:
                        print(f"[stage3 obj {obj_i}] it {it} "
                              f"mse={losses[-1]:.5f}")
        # the first use of a view rasterizes it inside the loop: its time
        # is the rasterization part's, not training's
        self.timer.seconds[f"obj {obj_i} training"] -= \
            self.timer.seconds.get(raster_key, 0.0) - raster_before
        self.color_fields[obj_i] = field
        self.losses[obj_i] = losses
        self._views = {k: v for k, v in self._views.items() if k[0] != obj_i}
        return losses

    # ------------------------------------------------------------------
    # texture baking
    # ------------------------------------------------------------------

    def export_mesh_texture(self, obj_i: int, texture_res: int | None = None,
                            chunk: int = 65536, atlas: str = "charts"):
        """Bake the colour field into a UV atlas and write
        surface_{obj_i}.obj/.mtl/.png (reference :717-796).

        atlas="charts" (default): normal-cone charts packed into the atlas
        (utils/uv_atlas.py). atlas="triangles": the per-triangle atlas."""
        assert obj_i in self.color_fields, "train the object first"
        tex_res = texture_res or self.texture_res
        if atlas == "charts":
            return self._export_chart_atlas(obj_i, tex_res, chunk)

        timer = self.timer
        mesh = self.meshes[obj_i]
        field = self.color_fields[obj_i]
        with timer.part(f"obj {obj_i} atlas"):
            faces = mesh.faces
            verts = mesh.vertices
            f_count = len(faces)
            cells = -(-f_count // 2)
            grid = int(np.ceil(np.sqrt(cells)))
            cell_px = tex_res // grid
            if cell_px < 4:
                # grow the atlas so every face chart gets >= 4x4 texels
                tex_res = 1 << int(np.ceil(np.log2(grid * 4)))
                cell_px = tex_res // grid
                print(f"[stage3] texture resized to {tex_res} "
                      f"({f_count} faces need >=4px charts)")
            pad = 1.0  # px gutter inside each cell

            # split vertices per face; per-face UVs into cell triangles
            tri_verts = verts[faces].reshape(-1, 3)  # [F*3, 3]
            new_faces = np.arange(f_count * 3).reshape(-1, 3)

            cell_idx = np.arange(f_count) // 2
            upper = (np.arange(f_count) % 2).astype(bool)
            cx = (cell_idx % grid) * cell_px
            cy = (cell_idx // grid) * cell_px
            s = cell_px
            lower_uv = np.array([[pad, pad], [s - 2 * pad, pad],
                                 [pad, s - 2 * pad]])
            upper_uv = np.array(
                [[s - pad, s - pad], [2 * pad, s - pad], [s - pad, 2 * pad]]
            )
            uv_px = np.where(upper[:, None, None], upper_uv[None],
                             lower_uv[None])
            uv_px = uv_px + np.stack([cx, cy], axis=-1)[:, None, :]
            uvs = uv_px.reshape(-1, 2) / tex_res
            uvs[:, 1] = 1.0 - uvs[:, 1]  # OBJ vt convention (v up)

        # bake: every texel -> owning face -> barycentric -> world pos
        ty, tx = np.mgrid[0:cell_px, 0:cell_px]
        tx = tx.ravel() + 0.5
        ty = ty.ravel() + 0.5
        is_upper_tex = (tx + ty) > s
        texel_cnt = cell_px * cell_px

        tex = np.zeros((tex_res, tex_res, 3), dtype=np.float32)
        covered = np.zeros((tex_res, tex_res), dtype=bool)

        def bary_of(tri_uv_px, px, py):
            """tri_uv_px [F,3,2]; px, py [F,P] -> bary [F,P,3]."""
            a, b, c = tri_uv_px[:, 0], tri_uv_px[:, 1], tri_uv_px[:, 2]
            v0 = b - a
            v1 = c - a
            v2 = np.stack([px, py], -1) - a[:, None]
            d00 = np.sum(v0 * v0, -1)[:, None]
            d01 = np.sum(v0 * v1, -1)[:, None]
            d11 = np.sum(v1 * v1, -1)[:, None]
            d20 = np.einsum("fpd,fd->fp", v2, v0)
            d21 = np.einsum("fpd,fd->fp", v2, v1)
            den = np.maximum(d00 * d11 - d01 * d01, 1e-12)
            v = (d11 * d20 - d01 * d21) / den
            w_ = (d00 * d21 - d01 * d20) / den
            return np.stack([1 - v - w_, v, w_], axis=-1)  # [F, P, 3]

        tri_world = verts[faces]  # [F, 3, 3]
        # process faces in chunks to bound memory
        fchunk = max(1, chunk // texel_cnt)
        with timer.part(f"obj {obj_i} field query"):
            for f0 in range(0, f_count, fchunk):
                f1 = min(f0 + fchunk, f_count)
                sel = slice(f0, f1)
                up = upper[sel]
                tex_mask = np.where(up[:, None], is_upper_tex[None],
                                    ~is_upper_tex[None])
                tri_uv = uv_px.reshape(-1, 3, 2)[sel]  # cell-absolute px
                px = cx[sel][:, None] + tx[None]
                py = cy[sel][:, None] + ty[None]
                # barycentrics in cell-local texel coords
                tri_uv_local = tri_uv - np.stack(
                    [cx[sel], cy[sel]], -1
                )[:, None, :]
                bary = np.clip(bary_of(
                    tri_uv_local, np.broadcast_to(tx, (f1 - f0, texel_cnt)),
                    np.broadcast_to(ty, (f1 - f0, texel_cnt))), 0, 1)
                bary = bary / np.maximum(bary.sum(-1, keepdims=True), 1e-12)
                wp = np.einsum("fpk,fkd->fpd", bary, tri_world[sel])
                pts = wp[tex_mask]
                if len(pts) == 0:
                    continue
                rgb = _query_color_field(field, pts, chunk)
                ix = np.clip(px[tex_mask].astype(int), 0, tex_res - 1)
                iy = np.clip(py[tex_mask].astype(int), 0, tex_res - 1)
                tex[iy, ix] = rgb
                covered[iy, ix] = True

        with timer.part(f"obj {obj_i} gutter fill"):
            _knn_fill_gutters(tex, covered)
        with timer.part(f"obj {obj_i} writing"):
            return self._write(obj_i, tex, tri_verts, new_faces, uvs)

    def _write(self, obj_i: int, tex, tri_verts, new_faces, uvs) -> str:
        from PIL import Image

        png_name = f"surface_{obj_i}.png"
        obj_path = os.path.join(self.out_dir, f"surface_{obj_i}.obj")
        Image.fromarray(
            np.clip(tex * 255, 0, 255).astype(np.uint8)
        ).save(os.path.join(self.out_dir, png_name))
        write_obj(obj_path, Mesh(tri_verts, new_faces, uvs=uvs),
                  mtl_name=f"surface_{obj_i}.mtl", texture_png=png_name)
        return obj_path

    def _export_chart_atlas(self, obj_i: int, tex_res: int, chunk: int):
        """Chart-packed bake: build the atlas, rasterize the UV layout
        (an orthographic camera over the atlas plane, with the screen-size
        split), query the colour field at per-texel world positions, and
        KNN-fill the gutters."""
        from holoscene_tpu_torch.utils.uv_atlas import build_chart_atlas

        timer = self.timer
        mesh = self.meshes[obj_i]
        field = self.color_fields[obj_i]
        verts = np.asarray(mesh.vertices, dtype=np.float64)
        faces = np.asarray(mesh.faces, dtype=np.int64)

        with timer.part(f"obj {obj_i} atlas"):
            tri_verts, new_faces, uv_px, n_charts, tex_res = \
                build_chart_atlas(verts, faces, tex_res)
        if not self.quiet:
            print(f"[stage3 obj {obj_i}] atlas: {n_charts} charts for "
                  f"{len(faces)} faces @ {tex_res}^2")

        with timer.part(f"obj {obj_i} uv rasterization"):
            uvV = np.concatenate(
                [uv_px - tex_res / 2.0, np.ones((len(uv_px), 1))], axis=-1
            ).astype(np.float32)
            out = rasterize_mesh(
                uvV, new_faces, np.eye(4, dtype=np.float32), None,
                (tex_res, tex_res), ortho_half_extent=tex_res / 2.0,
                device=self.device)
            fid = out["face_id"].cpu().numpy()
            bary = out["bary"].cpu().numpy()
            covered = fid >= 0

        with timer.part(f"obj {obj_i} field query"):
            wp = np.einsum(
                "pk,pkd->pd", bary[covered], verts[faces][fid[covered]],
            ).astype(np.float32)
            tex = np.zeros((tex_res, tex_res, 3), dtype=np.float32)
            iy, ix = np.nonzero(covered)
            tex[iy, ix] = _query_color_field(field, wp, chunk)

        with timer.part(f"obj {obj_i} gutter fill"):
            _knn_fill_gutters(tex, covered)

        with timer.part(f"obj {obj_i} writing"):
            uvs = uv_px / tex_res
            uvs[:, 1] = 1.0 - uvs[:, 1]              # OBJ vt convention
            return self._write(obj_i, tex, tri_verts, new_faces, uvs)

    def run(self, objects: list[int] | None = None,
            n_iters: int | None = None):
        objs = objects if objects is not None else range(len(self.meshes))
        paths = []
        for obj_i in objs:
            self.train_object(obj_i, n_iters)
            paths.append(self.export_mesh_texture(obj_i))
        return paths
