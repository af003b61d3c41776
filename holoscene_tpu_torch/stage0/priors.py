"""Stage-0 prior generation: monocular depth and normal maps for every image
(port of holoscene_tpu/stage0/priors.py; reference marigold/run.py, the
diffusion depth / normal CLI writing `depth/*.npy` + `normal/*.png` next to
`images/`, and midas/omnidata.py, DPT normals).

The frozen networks are externals behind providers, as in Stage 2:

  * `TorchScriptPriorProvider` runs TorchScript-exported depth / normal
    estimators on `device` (export Marigold / Omnidata / any monodepth net
    once; contract: model(image [1,3,H,W] in [0,1]) -> depth [1,1,H,W] or
    normal [1,3,H,W] in [-1,1]);
  * `CachedPriorProvider` replays depth / normal files recorded by an
    earlier run from a cache directory.

The files written are the ones NSDataset reads: float32 `.npy` depth and
`[0,1]`-mapped normal PNGs, ordered like `images/`. The provider and the
CLI run on the card by default (`device="cuda"`, no CPU fallback; JAX's
default is the CPU); `--device cpu` runs the models on the host.
"""

from __future__ import annotations

import abc
import os
import shutil

import numpy as np
import torch

from holoscene_tpu_torch import resolve_device


class PriorProvider(abc.ABC):
    @abc.abstractmethod
    def infer_depth(self, image: np.ndarray) -> np.ndarray:
        """image [H,W,3] float [0,1] -> depth [H,W] float32."""

    @abc.abstractmethod
    def infer_normal(self, image: np.ndarray) -> np.ndarray:
        """image [H,W,3] float [0,1] -> camera-frame unit normals [H,W,3]."""


class TorchScriptPriorProvider(PriorProvider):
    def __init__(self, depth_checkpoint: str | None = None,
                 normal_checkpoint: str | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.depth_model = None
        self.normal_model = None
        if depth_checkpoint:
            self.depth_model = torch.jit.load(
                depth_checkpoint, map_location=self.device).eval()
        if normal_checkpoint:
            self.normal_model = torch.jit.load(
                normal_checkpoint, map_location=self.device).eval()

    def _run(self, model, image: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            t = torch.from_numpy(
                np.ascontiguousarray(image, dtype=np.float32)
            ).permute(2, 0, 1)[None].to(self.device)
            return model(t)[0].permute(1, 2, 0).cpu().numpy()

    def infer_depth(self, image):
        if self.depth_model is None:
            raise RuntimeError("no depth checkpoint loaded")
        return self._run(self.depth_model, image)[..., 0].astype(np.float32)

    def infer_normal(self, image):
        if self.normal_model is None:
            raise RuntimeError("no normal checkpoint loaded")
        n = self._run(self.normal_model, image).astype(np.float32)
        return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)


class CachedPriorProvider(PriorProvider):
    """Replays priors recorded under cache_dir/{depth,normal}: a recording
    is keyed by the image's file stem, not by its pixels, so `replay`
    copies the files and the per-image inference raises."""

    def __init__(self, cache_dir: str):
        self.cache_dir = cache_dir

    def replay(self, stem: str, depth_path: str, normal_path: str) -> None:
        shutil.copy(os.path.join(self.cache_dir, "depth", stem + ".npy"),
                    depth_path)
        shutil.copy(os.path.join(self.cache_dir, "normal", stem + ".png"),
                    normal_path)

    def infer_depth(self, image):
        raise NotImplementedError("a cached provider replays files by name")

    def infer_normal(self, image):
        raise NotImplementedError("a cached provider replays files by name")


def generate_priors(
    scene_dir: str,
    provider: PriorProvider | None = None,
    cache_dir: str | None = None,
    overwrite: bool = False,
) -> tuple[list[str], list[str]]:
    """Write depth/*.npy + normal/*.png for every images/*.png in scene_dir
    (the reference marigold/run.py files). Either a live provider or a
    cache_dir of recorded priors (or a CachedPriorProvider) must be given;
    existing files are kept unless overwrite."""
    from PIL import Image

    if cache_dir is not None:
        provider = CachedPriorProvider(cache_dir)
    if provider is None:
        raise ValueError("generate_priors needs a provider or a cache_dir")
    img_dir = os.path.join(scene_dir, "images")
    names = sorted(os.listdir(img_dir))
    depth_dir = os.path.join(scene_dir, "depth")
    normal_dir = os.path.join(scene_dir, "normal")
    os.makedirs(depth_dir, exist_ok=True)
    os.makedirs(normal_dir, exist_ok=True)

    depth_paths, normal_paths = [], []
    for name in names:
        stem = os.path.splitext(name)[0]
        dp = os.path.join(depth_dir, stem + ".npy")
        npth = os.path.join(normal_dir, stem + ".png")
        depth_paths.append(dp)
        normal_paths.append(npth)
        if not overwrite and os.path.exists(dp) and os.path.exists(npth):
            continue
        if isinstance(provider, CachedPriorProvider):
            provider.replay(stem, dp, npth)
            continue
        img = np.asarray(
            Image.open(os.path.join(img_dir, name)).convert("RGB"),
            dtype=np.float32) / 255.0
        np.save(dp, provider.infer_depth(img).astype(np.float32))
        n01 = np.clip((provider.infer_normal(img) + 1.0) * 0.5, 0.0, 1.0)
        Image.fromarray((n01 * 255).astype(np.uint8)).save(npth)
    return depth_paths, normal_paths


def main(argv=None) -> tuple[list[str], list[str]]:
    """Stage-0 CLI (reference: python marigold/run.py --input_dir ...);
    returns the depth and normal paths written.

      python -m holoscene_tpu_torch.stage0.priors --scene_dir data/scene_0 \
          [--depth_checkpoint depth.pt --normal_checkpoint normal.pt] \
          [--cache_dir recorded_priors/] [--overwrite] [--device cuda]
    """
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--scene_dir", required=True)
    ap.add_argument("--depth_checkpoint", default=None)
    ap.add_argument("--normal_checkpoint", default=None)
    ap.add_argument("--cache_dir", default=None)
    ap.add_argument(
        "--device", default="cuda",
        help="torch device of the TorchScript models; 'cuda' fails without "
             "a card, 'cpu' runs them on the host")
    ap.add_argument("--overwrite", action="store_true")
    args = ap.parse_args(argv)

    provider = None
    if args.cache_dir is None:
        if not (args.depth_checkpoint or args.normal_checkpoint):
            ap.error("give TorchScript checkpoints (--depth_checkpoint / "
                     "--normal_checkpoint) or --cache_dir with recorded "
                     "priors")
        provider = TorchScriptPriorProvider(
            args.depth_checkpoint, args.normal_checkpoint, args.device)
    d, n = generate_priors(args.scene_dir, provider=provider,
                           cache_dir=args.cache_dir, overwrite=args.overwrite)
    print(f"wrote {len(d)} depth + {len(n)} normal priors under "
          f"{args.scene_dir}")
    return d, n


if __name__ == "__main__":
    main()
