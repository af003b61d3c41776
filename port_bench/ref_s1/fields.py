# Frozen copy of holoscene_tpu_torch/models/fields.py at commit badb067, for the
# benchmark's plain reference: imports rewired to port_bench.ref_s1, cut to
# the paths the benchmark's Stage-1 configuration runs, in plain PyTorch.
# Do not edit to follow the port.
"""Neural fields of Stage 1 (port of holoscene_tpu/models/fields.py), cut
to what the benchmark's Stage-1 configuration runs: the object-
compositional SDF network with its SDF and colour hash grids and the IDR
rendering network, as nn.Modules that keep the JAX parameter names
(`grid`, `color_grid`, `mlp.lin{i}.{v,g,b}`, `color_map_mlp.lin{0,1}.{w,b}`).

The render path is the vjp gradient mode, `implicit_get_outputs`:
hash-grid features, their analytic jacobian and the colour-grid features
from one H1 call (ref_s1/hashgrid.py), the scene-SDF gradient by the chain
rule through the MLP trunk (an inner autograd.grad with create_graph, so
the outer backward reaches H1-bwd with the second-order cotangent). The
eikonal jacobians of `implicit_all_gradients` push three forward-mode
tangents through the trunk from the single-table H1 call. The sampler's
probes go through `implicit_sdf_raw_sampler` (H2, no gradient).

A network other than the configuration's is refused (`require_ported`):
level_dim other than 2, tetrahedral interpolation, no colour grid or no
grid features; so is the rendering network's nerf mode."""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from port_bench.ref_s1.embedder import (
    embedder_out_dim,
    positional_encoding,
    positional_encoding_jvp,
)
from port_bench.ref_s1.hashgrid import (
    HashGridMeta,
    hash_encode_fused_dual,
    hash_encode_sampler,
    init_hash_embeddings,
)


@dataclasses.dataclass(frozen=True)
class ImplicitNetworkConfig:
    feature_vector_size: int = 256
    d_in: int = 3
    d_out: int = 32
    dims: tuple[int, ...] = (256, 256)
    geometric_init: bool = True
    bias: float = 0.9
    skip_in: tuple[int, ...] = ()
    multires: int = 6
    divide_factor: float = 1.0
    use_grid_feature: bool = True
    sigmoid: float = 10.0
    color_grid_feature: bool = True
    base_size: int = 16
    end_size: int = 2048
    logmap: int = 19
    num_levels: int = 16
    level_dim: int = 2
    grid_interp: str = "trilinear"
    dense_max_res: int = 0

    @property
    def grid_meta(self) -> HashGridMeta:
        return HashGridMeta(
            input_dim=3, num_levels=self.num_levels, level_dim=self.level_dim,
            base_resolution=self.base_size, log2_hashmap_size=self.logmap,
            desired_resolution=self.end_size,
            dense_max_res=self.dense_max_res)

    @property
    def layer_dims(self) -> tuple[int, ...]:
        grid_dim = self.num_levels * self.level_dim
        out = self.d_out
        d0 = self.d_in + grid_dim
        if self.multires > 0:
            d0 += embedder_out_dim(self.multires, self.d_in) - self.d_in
        return (d0,) + tuple(self.dims) + (out,)

    @classmethod
    def from_conf(cls, conf, feature_vector_size: int):
        return cls(
            feature_vector_size=feature_vector_size,
            d_in=conf.get_int("d_in", 3),
            d_out=conf.get_int("d_out", 32),
            dims=tuple(conf.get_list("dims", [256, 256])),
            geometric_init=conf.get_bool("geometric_init", True),
            bias=conf.get_float("bias", 0.9),
            skip_in=tuple(conf.get_list("skip_in", [])),
            multires=conf.get_int("multires", 6),
            divide_factor=conf.get_float("divide_factor", 1.0),
            use_grid_feature=conf.get_bool("use_grid_feature", True),
            sigmoid=conf.get_float("sigmoid", 10.0),
            color_grid_feature=conf.get_bool("color_grid_feature", True),
            base_size=conf.get_int("base_size", 16),
            end_size=conf.get_int("end_size", 2048),
            logmap=conf.get_int("logmap", 19),
            num_levels=conf.get_int("num_levels", 16),
            level_dim=conf.get_int("level_dim", 2),
            grid_interp=conf.get_string("grid_interp", "trilinear"),
            dense_max_res=conf.get_int("dense_max_res", 0),
        )


@dataclasses.dataclass(frozen=True)
class RenderingNetworkConfig:
    feature_vector_size: int = 256
    mode: str = "idr"
    d_in: int = 9
    d_out: int = 3
    dims: tuple[int, ...] = (256, 256)
    multires_view: int = 4
    multires_point: int = 4
    multires_normal: int = 4

    @property
    def layer_dims(self) -> tuple[int, ...]:
        d0 = self.d_in + self.feature_vector_size
        extra = embedder_out_dim(self.multires_view, 3) - 3
        if self.multires_view > 0:
            d0 += extra
        if self.multires_point > 0:
            d0 += extra
        if self.multires_normal > 0:
            d0 += extra
        return (d0,) + tuple(self.dims) + (self.d_out,)

    @classmethod
    def from_conf(cls, conf, feature_vector_size: int):
        return cls(
            feature_vector_size=feature_vector_size,
            mode=conf.get_string("mode", "idr"),
            d_in=conf.get_int("d_in", 9),
            d_out=conf.get_int("d_out", 3),
            dims=tuple(conf.get_list("dims", [256, 256])),
            multires_view=conf.get_int("multires_view", 4),
            multires_point=conf.get_int("multires_point", 4),
            multires_normal=conf.get_int("multires_normal", 4),
        )


class WNLinear(nn.Module):
    """Weight-normalised linear layer: w = g v / (||v||_row + 1e-12)."""

    def __init__(self, w: np.ndarray, b: np.ndarray):
        super().__init__()
        self.v = nn.Parameter(torch.tensor(w, dtype=torch.float32))
        self.g = nn.Parameter(torch.tensor(np.linalg.norm(w, axis=1),
                                           dtype=torch.float32))
        self.b = nn.Parameter(torch.tensor(b, dtype=torch.float32))

    def weight(self) -> torch.Tensor:
        norm = torch.linalg.norm(self.v, dim=1, keepdim=True)
        return self.v * (self.g[:, None] / (norm + 1e-12))

    def forward(self, x):
        return x @ self.weight().T + self.b


class PlainLinear(nn.Module):
    def __init__(self, w: np.ndarray, b: np.ndarray):
        super().__init__()
        self.w = nn.Parameter(torch.tensor(w, dtype=torch.float32))
        self.b = nn.Parameter(torch.tensor(b, dtype=torch.float32))

    def forward(self, x):
        return x @ self.w.T + self.b


def softplus100(x: torch.Tensor) -> torch.Tensor:
    """Softplus with beta 100, as softplus(100 x) / 100."""
    return F.softplus(100.0 * x) / 100.0


def _kaiming(rng, in_dim: int, out_dim: int) -> PlainLinear:
    """torch.nn.Linear's default init (kaiming-uniform + uniform bias)."""
    bw = math.sqrt(1.0 / in_dim) * math.sqrt(3.0)
    bb = math.sqrt(1.0 / in_dim)
    return PlainLinear(rng.uniform(-bw, bw, (out_dim, in_dim)),
                       rng.uniform(-bb, bb, out_dim))


def require_ported(cfg: ImplicitNetworkConfig) -> None:
    """Raise on a network this reference does not run."""
    if cfg.level_dim != 2:
        raise NotImplementedError(f"level_dim {cfg.level_dim}: the hash "
                                  "grid reads two channels a row")
    if cfg.grid_interp != "trilinear":
        raise NotImplementedError(f"grid_interp {cfg.grid_interp!r}")
    if not (cfg.color_grid_feature and cfg.use_grid_feature):
        raise NotImplementedError("a network without a colour grid or "
                                  "without grid features")


class ImplicitNetwork(nn.Module):
    """ObjectImplicitNetworkGrid: hash-grid features + sin/cos embedding ->
    weight-norm softplus MLP -> K object SDFs; the colour grid through a
    two-layer ReLU MLP gives the feature vectors. Geometric init flips the
    background's sign against the objects."""

    def __init__(self, cfg: ImplicitNetworkConfig, seed: int = 0):
        super().__init__()
        require_ported(cfg)
        self.cfg = cfg
        rng = np.random.default_rng(seed)
        dims = cfg.layer_dims
        n_layers = len(dims) - 1
        layers = {}
        for i in range(n_layers):
            in_dim, out_dim = dims[i], dims[i + 1]
            if i + 1 in cfg.skip_in:
                out_dim = dims[i + 1] - dims[0]
            w = rng.normal(0.0, np.sqrt(2) / np.sqrt(out_dim),
                           (out_dim, in_dim))
            b = np.zeros(out_dim)
            if cfg.geometric_init:
                if i == n_layers - 1:
                    w = rng.normal(0.0, 1e-4, (out_dim, in_dim))
                    w[0, :] += -np.sqrt(np.pi) / np.sqrt(in_dim)
                    w[1:, :] += np.sqrt(np.pi) / np.sqrt(in_dim)
                    b[0] = cfg.bias
                    b[1:] = -0.5 * cfg.bias
                elif cfg.multires > 0 and i == 0:
                    w = np.zeros((out_dim, in_dim))
                    w[:, :3] = rng.normal(0.0, np.sqrt(2) / np.sqrt(out_dim),
                                          (out_dim, 3))
            layers[f"lin{i}"] = WNLinear(w, b)
        gen = torch.Generator().manual_seed(seed)
        self.grid = nn.Parameter(init_hash_embeddings(cfg.grid_meta, gen))
        self.mlp = nn.ModuleDict(layers)
        self.color_grid = nn.Parameter(
            init_hash_embeddings(cfg.grid_meta, gen))
        grid_dim = cfg.num_levels * cfg.level_dim
        self.color_map_mlp = nn.ModuleDict({
            "lin0": _kaiming(rng, grid_dim, 256),
            "lin1": _kaiming(rng, 256, cfg.feature_vector_size)})

    def _layers(self):
        return [self.mlp[f"lin{i}"] for i in range(len(self.mlp))]

    def trunk(self, x: torch.Tensor, feature: torch.Tensor) -> torch.Tensor:
        """Positional-embed x, concat the grid features, run the
        weight-norm softplus layers: the raw head output [N, K]."""
        h = torch.cat([positional_encoding(x, self.cfg.multires), feature],
                      -1)
        inp = h
        layers = self._layers()
        for i, lin in enumerate(layers):
            if i in self.cfg.skip_in:
                h = torch.cat([h, inp], -1) / np.sqrt(2)
            h = lin(h)
            if i < len(layers) - 1:
                h = softplus100(h)
        return h

    def trunk_jvp(self, x, feature, tx, tfeat):
        """trunk and its tangents: tx [T, N, 3], tfeat [T, N, F] ->
        (raw [N, K], traw [T, N, K])."""
        mr = self.cfg.multires
        h = torch.cat([positional_encoding(x, mr), feature], -1)
        th = torch.cat([positional_encoding_jvp(x, tx, mr), tfeat], -1)
        inp, tinp = h, th
        layers = self._layers()
        for i, lin in enumerate(layers):
            if i in self.cfg.skip_in:
                h = torch.cat([h, inp], -1) / np.sqrt(2)
                th = torch.cat([th, tinp], -1) / np.sqrt(2)
            w = lin.weight()
            h = h @ w.T + lin.b
            th = th @ w.T
            if i < len(layers) - 1:
                th = torch.sigmoid(100.0 * h) * th
                h = softplus100(h)
        return h, th

    def color_features(self, cf: torch.Tensor) -> torch.Tensor:
        cf = torch.relu(self.color_map_mlp["lin0"](cf))
        return self.color_map_mlp["lin1"](cf)

    def split(self, h: torch.Tensor, cf: torch.Tensor | None):
        """The trunk's head h -> (sdf_raw [N, K], feature vectors [N, F] or
        None): the head is the SDFs and the features come from the colour
        grid's encode cf (None: none asked for)."""
        return h, None if cf is None else self.color_features(cf)

    def encode(self, x01: torch.Tensor, with_color: bool):
        """(grid features [N, 2L], J [2L, 3, N], colour-grid features or
        None) of x01 [N, 3] from one H1 call."""
        out = hash_encode_fused_dual(
            x01, self.grid, self.color_grid if with_color else None,
            self.cfg.grid_meta)
        return out[0], out[1], out[2] if with_color else None


def semantic_from_sdf(sdf_raw: torch.Tensor, k: float) -> torch.Tensor:
    return k * torch.sigmoid(-k * sdf_raw)


def _x01(net: ImplicitNetwork, x: torch.Tensor) -> torch.Tensor:
    return ((x / net.cfg.divide_factor + 1.0) * 0.5).contiguous()


def implicit_get_outputs(net: ImplicitNetwork, x: torch.Tensor,
                         create_graph: bool = True):
    """The vjp gradient mode (JAX implicit_get_outputs, fields.py:449):
    x [N, 3] -> (sdf [N], feature_vectors [N, F], gradients [N, 3],
    semantic [N, K], sdf_raw [N, K]); gradients = d scene-SDF / dx, the
    tie-sharing min cotangent eq / eq.sum(-1) pulled back through the MLP
    trunk and J_a from one H1 call. create_graph=False keeps no graph for
    the outer backward."""
    cfg = net.cfg
    feats, J, cf = net.encode(_x01(net, x.detach()), True)
    with torch.enable_grad():
        f_in = (feats if create_graph and feats.requires_grad
                else feats.detach().requires_grad_(True))
        p_in = x.detach().requires_grad_(True)
        sdf_raw, feature_vectors = net.split(net.trunk(p_in, f_in), cf)
        sdf = torch.amin(sdf_raw, -1)
        eq = (sdf_raw == sdf[:, None]).to(sdf_raw.dtype).detach()
        ct_sdf = eq / eq.sum(-1, keepdim=True)
        ct_feat, ct_x = torch.autograd.grad(sdf_raw, (f_in, p_in), ct_sdf,
                                            create_graph=create_graph)
    gradients = (torch.einsum("nf,fdn->nd", ct_feat, J)
                 * (1.0 / (2.0 * cfg.divide_factor)) + ct_x)
    semantic = semantic_from_sdf(sdf_raw, cfg.sigmoid)
    return sdf, feature_vectors, gradients, semantic, sdf_raw


def _min_tangent(raw: torch.Tensor, traw: torch.Tensor) -> torch.Tensor:
    """The tangent of the min over the last axis: ties share it equally, as
    JAX's reduce_min jvp does. raw [N, K], traw [T, N, K] -> [T, N]."""
    eq = (raw == torch.amin(raw, -1, keepdim=True)).to(raw.dtype).detach()
    return (traw * eq).sum(-1) / eq.sum(-1)


def _tangents(net: ImplicitNetwork, x: torch.Tensor, J: torch.Tensor):
    """The three basis tangents of the points and of the grid features
    (J [F, 3, N] scaled by d x01 / dx): ([3, N, 3], [3, N, F])."""
    n = x.shape[0]
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    tx = eye[:, None, :].expand(3, n, 3)
    return tx, J.permute(1, 2, 0) * (0.5 / net.cfg.divide_factor)


def implicit_all_gradients(net: ImplicitNetwork, x: torch.Tensor):
    """Jacobian of the K object SDFs and the scene SDF w.r.t. the points,
    [N, K+1, 3], by three forward-mode tangents through the trunk from one
    single-table H1 call (features + J of the SDF grid); also returns the
    raw SDFs [N, K] of the same evaluation."""
    feats, J, _ = net.encode(_x01(net, x.detach()), False)
    tx, tfeat = _tangents(net, x, J)
    h, th = net.trunk_jvp(x.detach(), feats, tx, tfeat)
    raw = net.split(h, None)[0]
    traw = th[..., :raw.shape[-1]]
    grads = torch.cat([traw, _min_tangent(raw, traw)[..., None]], -1)
    return grads.permute(1, 2, 0), raw


def implicit_sdf_raw_sampler(net: ImplicitNetwork, x: torch.Tensor,
                             grid_levels: int | None = None) -> torch.Tensor:
    """SDF-only forward for the sampler's probes (H2, no gradient)."""
    cfg = net.cfg
    with torch.no_grad():
        feats = hash_encode_sampler(_x01(net, x), net.grid, cfg.grid_meta,
                                    grid_levels)
        miss = cfg.num_levels * cfg.level_dim - feats.shape[-1]
        if miss:
            feats = F.pad(feats, (0, miss))
        return net.split(net.trunk(x, feats), None)[0]


class RenderingNetwork(nn.Module):
    """IDR rendering MLP on (points, view dirs, normals, features); points
    and normals are embedded with the view embedder, as the reference
    does."""

    def __init__(self, cfg: RenderingNetworkConfig, seed: int = 0):
        super().__init__()
        if cfg.mode != "idr":
            raise NotImplementedError(f"rendering mode {cfg.mode!r}")
        self.cfg = cfg
        rng = np.random.default_rng(seed)
        dims = cfg.layer_dims
        layers = {}
        for i in range(len(dims) - 1):
            bound = math.sqrt(1.0 / dims[i])
            w = rng.uniform(-bound * math.sqrt(3), bound * math.sqrt(3),
                            (dims[i + 1], dims[i]))
            layers[f"lin{i}"] = WNLinear(w, rng.uniform(-bound, bound,
                                                        dims[i + 1]))
        self.mlp = nn.ModuleDict(layers)

    def forward(self, points, normals, view_dirs, feature_vectors):
        cfg = self.cfg
        if cfg.multires_view > 0:
            view_dirs = positional_encoding(view_dirs, cfg.multires_view)
        if cfg.multires_point > 0:
            points = positional_encoding(points, cfg.multires_view)
        if cfg.multires_normal > 0:
            normals = positional_encoding(normals, cfg.multires_view)
        h = torch.cat([points, view_dirs, normals, feature_vectors], -1)
        n_layers = len(self.mlp)
        for i in range(n_layers):
            h = self.mlp[f"lin{i}"](h)
            if i < n_layers - 1:
                h = torch.relu(h)
        return torch.sigmoid(h[:, :3])
