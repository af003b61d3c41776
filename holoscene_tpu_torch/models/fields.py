"""Neural fields of Stage 1 (port of holoscene_tpu/models/fields.py): the
object-compositional SDF network with its hash grids and the IDR rendering
network, as nn.Modules that keep the JAX parameter names (`grid`,
`color_grid`, `mlp.lin{i}.{v,g,b}`, `color_map_mlp.lin{0,1}.{w,b}`).

The render path is `implicit_get_outputs_fused`: hash-grid features, their
analytic jacobian and the colour-grid features from one H1 call
(ops/hashgrid.py), the scene-SDF gradient by the chain rule through the MLP
trunk (an inner autograd.grad with create_graph, so the outer backward
reaches H1-bwd with the second-order cotangent). The vjp gradient mode,
`implicit_get_outputs` (the JAX default, and the background patch's field),
is the same construction in H1-bwd's exact mode. The jvp gradient mode,
`implicit_get_outputs_jvp`, pushes three tangents through the trunk from
H1's J (forward mode, as JAX's three jvps), and so do the eikonal
jacobians of `implicit_all_gradients`, from the single-table H1 call.
`implicit_forward` / `implicit_sdf_raw` are the plain forward through H1.
The sampler's probes go through `implicit_sdf_raw_sampler` (H2, no
gradient). Stage 3's colour field (`ColorField`, `color_field_forward`)
encodes through the packed encode with its table gradient (H2 forward,
H1-bwd backward).

Every network variant of the JAX package runs: `grid_interp` trilinear or
tetrahedral (H1 / H2's tetrahedral instantiations), the fused encode's
`fused_fetch` packed or raw, no colour grid (`color_grid_feature = false`:
the feature vectors are the head's columns after the K SDFs), no grid
features (`use_grid_feature = false`: zeros in their place, the colour
grid still encoded), `fused_dual_grid` (H1 fetches both tables in one pass
whatever it says), and the rendering network's `mode = nerf`.
`level_dim` other than 2 is refused (`require_ported` says why)."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from holoscene_tpu_torch.ops.embedder import (
    embedder_out_dim,
    positional_encoding,
    positional_encoding_jvp,
)
from holoscene_tpu_torch.ops.hashgrid import (
    FETCHES,
    INTERPS,
    HashGridMeta,
    hash_encode_fused_dual,
    hash_encode_packed,
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
    fused_dual_grid: bool = False
    grid_interp: str = "trilinear"
    dense_max_res: int = 0
    fused_fetch: str = "packed"
    color_bwd_sample: bool = True
    sdf_bwd_sample: bool = True

    def __post_init__(self):
        if self.sdf_bwd_sample and not self.color_bwd_sample:
            raise ValueError("sdf_bwd_sample=True requires "
                             "color_bwd_sample=True")

    @property
    def fused_ok(self) -> bool:
        """The fused encode's configs (JAX holoscene.py:358 fused_ok): a
        colour grid, grid features, trilinear interpolation."""
        return (self.color_grid_feature and self.use_grid_feature
                and self.grid_interp == "trilinear")

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
        out = (self.d_out if self.color_grid_feature
               else self.d_out + self.feature_vector_size)
        d0 = self.d_in + grid_dim
        if self.multires > 0:
            d0 += embedder_out_dim(self.multires, self.d_in) - self.d_in
        return (d0,) + tuple(self.dims) + (out,)

    @classmethod
    def from_conf(cls, conf, feature_vector_size: int):
        cb = conf.get_bool("color_bwd_sample", True)
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
            fused_dual_grid=conf.get_bool("fused_dual_grid", False),
            grid_interp=conf.get_string("grid_interp", "trilinear"),
            dense_max_res=conf.get_int("dense_max_res", 0),
            fused_fetch=conf.get_string("fused_fetch", "packed"),
            color_bwd_sample=cb,
            sdf_bwd_sample=conf.get_bool("sdf_bwd_sample", cb),
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
        if self.multires_point > 0 and self.mode == "idr":
            d0 += extra
        if self.multires_normal > 0 and self.mode == "idr":
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


LEVEL_DIM_REASON = (
    "level_dim {} is not run: every Stage-1 render of the JAX package "
    "builds build_dense_block_tables (holoscene_tpu/models/holoscene.py:"
    "228), which asserts level_dim == 2 (holoscene_tpu/ops/hashgrid.py:586),"
    " so no JAX configuration trains another; the port's hash-grid kernels "
    "read two channels a row")


def require_ported(cfg: ImplicitNetworkConfig) -> None:
    """Raise on a network the port does not run: level_dim other than 2
    (LEVEL_DIM_REASON), or an unknown interpolation or fetch."""
    if cfg.level_dim != 2:
        raise NotImplementedError(LEVEL_DIM_REASON.format(cfg.level_dim))
    if cfg.grid_interp not in INTERPS:
        raise ValueError(f"grid_interp must be one of {INTERPS}, got "
                         f"{cfg.grid_interp!r}")
    if cfg.fused_fetch not in FETCHES:
        raise ValueError(f"fused_fetch must be one of {FETCHES}, got "
                         f"{cfg.fused_fetch!r}")


class ImplicitNetwork(nn.Module):
    """ObjectImplicitNetworkGrid: hash-grid features + sin/cos embedding ->
    weight-norm softplus MLP -> K object SDFs; the colour grid through a
    two-layer ReLU MLP gives the feature vectors (without a colour grid,
    the MLP's head gives them after the K SDFs, and there is no
    `color_grid` / `color_map_mlp`). Geometric init flips the background's
    sign against the objects."""

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
        self.color_grid = self.color_map_mlp = None
        if cfg.color_grid_feature:
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
        None): with a colour grid the head is the SDFs and the features come
        from its encode cf (None: none asked for); without one the head's
        columns after the K SDFs are the features."""
        if self.cfg.color_grid_feature:
            return h, None if cf is None else self.color_features(cf)
        d = self.cfg.d_out
        return h[:, :d], h[:, d:]

    def encode(self, x01: torch.Tensor, with_color: bool,
               levels: int | None = None, mode: str = "exact", u_b=None,
               u_a=None, fetch: str = "packed"):
        """(grid features [N, 2l], J [2l, 3, N], colour-grid features or
        None) of x01 [N, 3] at the first `levels` levels (all by default),
        from one H1 call in the network's stencil. `fetch` is the fused
        gradient mode's fused_fetch (JAX reads it there alone; every other
        encode of JAX's is the packed one). Without grid features
        (use_grid_feature = false) the features and J are zeros, as JAX's
        render takes them, and the colour grid is encoded alone."""
        cfg = self.cfg
        want_b = with_color and cfg.color_grid_feature
        if cfg.use_grid_feature:
            out = hash_encode_fused_dual(
                x01, self.grid, self.color_grid if want_b else None,
                cfg.grid_meta, levels, mode, u_b, u_a, cfg.grid_interp, fetch)
            return out[0], out[1], out[2] if want_b else None
        n = x01.shape[0]
        width = cfg.level_dim * (levels or cfg.num_levels)
        feats = x01.new_zeros(n, width)
        J = x01.new_zeros(width, 3, n)
        cf = None
        if want_b:
            cf = hash_encode_fused_dual(x01, self.color_grid, None,
                                        cfg.grid_meta, levels,
                                        interp=cfg.grid_interp)[0]
        return feats, J, cf


def semantic_from_sdf(sdf_raw: torch.Tensor, k: float) -> torch.Tensor:
    return k * torch.sigmoid(-k * sdf_raw)


def _x01(net: ImplicitNetwork, x: torch.Tensor) -> torch.Tensor:
    return ((x / net.cfg.divide_factor + 1.0) * 0.5).contiguous()


def implicit_get_outputs_fused(net: ImplicitNetwork, x: torch.Tensor,
                               mode: str = "exact", u_b=None, u_a=None,
                               coarse_levels: int | None = None,
                               create_graph: bool = True,
                               fetch: str | None = None):
    """x [N, 3] -> (sdf [N], feature_vectors [N, F], gradients [N, 3],
    semantic [N, K], sdf_raw [N, K]); gradients = d scene-SDF / dx from one
    H1 call. coarse_levels encodes only that prefix (fine features and J
    zero-padded). mode / u_b / u_a select H1-bwd's hashed-level scatter
    (ops/hashgrid.py); fetch defaults to the config's fused_fetch.
    create_graph=False (eval) keeps no graph for the outer backward."""
    cfg = net.cfg
    L = cfg.num_levels
    levels = coarse_levels if coarse_levels and coarse_levels < L else None
    feats, J, cf = net.encode(
        _x01(net, x.detach()), True, levels, mode, u_b, u_a,
        cfg.fused_fetch if fetch is None else fetch)
    miss = L * cfg.level_dim - feats.shape[-1]
    if miss:
        feats = F.pad(feats, (0, miss))
        cf = None if cf is None else F.pad(cf, (0, miss))
        J = F.pad(J, (0, 0, 0, 0, 0, miss))
    with torch.enable_grad():
        # the features carry the outer graph when they have one (not the
        # zeros of a network without grid features)
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


def implicit_get_outputs(net: ImplicitNetwork, x: torch.Tensor,
                         create_graph: bool = True):
    """The vjp gradient mode (JAX implicit_get_outputs, fields.py:449):
    (sdf, feature_vectors, gradients, semantic, sdf_raw) as
    implicit_get_outputs_fused returns them, with H1-bwd in exact mode
    (JAX's vjp mode has no sampled backward) and the packed fetch (JAX's
    vjp mode reads the packed hash_encode whatever fused_fetch says).

    JAX builds the scene-SDF gradient as the pullback of the tie-sharing
    min cotangent eq / eq.sum(-1) through one forward of the packed
    hash_encode; here it is the same cotangent pulled back through the MLP
    trunk and J_a from H1, which is that pullback written out. The two
    encodes differ in one index rule: the packed encode wraps a dense
    level's row index modulo the level's size, H1 clamps the dense cell to
    [0, res - 2]. They pick different cells only for a point with a
    coordinate at exactly x01 = 1 on a level whose scale * 1 is an integer,
    and there the corners they disagree on carry zero weight, so features,
    J and table gradients agree to rounding (tests/test_torch_fields.py
    pins this). The tetrahedral stencil wraps as JAX's does: its J does
    not vanish at a face (csrc/hash_grid.cuh::tet_rows)."""
    return implicit_get_outputs_fused(net, x, "exact",
                                      create_graph=create_graph,
                                      fetch="packed")


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


def implicit_get_outputs_jvp(net: ImplicitNetwork, x: torch.Tensor):
    """The jvp gradient mode (JAX implicit_get_outputs_jvp, fields.py:479):
    the outputs of implicit_get_outputs, the scene-SDF gradient from three
    forward-mode tangents through the trunk (trunk_jvp), whose grid-feature
    tangents are H1's J (one H1 call, both tables, exact backward: the
    outer backward reaches H1-bwd through J, as JAX's reverse pass through
    its jvp-augmented graph does). The min's tangent shares ties as JAX's
    reduce_min jvp does."""
    feats, J, cf = net.encode(_x01(net, x.detach()), True)
    tx, tfeat = _tangents(net, x, J)
    h, th = net.trunk_jvp(x.detach(), feats, tx, tfeat)
    sdf_raw, feature_vectors = net.split(h, cf)
    traw = th[..., :sdf_raw.shape[-1]]
    gradients = _min_tangent(sdf_raw, traw).T
    sdf = torch.amin(sdf_raw, -1)
    semantic = semantic_from_sdf(sdf_raw, net.cfg.sigmoid)
    return sdf, feature_vectors, gradients, semantic, sdf_raw


def implicit_forward(net: ImplicitNetwork, x: torch.Tensor,
                     with_features: bool = True):
    """x [N, 3] -> (sdf_raw [N, K], feature_vectors [N, F] or None): the
    SDF network's forward (JAX implicit_forward, packed fetch), both tables
    from one H1 call (its jacobian unused); with_features=False encodes the
    SDF table alone. Differentiable in the parameters (H1-bwd, exact); the
    points' cotangent is computed on the CPU only (ops/hashgrid.py)."""
    feats, _, cf = net.encode(_x01(net, x), with_features)
    sdf_raw, feature_vectors = net.split(net.trunk(x, feats), cf)
    return sdf_raw, feature_vectors if with_features else None


def implicit_sdf_raw(net: ImplicitNetwork, x: torch.Tensor) -> torch.Tensor:
    """The object SDFs [N, K] alone (JAX implicit_sdf_raw)."""
    return implicit_forward(net, x, with_features=False)[0]


def implicit_scene_sdf(net: ImplicitNetwork, x: torch.Tensor) -> torch.Tensor:
    """Scene SDF [N] = the min over the object SDFs (JAX
    implicit_scene_sdf; reference model/network.py:287)."""
    return torch.amin(implicit_sdf_raw(net, x), -1)


def implicit_object_sdf(net: ImplicitNetwork, x: torch.Tensor,
                        idx: int) -> torch.Tensor:
    """Object idx's SDF [N] (JAX implicit_object_sdf)."""
    return implicit_sdf_raw(net, x)[:, idx]


def implicit_multi_object_sdf(net: ImplicitNetwork, x: torch.Tensor,
                              idxs) -> torch.Tensor:
    """The min over the objects idxs' SDFs [N] (JAX
    implicit_multi_object_sdf)."""
    return torch.amin(implicit_sdf_raw(net, x)[:, list(idxs)], -1)


def implicit_sdf_raw_grid(net: ImplicitNetwork,
                          x: torch.Tensor) -> torch.Tensor:
    """The object SDFs [N, K] for mesh extraction's grid evaluation: JAX
    implicit_sdf_raw (the packed encode, every level's values rounded to
    bf16), no gradient, every level through H2 in its packed mode (H1-fwd
    would also write the [P, 2L, 3] jacobian, which a grid throws away).
    The packed encode wraps a dense level's row where H2 clamps the cell;
    they name different rows only at x01 = 1 on a level of integer scale,
    and those corners carry zero weight (tests/test_torch_extract.py, on
    the boundary planes of an extraction grid at every dense level). A
    tetrahedral field's grid goes through H2's tetrahedral stencil, which
    wraps as JAX's does; without grid features the grid reads zeros, as
    JAX's implicit_sdf_raw does."""
    cfg = net.cfg
    with torch.no_grad():
        if cfg.use_grid_feature:
            feats = hash_encode_sampler(_x01(net, x), net.grid, cfg.grid_meta,
                                        packed=True, interp=cfg.grid_interp)
        else:
            feats = x.new_zeros(x.shape[0], cfg.num_levels * cfg.level_dim)
        return net.split(net.trunk(x, feats), None)[0]


def implicit_shift_sdf_raw(net: ImplicitNetwork,
                           x: torch.Tensor) -> torch.Tensor:
    """Disentangled per-object SDFs [N, K] (JAX implicit_shift_sdf_raw):
    where the scene SDF (the min) is negative, every other object's SDF is
    raised to at least -min, and the winning object keeps the min, so a
    per-object extraction cannot take in another object's interior. On
    the grid evaluator (no gradient)."""
    raw = implicit_sdf_raw_grid(net, x)
    idx = torch.argmin(raw, -1)
    sdf = raw.gather(-1, idx[:, None])
    shifted = torch.where(sdf < 0.0, torch.maximum(raw, -sdf), raw)
    return shifted.scatter(-1, idx[:, None], sdf)


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
    """SDF-only forward for the sampler's probes (H2, no gradient). As
    JAX's (fields.py:375), it reads the SDF grid trilinearly whatever the
    network's grid_interp, and even without grid features
    (use_grid_feature = false), where the render reads zeros: the JAX
    package's sampler and render then see different fields (ROADMAP.md
    queue C), and the port keeps the JAX package's behaviour."""
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
    does. mode = nerf reads the view dirs and the features alone (JAX
    rendering_forward, fields.py:678)."""

    def __init__(self, cfg: RenderingNetworkConfig, seed: int = 0):
        super().__init__()
        if cfg.mode not in ("idr", "nerf"):
            raise NotImplementedError(f"rendering mode {cfg.mode!r}: JAX "
                                      f"knows idr and nerf")
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
        if cfg.mode == "nerf":
            h = torch.cat([view_dirs, feature_vectors], -1)
        else:
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


# ---------------------------------------------------------------------------
# ColorImplicitNetworkSingle (Stage-3 texture field)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ColorFieldConfig:
    base_size: int = 16
    end_size: int = 2048
    logmap: int = 19
    num_levels: int = 16
    level_dim: int = 2
    divide_factor: float = 1.5
    hidden: int = 256

    @property
    def grid_meta(self) -> HashGridMeta:
        return HashGridMeta(
            input_dim=3, num_levels=self.num_levels, level_dim=self.level_dim,
            base_resolution=self.base_size,
            log2_hashmap_size=self.logmap,
            desired_resolution=self.end_size)


class ColorField(nn.Module):
    """The colour field of one object (JAX init_color_field): a hash grid
    `grid` [rows, 2] (uniform +-1e-4) and four PlainLinear `mlp.lin{0..3}`
    (torch.nn.Linear's default init), drawn from `generator`."""

    def __init__(self, cfg: ColorFieldConfig = ColorFieldConfig(),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.grid = nn.Parameter(init_hash_embeddings(cfg.grid_meta,
                                                      generator))
        dims = (cfg.num_levels * cfg.level_dim, cfg.hidden, cfg.hidden,
                cfg.hidden, 3)
        layers = {}
        for i in range(4):
            bw = math.sqrt(1.0 / dims[i]) * math.sqrt(3.0)
            bb = math.sqrt(1.0 / dims[i])
            w = torch.rand(dims[i + 1], dims[i], generator=generator)
            b = torch.rand(dims[i + 1], generator=generator)
            layers[f"lin{i}"] = PlainLinear((w * 2 - 1).numpy() * bw,
                                            (b * 2 - 1).numpy() * bb)
        self.mlp = nn.ModuleDict(layers)


def color_field_forward(field: ColorField, x: torch.Tensor) -> torch.Tensor:
    """x [N, 3] world points -> rgb [N, 3] (JAX color_field_forward):
    x / divide_factor -> [0, 1] -> the packed encode (H2, table gradient
    through H1-bwd) -> 3 x (linear, ReLU) -> linear -> sigmoid."""
    cfg = field.cfg
    xn = x / cfg.divide_factor
    h = hash_encode_packed((xn + 1.0) * 0.5, field.grid, cfg.grid_meta)
    for i in range(4):
        h = field.mlp[f"lin{i}"](h)
        if i < 3:
            h = torch.relu(h)
    return torch.sigmoid(h)
