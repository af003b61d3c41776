"""A (data, model) grid of ranks over torch.distributed, and the sharding
policy of the Stage-1 parameters (port of holoscene_tpu/parallel/mesh.py).

  * `data` axis: ray batches. Each data rank renders its rows of the
    global batch; the loss is computed on the rows of every rank
    (`gather_rows`), identically on each, and the parameter gradients are
    summed over the data ranks (`reduce_grads`).
  * `model` axis: hash-table rows (and MLP output rows, as JAX's rules
    say). A sharded parameter is stored and updated as this rank's rows
    (`shard_params`, `shard_optimizer`); the full tensor the forward reads
    is reassembled after every update (`gather_params`).

Rank r sits at (data r // n_model, model r % n_model), as jax's
`np.array(devices).reshape(n_data, n_model)` places device r. The caller
initialises the process group (address, world size and rank given
explicitly). Only all_reduce is used, so the gloo backend serves CUDA
tensors too (two ranks on one card, where NCCL refuses to run): a row
all-gather is the all_reduce of the zero-filled full tensor, exact since
each element is summed with zeros only.

Unlike JAX, whose GSPMD places the collectives, the port's Stage-1 step
makes them itself (training/stage1.py::train_step with a mesh)."""

from __future__ import annotations

import dataclasses
import re

import torch
import torch.distributed as dist
from torch import nn

MODEL_SHARDED = ("model", None)
REPLICATED = ()

# The explicit per-parameter tensor-parallel policy, JAX's _TP_RULES keyed
# by the port's parameter names (the JAX paths joined with dots): anchored
# patterns, first match wins. A LARGE parameter no rule covers raises
# instead of silently replicating.
_TP_RULES: tuple[tuple[str, tuple], ...] = (
    # hash-table rows (implicit.grid, implicit.color_grid): row-sharded
    (r"^implicit\.(color_)?grid$", MODEL_SHARDED),
    # MLP weight matrices (weight-norm v or plain w): output-dim sharded
    (r"^(implicit|rendering)\.(color_map_)?mlp\.lin\d+\.[vw]$",
     MODEL_SHARDED),
    # weight-norm gains / biases / scalars: replicated
    (r"^(implicit|rendering)\.(color_map_)?mlp\.lin\d+\.[bg]$", REPLICATED),
    (r"^density\.beta$", REPLICATED),
    # opt-in camera refinement (models/cam_opt.py): tiny, replicated
    (r"^cam_opt(\..*)?$", REPLICATED),
)
_TP_RAISE_ELEMS = 1 << 16  # parameters this big must have an explicit rule


@dataclasses.dataclass
class Mesh:
    """This rank's place in the (data, model) grid and its two groups: the
    data group (the ranks of its model column, which split the batch) and
    the model group (the ranks of its data row, which split the tables)."""

    n_data: int
    n_model: int
    rank: int
    data_group: object
    model_group: object

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "model": self.n_model}

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model


def make_mesh(n_data: int | None = None, n_model: int = 1) -> Mesh:
    """The (data, model) grid over the initialised process group; defaults
    to every rank on the data axis. Every rank must call it (it creates
    the groups collectively)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialised")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data} x {n_model} does not cover the "
                         f"world of {world} ranks")
    rank = dist.get_rank()
    data_group = model_group = None
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(n_data)])
        if rank % n_model == m:
            data_group = g
    for d in range(n_data):
        g = dist.new_group([d * n_model + m for m in range(n_model)])
        if rank // n_model == d:
            model_group = g
    return Mesh(n_data, n_model, rank, data_group, model_group)


def _rows(n: int, parts: int, index: int, what: str) -> slice:
    if n % parts:
        raise ValueError(f"{what} of {n} rows does not split over {parts} "
                         "ranks")
    k = n // parts
    return slice(index * k, (index + 1) * k)


def batch_sharding(mesh: Mesh, n: int) -> slice:
    """This rank's rows of an n-row global batch (leading axis over
    `data`)."""
    return _rows(n, mesh.n_data, mesh.data_index, "a batch")


def param_sharding(mesh: Mesh, named_params) -> dict:
    """{name: MODEL_SHARDED or REPLICATED} for (name, tensor) pairs (a
    module's named_parameters()), from `_TP_RULES`. A dimension that does
    not split evenly replicates; on a 1-sized model axis everything
    replicates. A large parameter with no rule raises."""
    out = {}
    for name, p in named_params:
        spec = None
        for pat, rule in _TP_RULES:
            if re.match(pat, name):
                spec = rule
                break
        if spec is None:
            if p.numel() >= _TP_RAISE_ELEMS:
                raise ValueError(
                    f"no tensor-parallel rule for large param '{name}' "
                    f"{tuple(p.shape)}; add it to parallel/mesh.py _TP_RULES")
            spec = REPLICATED
        if mesh.n_model == 1 or (spec and p.shape[0] % mesh.n_model):
            spec = REPLICATED
        out[name] = spec
    return out


def shard_rows(mesh: Mesh, n: int) -> slice:
    """This rank's rows of a model-sharded tensor of n rows."""
    return _rows(n, mesh.n_model, mesh.model_index, "a sharded tensor")


def shard_params(mesh: Mesh, model: nn.Module) -> dict:
    """{name: this rank's rows as a new leaf parameter} for every
    model-sharded parameter of `model` (empty on a 1-sized model axis)."""
    specs = param_sharding(mesh, model.named_parameters())
    return {name: nn.Parameter(p.detach()[shard_rows(mesh, p.shape[0])]
                               .clone())
            for name, p in model.named_parameters()
            if specs[name] == MODEL_SHARDED}


def gather_rows(x: torch.Tensor, rows: slice, n: int, group) -> torch.Tensor:
    """The full n-row tensor from each rank's rows (x holds `rows`): the
    all_reduce of the zero-filled full tensor. Differentiable: the
    backward takes this rank's rows of the cotangent and does not reduce
    it, which is right when every rank computes the same function of the
    gathered tensor (then the cotangents agree); the parameter gradients
    are summed over the ranks afterwards (reduce_grads)."""
    return _GatherRows.apply(x, rows, n, group)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rows, n, group):
        ctx.rows = rows
        wire = x.to(torch.int32) if x.dtype == torch.bool else x
        full = wire.new_zeros((n,) + tuple(x.shape[1:]))
        full[rows] = wire
        dist.all_reduce(full, group=group)
        return full.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rows], None, None, None


def all_reduce_sum(tensors: list, group) -> None:
    """Sum each tensor over the group in place, in one all_reduce."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    i = 0
    for t in tensors:
        t.copy_(flat[i:i + t.numel()].view_as(t))
        i += t.numel()


@torch.no_grad()
def gather_params(mesh: Mesh, model: nn.Module, shards: dict) -> None:
    """Write the full value of every sharded parameter into `model` from
    the model group's shards."""
    if not shards:
        return
    fulls = []
    for name, s in shards.items():
        p = model.get_parameter(name)
        full = torch.zeros_like(p)
        full[shard_rows(mesh, p.shape[0])] = s
        fulls.append(full)
    all_reduce_sum(fulls, mesh.model_group)
    for name, full in zip(shards, fulls):
        model.get_parameter(name).copy_(full)


@torch.no_grad()
def reduce_grads(mesh: Mesh, model: nn.Module, shards: dict,
                 scale: float = 1.0) -> None:
    """Sum every parameter gradient over the data group (times scale: 1
    for a loss over the global batch, 1 / n_data for a mean of per-rank
    losses); a parameter without one contributes zeros. A sharded
    parameter's shard then takes its rows of the sum."""
    params = list(model.parameters())
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    all_reduce_sum(grads, mesh.data_group)
    if scale != 1.0:
        for g in grads:
            g.mul_(scale)
    for name, s in shards.items():
        g = model.get_parameter(name).grad
        s.grad = g[shard_rows(mesh, g.shape[0])].clone()


def shard_optimizer(mesh: Mesh, optimizer: torch.optim.Optimizer,
                    model: nn.Module, shards: dict) -> None:
    """Make `optimizer` (built over model's full parameters) update the
    shards instead: each sharded parameter is swapped for its shard in its
    group, and its state (Adam's moments) cut to the shard's rows."""
    by_id = {id(model.get_parameter(n)): n for n in shards}
    for group in optimizer.param_groups:
        for i, p in enumerate(group["params"]):
            name = by_id.get(id(p))
            if name is None:
                continue
            s = shards[name]
            rows = shard_rows(mesh, p.shape[0])
            state = optimizer.state.pop(p, None)
            if state:
                optimizer.state[s] = {
                    k: (v[rows].clone() if torch.is_tensor(v)
                        and v.shape == p.shape else v)
                    for k, v in state.items()}
            group["params"][i] = s


@torch.no_grad()
def full_optimizer_state(mesh: Mesh, optimizer: torch.optim.Optimizer,
                         model: nn.Module, shards: dict) -> dict:
    """optimizer.state_dict() with every shard's moments reassembled to
    the full parameter's rows: what a single-process optimizer over the
    model holds. A collective: every rank calls it."""
    sd = optimizer.state_dict()
    if not shards:
        return sd
    full_shape = {id(s): model.get_parameter(n).shape
                  for n, s in shards.items()}
    index = 0
    pending = []
    for group in optimizer.param_groups:
        for p in group["params"]:
            shape = full_shape.get(id(p))
            st = sd["state"].get(index)
            if shape is not None and st:
                # state_dict() shares the live state's dicts: copy first
                st = sd["state"][index] = dict(st)
                for k, v in list(st.items()):
                    if torch.is_tensor(v) and v.shape == p.shape:
                        full = v.new_zeros(shape)
                        full[shard_rows(mesh, shape[0])] = v
                        st[k] = full
                        pending.append(full)
            index += 1
    all_reduce_sum(pending, mesh.model_group)
    return sd


def all_reduce_min(mesh: Mesh):
    """x -> its elementwise min over the data group (in place)."""

    def reduce(x):
        dist.all_reduce(x, op=dist.ReduceOp.MIN, group=mesh.data_group)
        return x

    return reduce
