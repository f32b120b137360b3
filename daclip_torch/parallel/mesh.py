"""Process groups, device meshes, DDP, FSDP and tensor parallelism of the
port's two trainers.

Counterpart of `daclip_tpu/parallel/mesh.py` (reference da-clip/src/
training/distributed.py:24-137). daclip_tpu runs one program over a mesh
of devices and GSPMD inserts every collective; here one process drives one
card (torchrun's launch, the reference's), and the collectives are torch's:

  * `initialize_distributed`: torchrun's `env://` (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR/PORT), SLURM's variables, or a `tcp://` /
    `file://` `--dist-url`; NCCL on CUDA, gloo on the CPU or when asked;
    nothing in a plain process;
  * `mesh_from_spec`: `--mesh 'data[,fsdp[,model]]'` as a `DeviceMesh`
    whose product must be the world size (there is no shrinking to a
    divisor of the batch: a torchrun process cannot sit out);
  * `apply_ddp` (the `data` axis alone), `apply_fsdp` (FSDP2 over the
    (data, fsdp) sub-mesh, which is HSDP: replicated over `data`, sharded
    over `fsdp`, one unit per block; parameters under `min_size` stay
    replicated, as `fsdp_param_shardings` leaves them) and
    `apply_tensor_parallel` (the `model` axis, Megatron's column/row split
    of the towers' attention and MLP as DTensors, head-aware for the packed
    q/k/v projection; the layers' own forward sums over the axis);
  * the helpers the trainers call whatever the wrapping: `unwrap`,
    `data_group`, `no_sync`, `finish_grads`, `grad_norm`, and the
    checkpoints' `model_state` / `optimizer_state` (torch.distributed.
    checkpoint's full state dicts, in the single-card layout) and
    `full_tensors` for the EMA's shadows, with their loaders, so a file
    does not depend on the mesh it was written under.

Without a process group every helper is the identity, and the trainers run
as they do on one card.
"""
from __future__ import annotations

import contextlib
import datetime
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from daclip_torch.models.layers import local_tensor

# the launchers' variables, in the reference's order (distributed.py:24-40)
_LOCAL_RANK_VARS = ("LOCAL_RANK", "MPI_LOCALRANKID", "SLURM_LOCALID",
                    "OMPI_COMM_WORLD_LOCAL_RANK")
_RANK_VARS = ("RANK", "PMI_RANK", "SLURM_PROCID", "OMPI_COMM_WORLD_RANK")
_WORLD_VARS = ("WORLD_SIZE", "PMI_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE")


def _first_int(names: Sequence[str], default: int) -> int:
    for name in names:
        if name in os.environ:
            return int(os.environ[name])
    return default


def _world_info_from_env() -> Tuple[int, int, int]:
    """(local_rank, rank, world_size) from the launcher's variables
    (distributed.py:24-40)."""
    return (_first_int(_LOCAL_RANK_VARS, 0), _first_int(_RANK_VARS, 0),
            _first_int(_WORLD_VARS, 1))


def launched_distributed() -> bool:
    """True under torchrun (WORLD_SIZE set, at any size, so a one-process
    torchrun launch forms its group too) or a SLURM/MPI job of more than
    one task."""
    return "WORLD_SIZE" in os.environ or _first_int(_WORLD_VARS[1:], 1) > 1


def initialize_distributed(dist_url: str = "env://", backend: Optional[str] = None,
                           device=None, set_device_rank: bool = True,
                           timeout: Optional[datetime.timedelta] = None):
    """Form the process group the launcher describes and return (rank,
    world, local_rank, device); with no launcher in the environment return
    (0, 1, 0, device) and form none.

    `device` defaults to CUDA (raising without a GPU unless given "cpu").
    `backend`: NCCL on CUDA, gloo on the CPU; "gloo" is taken on either.
    On CUDA the process pins cuda:LOCAL_RANK unless `set_device_rank` is
    False (--no-set-device-rank: cuda:0, or the device given). Under SLURM
    the job's ids are copied into RANK / WORLD_SIZE / LOCAL_RANK, as the
    reference does (distributed.py:63-114). A group that fails to form
    raises: nothing falls back to one process. The ranks meet at a barrier
    once the group has formed."""
    from daclip_torch.pipeline import resolve_device

    dev = resolve_device(device)
    if not launched_distributed():
        return 0, 1, 0, dev
    local_rank, rank, world = _world_info_from_env()
    os.environ.update(LOCAL_RANK=str(local_rank), RANK=str(rank), WORLD_SIZE=str(world))
    if dev.type == "cuda":
        if set_device_rank:
            dev = torch.device("cuda", local_rank)
        elif dev.index is None:
            dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    if backend is None or dev.type != "cuda":
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {} if timeout is None else {"timeout": timeout}
    if not dist.is_initialized():
        if dev.type == "cuda" and backend == "nccl":
            kw["device_id"] = dev
        dist.init_process_group(backend=backend, init_method=dist_url or "env://",
                                world_size=world, rank=rank, **kw)
        # every rank has finished connecting before any returns: a rank that
        # then leaves at once (a refused flag) would otherwise close its
        # sockets under a peer still inside gloo's connectFullMesh
        dist.barrier(**({"device_ids": [dev.index]} if backend == "nccl" else {}))
    return dist.get_rank(), dist.get_world_size(), local_rank, dev


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank_seed(seed: int, r: int) -> int:
    """The seed of rank r's own draws (augmentation, noise): `seed` itself
    on rank 0, as in one process, and one drawn from (seed, r) on the
    others."""
    if r == 0:
        return seed
    import numpy as np

    return int(np.random.SeedSequence([seed, r]).generate_state(1)[0])


def barrier() -> None:
    if is_distributed():
        dist.barrier()


def parse_mesh(spec: Optional[str], world: int) -> Tuple[int, int, int]:
    """`--mesh 'data[,fsdp[,model]]'` → (data, fsdp, model); no spec (or
    "none") → (world, 1, 1). Raises ValueError when the product is not the
    world size, naming both."""
    if spec in (None, "", "none"):
        return world, 1, 1
    dims = [int(x) for x in str(spec).split(",")]
    if not 1 <= len(dims) <= 3 or min(dims) < 1:
        raise ValueError(f"--mesh {spec!r}: expected 'data[,fsdp[,model]]' of positive sizes")
    data, fsdp, model = (dims + [1, 1])[:3]
    if data * fsdp * model != world:
        raise ValueError(
            f"--mesh {spec} spans {data * fsdp * model} processes, and this run has "
            f"{world} (the world size{'' if is_distributed() else ': no process group'}); "
            f"launch {data * fsdp * model} processes, e.g. torchrun --nproc_per_node "
            f"{data * fsdp * model}")
    return data, fsdp, model


class Mesh:
    """The run's `DeviceMesh` over ("data", "fsdp"[, "model"]) and the groups
    the trainers use: `dp_group` (the ranks that take distinct data: the
    (data, fsdp) sub-mesh at this rank's `model` index) and `model_group`."""

    def __init__(self, data: int, fsdp: int, model: int, device_type: str):
        from torch.distributed.device_mesh import init_device_mesh

        self.shape = (data, fsdp, model)
        names = ("data", "fsdp", "model") if model > 1 else ("data", "fsdp")
        self.device_mesh = init_device_mesh(device_type, self.shape[:len(names)],
                                            mesh_dim_names=names)
        self.model_group = self.device_mesh["model"].get_group() if model > 1 else None
        if model == 1:
            self.dp_group = dist.group.WORLD
        else:  # every rank makes every group, in one order (rank = dp·model + m)
            groups = [dist.new_group(list(range(m, world_size(), model))) for m in range(model)]
            self.dp_group = groups[rank() % model]

    @property
    def dp_size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def dp_rank(self) -> int:
        """This rank's index among the ranks that take distinct data."""
        return rank() // self.shape[2]


def mesh_from_spec(spec: Optional[str], world: int, device_type: str = "cuda",
                   batch_size: Optional[int] = None) -> Optional[Mesh]:
    """The run's `Mesh`, or None in a plain process with no group and no
    mesh past one device. The product of the spec must be `world`; with
    `batch_size` (a global batch the ranks split) the ranks that take
    distinct data must divide it."""
    data, fsdp, model = parse_mesh(spec, world)
    if batch_size is not None and batch_size % (data * fsdp):
        raise ValueError(f"the batch of {batch_size} does not split over the "
                         f"{data * fsdp} ranks of --mesh {spec or world} that take distinct "
                         "rows (daclip_tpu shrinks its mesh to a divisor; a torchrun "
                         "process cannot sit out)")
    if not is_distributed():
        return None
    return Mesh(data, fsdp, model, device_type)


# -- wrappers ---------------------------------------------------------------------
def unwrap(model: nn.Module) -> nn.Module:
    """The module under a DDP wrapper (FSDP2 and tensor parallelism keep
    the module itself)."""
    from torch.nn.parallel import DistributedDataParallel

    return model.module if isinstance(model, DistributedDataParallel) else model


def data_group(model: nn.Module):
    """The group over which a wrapped model's features are gathered and its
    gradients averaged; None for a model no mesh wrapped."""
    return getattr(unwrap(model), "_daclip_dp_group", None)


def apply_ddp(model: nn.Module, mesh: Mesh, device, static_graph: bool = False) -> nn.Module:
    """DDP over the mesh's data-parallel group. Parameters are already
    identical on every rank (seeded alike); buffers are not broadcast each
    forward (the models' have none that change). `static_graph`: DDP's
    static graph, which records in the first step the parameters that never
    reach the loss and skips them after. The UNet needs it: its
    cross-attention `to_q`, `to_k` and `norm2` get no gradient with a
    one-token context. DA-CLIP uses every parameter and takes it from
    `--ddp-static-graph`."""
    from torch.nn.parallel import DistributedDataParallel

    dev = torch.device(device)
    model._daclip_dp_group = mesh.dp_group
    return DistributedDataParallel(model, device_ids=[dev] if dev.type == "cuda" else None,
                                   process_group=mesh.dp_group, broadcast_buffers=False,
                                   static_graph=static_graph)


def _strided(p: torch.Tensor) -> bool:
    """A tensor-parallel q/k/v projection (`apply_tensor_parallel`)."""
    from torch.distributed.tensor.placement_types import _StridedShard

    return any(isinstance(pl, _StridedShard) for pl in getattr(p, "placements", ()))


def apply_fsdp(module: nn.Module, mesh: Mesh, min_size: int = 2 ** 16) -> nn.Module:
    """FSDP2 `fully_shard` over the (data, fsdp) sub-mesh: each parameter of
    at least `min_size` elements is sharded over `fsdp` and replicated over
    `data`; smaller ones stay whole on every rank, as daclip_tpu's
    `fsdp_param_shardings` leaves them, and `finish_grads` averages their
    gradients. Each transformer block, UNet ResBlock and attention wrap is
    its own unit, gathered just before its forward (and again in the
    backward) and freed after, so one block's parameters are whole at a
    time; the root holds the rest. A tensor-parallel q/k/v projection is
    sharded over its columns (its rows are split by heads), and its bias
    stays whole. Returns the module (FSDP2 changes it in place)."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    from daclip_torch.models.transformer import ResidualAttentionBlock
    from daclip_torch.models.unet import AttnWrap, ResBlock

    small = {p for p in module.parameters()
             if p.numel() < min_size or (_strided(p) and p.dim() == 1)}
    kw = dict(mesh=mesh.device_mesh["data", "fsdp"],
              shard_placement_fn=lambda p: Shard(1) if _strided(p) else Shard(0))
    for block in module.modules():
        if isinstance(block, (ResidualAttentionBlock, ResBlock, AttnWrap)):
            fully_shard(block, ignored_params=small & set(block.parameters()), **kw)
    fully_shard(module, ignored_params=small, **kw)
    module._daclip_dp_group = mesh.dp_group
    module._daclip_replicated = [p for p in module.parameters() if p in small]
    return module


def parallelize(model: nn.Module, mesh: Optional[Mesh], device,
                min_size: int = 2 ** 16, static_graph: bool = False) -> nn.Module:
    """The model as the mesh trains it: tensor parallel on `model` when
    that axis is past 1; then FSDP when `fsdp` or `model` is past 1 (DDP
    takes no DTensors, so a tensor-parallel model is replicated over `data`
    by FSDP at an `fsdp` of 1), else DDP (`static_graph` is its option);
    the model itself without a mesh."""
    if mesh is None:
        return model
    if mesh.shape[2] > 1:
        apply_tensor_parallel(model, mesh)
    if mesh.shape[1] > 1 or mesh.shape[2] > 1:
        return apply_fsdp(model, mesh, min_size)
    return apply_ddp(model, mesh, device, static_graph)


@contextlib.contextmanager
def no_sync(model: nn.Module, enabled: bool = True):
    """Gradients accumulate locally inside (DDP's `no_sync`, FSDP2's
    `set_requires_gradient_sync(False)`); a plain model is unaffected."""
    if not enabled:
        yield
    elif hasattr(model, "no_sync"):
        with model.no_sync():
            yield
    elif hasattr(model, "set_requires_gradient_sync"):
        model.set_requires_gradient_sync(False)
        try:
            yield
        finally:
            model.set_requires_gradient_sync(True)
    else:
        yield


@torch.no_grad()
def finish_grads(model: nn.Module) -> None:
    """Average over the data-parallel group the gradients FSDP leaves alone
    (the replicated parameters of an `apply_fsdp` model); DDP and FSDP
    reduce the others themselves. Call after the last backward of a step."""
    grads = [local_tensor(p.grad) for p in getattr(unwrap(model), "_daclip_replicated", ())
             if p.grad is not None]
    if not grads:
        return
    group = data_group(model)
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def grad_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm of the whole gradients, √(Σ g²) in f32: the
    squares of a DTensor's part (an FSDP shard, a tensor-parallel part, or
    both) are summed over each mesh dimension it is split on."""
    from torch.distributed.tensor import DTensor

    total = None
    for g in grads:
        sq = local_tensor(g).float().square().sum()
        if isinstance(g, DTensor):
            for d, pl in enumerate(g.placements):
                if not pl.is_replicate():
                    dist.all_reduce(sq, group=g.device_mesh.get_group(d))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def make_optimizer(cls, groups: Sequence[dict], **kw) -> torch.optim.Optimizer:
    """`cls` (a torch optimizer) over the param-group dicts `groups`, each
    group split by the mesh its DTensors lie on (whole tensors apart):
    torch's foreach kernels, its default on CUDA, refuse the mix, and its
    per-tensor loop rounds otherwise, so the shards' updates would differ
    in their last bits from one card's. The optimizer keeps `groups`'
    layout, in which `optimizer_state` writes its state: the file of a
    sharded run is a single-card file. Without DTensors the groups stay as
    given."""
    split, layout = [], []
    for g in groups:
        ps = list(g["params"])
        layout.append(ps)
        by_mesh: Dict[object, list] = {}
        for p in ps:
            by_mesh.setdefault(getattr(p, "device_mesh", None), []).append(p)
        split += [dict(g, params=part) for part in by_mesh.values()]
    optimizer = cls(split, **kw)
    optimizer._daclip_layout = layout
    return optimizer


def all_reduce_mean(values: Dict[str, torch.Tensor], group=None) -> Dict[str, torch.Tensor]:
    """The metrics' means over the group, in one collective (the values
    themselves without a process group)."""
    if not is_distributed() or not values:
        return values
    keys = list(values)
    flat = torch.stack([values[k].detach().float().reshape(()) for k in keys])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    return dict(zip(keys, flat.unbind()))


# -- tensor parallelism --------------------------------------------------------------
def tp_placement(layout: str):
    """The DTensor placement on the `model` mesh of a tensor-parallel
    layout: "heads" (the packed q/k/v rows split by heads: a
    `_StridedShard` of split factor 3, so each rank holds q, k and v of its
    heads, no cut falls inside a head, and the whole tensor is the
    single-card one), "rows" or "cols"."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    return {"heads": _StridedShard(0, split_factor=3), "rows": Shard(0),
            "cols": Shard(1)}[layout]


def apply_tensor_parallel(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Tensor parallelism over the mesh's `model` axis, in place: each
    `MultiheadAttention` whose heads the axis divides keeps its own heads
    and each `MLP` whose hidden width it divides its own hidden units, as
    DTensors on the `model` mesh, and gets the axis's group as `tp_group`
    (the layers' forward then sums the partial outputs over it). The packed
    q/k/v projection is split by heads (`tp_placement`), `out_proj` keeps
    the matching input columns, `c_fc` its rows and `c_proj` its columns. Biases after a
    row-parallel sum and everything else stay whole, as daclip_tpu's
    `tp_param_shardings` replicates what the axis does not divide."""
    from torch.distributed.tensor import distribute_tensor

    from daclip_torch.models.layers import MLP, MultiheadAttention

    m, tp_mesh = mesh.shape[2], mesh.device_mesh["model"]
    for mod in model.modules():
        if isinstance(mod, MultiheadAttention) and mod.packed and mod.heads % m == 0:
            split = {"in_proj_weight": "heads", "in_proj_bias": "heads",
                     "out_proj.weight": "cols"}
        elif isinstance(mod, MLP) and mod.c_fc.weight.shape[0] % m == 0:
            split = {"c_fc.weight": "rows", "c_fc.bias": "rows", "c_proj.weight": "cols"}
        else:
            continue
        for name, layout in split.items():
            owner, _, leaf = name.rpartition(".")
            holder = mod.get_submodule(owner)
            p = getattr(holder, leaf)
            part = distribute_tensor(p.data, tp_mesh, [tp_placement(layout)])
            setattr(holder, leaf, nn.Parameter(part, requires_grad=p.requires_grad))
        mod.tp_group = mesh.model_group
    return model


# -- mesh-independent checkpoints --------------------------------------------------
def _full_options(**kw):
    from torch.distributed.checkpoint.state_dict import StateDictOptions

    return StateDictOptions(full_state_dict=True, **kw)


def model_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state dict in the single-card form (whole CPU tensors
    under the reference's names, aliases included), from
    `torch.distributed.checkpoint`'s `get_model_state_dict`: FSDP shards
    and tensor-parallel parts gathered. A collective under a mesh: every
    rank calls it, in one order. Ranks other than 0 get an empty dict (and
    copy nothing where nothing is sharded)."""
    from torch.distributed.checkpoint.state_dict import get_model_state_dict

    return get_model_state_dict(unwrap(model), options=_full_options(cpu_offload=True))


def load_model_state(model: nn.Module, sd: Dict[str, torch.Tensor], strict: bool = True) -> None:
    """Load a single-card state dict into `model`, each rank keeping its part
    (`set_model_state_dict`); strictly, unless `strict=False` lets `sd` hold
    part of the model's keys (no key outside them)."""
    from torch.distributed.checkpoint.state_dict import set_model_state_dict

    set_model_state_dict(unwrap(model), dict(sd), options=_full_options(strict=strict))


def full_tensors(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Whole CPU copies of name-keyed tensors that are no state dict (the
    EMA's shadows): DTensors gathered, a collective that every rank calls.
    Ranks other than 0 get an empty dict."""
    from torch.distributed.tensor import DTensor

    out = {}
    for k, v in tensors.items():
        v = v.full_tensor() if isinstance(v, DTensor) else v
        if rank() == 0:
            out[k] = v.detach().cpu()
    return out


@torch.no_grad()
def load_tensors(dst: Dict[str, torch.Tensor], full: Dict[str, torch.Tensor]) -> None:
    """Copy `full_tensors`' form into the name-keyed tensors `dst` (the same
    keys), each DTensor keeping its part."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if set(dst) != set(full):
        missing, extra = sorted(set(dst) - set(full)), sorted(set(full) - set(dst))
        raise KeyError(f"state keys differ: missing {missing[:5]}, unexpected {extra[:5]}")
    for k, v in dst.items():
        src = full[k].to(device=v.device, dtype=v.dtype)
        if isinstance(v, DTensor):
            src = distribute_tensor(src, v.device_mesh, v.placements)
        v.copy_(src)


def _layout(optimizer) -> List[list]:
    """The parameter lists of the groups `make_optimizer` was given."""
    return getattr(optimizer, "_daclip_layout", None) or [list(g["params"])
                                                          for g in optimizer.param_groups]


def optimizer_layout(model: nn.Module, optimizer: torch.optim.Optimizer):
    """(each parameter's index in `optimizer_state`'s form, by its name in the
    unwrapped model; that form's param_groups): `make_optimizer`'s groups,
    with their hyperparameters, the indices running through them in order."""
    layout = _layout(optimizer)
    index = {id(p): i for i, p in enumerate(p for ps in layout for p in ps)}
    hyper = {id(p): {k: v for k, v in g.items() if k != "params"}
             for g in optimizer.param_groups for p in g["params"]}
    names = {n: index[id(p)] for n, p in unwrap(model).named_parameters() if id(p) in index}
    return names, [dict(hyper[id(ps[0])], params=[index[id(p)] for p in ps]) for ps in layout]


def optimizer_state(model: nn.Module, optimizer: torch.optim.Optimizer) -> dict:
    """`optimizer.state_dict()` of the single-card run: `make_optimizer`'s
    groups, parameter indices in their order, every state tensor whole on
    the CPU (`get_optimizer_state_dict`, which gathers the parts). A
    collective under a mesh; ranks other than 0 get an empty dict."""
    from torch.distributed.checkpoint.state_dict import get_optimizer_state_dict

    module = unwrap(model)
    index, groups = optimizer_layout(module, optimizer)
    state = {}
    if optimizer.state:  # (on an empty state DCP would take a step of lr 0 to make one)
        sd = get_optimizer_state_dict(module, optimizer, options=_full_options(cpu_offload=True))
        state = {index[n]: st for n, st in sd.get("state", {}).items()}
    if rank() != 0:
        return {}
    return {"state": dict(sorted(state.items())), "param_groups": groups}


def load_optimizer_state(model: nn.Module, optimizer: torch.optim.Optimizer, sd: dict) -> None:
    """Load `optimizer_state`'s form into `optimizer`, each rank keeping its
    part of each state tensor (`set_optimizer_state_dict`)."""
    from torch.distributed.checkpoint.state_dict import set_optimizer_state_dict

    module = unwrap(model)
    names = {id(p): n for n, p in module.named_parameters()}
    layout = _layout(optimizer)
    flat = [p for ps in layout for p in ps]
    owner = {id(p): gi for gi, ps in enumerate(layout) for p in ps}
    groups = [dict({k: v for k, v in sd["param_groups"][owner[id(g["params"][0])]].items()
                    if k != "params"}, params=[names[id(p)] for p in g["params"]])
              for g in optimizer.param_groups]
    named = {"state": {names[id(flat[i])]: st for i, st in sd["state"].items()},
             "param_groups": groups}
    set_optimizer_state_dict(module, optimizer, named, options=_full_options(strict=False))
    # DCP first makes a state for every parameter: keep only the file's (the
    # UNet's unused cross-attention parameters have none on one card)
    for i, p in enumerate(flat):
        if i not in sd["state"]:
            optimizer.state.pop(p, None)
