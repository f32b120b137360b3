"""The ranks of tests/test_torch_parallel*.py: each test spawns 2-4 CPU
processes that form a gloo group through a file in its tmp dir (never a
TCP port) and run one of the functions below on its rows of a global
batch. The module imports torch and daclip_torch only, never jax: the
parent runs daclip_tpu and compares."""
from __future__ import annotations

import copy
import datetime
import multiprocessing
import os
import pathlib
import time
import traceback

import numpy as np
import torch

# Under a full test run (six pytest workers on one host) a rank gets a
# fraction of a core: the restoration runs that take ~20 s alone took 139 s
# on 8 cores with 56 busy processes beside them, and outlived a 240 s
# deadline in a full run. The deadlines leave room for that; a rank that
# really hangs still fails its test.
GROUP_TIMEOUT = datetime.timedelta(seconds=300)
SPAWN_DEADLINE = 900.0


# -- spawning -------------------------------------------------------------------------
def store_path(tmp) -> str:
    """A fresh rendezvous file under `tmp`."""
    tmp = pathlib.Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    return str(tmp / f"store-{len(list(tmp.iterdir()))}")


def spawn(fn, world: int, tmp, payload=None, deadline: float = SPAWN_DEADLINE,
          init: bool = True):
    """Run `fn(rank, world, payload)` in `world` spawned processes with
    torchrun's RANK / WORLD_SIZE / LOCAL_RANK, which form one gloo group
    (through a file; with `init` False `fn` forms it), and return their
    results in rank order. Fails with the ranks' tracebacks, or when a
    rank outlives `deadline` seconds."""
    tmp = pathlib.Path(tmp)
    store = store_path(tmp) if init else None
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, store, str(tmp), payload))
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = [(tmp / f"err{r}.txt").read_text() for r in range(world)
              if (tmp / f"err{r}.txt").exists()]
    assert not hung, f"ranks {hung} of {fn.__name__} outlived {deadline} s\n" + "\n".join(errors)
    assert all(p.exitcode == 0 for p in procs), "\n".join(errors) or [p.exitcode for p in procs]
    out = [torch.load(tmp / f"out{r}.pt", weights_only=False) for r in range(world)]
    for r in range(world):
        (tmp / f"out{r}.pt").unlink()
    return out


def _entry(fn, rank, world, store, tmp, payload):
    from daclip_torch import parallel

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    try:
        if store is not None:
            parallel.initialize_distributed(f"file://{store}", "gloo", "cpu",
                                            timeout=GROUP_TIMEOUT)
        out = fn(rank, world, payload)
        torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
        if parallel.is_distributed():
            torch.distributed.destroy_process_group()
    except BaseException:
        pathlib.Path(tmp, f"err{rank}.txt").write_text(f"rank {rank}:\n{traceback.format_exc()}")
        raise


def whole(tensors):
    """Every rank's whole CPU copy of name-keyed tensors (DTensors
    gathered: FSDP shards, tensor-parallel parts)."""
    from torch.distributed.tensor import DTensor

    return {k: (v.full_tensor() if isinstance(v, DTensor) else v).detach().cpu()
            for k, v in tensors.items()}


def rows(a, r: int, n: int):
    """Rank r's rows (of n) of a global array, as a torch tensor (4-D
    images NHWC → NCHW)."""
    a = np.asarray(a)
    part = a[r * (len(a) // n):(r + 1) * (len(a) // n)]
    t = torch.from_numpy(np.ascontiguousarray(part))
    return t.permute(0, 3, 1, 2).contiguous() if t.dim() == 4 else t


# -- 1. the global losses ------------------------------------------------------------
def losses(rank, world, data):
    """Every loss over the gathered features, and the gradient of their sum
    with respect to this rank's features."""
    from daclip_torch.losses import (clip_loss, daclip_loss_fork, daclip_loss_uir,
                                     distill_clip_loss, gather_features)

    keys = ("image_features", "text_features", "image_degra_features",
            "text_degra_features", "gt_image_features", "pred")
    out = {k: rows(data[k], rank, world).requires_grad_(True) for k in keys}
    out.update(deg_type=rows(data["deg_type"], rank, world),
               gt_val=rows(data["gt_val"], rank, world),
               logit_scale=torch.tensor(data["logit_scale"]),
               all_d_type_tokens_features=torch.from_numpy(data["tokens"]),
               bin_center_features=torch.from_numpy(data["centers"]))
    g = gather_features(out)
    teacher = gather_features({"image_features": rows(data["t_image"], rank, world),
                               "text_features": rows(data["t_text"], rank, world)})
    terms = dict(clip=clip_loss(g["image_features"], g["text_features"], g["logit_scale"]),
                 **{f"fork_{k}": v for k, v in daclip_loss_fork(g).items()},
                 **{f"uir_{k}": v for k, v in daclip_loss_uir(g).items()},
                 **{f"distill_{k}": v for k, v in distill_clip_loss(
                     g["image_features"], g["text_features"], g["logit_scale"],
                     teacher["image_features"], teacher["text_features"],
                     torch.tensor(20.0)).items()})
    sum(terms.values()).backward()
    return {"losses": {k: float(v) for k, v in terms.items()},
            "grads": {k: out[k].grad.numpy() for k in keys}}


# -- 2, 3, 6. DA-CLIP steps -------------------------------------------------------------
def _torch_batch(b, r, n):
    return {k: rows(v, r, n) for k, v in b.items()}


def clip_runs(rank, world, runs):
    """`clip_steps` of each run in turn, in one group."""
    return [clip_steps(rank, world, p) for p in runs]


def clip_steps(rank, world, p):
    """DA-CLIP steps of the tiny DaCLIP under `p["mesh"]`, one a global
    batch of `p["batches"]`: the metrics of each, the whole state dict after
    them; with `p["tp"]` also the tensor-parallel forward beside the
    replicated one's."""
    from daclip_torch import parallel
    from daclip_torch.models.clip import CLIPCfg, DaCLIP, get_model_config
    from daclip_torch.train import clip_train as tct

    model = DaCLIP(CLIPCfg.from_dict(get_model_config(p["name"])), use_predictor=True)
    model.load_state_dict(p["sd"], strict=True)
    tct.partition_daclip_params(model)
    mesh = parallel.mesh_from_spec(p["mesh"], world, "cpu")
    n, r = (1, 0) if mesh is None else (mesh.dp_size, mesh.dp_rank)
    result = {}
    if p.get("tp"):
        replicated = copy.deepcopy(model).eval()
    wrapped = parallel.parallelize(model, mesh, "cpu", min_size=p.get("min_size", 2 ** 16),
                                   static_graph=p.get("static_graph", False))
    inner = parallel.unwrap(wrapped)
    result["static_graph"] = getattr(wrapped, "static_graph", None)
    if p.get("tp"):
        b = _torch_batch(p["forward"], 0, 1)
        with torch.no_grad():
            fw = dict(image=b["images"], text=b["texts"])
            want, got = replicated(**fw), inner.eval()(**fw)
        inner.train()
        result["forward"] = {k: (got[k].numpy(), want[k].numpy())
                             for k in ("image_features", "image_degra_features",
                                       "text_features", "text_degra_features")}
        result["tp_params"] = sum(1 for _, m in inner.named_modules()
                                  if getattr(m, "tp_group", None) is not None)
        result["splits"] = tp_splits(mesh, p["splits"])
    cfg = tct.ClipTrainConfig(**p["cfg"])
    state = tct.init_state(inner, cfg, device="cpu")
    if cfg.accum_freq > 1:
        step = tct.make_accum_train_step(wrapped, cfg, p["banks"], device="cpu")
    else:
        step = tct.make_train_step(wrapped, cfg, p["banks"], device="cpu")
    metrics = []
    for b in p["batches"]:
        if cfg.accum_freq > 1:
            state, m = step(state, [_torch_batch(mb, r, n) for mb in b])
        else:
            state, m = step(state, _torch_batch(b, r, n))
        metrics.append({k: float(v) for k, v in m.items()})
    result["metrics"] = metrics
    result["params"] = whole(inner.state_dict())
    result["model_state"] = parallel.model_state(inner)  # rank 0's, as a checkpoint holds it
    return result


def tp_splits(mesh, cases):
    """(this rank's part, the whole tensor) of an arange of each (layout,
    shape) case, placed on the `model` mesh as `apply_tensor_parallel`
    places that layout."""
    from torch.distributed.tensor import distribute_tensor

    from daclip_torch.parallel.mesh import tp_placement

    out = []
    for (layout,), shape in cases:
        full = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
        part = distribute_tensor(full, mesh.device_mesh["model"], [tp_placement(layout)])
        out.append((part.to_local().clone(), part.full_tensor()))
    return out


# -- 4, 5. restoration steps ----------------------------------------------------------
class _GivenDraws:
    """Stands in for `IRSDE.generate_random_states`: this rank's rows of the
    given global (t, noise) draws, one pair a call, through the port's
    formula."""

    def __init__(self, sde, draws, r, n):
        self.sde, self.draws, self.r, self.n = sde, list(draws), r, n

    def __call__(self, x0, mu, generator=None, **kw):
        t, noise = self.draws.pop(0)
        t, noise = rows(t, self.r, self.n), rows(noise, self.r, self.n)
        mean = self.sde.mu_bar(mu, x0, t)
        return t, (noise * self.sde._at("sigma_bars", t) + mean).float()


def resto_steps(rank, world, p):
    """Restoration steps of the tiny UNet under `p["mesh"]` on the given
    global batch and draws: the metrics, then the whole parameters, EMA and
    gradients; with `p["save"]` a checkpoint after `p["save_at"]` steps,
    with `p["resume"]` the run starts from that checkpoint."""
    from daclip_torch import parallel
    from daclip_torch.models.unet import ConditionalUNet
    from daclip_torch.sde import IRSDE
    from daclip_torch.train import restoration as trest
    from daclip_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

    unet = ConditionalUNet(**p["unet"])
    unet.load_state_dict(p["sd"], strict=True)
    mesh = parallel.mesh_from_spec(p["mesh"], world, "cpu", batch_size=len(p["batch"]["GT"]))
    wrapped = parallel.parallelize(unet, mesh, "cpu", min_size=p.get("min_size", 2 ** 16),
                                   static_graph=True)
    cfg = trest.RestorationTrainConfig(**p["cfg"])
    state = trest.init_state(unet, cfg, device="cpu")
    if p.get("resume"):
        restore_checkpoint(p["resume"], wrapped, state)
    sde = IRSDE(max_sigma=50, T=100)
    n, r = (1, 0) if mesh is None else (mesh.dp_size, mesh.dp_rank)
    sde.generate_random_states = _GivenDraws(sde, p["draws"], r, n)
    step = trest.make_train_step(wrapped, sde, cfg, device="cpu")
    batch = _torch_batch(p["batch"], r, n)
    metrics = []
    for i in range(len(p["draws"])):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        if p.get("save") and state.step == p["save_at"]:
            save_checkpoint(p["save"], wrapped, state)
    named = trest.trainable(unet)
    return {"metrics": metrics, "step": state.step,
            "params": whole(unet.state_dict()),
            "ema": whole(state.ema.params),
            "grads": whole({k: torch.zeros_like(q) if q.grad is None else q.grad
                            for k, q in named}),
            "sharded": sum(type(q).__name__ == "DTensor" for _, q in named),
            "files": sorted(os.listdir(p["save"])) if p.get("save") else []}


# -- 7, 8. the CLIs under torchrun's environment ------------------------------------------
def cli(rank, world, p):
    """One CLI's `main(p["argv"])` on this rank (the CLI forms the group
    from the environment and `--dist-url`), recording the loader's order
    of each epoch and the files the rank saved."""
    from daclip_torch import parallel
    from daclip_torch.data.loader import DataLoader

    order, saved = [], []
    indices, save = DataLoader._indices, torch.save

    def record_order(self):
        order.append(indices(self))
        return order[-1]

    def record_save(obj, f, *a, **k):
        saved.append(str(f))
        return save(obj, f, *a, **k)

    DataLoader._indices, torch.save = record_order, record_save
    if p["cli"] == "daclip":
        from daclip_torch.cli.train_daclip import main
    else:
        from daclip_torch.cli.train_restoration import main
    try:
        result = main(p["argv"])
    except SystemExit as e:
        return {"exit": str(e), "order": order, "saved": saved,
                "world": parallel.world_size()}
    finally:
        torch.save = save
    return {"result": result, "order": order, "saved": saved, "world": parallel.world_size()}
