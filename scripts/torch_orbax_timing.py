"""Host timings of loading a full-width restoration train dir written by
daclip_tpu: its `load_restoration_params` (orbax, which restores the whole
tree) against the port's (OCDBT, zarr and zstd read here, the EMA leaves
alone decoded).

It writes, in a temporary directory, the tree `cli/train_restoration`
saves for the production UNet (nf 64, ch_mult 1,2,4,8, context 512, both
contexts; daclip_tpu's `init_state`: params, AdamW state, EMA, step) with
every leaf filled from a seed (weights at fan-in scale, moments at the
scale training leaves them), through daclip_tpu's `save_checkpoint`. Then
it checks that the port's EMA leaves equal daclip_tpu's bit for bit and
times both loads in turns (daclip_tpu, port, port, daclip_tpu, ...).
It imports daclip_tpu, so it runs where JAX is installed (on the CPU).

Usage: python scripts/torch_orbax_timing.py [--rounds 3]
Prints one JSON line.
"""
import argparse
import json
import os
import pathlib
import platform
import sys
import tempfile
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def write_dir(path: str) -> dict:
    import jax
    import jax.numpy as jnp

    from daclip_tpu.models.unet import ConditionalUNet
    from daclip_tpu.train.restoration import RestorationTrainConfig, init_state
    from daclip_tpu.utils.checkpoint import save_checkpoint, wait_all

    net = ConditionalUNet(nf=64, ch_mult=(1, 2, 4, 8), context_dim=512,
                          use_degra_context=True, use_image_context=True)
    x, c = jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 512))
    shapes = jax.eval_shape(lambda: init_state(
        net.init(jax.random.PRNGKey(0), x, x, jnp.ones((1,)), c, c), RestorationTrainConfig()))
    rng = np.random.default_rng(0)

    def fill(path, leaf):
        names = "/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path)
        shape, dtype = leaf.shape, leaf.dtype
        if not shape or np.issubdtype(dtype, np.integer):
            return jnp.full(shape, 7, dtype)
        a = rng.standard_normal(shape, np.float32)
        if "nu" in names.split("/"):
            a = np.abs(a) * 1e-8
        elif "mu" in names.split("/"):
            a = a * 1e-4
        else:
            a = a / np.sqrt(np.prod(shape[:-1]) if len(shape) > 1 else 50.0)
        return jnp.asarray(a, dtype)

    state = jax.tree_util.tree_map_with_path(fill, shapes)
    n_params = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(state.params))
    save_checkpoint(path, 1, state)
    wait_all()
    size = sum(f.stat().st_size for f in pathlib.Path(path).rglob("*") if f.is_file())
    return {"unet_parameters": n_params, "dir_bytes": size}


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--rounds", type=int, default=3)
    args = p.parse_args(argv)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import torch

    from daclip_torch.utils import native_checkpoint as tnc
    from daclip_torch.utils import zstd
    from daclip_tpu.utils import native_checkpoint as jnc

    zstd.load()
    with tempfile.TemporaryDirectory() as tmp:
        run = os.path.join(tmp, "training_state")
        info = write_dir(run)

        def ours():
            return tnc.load_restoration_params(run)[0]

        def theirs():
            return jnc.load_restoration_params(run)[0]

        got, want = dict(flat(ours())), dict(flat(jax.tree.map(np.asarray, theirs())))
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == torch.float32 and np.array_equal(got[k].numpy(), want[k]), k
        times = {"daclip_tpu": [], "port": []}
        for r in range(args.rounds):
            for who in (("daclip_tpu", "port") if r % 2 == 0 else ("port", "daclip_tpu")):
                t0 = time.perf_counter()
                (theirs if who == "daclip_tpu" else ours)()
                times[who].append((time.perf_counter() - t0) * 1e3)
    ema_bytes = sum(v.numel() * 4 for v in got.values())
    print(json.dumps(dict(
        info, host=platform.node(), cpus=os.cpu_count(), ema_leaves=len(got),
        ema_bytes=ema_bytes, load_ms=times,
        median_ms={k: float(np.median(v)) for k, v in times.items()},
        port_ema_mb_s=ema_bytes / float(np.median(times["port"])) / 1e3,
        bit_equal=True)))


if __name__ == "__main__":
    main()
