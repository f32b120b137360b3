"""Writes tests/fixtures/orbax/: two orbax train dirs written by daclip_tpu's
own training CLIs, and what the port must read from them.

  restoration/  `daclip_tpu.cli.train_restoration` on a seeded 32² MD tree:
                a ConditionalUNet nf 16, ch_mult (1, 2), context 32, both
                contexts on, AdamW, 4 steps saved at steps 2 and 4, on the
                contexts of the DA-CLIP below
  daclip/       `daclip_tpu.cli.train_daclip` on its synthetic data,
                `daclip_test-tiny`, one epoch (its `best/` copy left out)
  expected.npz  a seeded 32² LQ, x_T and the posterior's noise bank, and
                daclip_tpu's restore of it (`DACLIPRestorer.load` of the two
                dirs, float32, the latest step's EMA UNet, the contexts of
                the LQ) through that bank
  leaves.json   every leaf of both latest trees as daclip_tpu's
                `restore_checkpoint` returns it: dtype, shape and the
                SHA-256 of its bytes (a Python scalar or None: its value)

With --full it writes restoration_full/ alone (and its entry of
leaves.json): the TrainState of daclip_tpu's `init_state` for
configs/daclip-sde/train.yml's UNet at full width (nf 64, ch_mult 1,2,4,8,
context 512, both contexts; 48.4 M parameters a tree), AdamW, at step 1000,
saved by daclip_tpu's own `save_checkpoint`. Each leaf of the parameters,
the EMA and the moments is a seeded block of at most BLOCK values, tiled:
the first values of daclip_tpu's own init of the leaf (the EMA: those plus
1e-4·N(0, 1); a kernel's copies each times a seeded sign, without which the
forward overflows), 1e-3·N(0, 1) for mu and its square for nu, and zero moments
where the model gives no gradient (the one-token cross-attention's to_k and
norm2), as optax holds them. zstd then stores a tree small. The card's
machine has no JAX, so its full-width resume reads this dir.

It imports daclip_tpu and runs on the CPU, never on the card.
Usage: python scripts/torch_orbax_fixture.py [--out tests/fixtures/orbax] [--full]
"""
import argparse
import hashlib
import json
import os
import pathlib
import shutil
import sys
import tempfile
import textwrap

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

T = 20           # posterior steps of the stored restore
MODEL = "daclip_test-tiny"
BLOCK = 512      # values of a full-width leaf's seeded block
FULL_STEP = 1000


def _jax():
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    return jax


def write_md_tree(root: pathlib.Path, n: int = 4, size: int = 32):
    import cv2
    rng = np.random.RandomState(0)
    for sub in ("GT", "LQ"):
        (root / "noisy" / sub).mkdir(parents=True)
        for i in range(n):
            cv2.imwrite(str(root / "noisy" / sub / f"{i}.png"),
                        (rng.rand(size, size, 3) * 255).astype(np.uint8))


def train_restoration(work: pathlib.Path, daclip_dir: pathlib.Path) -> pathlib.Path:
    """Trained on the contexts of the DA-CLIP in `daclip_dir`, which the CLI
    takes as a torch checkpoint."""
    import torch

    from daclip_torch.convert import daclip_state_dict_from_jax
    from daclip_tpu.cli.train_restoration import main
    from daclip_tpu.utils.native_checkpoint import load_daclip_train_params
    params, _ = load_daclip_train_params(str(daclip_dir))
    torch.save(daclip_state_dict_from_jax(params), work / "daclip.pt")
    write_md_tree(work / "md")
    yml = work / "train.yml"
    yml.write_text(textwrap.dedent(f"""
        name: orbax-fixture
        model: denoising
        distortion: [noisy]
        gpu_ids: [0]
        sde: {{max_sigma: 50, T: 100, schedule: cosine, eps: 0.005}}
        datasets:
          train: {{name: T, mode: MD, dataroot: {work / 'md'}, batch_size: 2, patch_size: 16,
                   use_shuffle: true, n_workers: 0, use_flip: true, use_rot: true,
                   clip_size: 32}}
          val: {{name: V, mode: MD, dataroot: {work / 'md'}, clip_size: 32}}
        network_G:
          which_model_G: ConditionalUNet
          setting: {{in_nc: 3, out_nc: 3, nf: 16, ch_mult: [1, 2], context_dim: 32,
                     use_degra_context: true, use_image_context: true}}
        path: {{pretrain_model_G: ~, root: {work}, daclip: {work / 'daclip.pt'},
                daclip_model: {MODEL}}}
        train:
          optimizer: AdamW
          lr_G: !!float 1e-4
          lr_scheme: TrueCosineAnnealingLR
          beta1: 0.9
          beta2: 0.99
          niter: 4
          warmup_iter: -1
          eta_min: !!float 1e-6
          loss_type: l1
          weight: 1.0
          manual_seed: 0
          val_freq: 1000
        logger: {{print_freq: 2, save_checkpoint_freq: 2}}
    """))
    main(["-opt", str(yml), "--max-steps", "4"])
    return work / "experiments" / "orbax-fixture" / "training_state"


def train_daclip(work: pathlib.Path) -> pathlib.Path:
    from daclip_tpu.cli.train_daclip import main
    main(["--dataset-type", "synthetic", "--train-num-samples", "8", "--batch-size", "4",
          "--epochs", "1", "--warmup", "1", "--model", MODEL, "--logs", str(work),
          "--name", "clip", "--precision", "fp32", "--seed", "0"])
    return work / "clip" / "checkpoints"


def leaf_record(x):
    if x is None or isinstance(x, (int, float)):
        return {"scalar": x}
    a = np.asarray(x)
    return {"dtype": str(a.dtype), "shape": list(a.shape),
            "sha256": hashlib.sha256(a.tobytes()).hexdigest()}


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flat(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def expected(out: pathlib.Path):
    jax = _jax()
    from daclip_tpu import pipeline as jpipe
    from daclip_tpu.utils.checkpoint import restore_checkpoint

    leaves = {}
    for name in ("restoration", "daclip"):
        tree = restore_checkpoint(str(out / name))
        leaves[name] = {k: leaf_record(v) for k, v in flat(tree)}
    (out / "leaves.json").write_text(json.dumps(leaves, indent=0, sort_keys=True) + "\n")

    ref = jpipe.DACLIPRestorer.load(str(out / "restoration"), str(out / "daclip"),
                                    jpipe.RestorerConfig(model_name=MODEL, T=T,
                                                         dtype="float32"))
    rng = np.random.RandomState(2026)
    lq = rng.rand(32, 32, 3).astype(np.float32)
    img_ctx, degra_ctx = ref.contexts(lq)
    x_T = np.asarray(ref.sde.noise_state(jax.random.PRNGKey(1), lq[None]), np.float32)
    noises = rng.randn(T, 1, 32, 32, 3).astype(np.float32)
    fn = lambda x, mu, tb, **c: ref.unet.apply({"params": ref.unet_params}, x, mu, tb,
                                               c["text_context"], c["image_context"])
    out_img = jax.jit(lambda xt, mu, zs, tc, ic: ref.sde.reverse_posterior(
        fn, xt, mu, jax.random.PRNGKey(0), noises=zs, text_context=tc,
        image_context=ic))(x_T, lq[None], noises, degra_ctx, img_ctx)
    np.savez_compressed(out / "expected.npz", lq=lq, x_T=x_T, noises=noises,
                        ref_out=np.asarray(out_img[0]), img_ctx=np.asarray(img_ctx),
                        degra_ctx=np.asarray(degra_ctx), T=T)


def full_restoration(out: pathlib.Path):
    """restoration_full/ and its leaves' records in leaves.json."""
    jax = _jax()
    import jax.numpy as jnp
    import yaml

    from daclip_tpu.models.unet import ConditionalUNet
    from daclip_tpu.train.restoration import RestorationTrainConfig, TrainState, init_state
    from daclip_tpu.utils.checkpoint import restore_checkpoint, save_checkpoint

    opt = yaml.safe_load((REPO / "configs" / "daclip-sde" / "train.yml").read_text())
    net = opt["network_G"]["setting"]
    unet = ConditionalUNet(nf=net["nf"], ch_mult=tuple(net["ch_mult"]),
                           context_dim=net["context_dim"],
                           use_degra_context=net["use_degra_context"],
                           use_image_context=net["use_image_context"])
    x = jnp.zeros((1, 32, 32, 3))
    ctx = jnp.zeros((1, net["context_dim"]))
    params = unet.init(jax.random.PRNGKey(opt["train"]["manual_seed"]), x, x,
                       jnp.ones((1,)), ctx, ctx)
    cfg = RestorationTrainConfig(optimizer=opt["train"]["optimizer"])
    state = init_state(params, cfg)
    rng = np.random.RandomState(2026)

    signs = {}

    def tile(block, shape, path=None):
        """block repeated to fill shape; a kernel's (ndim ≥ 2) copies each
        times a seeded sign, the same for its parameter, EMA and gradient's
        moments (its path): copies of one sign add up coherently along the
        kernel's fan-in, and the UNet's activations then overflowed by its
        up levels."""
        block = np.asarray(block, np.float32)
        out = np.resize(block, int(np.prod(shape)))
        if path is not None and len(shape) >= 2:  # a sign a BLOCK values (every block divides it)
            copies = -(-out.size // BLOCK)
            if path not in signs:
                signs[path] = np.where(rng.rand(copies) < 0.5, -1.0, 1.0).astype(np.float32)
            out = out * np.repeat(signs[path], BLOCK)[:out.size]
        return jnp.asarray(out.reshape(shape))

    def block(size):
        return rng.randn(min(BLOCK, size)).astype(np.float32)

    def unused(path):
        name = jax.tree_util.keystr(path)
        return "attn2" in name and "to_k" in name or "norm2" in name

    leaves = jax.tree_util.tree_leaves_with_path(state.params)
    firsts = {p: np.asarray(v).ravel()[:BLOCK] for p, v in leaves}
    new_params = jax.tree_util.tree_map_with_path(lambda p, v: tile(firsts[p], v.shape, p),
                                                  state.params)
    ema = jax.tree_util.tree_map_with_path(
        lambda p, v: tile(firsts[p] + 1e-4 * block(firsts[p].size), v.shape, p), state.params)
    mus = {p: (np.zeros(1, np.float32) if unused(p) else 1e-3 * block(np.size(v)))
           for p, v in leaves}
    mu = jax.tree_util.tree_map_with_path(lambda p, v: tile(mus[p], v.shape, p), state.params)
    nu = jax.tree_util.tree_map_with_path(lambda p, v: tile(np.square(mus[p]), v.shape),
                                          state.params)
    count = jnp.asarray(FULL_STEP, jnp.int32)

    def counted(s):  # an optax state with a count (a NamedTuple; tuples have count())
        return "count" in getattr(s, "_fields", ())

    def moments(s):
        if not counted(s):
            return s
        return s._replace(count=count, **({"mu": mu, "nu": nu} if "mu" in s._fields else {}))
    opt_state = jax.tree.map(moments, state.opt_state, is_leaf=counted)
    state = TrainState(new_params, opt_state, state.ema._replace(params=ema, step=count), count)
    target = out / "restoration_full"
    if target.exists():
        shutil.rmtree(target)
    save_checkpoint(str(target), FULL_STEP, state)
    stored = json.loads((out / "leaves.json").read_text())
    stored["restoration_full"] = {k: leaf_record(v)
                                  for k, v in flat(restore_checkpoint(str(target)))}
    (out / "leaves.json").write_text(json.dumps(stored, indent=0, sort_keys=True) + "\n")
    return target


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default=str(REPO / "tests" / "fixtures" / "orbax"))
    p.add_argument("--full", action="store_true",
                   help="write restoration_full/ alone (the other dirs stay)")
    args = p.parse_args(argv)
    _jax()
    out = pathlib.Path(args.out)
    if args.full:
        target = full_restoration(out)
        size = sum(f.stat().st_size for f in target.rglob("*") if f.is_file())
        print(json.dumps({"out": str(target), "bytes": size}))
        return
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    with tempfile.TemporaryDirectory() as tmp:
        work = pathlib.Path(tmp)
        clip = train_daclip(work / "clip")
        steps = [e for e in os.listdir(clip) if e.isdigit()]
        shutil.copytree(clip / max(steps, key=int), out / "daclip" / max(steps, key=int))
        (work / "resto").mkdir()
        shutil.copytree(train_restoration(work / "resto", out / "daclip"), out / "restoration")
    expected(out)
    size = sum(f.stat().st_size for f in out.rglob("*") if f.is_file())
    print(json.dumps({"out": str(out), "bytes": size}))


if __name__ == "__main__":
    main()
