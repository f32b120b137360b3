"""Checkpoint inspection CLI — key/shape dump for any format the port reads.

Counterpart of `daclip_tpu/tools/inspect_checkpoint.py` (the reference's
debug script da-clip/src/test.py:1-11, which torch.loads a checkpoint and
prints its keys). It reads each kind of `utils/native_checkpoint.
checkpoint_kind`: a torch `.pt`/`.pth` (its state dict, unwrapped as
`convert.load_torch_state_dict` does), an orbax train dir of daclip_tpu's
(either train CLI's) or one of its step dirs (read without JAX by
`utils/orbax_reader`), a flat `.npz`, the port's restoration train dir
(`<step>.pt`) and its DA-CLIP train dir (`epoch_<n>.pt`), each file's whole
tree. It prints the top-level layout, the flattened keys with shapes and
dtypes, and the total count of array elements: for the same `.npz` or
orbax dir, the same keys, array lines and counts as daclip_tpu's.

  python -m daclip_torch.tools.inspect_checkpoint <ckpt> [--keys-only] [--limit N]
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch


def _flatten(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _flatten(tree[k], f"{prefix}.{k}" if prefix else str(k))
    else:
        yield prefix, tree


def _leaf_desc(v: Any) -> str:
    shape = getattr(v, "shape", None)
    if shape is not None:
        dtype = str(getattr(v, "dtype", "?")).replace("torch.", "")
        return f"{tuple(shape)} {dtype}"
    return repr(v)


def load_tree(path: str, step=None) -> Tuple[Dict, str]:
    """Returns (tree, format_name). `step` picks a train dir's file (its
    step, or its epoch for a DA-CLIP train dir; default the latest)."""
    from daclip_torch.convert import load_torch_state_dict
    from daclip_torch.utils import checkpoint as ckpt
    from daclip_torch.utils import native_checkpoint as nc

    kind = nc.checkpoint_kind(path)
    if kind in ("orbax", "orbax_step"):
        tree, restored = nc.load_train_tree(path, step=step)
        return tree, f"orbax (step {restored})"
    if kind == "npz":
        return nc.load_params_npz(path), "npz"
    if kind in ("train_dir", "clip_train_dir"):
        prefix = ckpt.EPOCH if kind == "clip_train_dir" else ""
        n = ckpt.latest_step(path, prefix) if step is None else step
        tree = torch.load(ckpt.checkpoint_path(path, n, prefix), map_location="cpu",
                          weights_only=False)
        return tree, f"{kind} ({'epoch' if prefix else 'step'} {n})"
    return load_torch_state_dict(path), "torch"


def describe(tree: Dict, fmt: str, keys_only: bool = False, limit: int = 0,
             _print=print) -> Dict[str, int]:
    _print(f"format: {fmt}")
    if isinstance(tree, dict):
        _print(f"top-level keys: {sorted(tree, key=str)}")
    n_leaves = 0
    n_params = 0
    for i, (key, leaf) in enumerate(_flatten(tree)):
        n_leaves += 1
        size = int(np.prod(getattr(leaf, "shape", ()) or ())) \
            if hasattr(leaf, "shape") else 0
        n_params += size
        if limit and i >= limit:
            continue
        _print(key if keys_only else f"{key}  {_leaf_desc(leaf)}")
    if limit and n_leaves > limit:
        _print(f"... ({n_leaves - limit} more)")
    _print(f"{n_leaves} leaves, {n_params / 1e6:.2f}M array elements")
    return {"leaves": n_leaves, "elements": n_params}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkpoint",
                    help="torch .pt/.pth, orbax train dir, orbax step dir, .npz, "
                         "or the port's restoration or DA-CLIP train dir")
    ap.add_argument("--step", type=int, default=None,
                    help="train dir step (epoch for the port's DA-CLIP train dir) "
                         "to load (default: latest)")
    ap.add_argument("--keys-only", action="store_true",
                    help="print keys without shapes (reference test.py format)")
    ap.add_argument("--limit", type=int, default=0,
                    help="print at most N leaves (0 = all)")
    args = ap.parse_args(argv)
    tree, fmt = load_tree(args.checkpoint, step=args.step)
    return describe(tree, fmt, keys_only=args.keys_only, limit=args.limit)


if __name__ == "__main__":
    main()
