"""Compare two checkouts' builds of the port's v5 linear-attention wrap
forward kernel bit for bit, on one CUDA card.

  cd <checkout A> && python <this file> dump a.npz
  cd <checkout B> && python <this file> dump b.npz
  python <this file> compare a.npz b.npz

`dump` imports `daclip_torch` from the current directory, builds its kernels,
and saves `attn_wrap`'s output and `_forward_kernel`'s output with its kept
(w_attn, ctx, s, m) on seeded inputs at the UNet's shapes (bf16 and f32,
serving and training batch sizes, a ragged n). `compare` prints one JSON line
and exits non-zero unless every array is identical.
"""
import json
import os
import sys

import numpy as np

SHAPES = [("bfloat16", 1, 65536, 64), ("bfloat16", 1, 4096, 256), ("bfloat16", 2, 3001, 96),
          ("float32", 1, 1024, 32), ("bfloat16", 16, 16384, 128), ("float32", 2, 4096, 64)]


def dump(path):
    sys.path.insert(0, os.getcwd())
    import torch

    from daclip_torch.ops import linear_attention as la

    res = {}
    for i, (dtype, B, n, C) in enumerate(SHAPES):
        gen = torch.Generator(device="cuda").manual_seed(100 + i)
        rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")
        args = [rnd(B, n, C), 1 + 0.1 * rnd(C), rnd(C, 384) * C ** -0.5,
                rnd(128, C) * 128 ** -0.5, 0.1 * rnd(C), 1 + 0.1 * rnd(C)]
        args = [a.to(getattr(torch, dtype)).contiguous() for a in args]
        res[f"out{i}"] = la.attn_wrap(*args).float().cpu().numpy()
        out, stats = la._forward_kernel(*args, keep_stats=True)
        res[f"out_kept{i}"] = out.float().cpu().numpy()
        for j, s in enumerate(stats):
            res[f"stats{i}_{j}"] = s.cpu().numpy()
    np.savez(path, **res)
    print(json.dumps({"dumped": path, "arrays": len(res)}))


def compare(a_path, b_path):
    a, b = np.load(a_path), np.load(b_path)
    diff = {k: float(np.abs(a[k].astype(np.float64) - b[k]).max())
            for k in a.files if k in b.files}
    same = sorted(a.files) == sorted(b.files) and all(np.array_equal(a[k], b[k]) for k in a.files)
    print(json.dumps({"arrays": len(a.files), "identical": same, "max_diff": max(diff.values()),
                      "differing": {k: v for k, v in diff.items() if v}}))
    return same


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "dump":
        dump(sys.argv[2])
    elif len(sys.argv) == 4 and sys.argv[1] == "compare":
        sys.exit(0 if compare(sys.argv[2], sys.argv[3]) else 1)
    else:
        sys.exit(__doc__)
