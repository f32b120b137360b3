"""Time the port's bf16 linear-attention kernels (the forward #1 in its three
input forms, #1/#6 raw x, #5 normalised xn, #7 qkv, and the backward #3) on
one CUDA card beside an older checkout's build of the same kernels.

  python scripts/torch_linattn_hopper.py --parent DIR

It builds the kernel library, prints the linear-attention kernels' `ptxas
-v` lines and ptxas's advisories on them, then prints, per shape, the device
time (chip_smoke.device_ms: CUDA events around ten calls queued behind a
sleep) of each form's forward and of the backward (with its weight-gradient
launches), each kernel's share by launch (torch.profiler, in the window
that names the kernels), the backward's
dW_qkv launch beside `torch.matmul(xn.T, dqkv)`, and the same calls into
the kernels built from DIR (a checkout's `daclip_torch/ops` and
`daclip_torch/csrc`, e.g. `git archive` of the parent commit) in the order
parent, this, this, parent, with the largest difference between the two
builds' outputs. One JSON line per reading, each with the card's name and
power limit. chip_smoke.py holds these kernels against their plain
versions; this script only times them.
"""
import argparse
import importlib.util
import json
import pathlib
import subprocess
import sys

import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402  (its helpers; main() does not run)
from daclip_torch.ops import _build  # noqa: E402
from daclip_torch.ops import linear_attention as la  # noqa: E402

# (B, n, C): serve's six sites (down0/up0 share the first), the training
# step's (B = 16), shard_tiles' chunk, the Wild-IR sites at B = 1 and 16, and
# the edges (ragged n and C = 96, C = 512)
SERVE = [(1, 65536, 64), (1, 16384, 64), (1, 16384, 128), (1, 4096, 128), (1, 4096, 256)]
TRAIN = [(16, n, C) for _, n, C in SERVE]
WILD = [(B, n, C) for B in (1, 16)
        for n, C in ((16384, 64), (4096, 64), (4096, 128), (1024, 128), (1024, 256))]
EDGE = [(2, 3001, 96), (2, 1024, 512)]
FWD_SHAPES = SERVE + TRAIN + [(4, 147456, 64)] + [s for s in WILD if s not in SERVE + TRAIN] + EDGE
BWD_SHAPES = TRAIN + [s for s in WILD if s[0] == 16 and s not in TRAIN] + EDGE
FORMS = ("wrap", "fused_v4", "core")


def smi():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def emit(**kw):
    print(json.dumps(kw), flush=True)


def build():
    lib = _build.library()
    log = pathlib.Path(lib._name).with_suffix(".log")
    text = log.read_text() if log.exists() else ""
    lines = [ln for ln in cs.ptxas_summary(text) if ln.startswith(("wrap::", "wrap_bwd::"))]
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()[-1]
    emit(phase="build", nvcc=nvcc, ptxas=lines)
    emit(phase="advisories", lines=[ln for ln in text.splitlines() if "linear_attention" in ln
                                    and ("C75" in ln or "arning" in ln)][:40])
    return lib


def parent_lib(root):
    spec = importlib.util.spec_from_file_location(
        "parent_build", pathlib.Path(root) / "daclip_torch" / "ops" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    # -fno-gnu-unique: else launchers' static locals would be shared between
    # the two libraries in this process
    mod.NVCC_FLAGS = [*mod.NVCC_FLAGS, "-Xcompiler", "-fno-gnu-unique"]
    return mod.library(), mod.SIGNATURES


def stream():
    return torch.cuda.current_stream().cuda_stream


def ptrs(*ts):
    return [None if t is None else t.data_ptr() for t in ts]


def forward(lib, takes_tiles, form, args):
    """One forward of `form` through `lib`'s launchers (the apply launchers of
    an older build may take no tile count)."""
    x = args[0]
    B, n, C = x.shape
    rows, (pm, ps, pc, wa) = la._scratch(x, B, n)
    tiles = [la._tiles_per_cta(B, n, C)] if takes_tiles else []
    cn = [C] if lib.takes_cn else []
    if not takes_tiles:  # an older build's stats grid: two CTAs an SM
        rows = la._rows_per_part(B, n)
        parts = -(-n // rows)
        pm, ps = (torch.empty((B, parts, la.HID), dtype=torch.float32, device=x.device)
                  for _ in range(2))
        pc = torch.empty((B, parts, la.HEADS, la.DIM_HEAD, la.DIM_HEAD), dtype=torch.float32,
                         device=x.device)
    if form == "core":
        out = torch.empty((B, n, la.HID), dtype=x.dtype, device=x.device)
        _build.check(lib.daclip_linattn_core(*ptrs(x, pm, ps, pc, wa, out), B, n, rows, *tiles,
                                             1, stream()), "core")
    elif form == "fused_v4":
        out = torch.empty_like(x)
        _build.check(lib.daclip_linattn_fused_v4(*ptrs(*args, pm, ps, pc, wa, out), B, n, C,
                                                 *cn, rows, *tiles, 1, stream()), "fused_v4")
    else:
        out = torch.empty_like(x)
        g_pre, w_qkv, w_out, b_out, g_out = args[1:]
        _build.check(lib.daclip_wrap_stats(*ptrs(x, g_pre, w_qkv, pm, ps, pc), B, n, C, *cn,
                                           rows, 1, stream()), "stats")
        _build.check(lib.daclip_wrap_combine(*ptrs(pm, ps, pc, wa), None, None, None, B,
                                             pm.shape[1], n, 1, stream()), "combine")
        _build.check(lib.daclip_wrap_apply(*ptrs(x, g_pre, w_qkv, wa, w_out, b_out, g_out, out),
                                           B, n, C, *cn, *tiles, 1, stream()), "apply")
    return out


def backward(lib, args, dout, stats):
    """attn_wrap_bwd's launches through `lib` (the same C signatures in both
    builds); its six gradients."""
    x, g_pre, w_qkv, w_out, b_out, g_out = args
    w_attn, ctx, s, m = stats
    B, n, C = x.shape
    cn = [C] if lib.takes_cn else []
    rows = la._rows_per_part(B, n)
    parts = -(-n // rows)
    f32 = dict(dtype=torch.float32, device=x.device)
    dy, dx, xn = torch.empty_like(x), torch.empty_like(x), torch.empty_like(x)
    attn = torch.empty((B, n, la.HID), dtype=x.dtype, device=x.device)
    dqkv = torch.empty((B, n, 3 * la.HID), dtype=x.dtype, device=x.device)
    part_dw = torch.empty((B, parts, la.HEADS, la.DIM_HEAD, la.DIM_HEAD), **f32)
    part_dgout, part_dbout, part_dgpre = (torch.empty((B, parts, C), **f32) for _ in range(3))
    dctx = torch.empty((B, la.HEADS, la.DIM_HEAD, la.DIM_HEAD), **f32)
    ds = torch.empty((B, la.HID), **f32)
    _build.check(lib.daclip_wrap_bwd1(*ptrs(x, dout, g_pre, w_qkv, w_attn, w_out, b_out, g_out,
                                            dy, attn, part_dw, part_dgout, part_dbout),
                                      B, n, C, *cn, rows, 1, stream()), "bwd1")
    _build.check(lib.daclip_wrap_bwd_mid(*ptrs(part_dw, ctx, s, dctx, ds), B, parts, n, 1,
                                         stream()), "mid")
    _build.check(lib.daclip_wrap_bwd2(*ptrs(x, dout, g_pre, w_qkv, w_attn, w_out, dctx, ds, m,
                                            dy, dx, xn, dqkv, part_dgpre),
                                      B, n, C, *cn, rows, 1, stream()), "bwd2")
    dw_qkv = la._wgrad(lib, xn, dqkv, stream())
    dw_out = la._wgrad(lib, attn, dy, stream())
    return (dx, part_dgpre.sum((0, 1)), dw_qkv, dw_out, part_dbout.sum((0, 1)),
            part_dgout.sum((0, 1)))


def max_diff(a, b):
    if isinstance(a, torch.Tensor):
        return float((a.float() - b.float()).abs().max())
    return max(max_diff(u, v) for u, v in zip(a, b))


def dms(fn, match, split=None):
    """chip_smoke.device_ms (its profiler window fills `split`), taken again
    once if that window names no kernel (it then raises); None, with a line
    that says so, if it fails twice."""
    for _ in range(2):
        try:
            return cs.device_ms(fn, match, split=split)
        except RuntimeError as e:
            error = str(e)
    emit(phase="device_ms_failed", match=match, error=error)
    return None


def four(new, old, match):
    """Device ms in the order parent, this, this, parent, and each build's
    split by launch (torch.profiler, device ms a call)."""
    row, splits = {}, {"this": {}, "parent": {}}
    for name, fn in (("parent", old), ("this", new), ("this", new), ("parent", old)):
        row.setdefault(name, []).append(dms(fn, match, splits[name]))
    return dict(row, split=splits["this"], parent_split=splits["parent"])


def time_all(lib, plib, parent_tiles, card):
    gen = torch.Generator(device="cuda").manual_seed(5)
    for B, n, C in FWD_SHAPES:
        args = cs.wrap_case(B, n, C, torch.bfloat16, gen, False)
        xn = la._channel_ln(args[0], args[1])
        inputs = {"wrap": args, "fused_v4": [xn, *args[2:]],
                  "core": [(xn @ args[2]).contiguous()]}
        for form in FORMS:
            a = inputs[form]
            new = lambda: forward(lib, True, form, a)
            old = lambda: forward(plib, parent_tiles, form, a)
            esize = 2
            if form == "core":
                bms, by = cs.bound_ms(B * n * (384 + 128) * esize, 2 * B * n * 8192, torch.bfloat16)
            else:
                bms, by = cs.linattn_bound(B, n, C, esize, torch.bfloat16)
            row = dict(phase="time_fwd", form=form, shape=[B, n, C], card=card, bound_ms=bms,
                       bound_by=by, max_diff_vs_parent=max_diff(new(), old()),
                       **four(new, old, "daclip::wrap::"))
            emit(**row)
        del args, xn, inputs
    for B, n, C in BWD_SHAPES:
        args = cs.wrap_case(B, n, C, torch.bfloat16, gen, False)
        dout = torch.randn(B, n, C, generator=gen, device="cuda").to(torch.bfloat16)
        _, stats = la._forward_kernel(*args, keep_stats=True)
        new = lambda: backward(lib, args, dout, stats)
        old = lambda: backward(plib, args, dout, stats)
        bms, by = cs.bound_ms((3 * B * n * C + 2 * (C * 384 + 128 * C + 3 * C)) * 2,
                              2 * B * n * (1536 * C + 20480), torch.bfloat16)
        row = dict(phase="time_bwd", shape=[B, n, C], card=card, bound_ms=bms, bound_by=by,
                   max_diff_vs_parent=max_diff(new(), old()),
                   **four(new, old, "daclip::wrap_bwd::"))
        xs = torch.randn(B * n, C, generator=gen, device="cuda").to(torch.bfloat16)
        dq = torch.randn(B * n, 3 * la.HID, generator=gen, device="cuda").to(torch.bfloat16)
        row.update(wgrad=four(lambda: la._wgrad(lib, xs, dq, stream()),
                              lambda: la._wgrad(plib, xs, dq, stream()), "wgrad"),
                   matmul=dms(lambda: torch.matmul(xs.t(), dq), ""))
        emit(**row)
        del args, dout, stats, xs, dq
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="a checkout whose daclip_torch/ops and csrc build the other kernels")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_linattn_hopper: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smi()
    emit(phase="device", card=card, torch=torch.__version__, cuda=torch.version.cuda)
    lib = build()
    plib, signatures = parent_lib(args.parent)
    # an older build's launchers may take no LayerNorm width (cn), and its
    # apply launchers no tile count
    lib.takes_cn = True
    plib.takes_cn = len(signatures["daclip_wrap_stats"]) == len(
        _build.SIGNATURES["daclip_wrap_stats"])
    parent_tiles = len(signatures["daclip_wrap_apply"]) - plib.takes_cn == len(
        _build.SIGNATURES["daclip_wrap_apply"]) - 1
    emit(phase="parent", root=args.parent, takes_tiles=parent_tiles)
    time_all(lib, plib, parent_tiles, card)
    emit(phase="done")


if __name__ == "__main__":
    main()
