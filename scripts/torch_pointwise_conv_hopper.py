"""Time the port's bf16 dual 1×1 (#8) and 3×3 conv (#9) kernels on one CUDA
card beside an older checkout's build of the same kernels.

  python scripts/torch_pointwise_conv_hopper.py --parent DIR [--check-only] [--sweep]
      [--stamps]

It builds this checkout's kernel library and the one of DIR (a checkout's
`daclip_torch/ops` and `daclip_torch/csrc`, e.g. `git archive` of the parent
commit) into separate libraries, prints both builds' `ptxas -v` lines of the
two kernels and ptxas's advisories on this build's, then, for every bf16 row
of chip_smoke's DUAL_SHAPES (both forms), TRAIN_DUAL_SHAPES and CONV_SHAPES:
the schedule this build's plan picks, the largest difference from the plain
version (relative to its max) and from DIR's build, whether a second call
repeats bit for bit, and the device time (chip_smoke.device_ms: CUDA events
around ten calls queued behind a sleep) of this build and DIR's in the order
this, parent, this, parent, beside `torch.matmul` (the dual's single form)
or cuDNN's `conv2d` on the channels_last view, and the bound. Then the conv's
44 sites of one serving forward summed, each build and cuDNN. `--check-only`
stops before the times; `--sweep` also times, at each shape, the plans one
step from the chosen one (tile shape, splits, ring depth, tile columns, half
the persistent CTAs). `--stamps` builds a copy of the two kernels with
-DDACLIP_STAMPS and prints, at the element-path edges and their aligned
twins, the clock64() cycles from the first CTA's entry to each phase
(csrc/common.cuh `DACLIP_STAMP`: 1 barriers ready, 2 first stage free, 9
and 10 the producer thread's element fill and proxy fence done, 3 first
stage issued and filled, 4 producer done, 5 first stage full, 6 products
done, 7 stores done, 8 cluster done) and its span in ns beside the device
time of both builds; then how many clusters of 1, 2, 4 and 8 CTAs of each
conv tile shape the card holds at once. One JSON line per reading, each
with the card's name and power limit.
chip_smoke.py holds these kernels against their plain versions and gates
the run; this script reads them.
"""
import argparse
import ctypes
import importlib
import importlib.util
import json
import pathlib
import shutil
import subprocess
import sys

import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402  (its helpers; main() does not run)
from daclip_torch.ops import _build  # noqa: E402
from daclip_torch.ops import pointwise as pw  # noqa: E402

# the module: `daclip_torch.ops.conv3x3` names the function
cv = importlib.import_module("daclip_torch.ops.conv3x3")

KERNELS = ("pointwise::", "conv3x3::")


def smi():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def emit(**kw):
    print(json.dumps(kw), flush=True)


def ptxas(lib):
    log = pathlib.Path(lib._name).with_suffix(".log")
    text = log.read_text() if log.exists() else ""
    return [ln for ln in cs.ptxas_summary(text) if ln.startswith(KERNELS)], text


def parent_lib(root):
    spec = importlib.util.spec_from_file_location(
        "parent_build", pathlib.Path(root) / "daclip_torch" / "ops" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    # -fno-gnu-unique: else the launchers' static locals would be shared
    # between the two libraries in this process
    mod.NVCC_FLAGS = [*mod.NVCC_FLAGS, "-Xcompiler", "-fno-gnu-unique"]
    return mod.library(), mod.SIGNATURES


def stream():
    return torch.cuda.current_stream().cuda_stream


def dual_this(lib, x, skip, w, plan):
    R, cx = x.shape
    cs_ = 0 if skip is None else skip.shape[1]
    y = torch.empty((R, w.shape[1]), dtype=x.dtype, device=x.device)
    _build.check(lib.daclip_dual_conv1x1(
        x.data_ptr(), None if skip is None else skip.data_ptr(), w.data_ptr(), y.data_ptr(),
        R, cx, cs_, w.shape[1], 1, plan.cfg, plan.stages, plan.splits, plan.grid[0], stream()),
        "this dual")
    return y


def dual_parent(lib, signatures, x, skip, w):
    R, cx = x.shape
    cs_ = 0 if skip is None else skip.shape[1]
    y = torch.empty((R, w.shape[1]), dtype=x.dtype, device=x.device)
    args = [x.data_ptr(), None if skip is None else skip.data_ptr(), w.data_ptr(), y.data_ptr(),
            R, cx, cs_, w.shape[1], 1]
    if len(signatures["daclip_dual_conv1x1"]) > 10:  # a build that takes a plan
        p = pw._dual_plan(R, cx, cs_, w.shape[1], _build.sms(x.device))
        args += [p.cfg, p.stages, p.splits, p.grid[0]]
    _build.check(lib.daclip_dual_conv1x1(*args, stream()), "parent dual")
    return y


def conv_this(lib, x, w, plan):
    B, H, W, C = x.shape
    y = torch.empty((B, H, W, w.shape[3]), dtype=x.dtype, device=x.device)
    _build.check(lib.daclip_conv3x3(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), B, H, W, C, w.shape[3], 1, plan.cfg,
        plan.tile_cols, plan.stages, plan.splits, plan.grid[0], stream()), "this conv")
    return y


def conv_parent(lib, signatures, x, w):
    B, H, W, C = x.shape
    y = torch.empty((B, H, W, w.shape[3]), dtype=x.dtype, device=x.device)
    args = [x.data_ptr(), w.data_ptr(), y.data_ptr(), B, H, W, C, w.shape[3], 1]
    if len(signatures["daclip_conv3x3"]) > 10:  # a build that takes a plan
        p = cv._conv_plan(B, H, W, C, w.shape[3], _build.sms(x.device))
        args += [p.cfg, p.tile_cols, p.stages, p.splits, p.grid[0]]
    _build.check(lib.daclip_conv3x3(*args, stream()), "parent conv")
    return y


def dms(fn, match):
    """chip_smoke.device_ms, taken again once if it fails (a profiler window
    that names no kernel); None, with a line that says so, if it fails twice."""
    for _ in range(2):
        try:
            return cs.device_ms(fn, match)
        except RuntimeError as e:
            error = str(e)
    emit(phase="device_ms_failed", match=match, error=error)
    return None


def four(new, old, match):
    """Device ms in the order this, parent, this, parent."""
    row = {"this": [], "parent": []}
    for name, fn in (("this", new), ("parent", old), ("this", new), ("parent", old)):
        row[name].append(dms(fn, match))
    pairs = [(a, b) for a, b in zip(row["this"], row["parent"]) if a and b]
    row["this_over_parent"] = (sum(a for a, _ in pairs) / sum(b for _, b in pairs)
                               if pairs else None)
    return row


def check(got, again, want, other):
    return dict(max_rel_err=cs.rel_err(got, want), repeats_bitwise=torch.equal(got, again),
                max_diff_vs_parent=float((got.float() - other.float()).abs().max()))


def dual_neighbours(plan, R, Kx, Ks, O):
    """Plans one step from `plan` that the launcher takes."""
    total = -(-Kx // 64) + -(-Ks // 64)
    out = []
    for cfg in (0, 1):
        t = pw.DUAL_TILES[cfg]
        rows, cols = -(-R // t.rows), -(-O // (64 * t.panels))
        for splits in (1, 2, 4, 8):
            if splits > total or (t.resident and -(-total // splits) > 16):
                continue
            for stages in (2, 3, 4, 6):
                if stages < pw._min_stages(cfg):
                    continue
                smem = pw._dual_smem(cfg, stages, -(-total // splits))
                if smem > _build.SMEM_PER_CTA:
                    continue
                per_sm = pw._ctas_per_sm(cfg, smem, False)
                gx = rows if splits > 1 else min(rows, max(1, per_sm * 132 // cols))
                p = pw.DualPlan(cfg, stages, splits, (gx, cols, splits), smem)
                steps = (cfg != plan.cfg) + (splits != plan.splits) + (stages != plan.stages)
                if p != plan and steps == 1:
                    out.append(p)
    if plan.splits == 1 and plan.grid[0] > 1:  # half the persistent CTAs, two tiles each
        out.append(plan._replace(grid=(plan.grid[0] // 2, *plan.grid[1:])))
    return out


def conv_neighbours(plan, B, H, W, C, O):
    slices, otiles = -(-C // 32), -(-O // 64)
    out = []
    for cfg in range(len(cv.CONV_TILES)):
        tm = cv.CONV_TILES[cfg].pixels
        for tc in cv.TILE_COLS:
            tiles = B * -(-H // (tm // tc)) * -(-W // tc)
            for splits in (1, 2, 4, 8):
                if splits > slices:
                    continue
                for stages in (2, 3, 4):
                    smem = cv._conv_smem(cfg, stages)
                    if smem > _build.SMEM_PER_CTA:
                        continue
                    gx = tiles if splits > 1 else min(tiles, max(1, 132 // otiles))
                    p = cv.ConvPlan(cfg, tc, stages, splits, (gx, otiles, splits), smem)
                    # a tile shape's own ring depth counts as no step
                    depth = plan.stages if cfg == plan.cfg else cv.CONV_TILES[cfg].stages
                    steps = ((cfg != plan.cfg) + (tc != plan.tile_cols) + (splits != plan.splits)
                             + (stages != depth))
                    if p != plan and steps == 1:
                        out.append(p)
    if plan.splits == 1 and plan.grid[0] > 1:
        out.append(plan._replace(grid=(plan.grid[0] // 2, *plan.grid[1:])))
    return out


# the element-path edges that ran slower than the parent, and twins of them
# with every operand TMA can take: (R, Kx, Ks, O) of the dual form, and
# (B, H, W, C, O)
STAMP_DUAL = [(65, 24, 16, 33), (65, 24, 16, 40), (1000, 36, 20, 50), (1000, 40, 24, 56)]
STAMP_CONV = [(2, 37, 45, 6, 72), (2, 37, 45, 8, 72)]
STAMPED = ("pointwise", "conv3x3")


CLUSTERS = """
extern "C" int daclip_conv_clusters(int cfg, int stages, int splits) {
  auto kernel = cfg == 0 ? tc::conv_tma_kernel<tc::Large> : tc::conv_tma_kernel<tc::Small>;
  const int smem = cfg == 0 ? tc::Large::smem(stages) : tc::Small::smem(stages);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaLaunchAttribute a[1];
  a[0].id = cudaLaunchAttributeClusterDimension;
  a[0].val.clusterDim.x = 1;
  a[0].val.clusterDim.y = 1;
  a[0].val.clusterDim.z = splits;
  cudaLaunchConfig_t c = {};
  c.gridDim = dim3(1, 1, splits);
  c.blockDim = dim3(cfg == 0 ? tc::Large::THREADS : tc::Small::THREADS);
  c.dynamicSmemBytes = smem;
  c.attrs = a;
  c.numAttrs = 1;
  int n = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&n, (const void*)kernel, &c);
  return e == cudaSuccess ? n : -(int)e;
}
"""


def stamps_lib(root):
    """This checkout's two kernels built with -DDACLIP_STAMPS in a copy under
    `root`, each source with a function that reads (or clears) its stamps."""
    src, dst = REPO / "daclip_torch", root / "daclip_torch"
    shutil.rmtree(root, ignore_errors=True)
    (dst / "csrc").mkdir(parents=True)
    (dst / "ops").mkdir()
    shutil.copy(src / "ops" / "_build.py", dst / "ops" / "_build.py")
    for f in (src / "csrc").glob("*.cuh"):
        shutil.copy(f, dst / "csrc" / f.name)
    for name in STAMPED:
        text = (src / "csrc" / f"{name}.cu").read_text()
        text += (f'\nextern "C" int daclip_stamps_{name}(long long* out, int clear) {{\n'
                 "  static const long long zero[2][32] = {};\n"
                 "  return (int)(clear ? cudaMemcpyToSymbol(daclip_stamps, zero, sizeof zero)\n"
                 "                     : cudaMemcpyFromSymbol(out, daclip_stamps, sizeof zero));\n"
                 "}\n")
        if name == "conv3x3":  # the clusters of a launch that the card holds at once
            text += CLUSTERS
        (dst / "csrc" / f"{name}.cu").write_text(text)
    spec = importlib.util.spec_from_file_location("stamps_build", dst / "ops" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.NVCC_FLAGS = [*mod.NVCC_FLAGS, "-DDACLIP_STAMPS", "-Xcompiler", "-fno-gnu-unique"]
    target = mod.BUILD_DIR / "libdaclip_stamps.so"
    mod._build(target)
    lib = ctypes.CDLL(str(target))
    for name in ("daclip_dual_conv1x1", "daclip_conv3x3"):
        getattr(lib, name).argtypes = _build.SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    for name in STAMPED:
        fn = getattr(lib, f"daclip_stamps_{name}")
        fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    lib.daclip_conv_clusters.argtypes = [ctypes.c_int] * 3
    lib.daclip_conv_clusters.restype = ctypes.c_int
    return lib


def read_stamps(slib, name, launch):
    """The stamps of the first CTA of `launch` (after a warm call): cycles
    from its entry to each stamp, and its span in ns (entry to the last)."""
    launch()
    torch.cuda.synchronize()
    fn = getattr(slib, f"daclip_stamps_{name}")
    _build.check(fn(None, 1), "clear stamps")
    launch()
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * 64)()
    _build.check(fn(ctypes.addressof(buf), 0), "read stamps")
    cyc, ns = list(buf[:11]), list(buf[32:43])
    last = max(i for i in range(9) if cyc[i])
    return dict(cycles={i: cyc[i] - cyc[0] for i in range(1, 11) if cyc[i]},
                span_ns=ns[last] - ns[0], span_cycles=cyc[last] - cyc[0])


def stamps(slib, lib, plib, psig, card):
    gen = torch.Generator(device="cuda").manual_seed(21)
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(torch.bfloat16)
    for R, cx, cs_, O in STAMP_DUAL:
        x, skip, w = rnd(R, cx), rnd(R, cs_), rnd(cx + cs_, O)
        plan = pw._dual_plan(R, cx, cs_, O, _build.sms(x.device))
        row = dict(phase="stamps_dual", shape=[R, cx, cs_, O], card=card, plan=plan._asdict(),
                   **read_stamps(slib, "pointwise", lambda: dual_this(slib, x, skip, w, plan)))
        row.update(four(lambda: dual_this(lib, x, skip, w, plan),
                        lambda: dual_parent(plib, psig, x, skip, w), "daclip::pointwise::"))
        emit(**row)
    for B, H, W, C, O in STAMP_CONV:
        x, w = rnd(B, H, W, C), rnd(3, 3, C, O)
        plan = cv._conv_plan(B, H, W, C, O, _build.sms(x.device))
        row = dict(phase="stamps_conv", shape=[B, H, W, C, O], card=card, plan=plan._asdict(),
                   **read_stamps(slib, "conv3x3", lambda: conv_this(slib, x, w, plan)))
        row.update(four(lambda: conv_this(lib, x, w, plan), lambda: conv_parent(plib, psig, x, w),
                        "daclip::conv3x3::"))
        emit(**row)
    for cfg, t in enumerate(cv.CONV_TILES):
        emit(phase="clusters", cfg=cfg, stages=t.stages, card=card,
             what="clusters of CTAs the card holds at once, by cluster size",
             held={z: slib.daclip_conv_clusters(cfg, t.stages, z) for z in (1, 2, 4, 8)})


def run(lib, plib, psig, card, timed, sweep):
    gen = torch.Generator(device="cuda").manual_seed(20)
    dual = [(R, cx, cs_, O, form) for R, cx, cs_, O, dt in cs.DUAL_SHAPES
            if dt == torch.bfloat16 for form in ("dual", "single")]
    dual += [(R, cx, cs_, O, "single") for R, cx, cs_, O, dt in cs.TRAIN_DUAL_SHAPES]
    for R, cx, cs_, O, form in dual:
        rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(torch.bfloat16)
        x, skip, w = rnd(R, cx), rnd(R, cs_), rnd(cx + cs_, O) * (cx + cs_) ** -0.5
        if form == "single":
            x, skip = torch.cat([x, skip], dim=1), None
        Kx, Ks = x.shape[1], 0 if skip is None else cs_
        plan = pw._dual_plan(R, Kx, Ks, O, _build.sms(x.device))
        new = lambda p=plan: dual_this(lib, x, skip, w, p)
        old = lambda: dual_parent(plib, psig, x, skip, w)
        got = new()
        want = pw.dual_conv1x1_reference(x.float(), None if skip is None else skip.float(),
                                         w.float())
        row = dict(phase="dual", form=form, shape=[R, cx, cs_, O], card=card,
                   plan=plan._asdict(), **check(got, new(), want, old()))
        K = cx + cs_
        row["bound_ms"], row["bound_by"] = cs.bound_ms((R * K + R * O + K * O) * 2, 2 * R * K * O,
                                                       torch.bfloat16)
        if timed:
            row.update(four(new, old, "daclip::pointwise::"))
            if form == "single":
                row["matmul"] = dms(lambda: torch.matmul(x, w), "")
        emit(**row)
        if sweep:
            for p in dual_neighbours(plan, R, Kx, Ks, O):
                fn = lambda p=p: dual_this(lib, x, skip, w, p)
                emit(phase="dual_sweep", form=form, shape=[R, cx, cs_, O], plan=p._asdict(),
                     max_rel_err=cs.rel_err(fn(), want), device_ms=dms(fn, "daclip::pointwise::"))
        del x, skip, w, got, want
        torch.cuda.empty_cache()

    sites = {(H, C, O): n for H, C, O, n in cs.CONV_SITES}
    sums = {"this": 0.0, "parent": 0.0, "cudnn": 0.0, "bound": 0.0}
    for B, H, W, C, O, dt in cs.CONV_SHAPES:
        if dt != torch.bfloat16:
            continue
        x = torch.randn(B, H, W, C, generator=gen, device="cuda").to(dt)
        w = (torch.randn(3, 3, C, O, generator=gen, device="cuda") * (9 * C) ** -0.5).to(dt)
        plan = cv._conv_plan(B, H, W, C, O, _build.sms(x.device))
        new = lambda p=plan: conv_this(lib, x, w, p)
        old = lambda: conv_parent(plib, psig, x, w)
        got = new()
        want = cv.conv3x3_reference(x.float(), w.float())
        row = dict(phase="conv", shape=[B, H, W, C, O], card=card, plan=plan._asdict(),
                   **check(got, new(), want, old()))
        row["bound_ms"], row["bound_by"] = cs.bound_ms(
            (B * H * W * (C + O) + 9 * C * O) * 2, 2 * B * H * W * 9 * C * O, dt)
        if timed:
            x_nchw = x.permute(0, 3, 1, 2)
            w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            row.update(four(new, old, "daclip::conv3x3::"))
            row["cudnn"] = dms(lambda: torch.nn.functional.conv2d(x_nchw, w_oihw, padding=1), "")
            n = sites.get((H, C, O)) if B == 1 and H == W else None
            if n and None not in (*row["this"], *row["parent"], row["cudnn"]):
                sums["this"] += n * sum(row["this"]) / 2
                sums["parent"] += n * sum(row["parent"]) / 2
                sums["cudnn"] += n * row["cudnn"]
                sums["bound"] += n * row["bound_ms"]
        emit(**row)
        if sweep:
            for p in conv_neighbours(plan, B, H, W, C, O):
                fn = lambda p=p: conv_this(lib, x, w, p)
                emit(phase="conv_sweep", shape=[B, H, W, C, O], plan=p._asdict(),
                     max_rel_err=cs.rel_err(fn(), want), device_ms=dms(fn, "daclip::conv3x3::"))
        del x, w, got, want
        torch.cuda.empty_cache()
    if timed:
        emit(phase="conv_sites", what="device ms over the 44 3x3 sites of one serving forward",
             card=card, **sums)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="a checkout whose daclip_torch/ops and csrc build the other kernels")
    ap.add_argument("--check-only", action="store_true", help="no times")
    ap.add_argument("--sweep", action="store_true", help="also time the neighbouring plans")
    ap.add_argument("--stamps", action="store_true",
                    help="also read the phases of the element-path edges from a stamped build")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_pointwise_conv_hopper: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi()
    emit(phase="device", card=card, torch=torch.__version__, cuda=torch.version.cuda)
    lib = _build.library()
    lines, text = ptxas(lib)
    smem = dict(dual=[lib.daclip_dual_smem(0, 4, 16), lib.daclip_dual_smem(1, 4, 0)],
                conv=[lib.daclip_conv_smem(c, t.stages) for c, t in enumerate(cv.CONV_TILES)])
    plans = dict(dual=[pw._dual_smem(0, 4, 16), pw._dual_smem(1, 4, 0)],
                 conv=[cv._conv_smem(c, t.stages) for c, t in enumerate(cv.CONV_TILES)])
    emit(phase="build", ptxas=lines, smem=smem, smem_agrees_with_plans=smem == plans)
    emit(phase="advisories", lines=[ln for ln in text.splitlines()
                                    if ("pointwise" in ln or "conv3x3" in ln)
                                    and ("C75" in ln or "arning" in ln)][:40])
    plib, psig = parent_lib(args.parent)
    emit(phase="parent", root=args.parent, ptxas=ptxas(plib)[0])
    if args.stamps:
        stamps(stamps_lib(REPO / ".chipscratch" / "stamps"), lib, plib, psig, card)
    run(lib, plib, psig, card, not args.check_only, args.sweep)
    emit(phase="done", card=card)


if __name__ == "__main__":
    main()
