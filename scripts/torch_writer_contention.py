"""What a background step-dir write costs a host-bound loop on the CPU:
`orbax_writer`'s async save as it runs (in its writer process) against
the same save run in the writer thread of the caller's process.

It trains nothing. A UNet of the production layout (ch_mult 1,2,4,8,
context 512, both contexts) at `--nf` takes one AdamW update from seeded
gradients; then, for each variant in turns (process, thread, thread,
process, ...), `utils/checkpoint.save_checkpoint(..., cfg=, wait=False)` writes its
`.pt` and step dir while the caller runs a "step" of `--ops` tiny in-place
torch ops (host-bound, as a launch-bound training step is) until the
write ends. A step's ms before the save and during the write are printed
for each variant; a writer that takes the interpreter lock from the loop
shows as longer steps during the write.

Usage: python scripts/torch_writer_contention.py [--nf 32] [--rounds 2] [--ops 4000]
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

import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from daclip_torch.models.unet import ConditionalUNet  # noqa: E402
from daclip_torch.train import restoration as trest  # noqa: E402
from daclip_torch.utils import checkpoint, orbax_writer  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nf", type=int, default=32)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--ops", type=int, default=4000)
    args = ap.parse_args()

    torch.manual_seed(0)
    unet = ConditionalUNet(nf=args.nf, ch_mult=(1, 2, 4, 8), context_dim=512,
                           use_degra_context=True, use_image_context=True)
    cfg = trest.RestorationTrainConfig()
    state = trest.init_state(unet, cfg, device="cpu")
    for name, p in trest.trainable(unet):  # none where the UNet gives no gradient
        one_token = ".attn2.to_q." in name or ".attn2.to_k." in name or ".norm2." in name
        p.grad = None if one_token else torch.randn(p.shape) * 0.1
    trest.apply_gradients(state, unet, cfg, trest.make_schedule(cfg))

    x = torch.zeros(8)

    def step():
        t0 = time.perf_counter()
        for _ in range(args.ops):
            x.add_(1)
        return (time.perf_counter() - t0) * 1e3

    in_process = orbax_writer._write_step_in_process

    def in_thread(directory, step, packed, build, max_to_keep):
        return orbax_writer._write_step(directory, step, orbax_writer._unpack(*packed), build,
                                        max_to_keep)

    variants = {"process": in_process, "thread": in_thread}
    out = {k: dict(before_ms=[], during_ms=[], held_ms=[], write_ms=[]) for k in variants}
    order = [v for r in range(args.rounds) for v in (("process", "thread") if r % 2 == 0
                                                     else ("thread", "process"))]
    try:
        for variant in order:
            orbax_writer._write_step_in_process = variants[variant]
            rec = out[variant]
            with tempfile.TemporaryDirectory() as d:
                rec["before_ms"] += [step() for _ in range(5)]
                t0 = time.perf_counter()
                checkpoint.save_checkpoint(d, unet, state, cfg=cfg, wait=False)
                rec["held_ms"].append((time.perf_counter() - t0) * 1e3)
                writer = orbax_writer._writers[os.path.abspath(d)]
                while any(not f.done() for f in writer.pending):
                    rec["during_ms"].append(step())
                orbax_writer.wait_all()
                rec["write_ms"].append((time.perf_counter() - t0) * 1e3 - rec["held_ms"][-1])
                rec["dir_bytes"] = sum(os.path.getsize(os.path.join(r, f))
                                       for r, _, fs in os.walk(os.path.join(d, str(state.step)))
                                       for f in fs)
    finally:
        orbax_writer._write_step_in_process = in_process
    for rec in out.values():
        for k in ("before_ms", "during_ms"):
            v = sorted(rec[k])
            rec[k.replace("_ms", "_median_ms")] = v[len(v) // 2] if v else None
            rec[k] = len(v)
    print(json.dumps(dict(host=platform.node(), cpus=os.cpu_count(), nf=args.nf, ops=args.ops,
                          parameters=sum(p.numel() for p in unet.parameters()),
                          order=order, **out)))


if __name__ == "__main__":
    main()
