"""chip_smoke's `resume` phase alone, on the card, from the checkout at
CHECKOUT, to hold the resumed restoration CLI's steps beside another
checkout's in one call (run parent, this, this, parent).

VARIANT is `parent` (a checkout whose `run_resume` takes no argument and
whose CLI writes no step dir), `change` (this tree as it is), or
`inthread` (this tree with each async step-dir write run in the
directory's writer thread of the training process instead of the writer
process: what the write costs the loop when it shares its interpreter
lock). The kernels are built first. The phase runs all its checks; the
last line is `SUMMARY {json}`: the card, the CLI's step ms and losses, the
kernels' launches, and, for a tree that writes step dirs, each save's and
write's ms and bytes.

Usage: python scripts/torch_resume_ab.py CHECKOUT VARIANT
"""
import json
import pathlib
import subprocess
import sys
import time


def main():
    root, variant = pathlib.Path(sys.argv[1]).resolve(), sys.argv[2]
    if variant not in ("parent", "change", "inthread"):
        sys.exit(f"unknown variant {variant!r}")
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    from daclip_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    if variant == "inthread":
        from daclip_torch.utils import orbax_writer

        def in_thread(directory, step, packed, build, max_to_keep):
            return orbax_writer._write_step(directory, step, orbax_writer._unpack(*packed), build,
                                            max_to_keep)

        orbax_writer._write_step_in_process = in_thread
    rows, emit = [], cs.emit

    def keep(**kw):
        rows.append(kw)
        emit(**kw)

    cs.emit = keep
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    counts, records = cs.run_resume() if variant == "parent" else cs.run_resume(smi)
    row = [r for r in rows if r.get("phase") == "resume"][-1]
    summary = dict(variant=variant, card=smi, seconds=time.perf_counter() - t0, counts=counts,
                   steps=[r["step"] for r in records], ms=[r["ms"] for r in records],
                   loss=[r["loss"] for r in records])
    if "orbax_write" in row:
        summary.update(saves=row["orbax_write"]["saves"], writes=row["orbax_write"]["writes"],
                       clip_writes=row["daclip_cli"]["writes"])
    print("SUMMARY " + json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
