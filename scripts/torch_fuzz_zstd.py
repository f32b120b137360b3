"""Seeded mutation fuzz of the port's zstd decoder
(daclip_torch/native/zstd.cc through daclip_torch/utils/zstd.py).

Builds zstd.cc with AddressSanitizer and UndefinedBehaviorSanitizer, then, in
a child process that preloads the ASan runtime, decodes mutants of a seed
corpus of frames that the `zstandard` package writes (levels -5 to 22, with
and without checksum and content size, raw, text and f32-weight inputs, a
streamed frame without content size, several frames with skippable ones
between them). A mutant flips or sets bytes (in the header, the blocks or
the checksum), cuts the input short, or splices two frames. Each must decode
or raise ZstdError; where the frame has a checksum, a decode that succeeds
must give the original bytes. A sanitizer report or a crash fails the run.
tests/test_torch_orbax.py runs mutants of its own, without the sanitizers.

Usage: python scripts/torch_fuzz_zstd.py [--iterations 50000] [--seed 0]
           [--out DIR]
Needs g++ with libasan and libubsan, and zstandard. Prints one JSON line of
counts.
"""
import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from daclip_torch.utils import zstd  # noqa: E402

SANITIZE = ("-O1", "-g", "-fno-omit-frame-pointer", "-fsanitize=address,undefined",
            "-fno-sanitize-recover=undefined", "-fPIC", "-shared", "-std=c++17")


def corpus(rng):
    """(frame bytes, original bytes, whether every frame has a checksum)."""
    import zstandard

    text = b"".join((REPO / p).read_bytes() for p in ("README.md", "daclip_torch/pipeline.py"))
    inputs = [b"", b"x", rng.bytes(3000), text[:5000], text[:140_000],
              (0.02 * rng.standard_normal(40_000)).astype(np.float32).tobytes(),
              bytes(70_000) + rng.bytes(100)]
    out = []
    for level in (-5, 1, 3, 9, 19, 22):
        for checksum in (False, True):
            c = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                         write_content_size=level % 2 == 1)
            out += [(c.compress(d), d, checksum) for d in inputs]
    c = zstandard.ZstdCompressor(level=3, write_checksum=True).compressobj()
    streamed = c.compress(text[:90_000]) + c.compress(text[90_000:150_000]) + c.flush()
    out.append((streamed, text[:150_000], True))
    skip = (0x184D2A53).to_bytes(4, "little") + (3).to_bytes(4, "little") + b"abc"
    (f1, d1, _), (f2, d2, _) = [e for e in out if e[2] and len(e[1]) > 1000][:2]
    out.append((f1 + skip + f2, d1 + d2, True))
    return out


def mutate(rng, frame: bytes, other: bytes) -> bytes:
    b = bytearray(frame)
    kind = rng.integers(0, 5)
    if kind == 0 and len(b) > 4:      # flip bits anywhere past the magic
        for _ in range(int(rng.integers(1, 4))):
            b[int(rng.integers(4, len(b)))] ^= 1 << int(rng.integers(0, 8))
    elif kind == 1 and len(b) > 4:    # set a header or early byte
        b[int(rng.integers(4, min(len(b), 24)))] = int(rng.integers(0, 256))
    elif kind == 2:                   # cut short
        b = b[:int(rng.integers(0, len(b) + 1))]
    elif kind == 3 and len(b) > 8:    # splice another frame's tail in
        cut = int(rng.integers(4, len(b)))
        b = b[:cut] + other[int(rng.integers(0, len(other))):]
    elif len(b) > 4:                  # a run of random bytes
        at = int(rng.integers(4, len(b)))
        b[at:at + 8] = rng.bytes(8)
    return bytes(b)


def _child(lib: str, iterations: int, seed: int):
    zstd.load(lib)
    rng = np.random.default_rng(seed)
    frames = corpus(rng)
    counts = {"decoded": 0, "raised": 0, "checked": 0}
    for f, d, _ in frames:
        assert zstd.decompress(f) == d
    for i in range(iterations):
        frame, data, checked = frames[int(rng.integers(0, len(frames)))]
        bad = mutate(rng, frame, frames[int(rng.integers(0, len(frames)))][0])
        try:
            got = zstd.decompress(bad, limit=1 << 22)
        except zstd.ZstdError:
            counts["raised"] += 1
            continue
        counts["decoded"] += 1
        if checked and bad.startswith(frame[:4]) and len(bad) == len(frame) and got != data:
            # the checksum covers the content: a changed output must raise
            raise AssertionError(f"iteration {i}: a frame with a checksum decoded wrongly")
        counts["checked"] += checked
        zstd.crc32c(bad)
    return counts


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--iterations", type=int, default=50000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="directory for the sanitizer build")
    p.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:
        print(json.dumps(_child(args.child, args.iterations, args.seed)))
        return
    out = args.out or tempfile.mkdtemp(prefix="zstd_fuzz_")
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, "libzstd_sanitized.so")
    subprocess.run(["g++", *SANITIZE, "-o", lib, zstd._SRC], check=True)
    # libstdc++ preloaded too: ASan intercepts __cxa_throw (the decoder's
    # errors are C++ exceptions) only when it is loaded at start-up
    pre = [subprocess.run(["g++", f"-print-file-name={name}"], capture_output=True,
                          text=True, check=True).stdout.strip()
           for name in ("libasan.so", "libstdc++.so")]
    env = dict(os.environ, LD_PRELOAD=" ".join(pre), ASAN_OPTIONS="detect_leaks=0:abort_on_error=1",
               UBSAN_OPTIONS="halt_on_error=1:print_stacktrace=1")
    res = subprocess.run([sys.executable, __file__, "--child", lib, "--iterations",
                          str(args.iterations), "--seed", str(args.seed)], env=env)
    sys.exit(res.returncode)


if __name__ == "__main__":
    main()
