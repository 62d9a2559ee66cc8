"""Probe which clip sizes the native frame decoder (`native/libvidi_media.so`)
takes without corrupting its heap: the rule `media/video.native_frames_safe`
encodes.

    python3 scripts/native_decode_probe.py [--widths 16:330:2] \
        [--heights 64] [--malloc-check] [--workers 6] [--dir DIR]

For each (width, height) it writes a 10-frame mp4v clip of random pixels
with `cv2.VideoWriter` (into DIR, a temporary directory by default), then
decodes it in a subprocess through the library's whole-clip
(`vm_decode_frames`) and streamed (`vm_stream_*`) paths with the width rule
switched off. A subprocess that aborts (SIGABRT "double free or
corruption", SIGSEGV) marks the size. `--malloc-check` preloads glibc's
`libc_malloc_debug.so.0` with MALLOC_CHECK_=3, which catches a write of
one byte past a block instead of only the overruns that happen to break
the heap. It prints the failing sizes, the widths' residues mod 16 that
failed and passed, and whether the rule agrees with every result. Needs
the library to load (libav installed) and cv2.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

MALLOC_DEBUG = "libc_malloc_debug.so.0"  # glibc >= 2.34; found on the loader path
HUNG = -1000

_CHILD = r"""
import sys
from vidi_tpu_torch.media import video as V
V.native_frames_safe = lambda width: True  # the library for every width
if not V._load_native():
    sys.exit(3)
mode, path = sys.argv[1], sys.argv[2]
if mode == "load":
    frames = V.load_video(path, fps=5)
else:
    frames = [f for block in V.stream_video(path, fps=5, chunk=3) for f in block]
print(len(frames))
"""


def _span(text: str):
    if ":" in text:
        a, b, step = (int(x) for x in text.split(":"))
        return list(range(a, b, step))
    return [int(x) for x in text.split(",")]


def write_clip(path: str, width: int, height: int, frames: int = 10) -> None:
    import cv2

    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 5, (width, height))
    rng = np.random.default_rng(width * 10007 + height)
    for _ in range(frames):
        writer.write(rng.integers(0, 255, (height, width, 3), dtype=np.uint8))
    writer.release()


def decode_rc(path: str, mode: str, malloc_check: bool) -> int:
    """Exit code of one decode of `path` in a subprocess (negative: signal;
    HUNG: still running after 60 s, as a corrupted heap can leave malloc)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    if malloc_check:
        env.update(LD_PRELOAD=MALLOC_DEBUG, MALLOC_CHECK_="3")
    try:
        return subprocess.run([sys.executable, "-c", _CHILD, mode, path], env=env,
                              capture_output=True, timeout=60).returncode
    except subprocess.TimeoutExpired:
        return HUNG


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--widths", default="16:330:2", help="a:b:step or a,b,c")
    ap.add_argument("--heights", default="64")
    ap.add_argument("--malloc-check", action="store_true")
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--dir", default=None)
    args = ap.parse_args(argv)
    from vidi_tpu_torch.media.video import _load_native, native_frames_safe

    if not _load_native():
        sys.exit("the native library does not load here: nothing to probe")
    sizes = [(w, h) for w in _span(args.widths) for h in _span(args.heights)]
    root = args.dir or tempfile.mkdtemp(prefix="native_probe_")
    os.makedirs(root, exist_ok=True)
    paths = {}
    for w, h in sizes:
        paths[w, h] = os.path.join(root, f"clip_{w}x{h}.mp4")
        write_clip(paths[w, h], w, h)
    jobs = [(w, h, mode) for w, h in sizes for mode in ("load", "stream")]
    with ThreadPoolExecutor(args.workers) as ex:
        rcs = list(ex.map(lambda j: decode_rc(paths[j[0], j[1]], j[2],
                                              args.malloc_check), jobs))
    failed = sorted({(w, h) for (w, h, _), rc in zip(jobs, rcs) if rc != 0})
    for (w, h, mode), rc in zip(jobs, rcs):
        if rc != 0:
            print(f"failed: {w}x{h} {mode} rc={rc}")
    bad_w = {w for w, _ in failed}
    print(f"{len(sizes)} sizes, {len(failed)} failed")
    print("width % 16 of failures:", sorted({w % 16 for w in bad_w}))
    print("width % 16 of passes:", sorted({w % 16 for w, _ in sizes if w not in bad_w}))
    wrong = [(w, h) for w, h in sizes if native_frames_safe(w) and (w, h) in failed]
    print("native_frames_safe allows a failing size:", wrong or "none")


if __name__ == "__main__":
    main()
