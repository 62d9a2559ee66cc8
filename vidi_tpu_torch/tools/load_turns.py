"""Time a load of Vidi1.5-9B from a checkpoint on one CUDA card with the
port's reader and with its first design, in turns.

    python3 vidi_tpu_torch/tools/load_turns.py [ORDER]

Run from the root of a checkout. It writes the 9B (random weights from
seed 0, full width and depth, bf16) with `save_pretrained` to a temporary
directory (~21 GB of disk, removed at the end), then loads it back with
`load_model(model_path=...)` once for each letter of ORDER (default
ABBAAB): A is the reader as it stands (`safetensors_io.Index.load`,
STAGE_BYTES at a time through a buffer registered with CUDA for one
load), B the first design (each tensor whole through one pinned block of
torch's caching host allocator, grown to the largest tensor and kept for
the life of the process). Each load prints its seconds and the process's
host VmRSS before, at its sampled peak and after.
"""
import os
import shutil
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as c  # noqa: E402
from vidi_tpu_torch.infer import export as E  # noqa: E402
from vidi_tpu_torch.infer import loader as L  # noqa: E402
from vidi_tpu_torch.infer import safetensors_io as sio  # noqa: E402

_BLOCK = {}


def first_design_load(self, name, device):
    """Index.load as first written: the whole tensor through one cached
    pinned block, then one copy to the device."""
    ref = self.refs[name]
    block = _BLOCK.get("b")
    if block is None or block.numel() < ref.nbytes:
        _BLOCK["b"] = block = torch.empty(ref.nbytes, dtype=torch.uint8, pin_memory=True)
    raw = block[:ref.nbytes]
    with open(ref.path, "rb") as f:
        f.seek(ref.offset)
        if f.readinto(memoryview(raw.numpy())) != ref.nbytes:
            raise ValueError(f"{ref.path}: short read of {name}")
    return raw.to(device).view(ref.dtype).reshape(ref.shape)


def main(order: str) -> None:
    readers = {"A": sio.Index.load, "B": first_design_load}
    dev = torch.device("cuda", 0)
    print(f"card: {c._card()}", flush=True)
    params, cfg, _ = L.load_model(random_weights="9b", device=dev, seed=0)
    tmp = tempfile.mkdtemp(prefix="load_turns_")
    try:
        with c._HostPeak() as host:
            t0 = time.perf_counter()
            E.save_pretrained(params, cfg, tmp)
            write_s = time.perf_counter() - t0
        print(f"write: {write_s:.3f} s; {host}", flush=True)
        del params
        torch.cuda.empty_cache()
        for letter in order:
            sio.Index.load = readers[letter]
            torch.cuda.synchronize()
            with c._HostPeak() as host:
                t0 = time.perf_counter()
                loaded = L.load_model(model_path=tmp, device=dev)[0]
                torch.cuda.synchronize()
                load_s = time.perf_counter() - t0
            print(f"load {letter}: {load_s:.3f} s; {host}", flush=True)
            del loaded
            torch.cuda.empty_cache()
    finally:
        sio.Index.load = readers["A"]
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "ABBAAB")
