"""Compare K3 (decode attention) of two checkouts on one CUDA card, in turns.

    python3 vidi_tpu_torch/tools/k3_turns.py TREE [TREE ...]

Each TREE is the root of a checkout of this repository (for example the
parent commit unpacked with `git archive` into a directory that .gitignore
lists, then this one): each runs in a process of its own, in the order
given (parent, this, this, parent compares two versions in turns), with its
own `vidi_tpu_torch` and `chip_smoke.py`, building its own kernels. A turn
prints, for the decode caches of Vidi1.5-9B as the serving slice gives them
(every image and audio key visible; the text cache of a 128-token prompt
with 32 decode slots, window 4096) and the 1.5B's image cache, the device
time of one K3 call (torch.profiler, all kernels of the call) and the time
of 20 calls back to back (CUDA events); then it loads the 9B slice (random
weights), encodes the clip, prefills one query and profiles 8 decode steps
on the K3 route and on the plain route, as `chip_smoke.py --profile` does
(wall, device time, idle share, K3's kernels and their count).
"""
import os
import subprocess
import sys
from pathlib import Path


def turn(tree: Path) -> None:
    """One turn: the K3 cases and the decode profile of the checkout `tree`."""
    sys.path.insert(0, str(tree))
    os.chdir(tree)
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as c
    from vidi_tpu_torch.models import decoder
    from vidi_tpu_torch.ops.cuda import _lib
    from vidi_tpu_torch.ops.cuda import decode_attention as k3

    dev = torch.device("cuda", 0)
    _lib.library()
    tag = tree.name
    gen = torch.Generator(device=dev).manual_seed(c.SEED + 3)
    n_real, t = c._prompt_lengths()
    for label, hq, hk, d, s, n_valid, window, q_pos in (
            (f"9b image S={c.IMG_S} all visible", 16, 8, 256, c.IMG_S, c.IMG_S, None, None),
            (f"9b audio S={c.AUD_S} all visible", 16, 8, 256, c.AUD_S, c.AUD_S, None, None),
            (f"9b text S={t + 32} window=4096", 16, 8, 256, t + 32, n_real + 6, 4096,
             n_real + 5),
            (f"1.5b image S={c.IMG_S} all visible", 12, 6, 128, c.IMG_S, c.IMG_S, None, None)):
        cache = c._randn(gen, (2, 2, 1, hk, s, d), dev)
        args = dict(q=c._randn(gen, (1, hq, d), dev, c.Q_GAIN), k=cache[0, 1], v=cache[1, 1],
                    kv_mask=c._kv_mask(s, n_valid, dev), sm_scale=d**-0.5, softcap=50.0,
                    window=window, q_pos=None if q_pos is None else
                    torch.tensor([q_pos], dtype=torch.int64, device=dev))
        run = lambda: k3.decode_attention(**args)  # noqa: E731
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                run()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        device_us = sum(e.self_device_time_total for e in kernels) / 10
        print(f"[{tag}] K3 {label}: device {device_us:.1f} us a call in "
              f"{sum(e.count for e in kernels) / 10:.0f} kernels, events "
              f"{1e3 * c._time_ms(run):.1f} us", flush=True)
        del cache

    sl = c.load_slice(dev)
    sl.media = c._encode(sl)
    _, caches, lens, emb = c._prefill(sl, c.QUERIES[0])
    for flash in (True, False):
        def steps():
            cur, e = lens.clone(), emb
            for _ in range(c.PROFILE_DECODE_STEPS):
                logits = c._decode_step(sl, e, cur, caches, flash)
                e = decoder.embed_tokens(sl.params["text"], logits.argmax(-1)[:, None],
                                         sl.cfg.text)
                cur = cur + 1
            return logits
        print(f"[{tag}] decode {'K3' if flash else 'plain'} route:", flush=True)
        c._region(f"decode {'K3' if flash else 'plain'} route x{c.PROFILE_DECODE_STEPS}",
                  steps)
    sys.stdout.flush()


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--turn":
        turn(Path(sys.argv[2]).resolve())
        return 0
    for tree in sys.argv[1:]:
        res = subprocess.run([sys.executable, __file__, "--turn", tree], text=True,
                             capture_output=True, timeout=900)
        print(res.stdout.strip(), flush=True)
        if res.returncode:
            print(f"[{tree}] failed:\n{res.stderr[-3000:]}", flush=True)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
