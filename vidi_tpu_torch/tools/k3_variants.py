"""Time K3's bf16 decode-attention designs on one CUDA card: the kernel of
vidi_tpu_torch/csrc/decode_attention_sm90.cuh as the sources have it, and
variants made by editing a copy of the sources (and, where the split plan
changes, the wrapper's constants), each built and run in a process of its
own, at the decode caches of Vidi1.5-9B and of the 1.5B configuration.

    python3 vidi_tpu_torch/tools/k3_variants.py [variant ...]     (default: all)
    python3 vidi_tpu_torch/tools/k3_variants.py --splits          (split counts, short caches)

For each variant and case it prints the largest error against the plain
version in bf16 ulps of max|plain|, whether two runs are bit-equal, the
device time a call (torch.profiler) and the time of 20 calls back to back
(CUDA events). The variants:

  contiguous             each split one contiguous chunk of whole tiles (the
                         sources: the splits take the tiles in turn, so a
                         masked tail or the keys before a window spread over
                         every split instead of idling whole ones)
  consumers8             eight consumer warps a block (half the keys a warp
                         a tile)
  stages4                a ring of four stages and one block an SM
  nocompute              a probe: the consumers wait for each tile and
                         release it without computing (wrong outputs; the
                         time of the copies alone)
  empty                  a probe: the kernel returns at once (the floor of
                         a launch as the profiler times it)
  prefetch               the producer also prefetches into L2 the tile
                         kStages ahead of the one it copies
  release_early          each warp's rows loaded into registers and the
                         stage handed back before the tile's arithmetic
  tile64                 64 keys a stage at D = 256 too (64 KB stages), one
                         block an SM, a split count that fits one wave
  blocks3                two stages a block, three blocks an SM
  library_math           the CUDA library's tanhf and expf for the softcap
                         and the softmax (the sources: one exp2 and a fast
                         reciprocal for the cap, exp2 with log2(e) folded)
  timeline               a probe: the SM clock at each phase of the block
                         that merges head 0, printed for its first calls
  timeline_merge         a probe: the SM clock at each step of the merge
                         (the staging issued, the row maxima, the staged
                         partials, the merged output), printed likewise
  fenced_count           the merge count as a fence, an atomic add and a
                         fence (the sources: one acquire-release atomic)
  stages2                a ring of two stages
  tile16                 16 keys a stage at D = 256, six stages (the same
                         bytes in flight, more stages; D = 128 keeps 64 keys
                         and gets six stages, one block an SM)
  no_evict_hint          the bulk copies without the L2 evict-first hint
  first_copy_early       the first tile copied at once, before its mask is
                         read (and waited for, unread, where it is hidden)

An edit that no longer matches the sources is reported and skipped.
"""
import math
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

HDR = "decode_attention_sm90.cuh"
# variant -> [(source file, text, replacement), ...]
VARIANTS = {
    "contiguous": [
        (HDR,
         "  const int n_tiles = ((p.S + C::kTile - 1) / C::kTile - split + p.n_split - 1) / p.n_split;\n"
         "  auto key0 = [&](int t) { return (split + t * p.n_split) * C::kTile; };",
         "  const int n_tiles = (min(p.S - split * p.chunk, p.chunk) + C::kTile - 1) / C::kTile;\n"
         "  auto key0 = [&](int t) { return split * p.chunk + t * C::kTile; };"),
    ],
    "consumers8": [
        (HDR, "constexpr int kConsumers = 4;", "constexpr int kConsumers = 8;"),
    ],
    "stages4": [
        (HDR, "constexpr int kStages = 3;", "constexpr int kStages = 4;"),
        (HDR, "__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 1)"),
    ],
    "nocompute": [  # a probe, not a design: the consumers only wait and release
        (HDR, "      float part[C::kNV];\n",
         "      if (nk > -1000000) {\n        __syncwarp();\n"
         "        if (lane == 0) mbar_arrive(smem_u32(&empty[s]));\n        continue;\n      }\n"
         "      float part[C::kNV];\n"),
    ],
    "empty": [  # a probe: the kernel returns at once (launch and timing floor)
        (HDR, "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n",
         "  if (p.S > 0) return;\n  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"),
    ],
    "prefetch": [
        (HDR,
         "      const int s = it % kStages;\n      if (lane == 0) {\n"
         "        mbar_wait(smem_u32(&empty[s]), ((it / kStages) & 1) ^ 1);\n        issue(t, s);\n",
         "      const int s = it % kStages;\n"
         "      const bool pf = t + kStages < n_tiles && visible(t + kStages);\n"
         "      if (lane == 0) {\n"
         "        mbar_wait(smem_u32(&empty[s]), ((it / kStages) & 1) ^ 1);\n        issue(t, s);\n"
         "        if (pf) {\n"
         "          const long long o = (long long)key0(t + kStages) * D;\n"
         "          asm volatile(\"cp.async.bulk.prefetch.L2.global [%0], %1;\\n\" :: \"l\"(kb + o),"
         " \"r\"(tile_bytes(t + kStages)) : \"memory\");\n"
         "          asm volatile(\"cp.async.bulk.prefetch.L2.global [%0], %1;\\n\" :: \"l\"(vb + o),"
         " \"r\"(tile_bytes(t + kStages)) : \"memory\");\n"
         "        }\n"),
    ],
    "release_early": [  # each warp's rows into registers, the stage back before the arithmetic
        (HDR, "      using Bits = RowBits<C::kEPL>;\n\n",
         "      using Bits = RowBits<C::kEPL>;\n      Bits kb_[C::kKPW], vb_[C::kKPW];\n"
         "#pragma unroll\n      for (int j = 0; j < C::kKPW; ++j) {\n        if (j < nk) {\n"
         "          kb_[j] = *reinterpret_cast<const Bits*>(sk + (row0 + j) * D + lane * C::kEPL);\n"
         "          vb_[j] = *reinterpret_cast<const Bits*>(sv + (row0 + j) * D + lane * C::kEPL);\n"
         "        }\n      }\n      __syncwarp();\n      if (lane == 0) mbar_arrive(smem_u32(&empty[s]));\n\n"),
        (HDR, "reinterpret_cast<const Bits*>(sk + (row0 + j) * D + lane * C::kEPL)->unpack(kk);",
         "kb_[j].unpack(kk);"),
        (HDR, "reinterpret_cast<const Bits*>(sv + (row0 + j) * D + lane * C::kEPL)->unpack(vv);",
         "vb_[j].unpack(vv);"),
        (HDR, "      __syncwarp();  // every lane is done with the stage and with sP\n"
              "      if (lane == 0) mbar_arrive(smem_u32(&empty[s]));\n",
         "      __syncwarp();\n"),
    ],
    "tile64": [  # 64 keys a stage at D = 256 too, three stages, one block an SM
        (HDR, "static constexpr int kTile = D == 256 ? 32 : 64;", "static constexpr int kTile = 64;"),
        (HDR, "__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 1)"),
    ],
    "blocks3": [  # two stages, three blocks an SM
        (HDR, "constexpr int kStages = 3;", "constexpr int kStages = 2;"),
        (HDR, "__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 3)"),
    ],
    "library_math": [  # tanhf and expf of the CUDA library on the per-tile path
        (HDR, "if (p.softcap > 0.f) sc = softcap(sc, p.softcap);",
         "if (p.softcap > 0.f) sc = tanhf(sc / p.softcap) * p.softcap;"),
        (HDR, "alpha[g] = exp2f((m[g] - m_new[g]) * kLog2e);", "alpha[g] = expf(m[g] - m_new[g]);"),
        (HDR, "exp2f((sc - (my_g ? m_new[1] : m_new[0])) * kLog2e)",
         "expf(sc - (my_g ? m_new[1] : m_new[0]))"),
    ],
    "timeline": [  # a probe: SM clock at each phase of the merging block of head 0, printed
        (HDR, "#include <limits.h>\n", "#include <limits.h>\n#include <stdio.h>\n"),
        (HDR, "  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;\n",
         "  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;\n"
         "  __shared__ long long tl[6];\n  if (threadIdx.x == 0) tl[0] = clock64();\n"),
        (HDR, "      : 0;\n  __syncthreads();\n",
         "      : 0;\n  __syncthreads();\n  if (threadIdx.x == 0) tl[1] = clock64();\n"
         "  if (threadIdx.x == 0) tl[2] = 0;\n"),
        (HDR, "      mbar_wait(smem_u32(&full[s]), phase);\n",
         "      mbar_wait(smem_u32(&full[s]), phase);\n"
         "      if (threadIdx.x == 0 && tl[2] == 0) tl[2] = clock64();\n"),
        (HDR, "  __syncthreads();  // every tile consumed: the ring is free\n",
         "  __syncthreads();  // every tile consumed: the ring is free\n"
         "  if (threadIdx.x == 0) tl[3] = clock64();\n"),
        (HDR, "  if (!sLast) return;\n",
         "  if (!sLast) return;\n  if (threadIdx.x == 0) tl[4] = clock64();\n"),
        (HDR, "  if (tid == 0) p.counters[head] = 0;",
         "  __syncthreads();\n  if (tid == 0 && b == 0 && hk == 0) {\n"
         "    static __device__ int shown = 0;\n    if (atomicAdd(&shown, 1) < 6)\n"
         "      printf(\"timeline S=%d n_split=%d split=%d: prologue %lld, first tile %lld, "
         "tiles done %lld, partial+count %lld, merge %lld cycles\\n\", p.S, p.n_split, split,"
         " tl[1] - tl[0], tl[2] - tl[1], tl[3] - tl[1], tl[4] - tl[3], clock64() - tl[4]);\n"
         "  }\n  if (tid == 0) p.counters[head] = 0;"),
    ],
    "timeline_merge": [  # a probe: the SM clock at each step of the merge, head 0, printed
        (HDR, "#include <limits.h>\n", "#include <limits.h>\n#include <stdio.h>\n"),
        (HDR, "  if (!sLast) return;\n",
         "  if (!sLast) return;\n  __shared__ long long tm[6];\n"
         "  if (threadIdx.x == 0) tm[0] = clock64();\n"),
        (HDR, "  int ns = stage(0);\n", "  int ns = stage(0);\n  if (threadIdx.x == 0) tm[1] = clock64();\n"),
        (HDR, "    if (lane == 0) sMx[warp] = mx;\n  }\n",
         "    if (lane == 0) sMx[warp] = mx;\n  }\n  if (threadIdx.x == 0) tm[2] = clock64();\n"),
        (HDR, "    mbar_wait(smem_u32(&staged), (s0 / kGroup) & 1);\n    __syncthreads();\n",
         "    mbar_wait(smem_u32(&staged), (s0 / kGroup) & 1);\n"
         "    if (threadIdx.x == 0) tm[3] = clock64();\n    __syncthreads();\n"),
        (HDR, "  if (tid < kG * D / 4) {\n    const float ls = sLs[g];",
         "  if (threadIdx.x == 0 && b == 0 && hk == 0) {\n"
         "    static __device__ int shown = 0;\n    if (atomicAdd(&shown, 1) < 6)\n"
         "      printf(\"merge S=%d n_split=%d: stage issued %lld, max %lld, staged %lld, "
         "merged %lld cycles\\n\", p.S, p.n_split, tm[1] - tm[0], tm[2] - tm[1], "
         "tm[3] - tm[2], clock64() - tm[3]);\n  }\n"
         "  if (tid < kG * D / 4) {\n    const float ls = sLs[g];"),
    ],
    "fenced_count": [  # the count as a fence, an atomic add and a fence
        (HDR, "    unsigned prev;\n"
              "    asm volatile(\"atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\\n\"\n"
              "                 : \"=r\"(prev) : \"l\"(p.counters + head) : \"memory\");\n"
              "    sLast = prev == (unsigned)(p.n_split - 1);\n",
         "    __threadfence();\n"
         "    sLast = atomicAdd(p.counters + head, 1u) == (unsigned)(p.n_split - 1);\n"
         "    __threadfence();\n"),
    ],
    "stages2": [
        (HDR, "constexpr int kStages = 3;", "constexpr int kStages = 2;"),
    ],
    "tile16": [
        (HDR, "static constexpr int kTile = D == 256 ? 32 : 64;",
         "static constexpr int kTile = D == 256 ? 16 : 64;"),
        (HDR, "constexpr int kStages = 3;", "constexpr int kStages = 6;"),
    ],
    "no_evict_hint": [
        (HDR,
         '      "{\\n.reg .b64 pol;\\ncreatepolicy.fractional.L2::evict_first.b64 pol, 1.0;\\n"\n'
         '      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"\n'
         '      " [%0], [%1], %2, [%3], pol;\\n}\\n"\n',
         '      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"\n'
         '      " [%0], [%1], %2, [%3];\\n"\n'),
    ],
    "first_copy_early": [
        (HDR,
         '      mbar_init(smem_u32(&empty[s]), kConsumers);\n    }\n'
         '    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");\n  }',
         '      mbar_init(smem_u32(&empty[s]), kConsumers);\n    }\n'
         '    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");\n'
         '    issue(0, 0);\n  }'),
        (HDR, "    for (int t = 0, it = 0; t < n_tiles; ++t) {\n      if (!visible(t)) continue;\n"
              "      const int s = it % kStages;\n      if (lane == 0) {",
         "    for (int t = 1, it = 1; t < n_tiles; ++t) {\n      if (!visible(t)) continue;\n"
         "      const int s = it % kStages;\n      if (lane == 0) {"),
        (HDR, "      if (!visible(t)) continue;\n      const int s = it % kStages, phase",
         "      const bool seen = visible(t);\n      if (!seen && t > 0) continue;\n"
         "      const int s = it % kStages, phase"),
        (HDR, "      mbar_wait(smem_u32(&full[s]), phase);\n",
         "      mbar_wait(smem_u32(&full[s]), phase);\n      if (!seen) {\n"
         "        if (lane == 0) mbar_arrive(smem_u32(&empty[s]));\n        continue;\n      }\n"),
    ],
}


def _contiguous_plan(b, hk, s, d, sms, *, g):
    """(tile, chunk, n_split) with each split one contiguous chunk of whole
    tiles: as many as give up to one wave of two blocks an SM."""
    from vidi_tpu_torch.ops.cuda import decode_attention as k3

    tile = k3.sm90_tile(d, g)
    n = min(-(-2 * sms // (b * hk)), -(-s // tile))
    n = max(1, n, -(-s // k3.SM90_MAX_CHUNK))
    chunk = -(-(-(-s // n)) // tile) * tile
    return tile, chunk, -(-s // chunk)


def _python_side(name: str) -> None:
    """The wrapper's constants a variant's kernel needs."""
    from vidi_tpu_torch.ops.cuda import decode_attention as k3

    if name == "contiguous":
        k3.decode_plan = _contiguous_plan
    if name in ("tile64", "blocks3"):
        per_sm = 1 if name == "tile64" else 3
        if name == "tile64":
            k3.SM90_TILE = {128: 64, 256: 64}

        def plan(b, hk, s, d, sms, *, g):
            tile = k3.sm90_tile(d, g)
            tiles = -(-s // tile)
            n = max(1, min(per_sm * sms // (b * hk), tiles))
            return tile, -(-tiles // n) * tile, n
        k3.decode_plan = plan
    if name == "tile16":
        k3.SM90_TILE = {128: 64, 256: 16}
        k3.decode_plan.cache_clear()
    if name == "stages4":
        k3.SM90_BLOCKS_PER_SM = 1
        k3.decode_plan.cache_clear()


def _device_us(fn, reps: int = 10) -> float:
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type.name == "CUDA") / reps


def run(tag: str, csrc: Path) -> None:
    """Build the kernels of `csrc` and time K3's cases (this process)."""
    import torch

    import chip_smoke as c
    from vidi_tpu_torch.ops.cuda import _lib
    from vidi_tpu_torch.ops.cuda import decode_attention as k3

    _lib.CSRC, _lib.BUILD_DIR = csrc, csrc.parent / "build"
    _python_side(tag)
    dev = torch.device("cuda", 0)
    _lib.library()
    sms = _lib.sm_count(dev)
    gen = torch.Generator(device=dev).manual_seed(c.SEED + 3)
    n_real, t = c._prompt_lengths()
    for label, hq, hk, d, s, n_valid, window, q_pos in (
            ("9b image global", 16, 8, 256, c.IMG_S, c.IMG_VALID, None, None),
            ("9b image window=4096", 16, 8, 256, c.IMG_S, c.IMG_S - 301, 4096, c.IMG_S - 302),
            ("9b audio global", 16, 8, 256, c.AUD_S, c.AUD_VALID, None, None),
            (f"9b text S={t + 32}", 16, 8, 256, t + 32, n_real + 6, 4096, n_real + 5),
            ("1.5b image global", 12, 6, 128, c.IMG_S, c.IMG_VALID, None, None)):
        cache = c._randn(gen, (2, 2, 1, hk, s, d), dev)
        args = dict(q=c._randn(gen, (1, hq, d), dev, c.Q_GAIN), k=cache[0, 1], v=cache[1, 1],
                    kv_mask=c._kv_mask(s, n_valid, dev), sm_scale=d**-0.5, softcap=50.0,
                    window=window,
                    q_pos=None if q_pos is None else torch.tensor([q_pos], device=dev))
        run_k3 = lambda: k3.decode_attention(**args)  # noqa: E731
        out, again = run_k3(), run_k3()
        ref = k3.decode_attention_plain(**args)
        torch.cuda.synchronize()
        top = float(ref.float().abs().max())
        ulps = float((out.float() - ref.float()).abs().max()) / 2.0 ** (math.floor(math.log2(top)) - 7)
        plan = k3.decode_plan(1, hk, s, d, sms, g=hq // hk)
        print(f"[{tag}] {label}: plan {plan}, err {ulps:.1f} ulps, "
              f"two runs {'bit-equal' if torch.equal(out, again) else 'DIFFER'}, device "
              f"{_device_us(run_k3):.1f} us a call, events {1e3 * c._time_ms(run_k3):.1f} us",
              flush=True)
        del cache


def splits() -> None:
    """The sources' kernel at the short caches (9B audio and text, the 1.5B
    audio) and at the 9B image cache with every key visible, with the split
    count forced to each of a few values: where the merge across splits
    costs more than the tiles it spreads."""
    import torch

    import chip_smoke as c
    from vidi_tpu_torch.ops.cuda import decode_attention as k3

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(c.SEED + 3)
    n_real, t = c._prompt_lengths()
    for label, hq, hk, d, s, n_valid, window, q_pos, counts in (
            ("9b audio global", 16, 8, 256, c.AUD_S, c.AUD_VALID, None, None,
             (33, 19, 13, 10, 7, 5)),
            (f"9b text S={t + 32}", 16, 8, 256, t + 32, n_real + 6, 4096, n_real + 5,
             (5, 3, 2, 1)),
            ("1.5b audio global", 12, 6, 128, c.AUD_S, c.AUD_VALID, None, None,
             (19, 10, 5, 3)),
            ("9b image, every key visible (as in the slice)", 16, 8, 256, c.IMG_S, c.IMG_S,
             None, None, (33, 24, 17))):
        cache = c._randn(gen, (2, 2, 1, hk, s, d), dev)
        args = dict(q=c._randn(gen, (1, hq, d), dev, c.Q_GAIN), k=cache[0, 1], v=cache[1, 1],
                    kv_mask=c._kv_mask(s, n_valid, dev), sm_scale=d**-0.5, softcap=50.0,
                    window=window,
                    q_pos=None if q_pos is None else torch.tensor([q_pos], device=dev))
        ref = k3.decode_attention_plain(**args)
        tile = k3.sm90_tile(d, hq // hk)
        tiles = -(-s // tile)
        for n in counts:
            plan = (tile, -(-tiles // n) * tile, n)
            k3.decode_plan = lambda *a, plan=plan, **kw: plan  # noqa: E731
            k3._LAYOUTS.clear()  # the wrapper keeps the plan of a checked layout
            run_k3 = lambda: k3.decode_attention(**args)  # noqa: E731
            err = float((run_k3().float() - ref.float()).abs().max())
            print(f"[splits] {label}: plan {plan}, max_abs_err {err:.3e}, device "
                  f"{_device_us(run_k3):.1f} us a call", flush=True)


def main() -> int:
    from vidi_tpu_torch.ops.cuda import _lib

    if len(sys.argv) > 1 and sys.argv[1] == "--splits":
        splits()
        return 0
    if len(sys.argv) > 2 and sys.argv[1] == "--run":
        run(Path(sys.argv[2]).parent.name, Path(sys.argv[2]))
        return 0
    names = sys.argv[1:] or ["base", *VARIANTS]
    work = _lib.BUILD_DIR / "k3_variants"
    for name in names:
        csrc = work / name / "csrc"
        shutil.rmtree(csrc.parent, ignore_errors=True)
        shutil.copytree(_lib.CSRC, csrc)
        edits = VARIANTS.get(name, [])
        texts = {f: (csrc / f).read_text() for f, _, _ in edits}
        if any(texts[f].count(old) != 1 for f, old, _ in edits):
            print(f"[{name}] an edit no longer matches the sources: skipped", flush=True)
            continue
        for f, old, new in edits:
            texts[f] = texts[f].replace(old, new)
        for f, text in texts.items():
            (csrc / f).write_text(text)
        res = subprocess.run([sys.executable, __file__, "--run", str(csrc)], text=True,
                             capture_output=True, timeout=600)
        print(res.stdout.strip(), flush=True)
        if res.returncode:
            print(f"[{name}] failed:\n{res.stderr[-3000:]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
