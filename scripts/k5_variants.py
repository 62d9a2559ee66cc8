"""Time K5's int8 GEMM designs on one CUDA card: the persistent ping-pong
kernel of vidi_tpu_torch/csrc/int8_gemm_pp.cuh as the sources have it, and
variants made by editing a copy of the sources, each built and run in a
process of its own, at SigLIP-so400m's ([4, 729, 1152], ff 4352) and
Whisper-large-v3's ([1, 1500, 1280], ff 5120) layer shapes.

    python3 scripts/k5_variants.py [variant ...]     (default: all)

For each variant, tower and piece it prints the relative error against the
plain version and the device time a call of each kernel (torch.profiler);
`base` also times each product alone on K6's GEMM (csrc/int8_gemm.cuh).
The variants are the designs PERF.md's PR 8 findings compare:

  act_in_epilogue  fc1's activation in the GEMM epilogue, not in the row
                   pass that requantizes the hidden
  stages4          a ring of four stages (five in bf16)
  stages6          six stages, the output staged 32 columns at a time
  rings            a ring per consumer, each fed by its own producer
                   thread, and no turns between the consumers
  cluster2         clusters of two blocks along M that share each weight
                   tile by TMA multicast

An edit that no longer matches the sources is reported and skipped.
"""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# variant -> [(source file, text, replacement), ...]
VARIANTS = {
    'act_in_epilogue': [
        ('int8_gemm.cuh',
         'enum Epilogue { EPI_SCALE = 0, EPI_BIAS = 1, EPI_BIAS_RES = 2, EPI_GATED = 4 };',
         'enum Epilogue { EPI_SCALE = 0, EPI_BIAS = 1, EPI_BIAS_RES = 2, EPI_BIAS_ACT = 3, EPI_GATED = 4 };'),
        ('int8_gemm.cuh',
         '  } else {  // gated: act(gate) * up, each rounded to T',
         '  } else if constexpr (EPI == EPI_BIAS_ACT) {\n    return activate<T>(round_to<T>(__fadd_rn(y, bias)), act);\n  } else {  // gated: act(gate) * up, each rounded to T'),
        ('int8_gemm_pp.cuh',
         '  static_assert(EPI == EPI_BIAS || EPI == EPI_BIAS_RES,',
         '  static_assert(EPI == EPI_BIAS || EPI == EPI_BIAS_RES || EPI == EPI_BIAS_ACT,'),
        ('fused_tower_layer.cu',
         '  p1.b[0] = w1; p1.sb[0] = s1; p1.bias[0] = b1; p1.out[0] = hidden;\n  err = vidi_int8::gemm_pp<T, vidi_int8::EPI_BIAS>(p1, 1, sms, s);',
         '  p1.b[0] = w1; p1.sb[0] = s1; p1.bias[0] = b1; p1.out[0] = hidden; p1.act = act;\n  err = vidi_int8::gemm_pp<T, vidi_int8::EPI_BIAS_ACT>(p1, 1, sms, s);'),
        ('fused_tower_layer.cu',
         '0.0f, hq, hsx, s, act);',
         '0.0f, hq, hsx, s);'),
    ],
    'stages4': [
        ('int8_gemm_pp.cuh',
         'sizeof(T) == 2 ? 5 : 4',
         '4'),
    ],
    'stages6': [
        ('int8_gemm_pp.cuh',
         'sizeof(T) == 2 ? 5 : 4',
         'sizeof(T) == 2 ? 6 : 5'),
        ('int8_gemm_pp.cuh',
         'constexpr int HALF = 64;',
         'constexpr int HALF = 32;'),
    ],
    'rings': [
        ('int8_gemm_pp.cuh',
         'constexpr int A_STAGE = BM * BK, STAGE_BYTES = A_STAGE + BN * BK;\nconstexpr int HALF = 64;  // output columns staged at a time\nconstexpr int ORDER_BAR = 1;  // named barriers ORDER_BAR + consumer\n',
         'constexpr int A_STAGE = BM * BK, STAGE_BYTES = A_STAGE + BN * BK;\nconstexpr int HALF = 32;  // output columns staged at a time\n'),
        ('int8_gemm_pp.cuh',
         'struct Layout {\n  static constexpr int STAGES = sizeof(T) == 2 ? 5 : 4;\n',
         "struct Layout {\n  static constexpr int STAGES = sizeof(T) == 2 ? 6 : 4;  // half of them each consumer's\n  static constexpr int SPC = STAGES / CONSUMERS;\n"),
        ('int8_gemm_pp.cuh',
         '  using L = Layout<T>;\n  constexpr int STAGES = L::STAGES, RB = L::ROW_BYTES;\n',
         '  using L = Layout<T>;\n  constexpr int STAGES = L::STAGES, SPC = L::SPC, RB = L::ROW_BYTES;\n'),
        ('int8_gemm_pp.cuh',
         '    setmaxnreg_dec<40>();\n    if (tid == 128 * CONSUMERS) {\n',
         '    setmaxnreg_dec<40>();\n    const int pc = (tid - 128 * CONSUMERS) / 32;  // the consumer whose ring this warp fills\n    if (tid % 32 == 0 && pc < CONSUMERS) {\n'),
        ('int8_gemm_pp.cuh',
         '      int g = 0;\n      for (int j = 0; j < count; ++j) {\n',
         '      int g = 0;\n      for (int j = pc; j < count; j += CONSUMERS) {\n'),
        ('int8_gemm_pp.cuh',
         '        for (int it = 0; it < n_it; ++it, ++g) {\n          const int s = g % STAGES;\n',
         '        for (int it = 0; it < n_it; ++it, ++g) {\n          const int s = pc * SPC + g % SPC;\n'),
        ('int8_gemm_pp.cuh',
         '          const uint32_t sa = base + s * STAGE_BYTES;\n          mbar_wait(empty(s), ((g / STAGES) & 1) ^ 1);\n',
         '          const uint32_t sa = base + s * STAGE_BYTES;\n          mbar_wait(empty(s), ((g / SPC) & 1) ^ 1);\n'),
        ('int8_gemm_pp.cuh',
         "    for (int j = wg; j < count; j += CONSUMERS) {\n      if (j > 0) named_sync(ORDER_BAR + wg, 256);  // the other issued tile j - 1's products\n",
         '    for (int j = wg; j < count; j += CONSUMERS) {\n'),
        ('int8_gemm_pp.cuh',
         '      for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0;\n      const int g0 = j * n_it;\n',
         '      for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0;\n      const int g0 = j / CONSUMERS * n_it;\n'),
        ('int8_gemm_pp.cuh',
         '      for (int it = 0; it < n_it; ++it) {\n        const int g = g0 + it, s = g % STAGES;\n',
         '      for (int it = 0; it < n_it; ++it) {\n        const int g = g0 + it, s = wg * SPC + g % SPC;\n'),
        ('int8_gemm_pp.cuh',
         '        const uint32_t sa = base + s * STAGE_BYTES, sb = sa + A_STAGE;\n        mbar_wait(full(s), (g / STAGES) & 1);\n',
         '        const uint32_t sa = base + s * STAGE_BYTES, sb = sa + A_STAGE;\n        mbar_wait(full(s), (g / SPC) & 1);\n'),
        ('int8_gemm_pp.cuh',
         '        fence_regs(acc[1]);\n        if (it > 0 && lane == 0) mbar_arrive(empty((g - 1) % STAGES));\n',
         '        fence_regs(acc[1]);\n        if (it > 0 && lane == 0) mbar_arrive(empty(wg * SPC + (g - 1) % SPC));\n'),
        ('int8_gemm_pp.cuh',
         "      fence_regs(acc[1]);\n      if (lane == 0) mbar_arrive(empty((g0 + n_it - 1) % STAGES));\n      // the other consumer's next tile may start its products\n      if (j + 1 < count) named_arrive(ORDER_BAR + (1 - wg), 256);\n",
         '      fence_regs(acc[1]);\n      if (lane == 0) mbar_arrive(empty(wg * SPC + (g0 + n_it - 1) % SPC));\n'),
    ],
    'cluster2': [
        ('int8_gemm_pp.cuh',
         'constexpr int ORDER_BAR = 1;  // named barriers ORDER_BAR + consumer\n',
         'constexpr int ORDER_BAR = 1;  // named barriers ORDER_BAR + consumer\nconstexpr int CLUSTER = 2;    // blocks of a cluster, along M: they share each B tile\nconstexpr int B_ROWS = BN / CLUSTER;  // B rows each block loads and multicasts\n'),
        ('int8_gemm_pp.cuh',
         '  int tiles_m, tiles_n, total;  // tiles of one product; of the launch\n};\n\n// tile t -> product z and its first row and column\n__device__ __forceinline__ void tile_origin(const PpParams& P, int t, int& z, int& m0, int& n0) {\n  const int per = P.tiles_m * P.tiles_n;\n  z = t / per;\n  const int r = t - z * per;\n  n0 = (r / P.tiles_m) * BN;\n  m0 = (r % P.tiles_m) * BM;\n}',
         '  int tiles_m, tiles_n, total;  // units of one product: row pairs, columns; of the launch\n};\n\n__device__ __forceinline__ void tile_origin(const PpParams& P, int u, int rank, int& z, int& m0,\n                                            int& n0) {\n  const int per = P.tiles_m * P.tiles_n;\n  z = u / per;\n  const int r = u - z * per;\n  n0 = (r / P.tiles_m) * BN;\n  m0 = ((r % P.tiles_m) * CLUSTER + rank) * BM;\n}'),
        ('int8_gemm_pp.cuh',
         "  const int G = gridDim.x, b = blockIdx.x;\n  const int count = (P.total - b + G - 1) / G;  // this block's tiles: b + j G\n",
         '  const int G = gridDim.x / CLUSTER, c = blockIdx.x / CLUSTER, rank = blockIdx.x % CLUSTER;\n  const int count = (P.total - c + G - 1) / G;\n'),
        ('int8_gemm_pp.cuh',
         '      mbar_init(empty(s), 4);  // a lane of each warp of the consumer that read it',
         '      mbar_init(empty(s), 4 * CLUSTER);'),
        ('int8_gemm_pp.cuh',
         '  __syncthreads();\n\n  const int wg = tid / 128;',
         '  cluster_sync();\n\n  const int wg = tid / 128;'),
        ('int8_gemm_pp.cuh',
         '        tile_origin(P, b + j * G, z, m0, n0);\n        for (int it = 0; it < n_it; ++it, ++g) {',
         '        tile_origin(P, c + j * G, rank, z, m0, n0);\n        for (int it = 0; it < n_it; ++it, ++g) {'),
        ('int8_gemm_pp.cuh',
         '          tma_load_2d(sa + A_STAGE, &P.map_b[z], full(s), it * BK, n0);\n        }\n      }\n    }\n  } else {',
         '          tma_load_2d_multicast(sa + A_STAGE + rank * B_ROWS * BK, &P.map_b[z], full(s),\n                                it * BK, n0 + rank * B_ROWS, (1u << CLUSTER) - 1);\n        }\n      }\n    }\n    cluster_sync();\n  } else {'),
        ('int8_gemm_pp.cuh',
         '      int z, m0, n0;\n      tile_origin(P, b + j * G, z, m0, n0);\n#pragma unroll',
         '      int z, m0, n0;\n      tile_origin(P, c + j * G, rank, z, m0, n0);\n#pragma unroll'),
        ('int8_gemm_pp.cuh',
         '        if (it > 0 && lane == 0) mbar_arrive(empty((g - 1) % STAGES));',
         '        if (it > 0 && lane == 0)\n          for (int r = 0; r < CLUSTER; ++r) mbar_arrive_cluster(empty((g - 1) % STAGES), r);'),
        ('int8_gemm_pp.cuh',
         '      if (lane == 0) mbar_arrive(empty((g0 + n_it - 1) % STAGES));',
         '      if (lane == 0)\n        for (int r = 0; r < CLUSTER; ++r) mbar_arrive_cluster(empty((g0 + n_it - 1) % STAGES), r);'),
        ('int8_gemm_pp.cuh',
         '        __syncwarp();  // the staged half is stored before the next overwrites it\n      }\n    }\n  }\n}',
         '        __syncwarp();  // the staged half is stored before the next overwrites it\n      }\n    }\n    cluster_sync();\n  }\n}'),
        ('int8_gemm_pp.cuh',
         '      sms < 1 || !aligned16(g.res))',
         '      sms < pp::CLUSTER || !aligned16(g.res))'),
        ('int8_gemm_pp.cuh',
         '    if (!vidi::sm90::make_map_s8(&P.map_b[i], g.b[i], g.K, g.N, pp::BK, pp::BN))',
         '    if (!vidi::sm90::make_map_s8(&P.map_b[i], g.b[i], g.K, g.N, pp::BK, pp::B_ROWS))'),
        ('int8_gemm_pp.cuh',
         '  P.tiles_m = (g.M + pp::BM - 1) / pp::BM;',
         '  P.tiles_m = ((g.M + pp::BM - 1) / pp::BM + pp::CLUSTER - 1) / pp::CLUSTER;'),
        ('int8_gemm_pp.cuh',
         '  const int grid = P.total < sms ? P.total : sms;\n  pp::int8_gemm_pp_sm90<T, EPI><<<grid, pp::THREADS, pp::Layout<T>::SMEM_BYTES, s>>>(P);\n  return cudaGetLastError();',
         '  const int clusters = P.total < sms / pp::CLUSTER ? P.total : sms / pp::CLUSTER;\n  cudaLaunchConfig_t cfg = {};\n  cfg.gridDim = dim3(clusters * pp::CLUSTER);\n  cfg.blockDim = dim3(pp::THREADS);\n  cfg.dynamicSmemBytes = pp::Layout<T>::SMEM_BYTES;\n  cfg.stream = s;\n  cudaLaunchAttribute attr = {};\n  attr.id = cudaLaunchAttributeClusterDimension;\n  attr.val.clusterDim.x = pp::CLUSTER;\n  attr.val.clusterDim.y = 1;\n  attr.val.clusterDim.z = 1;\n  cfg.attrs = &attr;\n  cfg.numAttrs = 1;\n  return cudaLaunchKernelEx(&cfg, pp::int8_gemm_pp_sm90<T, EPI>, P);'),
    ],
}


def _kernels(fn, reps: int = 10) -> str:
    """Device time a call of each kernel `fn` launches, largest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.self_device_time_total / reps) for e in prof.key_averages()
                   if e.self_device_time_total > 0), key=lambda r: -r[1])
    return " | ".join(f"{re.sub(r'void |vidi_int8::|pp::', '', k)[:44]} {t:.1f} us"
                      for k, t in rows)


def run(tag: str, csrc: Path) -> None:
    """Build the kernels of `csrc` and time K5's pieces (this process)."""
    import torch

    import chip_smoke as c
    from vidi_tpu_torch.ops.cuda import _lib
    from vidi_tpu_torch.ops.cuda import fused_tower_layer as k5
    from vidi_tpu_torch.ops.cuda import quant_matmul as k6

    _lib.CSRC, _lib.BUILD_DIR = csrc, csrc.parent / "build"
    dev = torch.device("cuda", 0)
    _lib.library()
    gen = torch.Generator(device=dev).manual_seed(c.SEED + 5)
    for name, (b, t, d, ff, act, eps, k_bias) in (
            ("siglip", (4, 729, 1152, 4304, "gelu_tanh", 1e-6, True)),
            ("whisper", (1, 1500, 1280, 5120, "gelu", 1e-5, False))):
        lp = c._int8_layer(gen, dev, d, ff, k_bias)
        x, attn = c._rows(gen, (b, t, d), dev), c._rows(gen, (b, t, d), dev)
        for piece, fn, plain in (
                ("ln_qkv", lambda: k5.ln_qkv(x, lp, eps), lambda: k5.ln_qkv_plain(x, lp, eps)),
                ("o_residual", lambda: k5.o_residual(attn, x, lp),
                 lambda: k5.o_residual_plain(attn, x, lp)),
                ("ln_ffn", lambda: k5.ln_ffn(x, lp, eps, act),
                 lambda: k5.ln_ffn_plain(x, lp, eps, act))):
            got, want = c._flat(fn()), c._flat(plain())
            err = float((got - want).norm() / want.norm())
            print(f"[{tag}] {name} {piece}: relative error {err:.3e}; {_kernels(fn)}",
                  flush=True)
        if tag == "base":
            rows = x.reshape(-1, d)
            hidden = c._rows(gen, (rows.shape[0], lp["fc1_w"]["qi8"].shape[1]), dev)
            for key, a in (("q_w", rows), ("fc1_w", rows), ("fc2_w", hidden)):
                w = lp[key]["qi8"].contiguous()  # K6 reads [K, N] through its cache
                print(f"[k6 core] {name} {key} alone: "
                      f"{_kernels(lambda: k6.quant_matmul(a, w, lp[key]['scale']))}",
                      flush=True)
        del lp


def main() -> int:
    from vidi_tpu_torch.ops.cuda import _lib

    if len(sys.argv) > 2 and sys.argv[1] == "--run":
        run(Path(sys.argv[2]).parent.name, Path(sys.argv[2]))
        return 0
    names = sys.argv[1:] or ["base", *VARIANTS]
    work = _lib.BUILD_DIR / "k5_variants"
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
