"""Write vidi_tpu_torch/csrc/wgmma.cuh: the Hopper warpgroup products that
the sm_90a attention kernel and the int8 GEMM core use, one inline-PTX
function per shape.

    python scripts/gen_wgmma.py

A `wgmma.mma_async` names every accumulator register of the warpgroup's
64 x N tile (N / 2 per thread), so each shape is spelled out here instead
of by hand. Overloads are picked by the accumulator array's length:

  wgmma_ss(d[N/2], desc_a, desc_b, scale_d)  A and B in shared memory,
                                             both K-major (S = Q K^T)
  wgmma_rs(d[N/2], a[4], desc_b)             A in registers, B MN-major
                                             (O += P V), accumulating
  wgmma_ss_mn(d[N/2], desc_a, desc_b)        A in shared memory K-major, B
                                             MN-major (dV += P^T dO in the
                                             attention backward), accumulating
  wgmma_s8(d[N/2], desc_a, desc_b, scale_d)  int8 A and B in shared memory,
                                             both K-major, int32 sums, depth
                                             32 (the integer form has no
                                             scale or transpose immediates)
"""
from pathlib import Path

OUT = Path(__file__).resolve().parents[1] / "vidi_tpu_torch" / "csrc" / "wgmma.cuh"
SS_N = (32, 64, 128)       # S tiles: keys (or query rows) per tile
RS_N = (64, 72, 128, 256)  # O tiles: head dims
SSMN_N = (64, 128)         # dK / dV tiles: half a head dim of 128 or 256
S8_N = (128, 256)          # int8 GEMM tiles: output columns per warpgroup product


def _regs(n_acc: int, first: int = 0) -> str:
    return ", ".join(f"%{first + i}" for i in range(n_acc))


def _outs(n_acc: int, kind: str = "f") -> str:
    items = [f'"+{kind}"(d[{i}])' for i in range(n_acc)]
    return ",\n        ".join(", ".join(items[i:i + 8]) for i in range(0, n_acc, 8))


def ss(n: int) -> str:
    a = n // 2
    return f"""
__device__ __forceinline__ void wgmma_ss(float (&d)[{a}], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{a + 2}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
      "{{{_regs(a)}}}, %{a}, %{a + 1}, p, 1, 1, 0, 0;\\n}}\\n"
      : {_outs(a)}
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}}
"""


def rs(n: int) -> str:
    a = n // 2
    return f"""
__device__ __forceinline__ void wgmma_rs(float (&d)[{a}], const uint32_t (&x)[4],
                                         uint64_t desc_b) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{a + 5}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
      "{{{_regs(a)}}}, {{{_regs(4, a)}}}, %{a + 4}, p, 1, 1, 1;\\n}}\\n"
      : {_outs(a)}
      : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "l"(desc_b), "r"(1));
}}
"""


def ss_mn(n: int) -> str:
    a = n // 2
    return f"""
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[{a}], uint64_t desc_a,
                                            uint64_t desc_b) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{a + 2}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
      "{{{_regs(a)}}}, %{a}, %{a + 1}, p, 1, 1, 0, 1;\\n}}\\n"
      : {_outs(a)}
      : "l"(desc_a), "l"(desc_b), "r"(1));
}}
"""


def s8(n: int) -> str:
    a = n // 2
    return f"""
__device__ __forceinline__ void wgmma_s8(int32_t (&d)[{a}], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{a + 2}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k32.s32.s8.s8 "
      "{{{_regs(a)}}}, %{a}, %{a + 1}, p;\\n}}\\n"
      : {_outs(a, "r")}
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}}
"""


def render() -> str:
    body = ("".join(ss(n) for n in SS_N) + "".join(rs(n) for n in RS_N)
            + "".join(ss_mn(n) for n in SSMN_N) + "".join(s8(n) for n in S8_N))
    return f"""// Generated by scripts/gen_wgmma.py; edit that script, not this file.
//
// Hopper warpgroup products (wgmma.mma_async, sm_90a), bf16 in, fp32
// accumulate, 64 x N tiles. wgmma_ss: A and B from shared memory, both
// K-major; scale_d = 0 overwrites the accumulator. wgmma_rs: A from
// registers (the m16n8k16 A-fragment layout per warp), B MN-major
// (imm-trans-b = 1), accumulating. wgmma_ss_mn: A from shared memory
// K-major, B MN-major, accumulating. wgmma_s8: int8 A and B from shared
// memory, both K-major, int32 accumulate, depth 32. The caller fences
// (wgmma.fence), commits and waits.
#pragma once

#include <cstdint>

namespace vidi {{
{body}
}}  // namespace vidi
"""


def main() -> None:
    OUT.write_text(render())


if __name__ == "__main__":
    main()
