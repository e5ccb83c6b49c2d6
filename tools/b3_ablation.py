"""Ablation of the cp.async bf16 flash-attention kernel (B3) on the card.

Run from the repository root on a machine with one NVIDIA card:

    python3 tools/b3_ablation.py SOURCE [OUT_DIR]

SOURCE is ``src/repro_torch/csrc/flash_attention.cu`` as it stood before
the TMA design replaced it: its last version with ``cp.async`` staging and
``__syncthreads`` in the tile loop, taken from the history (``git log --
src/repro_torch/csrc/flash_attention.cu``, then ``git show
<commit>:src/repro_torch/csrc/flash_attention.cu``).  The patches below
match that text exactly and raise on any other, so the script measures
that kernel and nothing else; the current source is not its input.  The
script writes four copies of it to OUT_DIR (default
``build/b3_ablation``), each changed in one way, builds them with the
project's ``nvcc`` flags, holds each against the plain version
(``kernels/flash_attention/ref.py``) at ``chip_smoke.B3_TOL``, and times
each at moonshot's largest call, (B, Hq, Hkv, S, D) = (8, 16, 16, 2048,
128) causal bf16 on strided (B, S, H, D) views, by CUDA events over 20
calls, in two turns (a b c d, then d c b a):

a. the kernel as it is;
b. P V with P_hi only (the split's second product dropped; its numbers
   are wrong, only its time counts);
c. each warpgroup stages its own 64 Q rows and its own K / V ring with
   its 128 threads, and a ``bar.sync`` of its 128 threads replaces both
   ``__syncthreads`` of the tile loop (D = 128 only);
d. 128-key K / V tiles: S = Q K^T as m64n128k16 and eight k-steps of P V.

It prints the card's name and power limit, each variant's registers and
spills, and a JSON line of the results.  The numbers stand beside the
redesign in PERF.md §6.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import ref  # noqa: E402


def sub(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise ValueError(f"expected one {old[:60]!r} in the source")
    return text.replace(old, new)


def wgmma_ss_n128() -> str:
    """wgmma m64n128k16 with both operands in shared memory (variant d)."""
    regs = ", ".join(f"%{i}" for i in range(64))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(64))
    return (
        "__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], "
        "uint64_t a, uint64_t b, int scale_d) {\n"
        '  asm volatile("{\\n.reg .pred p;\\nsetp.ne.b32 p, %66, 0;\\n"\n'
        '      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"\n'
        f'      "{regs}"\n'
        '      "}, %64, %65, p, 1, 1, 0, 0;\\n}\\n"\n'
        f"      : {outs}\n"
        '      : "l"(a), "l"(b), "r"(scale_d));\n}\n\n')


def variants(src: str) -> dict:
    out = {"a_as_is": src,
           "b_no_split": sub(src, "        wgmma_rs<DP>(acc, p_lo + 4 * kk, "
                                  "vd);\n", "")}
    c = sub(src, """template <int R, int DP>
__device__ __forceinline__ void stage(uint32_t dst, const bf16* g,
                                      long long ld, int row0, int limit,
                                      int d) {
  constexpr int kChunks = DP / 8;  // 16-byte chunks a row
  constexpr int kStep = kThreads / kChunks;
  static_assert(kStep % 8 == 0 && R % kStep == 0, "whole rounds of rows");
  const int c = threadIdx.x % kChunks, r = threadIdx.x / kChunks;
  dst += swizzled(R, r, c);""", """template <int R, int DP, int RB = R, int NT = kThreads>
__device__ __forceinline__ void stage(uint32_t dst, const bf16* g,
                                      long long ld, int row0, int limit,
                                      int d) {
  constexpr int kChunks = DP / 8;  // 16-byte chunks a row
  constexpr int kStep = NT / kChunks;
  static_assert(kStep % 8 == 0 && R % kStep == 0, "whole rounds of rows");
  const int c = threadIdx.x % NT % kChunks, r = threadIdx.x % NT / kChunks;
  dst += swizzled(RB, r, c);""")
    c = sub(c, """  const uint32_t k_s = q_s + kRows * DP * 2;   // [kStages] K tiles
  const uint32_t v_s = k_s + kStages * kTile;  // [kStages] V tiles

  const int wg = threadIdx.x / 128;  // warpgroup""", """  const int wg = threadIdx.x / 128;  // warpgroup
  const uint32_t k_s = q_s + kRows * DP * 2 + wg * 2 * kStages * kTile;
  const uint32_t v_s = k_s + kStages * kTile;  // [kStages] V tiles""")
    c = sub(c, """  stage<kRows, DP>(q_s, qp, qs.s, q0, s_q, d);
  if (n_tiles > 0) {
    stage<kKeys, DP>(k_s, kp, ks.s, k_lo, s_kv, d);
    stage<kKeys, DP>(v_s, vp, vs.s, k_lo, s_kv, d);
  }""", """  stage<64, DP, kRows, 128>(q_s + wg * 64 * 128, qp, qs.s, q0 + 64 * wg,
                            s_q, d);
  if (n_tiles > 0) {
    stage<kKeys, DP, kKeys, 128>(k_s, kp, ks.s, k_lo, s_kv, d);
    stage<kKeys, DP, kKeys, 128>(v_s, vp, vs.s, k_lo, s_kv, d);
  }""")
    c = sub(c, """      stage<kKeys, DP>(k_s + next, kp, ks.s, k0 + kKeys, s_kv, d);
      stage<kKeys, DP>(v_s + next, vp, vs.s, k0 + kKeys, s_kv, d);""",
            """      stage<kKeys, DP, kKeys, 128>(k_s + next, kp, ks.s, k0 + kKeys,
                                   s_kv, d);
      stage<kKeys, DP, kKeys, 128>(v_s + next, vp, vs.s, k0 + kKeys,
                                   s_kv, d);""")
    bar = '    asm volatile("bar.sync %0, 128;\\n" ::"r"(1 + wg) : "memory");'
    c = sub(c, "    __syncthreads();     // and every thread's, visible to "
               "wgmma", bar)
    c = sub(c, "    __syncthreads();  // tile t is read: its stage may be "
               "refilled", bar)
    c = sub(c, "  return (kRows + 2 * kStages * kKeys) * dp * 2 + 1024;",
            "  return (kRows + 4 * kStages * kKeys) * dp * 2 + 1024;")
    for w in ("64", "256"):     # two rings of D = 256 do not fit: D = 128 only
        c = sub(c, f"return launch_tc<{w}>(", "return launch_tc<128>(")
    out["c_warpgroup_barriers"] = c
    d = sub(src, "constexpr int kKeys = 64;   // key rows of a tile",
            "constexpr int kKeys = 128;  // key rows of a tile")
    d = sub(d, "\n// O (64 x N", "\n" + wgmma_ss_n128() + "// O (64 x N")
    for old, new in (
            ("      float s[32];\n#pragma unroll\n      for (int j = 0; j < 32;"
             " ++j) s[j] = 0.f;",
             "      float s[64];\n#pragma unroll\n      for (int j = 0; j < 64;"
             " ++j) s[j] = 0.f;"),
            ("          wgmma_ss_n64(s, qd", "          wgmma_ss_n128(s, qd"),
            ("#pragma unroll\n        for (int j = 0; j < 32; ++j) {\n"
             "          const int qi",
             "#pragma unroll\n        for (int j = 0; j < 64; ++j) {\n"
             "          const int qi"),
            ("      for (int j = 0; j < 32; ++j)\n        mx[j / 2 % 2]",
             "      for (int j = 0; j < 64; ++j)\n        mx[j / 2 % 2]"),
            ("      uint32_t p_hi[16], p_lo[16];",
             "      uint32_t p_hi[32], p_lo[32];"),
            ("      for (int j = 0; j < 32; j += 2) {",
             "      for (int j = 0; j < 64; j += 2) {"),
            ("      for (int kk = 0; kk < 4; ++kk) {\n        const uint64_t vd",
             "      for (int kk = 0; kk < 8; ++kk) {\n        const uint64_t vd")):
        d = sub(d, old, new)
    out["d_128_keys"] = d
    return out


def main(argv) -> int:
    if not torch.cuda.is_available() or len(argv) not in (1, 2):
        print("usage (on a card): python3 tools/b3_ablation.py SOURCE "
              "[OUT_DIR]", file=sys.stderr)
        return 2
    out_dir = Path(argv[1] if len(argv) > 1 else ROOT / "build/b3_ablation")
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = variants(Path(argv[0]).read_text())
    procs = {}
    for name, text in srcs.items():
        (out_dir / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"),
             str(out_dir / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, ptxas = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{log}")
        ptxas[name] = {k[-48:]: v for k, v in
                       chip_smoke.ptxas_kernels(log).items()
                       if "tc_kernelILi128E" in k}
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        lib.flash_attention.argtypes = ([ctypes.c_void_p] * 5
                                        + [ctypes.c_int] * 9
                                        + [ctypes.c_void_p])
        lib.flash_attention.restype = ctypes.c_int
        libs[name] = lib
    smi = chip_smoke.nvidia_smi()
    print(smi)
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, Hq, Hkv, S, D = 8, 16, 16, 2048, 128
    q, k, v = (torch.randn((B, S, H, D), generator=gen, device="cuda")
               .bfloat16().transpose(1, 2) for H in (Hq, Hkv, Hkv))
    want = ref.mha_reference(q, k, v).float()
    o = torch.empty_like(q)
    strides = (ctypes.c_longlong * 12)(*(st for x in (q, k, v, o)
                                         for st in x.stride()[:3]))

    def call(lib):
        rc = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            ctypes.addressof(strides), B, Hq, S, S, D, Hq // Hkv, 1, 0, 1,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")

    res = {}
    for name, lib in libs.items():
        call(lib)
        torch.cuda.synchronize()
        res[name] = dict(
            max_abs_err=float((o.float() - want).abs().max()),
            within_b3_tol=bool(torch.allclose(o.float(), want,
                                              **chip_smoke.B3_TOL)),
            ptxas=ptxas[name], ms=[])
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            res[name]["ms"].append(chip_smoke.time_ms(
                torch, lambda: call(libs[name]), 20))
    for name, r in res.items():
        print(f"{name}: {r['ms'][0]:.4f} / {r['ms'][1]:.4f} ms, max abs err "
              f"{r['max_abs_err']:.4g}, within B3_TOL {r['within_b3_tol']}")
    print(json.dumps(dict(card=smi, shape=[B, Hq, Hkv, S, D], results=res)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
