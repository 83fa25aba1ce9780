#!/usr/bin/env python3
"""What the H100's tensor cores compute for ``mma.sync.m16n8k16`` (and,
with ``--wgmma``, for the warpgroup's ``wgmma.mma_async`` m64nNk16) on
bfloat16 / float16 operands with a float32 accumulator, held against the
port's emulation of it (``repro_torch.kernels.ref._mma_chain``, which
``flash_attention``'s 16-bit plain version sums with).

    python3 chip_mma_probe.py            # mma.sync m16n8k16
    python3 chip_mma_probe.py --wgmma    # wgmma m64nNk16

Builds one small kernel with ``nvcc`` (sm_90a) into a temporary
directory: each warp runs a chain of ``K / 16`` m16n8k16 steps from a
zero accumulator, A (16 x K) by B (K x 8), as the flash kernel chains its
steps.  For K = 16 and 32, in both dtypes, on five input sets (unit
normal; positive, where truncation and rounding toward 0 both lower
every sum; exponents spread over 2^-12..2^3; unit normal with a few
exact zeros; and a hundredth of the values at 2^-20), it prints the share
of outputs equal to the emulation bit for bit and to a float32 sum in
order, and fails unless every output equals the emulation.  ``--wgmma``
does the same for one warpgroup's chain of ``wgmma.mma_async`` m64nNk16
steps from a zero accumulator (the first step with scale-d 0), 64 x K by
K x N: N = 8 and 128, A from shared memory and A from registers, chains
of 1, 2 and 8 k-steps (K = 16, 32, 128), both dtypes, the same five input
sets; both operands in shared memory in the no-swizzle core-matrix layout
(8 rows of 16 bytes a core matrix, K-major).  Needs one card.
"""
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CALLS = 512            # warps (one chain each) per input set
# warpgroups (one chain each) per wgmma input set, by N
WG_CALLS = {8: 256, 128: 32}

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// one chain of K / 16 m16n8k16 steps a warp: A (16 x K, row-major) by B
// (8 x K: n x k), float32 accumulator from 0 -> D (16 x 8)
__global__ void mma_chain(const uint16_t* A, const uint16_t* B, float* D,
                          int K, int bf) {
  const int w = blockIdx.x, lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const uint16_t* a = A + static_cast<size_t>(w) * 16 * K;
  const uint16_t* b = B + static_cast<size_t>(w) * 8 * K;
  auto pk = [](uint16_t lo, uint16_t hi) {
    return static_cast<uint32_t>(lo) | static_cast<uint32_t>(hi) << 16;
  };
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < K; k0 += 16) {
    const uint16_t* ak = a + k0;
    const uint16_t* bk = b + k0;
    const uint16_t* r0 = ak + g * K + 2 * t;        // row g
    const uint16_t* r1 = ak + (g + 8) * K + 2 * t;  // row g + 8
    const uint32_t a0 = pk(r0[0], r0[1]), a1 = pk(r1[0], r1[1]);
    const uint32_t a2 = pk(r0[8], r0[9]), a3 = pk(r1[8], r1[9]);
    const uint32_t b0 = pk(bk[g * K + 2 * t], bk[g * K + 2 * t + 1]);
    const uint32_t b1 = pk(bk[g * K + 2 * t + 8], bk[g * K + 2 * t + 9]);
    if (bf)
      asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    else
      asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  float* o = D + static_cast<size_t>(w) * 128;
  o[g * 8 + 2 * t] = d[0];
  o[g * 8 + 2 * t + 1] = d[1];
  o[(g + 8) * 8 + 2 * t] = d[2];
  o[(g + 8) * 8 + 2 * t + 1] = d[3];
}
extern "C" int probe(const void* A, const void* B, void* D, int n, int K,
                     int bf, cudaStream_t s) {
  mma_chain<<<n, 32, 0, s>>>(static_cast<const uint16_t*>(A),
                             static_cast<const uint16_t*>(B),
                             static_cast<float*>(D), K, bf);
  return static_cast<int>(cudaGetLastError());
}
"""

# one warpgroup (128 threads) a block: D (64 x N) = A (64 x K, row-major)
# by B (N x K: n x k), a chain of K / 16 wgmma m64nNk16 steps
WGMMA_HEAD = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// element offset of (r, k) in the no-swizzle K-major core-matrix layout of
// an R x K operand: 8 x 8 core matrices of 128 contiguous bytes, the K / 8
// of one 8-row group next to each other (LBO 128 bytes), the groups K / 8
// core matrices apart (SBO K * 16 bytes)
__device__ __forceinline__ int cm(int r, int k, int K) {
  return (r >> 3) * (K >> 3) * 64 + (k >> 3) * 64 + (r & 7) * 8 + (k & 7);
}
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  const uint64_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return ((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}
"""

WGMMA_KERNEL = r"""
template <int N, bool kRegA, bool kBF>
__global__ void wgmma_chain(const uint16_t* A, const uint16_t* B, float* D,
                            int K) {
  extern __shared__ __align__(128) uint16_t sm[];
  uint16_t* sA = sm;
  uint16_t* sB = sm + 64 * K;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint16_t* a = A + static_cast<size_t>(blockIdx.x) * 64 * K;
  const uint16_t* b = B + static_cast<size_t>(blockIdx.x) * N * K;
  for (int i = tid; i < 64 * K; i += 128) sA[cm(i / K, i % K, K)] = a[i];
  for (int i = tid; i < N * K; i += 128) sB[cm(i / K, i % K, K)] = b[i];
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  float d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  auto pk = [](uint16_t lo, uint16_t hi) {
    return static_cast<uint32_t>(lo) | static_cast<uint32_t>(hi) << 16;
  };
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
  for (int s = 0; s < K / 16; ++s) {
    const uint64_t db = desc(sB + s * 128, 128, K * 16);
    const int sc = s > 0;
    if constexpr (kRegA) {
      const uint16_t* r0 = a + (16 * w + g) * K + 16 * s + 2 * t;
      const uint16_t* r1 = r0 + 8 * K;
      const uint32_t a0 = pk(r0[0], r0[1]), a1 = pk(r1[0], r1[1]);
      const uint32_t a2 = pk(r0[8], r0[9]), a3 = pk(r1[8], r1[9]);
      step<N, true, kBF>(d, a0, a1, a2, a3, 0, db, sc);
    } else {
      const uint64_t da = desc(sA + s * 128, 128, K * 16);
      step<N, false, kBF>(d, 0, 0, 0, 0, da, db, sc);
    }
  }
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  float* o = D + static_cast<size_t>(blockIdx.x) * 64 * N;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    o[(16 * w + g) * N + 8 * j + 2 * t] = d[4 * j];
    o[(16 * w + g) * N + 8 * j + 2 * t + 1] = d[4 * j + 1];
    o[(16 * w + g + 8) * N + 8 * j + 2 * t] = d[4 * j + 2];
    o[(16 * w + g + 8) * N + 8 * j + 2 * t + 1] = d[4 * j + 3];
  }
}

template <int N, bool kRegA, bool kBF>
int run(const void* A, const void* B, void* D, int n, int K,
        cudaStream_t s) {
  const int smem = (64 + N) * K * 2;
  cudaError_t err = cudaFuncSetAttribute(
      wgmma_chain<N, kRegA, kBF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  wgmma_chain<N, kRegA, kBF><<<n, 128, smem, s>>>(
      static_cast<const uint16_t*>(A), static_cast<const uint16_t*>(B),
      static_cast<float*>(D), K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe(const void* A, const void* B, void* D, int n, int K,
                     int N, int reg_a, int bf, cudaStream_t s) {
#define CASE(NN, R, F) \
  if (N == NN && reg_a == R && bf == F) return run<NN, R, F>(A, B, D, n, K, s);
  CASE(8, 0, 0) CASE(8, 0, 1) CASE(8, 1, 0) CASE(8, 1, 1)
  CASE(128, 0, 0) CASE(128, 0, 1) CASE(128, 1, 0) CASE(128, 1, 1)
#undef CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
"""


def wgmma_step(n: int, reg_a: bool, bf: bool) -> str:
    """The specialisation of ``step`` that issues one wgmma m64n{n}k16
    with n / 2 float32 accumulators a thread (scale-d from ``sc``)."""
    nd, dt = n // 2, "bf16" if bf else "f16"
    outs = ", ".join(f"%{i}" for i in range(nd))
    if reg_a:
        a = "{" + ", ".join(f"%{nd + i}" for i in range(4)) + "}"
        b, sc, imm = f"%{nd + 4}", f"%{nd + 5}", "1, 1, 0"
        ins = ('"r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(sc)')
    else:
        a, b, sc, imm = f"%{nd}", f"%{nd + 1}", f"%{nd + 2}", "1, 1, 0, 0"
        ins = '"l"(da), "l"(db), "r"(sc)'
    cons = ", ".join(f'"+f"(d[{i}])' for i in range(nd))
    return (
        f"template <> __device__ __forceinline__ void step<{n}, "
        f"{'true' if reg_a else 'false'}, {'true' if bf else 'false'}>(\n"
        f"    float* d, uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,\n"
        f"    uint64_t da, uint64_t db, int sc) {{\n"
        f'  asm volatile("{{\\n.reg .pred p;\\nsetp.ne.b32 p, {sc}, 0;\\n"\n'
        f'      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.{dt}.{dt} "\n'
        f'      "{{{outs}}}, {a}, {b}, p, {imm};\\n}}\\n"\n'
        f"      : {cons}\n"
        f"      : {ins} : \"memory\");\n"
        f"}}\n")


def wgmma_source() -> str:
    steps = "".join(wgmma_step(n, r, f) for n in (8, 128)
                    for r in (False, True) for f in (False, True))
    return (WGMMA_HEAD
            + "template <int N, bool kRegA, bool kBF>\n"
              "__device__ __forceinline__ void step(float* d, uint32_t a0, "
              "uint32_t a1, uint32_t a2, uint32_t a3, uint64_t da, "
              "uint64_t db, int sc);\n"
            + steps + WGMMA_KERNEL)


def inputs(torch, kind, shape, gen):
    x = torch.randn(shape, generator=gen)
    if kind == "positive":
        x = x.abs()
    elif kind == "spread":
        x = x * torch.exp2(torch.randint(-12, 4, shape, generator=gen).float())
    elif kind == "zeros":
        x = torch.where(torch.rand(shape, generator=gen) < 0.05,
                        torch.zeros(()), x)
    elif kind == "tiny":
        x = torch.where(torch.rand(shape, generator=gen) < 0.01,
                        x * 2.0 ** -20, x)
    return x


def compare(torch, ref, label, a, b, got):
    """Outputs equal to the emulation (and to a float32 sum in order) for
    one input set: prints the line, returns the count off the
    emulation."""
    emul = ref._mma_chain(a.float(), b.float().transpose(1, 2))
    seq = torch.zeros_like(got)
    for k in range(a.shape[-1]):
        seq = seq + a.float()[:, :, k, None] * b.float()[:, None, :, k]
    same = (got == emul).float().mean().item()
    print(f"{label}: {got.numel()} outputs, emulation {same:.6f} bit for "
          f"bit, float32 sum in order "
          f"{(got == seq).float().mean().item():.6f}")
    return int((got != emul).sum())


def build(tmp, source, name):
    src, so = Path(tmp) / f"{name}.cu", Path(tmp) / f"{name}.so"
    src.write_text(source)
    from repro_torch.kernels import _build
    subprocess.run([_build._nvcc(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(so), str(src)],
                   check=True)
    return ctypes.CDLL(str(so))


DTYPES = (("bfloat16", "bfloat16", 1), ("float16", "float16", 0))
KINDS = ("normal", "positive", "spread", "zeros", "tiny")


def probe_mma(torch, ref, tmp, gen):
    lib = build(tmp, SOURCE, "probe")
    lib.probe.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    bad = 0
    for name, dt, bf in DTYPES:
        dt = getattr(torch, dt)
        for K in (16, 32):
            for kind in KINDS:
                a = inputs(torch, kind, (CALLS, 16, K), gen).to(dt)
                b = inputs(torch, kind, (CALLS, 8, K), gen).to(dt)
                d = torch.empty((CALLS, 16, 8), device="cuda")
                ac, bc = (x.view(torch.int16).cuda() for x in (a, b))
                rc = lib.probe(ac.data_ptr(), bc.data_ptr(), d.data_ptr(),
                               CALLS, K, bf,
                               torch.cuda.current_stream().cuda_stream)
                torch.cuda.synchronize()
                if rc:
                    raise RuntimeError(f"probe launch failed: {rc}")
                bad += compare(torch, ref, f"mma {name:8s} K={K:2d} "
                               f"{kind:8s}", a, b, d.cpu())
    return bad


def probe_wgmma(torch, ref, tmp, gen):
    lib = build(tmp, wgmma_source(), "wgmma")
    lib.probe.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    bad = 0
    for name, dt, bf in DTYPES:
        dt = getattr(torch, dt)
        for N in (8, 128):
            for reg_a in (0, 1):
                for K in (16, 32, 128):
                    calls = WG_CALLS[N]
                    for kind in KINDS:
                        a = inputs(torch, kind, (calls, 64, K), gen).to(dt)
                        b = inputs(torch, kind, (calls, N, K), gen).to(dt)
                        d = torch.empty((calls, 64, N), device="cuda")
                        ac, bc = (x.view(torch.int16).cuda() for x in (a, b))
                        rc = lib.probe(
                            ac.data_ptr(), bc.data_ptr(), d.data_ptr(),
                            calls, K, N, reg_a, bf,
                            torch.cuda.current_stream().cuda_stream)
                        torch.cuda.synchronize()
                        if rc:
                            raise RuntimeError(f"wgmma probe launch failed: "
                                               f"{rc}")
                        bad += compare(
                            torch, ref, f"wgmma {name:8s} m64n{N}k16 A from "
                            f"{'registers' if reg_a else 'shared'} "
                            f"K={K:3d} {kind:8s}", a, b, d.cpu())
    return bad


def main(argv) -> int:
    if argv not in ([], ["--wgmma"]):
        print("usage: chip_mma_probe.py [--wgmma]", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_mma_probe: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_mma_probe: src/repro_torch not found next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ref
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    wgmma = argv == ["--wgmma"]
    gen = torch.Generator().manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        bad = (probe_wgmma if wgmma else probe_mma)(torch, ref, tmp, gen)
    print(f"{'wgmma' if wgmma else 'mma'} probe: "
          f"{'ok' if bad == 0 else 'FAIL'} ({bad} outputs off the emulation)")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
