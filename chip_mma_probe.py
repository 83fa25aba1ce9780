#!/usr/bin/env python3
"""What the H100's tensor cores compute for ``mma.sync.m16n8k16`` on
bfloat16 / float16 operands with a float32 accumulator, held against the
port's emulation of it (``repro_torch.kernels.ref._mma_chain``, which
``flash_attention``'s 16-bit plain version sums with).

    python3 chip_mma_probe.py

Builds one small kernel with ``nvcc`` (sm_90a) into a temporary
directory: each warp runs a chain of ``K / 16`` m16n8k16 steps from a
zero accumulator, A (16 x K) by B (K x 8), as the flash kernel chains its
steps.  For K = 16 and 32, in both dtypes, on five input sets (unit
normal; positive, where truncation and rounding toward 0 both lower
every sum; exponents spread over 2^-12..2^3; unit normal with a few
exact zeros; and a hundredth of the values at 2^-20), it prints the share
of outputs equal to the emulation bit for bit and to a float32 sum in
order, and fails unless every output equals the emulation.  Needs one
card.
"""
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CALLS = 512            # warps (one chain each) per input set

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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_mma_probe: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_mma_probe: src/repro_torch not found next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, ref
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        src, so = Path(tmp) / "probe.cu", Path(tmp) / "probe.so"
        src.write_text(SOURCE)
        subprocess.run([_build._nvcc(), "-gencode",
                        "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                        "-Xcompiler", "-fPIC", "-o", str(so), str(src)],
                       check=True)
        lib = ctypes.CDLL(str(so))
        lib.probe.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        gen = torch.Generator().manual_seed(0)
        bad = 0
        for name, dt, bf in (("bfloat16", torch.bfloat16, 1),
                             ("float16", torch.float16, 0)):
            for K in (16, 32):
                for kind in ("normal", "positive", "spread", "zeros", "tiny"):
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
                    got = d.cpu()
                    emul = ref._mma_chain(a.float(), b.float().transpose(1, 2))
                    seq = torch.zeros_like(got)
                    for k in range(K):
                        seq = seq + a.float()[:, :, k, None] * \
                            b.float()[:, None, :, k]
                    same = (got == emul).float().mean().item()
                    bad += int((got != emul).sum())
                    print(f"mma {name:8s} K={K:2d} {kind:8s}: "
                          f"{got.numel()} outputs, emulation {same:.6f} bit "
                          f"for bit, float32 sum in order "
                          f"{(got == seq).float().mean().item():.6f}")
    print(f"mma probe: {'ok' if bad == 0 else 'FAIL'} ({bad} outputs off "
          "the emulation)")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
