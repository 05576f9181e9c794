// Fused two-layer 3x3 stride-2 conv frontend, for sm_90a.
//
// Replaces cassnat_asr_public_tpu/kernels/fused_frontend.py:120
// fused_conv_frontend (Pallas _frontend_kernel):
//   out = relu(conv2(relu(conv1(x)))), 3x3 kernels, stride 2, padding 1,
//   conv1 1 -> C channels, conv2 C -> C; conv1's output never reaches
//   device memory.
//
// Bound on the H100: conv2 does 2 * 9 * C * C FLOPs per output position,
// far more than the bytes it moves, so the limit is arithmetic: at the
// path shape (B=32, T=736, F=240, C=512) 1.67 TFLOP, 1.70 ms at the bf16
// tensor-core peak. Both routes are implicit GEMMs with f32 accumulation
// (M = output positions, N = output channels, K = 9 taps x C inputs)
// that compute conv1 (1 input channel, 9 taps) from f32 w1 and b1 into
// shared memory, zero outside the valid range (conv2's own padding):
//  - bf16 inputs (the decode path; C % 8 == 0) run a warp-specialised,
//    persistent kernel: conv2 on wgmma, w2 by TMA, conv1 on mma.sync
//    (fused_frontend_wgmma_kernel, below);
//  - f32 inputs, whose check against the plain version allows no TF32
//    rounding, run conv1 and conv2 on the CUDA cores
//    (fused_frontend_kernel, next).
//
// f32 route: a block owns up to 128 output positions (TT rows x FW
// columns of the (T4, F4) grid) and 128 output channels, 8 x 8 of them
// per thread (the channels as two runs of 4, read from shared memory as
// float4). The input rows and columns that tile needs (with the halo) are
// staged in shared memory once. Then, for each slice of kCK conv2 input
// channels: the conv1 outputs of that slice for the tile's (2TT+1) x
// (2FW+1) window are computed into shared memory, the matching w2 slice
// is staged beside them, and the nine taps accumulate. The conv1 window
// is kept split into even and odd columns so that the stride-2 reads of
// neighbouring output columns are consecutive words.
//
// Layouts: x (B,T,F); w1 f32 (9,C) tap-major; b1, b2 f32 (C); w2 (9,Cin,
// Cout) for f32, (9,Cout,Cin) for bf16 (K-major, as a wgmma B descriptor
// reads it); out (B,T4,F4,C). x, w2 and out share the element type.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;  // output positions per block
constexpr int kBN = 128;  // output channels per block
constexpr int kCK = 8;    // conv2 input channels per slice
constexpr int kTM = 8;    // positions per thread (stride 16)
constexpr int kTN = 8;    // channels per thread: 4 at 4*tx, 4 at 64 + 4*tx

struct Geometry {
  int T, F, C, T2, F2, T4, F4;
  int TT, FW;         // output tile: TT rows x FW columns, TT * FW <= kBM
  int tiles_f;        // column tiles per row band
  int R1, HW;         // conv1 window: R1 rows, 2 x HW columns (even/odd)
  int XR, XC;         // staged input window
};

__global__ void __launch_bounds__(kThreads)
fused_frontend_kernel(const float* __restrict__ x,
                      const float* __restrict__ w1,
                      const float* __restrict__ b1,
                      const float* __restrict__ w2,
                      const float* __restrict__ b2, float* __restrict__ out,
                      Geometry g) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int plane = g.R1 * 2 * g.HW;      // one conv1 channel of the window
  float* ws = smem;                        // [9][kCK][kBN], 16-byte aligned
  float* w1s = ws + 9 * kCK * kBN;         // [9][kCK]
  float* b1s = w1s + 9 * kCK;              // [kCK]
  float* xs = b1s + kCK;                   // [XR][XC]
  float* h1s = xs + g.XR * g.XC;           // [kCK][R1][2][HW]

  const int tile = blockIdx.x;
  const int t4_0 = (tile / g.tiles_f) * g.TT;
  const int f4_0 = (tile % g.tiles_f) * g.FW;
  const int n0 = blockIdx.y * kBN;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  // conv1 window origin (t2, f2) and input window origin (t, f)
  const int r2_0 = 2 * t4_0 - 1, c2_0 = 2 * f4_0 - 1;
  const int xr_0 = 2 * r2_0 - 1, xc_0 = 2 * c2_0 - 1;

  const float* xb = x + (int64_t)b * g.T * g.F;
  for (int i = tid; i < g.XR * g.XC; i += kThreads) {
    const int r = i / g.XC, c = i - r * g.XC;
    const int tr = xr_0 + r, fc = xc_0 + c;
    xs[i] = (tr >= 0 && tr < g.T && fc >= 0 && fc < g.F)
                ? xb[(int64_t)tr * g.F + fc] : 0.f;
  }

  // this thread's output positions, as offsets into one conv1 plane
  int base[kTM];
  bool pvalid[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = ty + 16 * i;
    const int ti = m / g.FW, fi = m - (m / g.FW) * g.FW;
    pvalid[i] = m < g.TT * g.FW && t4_0 + ti < g.T4 && f4_0 + fi < g.F4;
    base[i] = pvalid[i] ? (2 * ti) * (2 * g.HW) + fi : 0;
  }

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  const int win_cols = 2 * g.HW;
  for (int ci0 = 0; ci0 < g.C; ci0 += kCK) {
    __syncthreads();  // previous slice consumed; xs staged on first pass
    for (int i = tid; i < 9 * kCK; i += kThreads) {
      const int tap = i / kCK, kk = i - tap * kCK, ci = ci0 + kk;
      w1s[i] = ci < g.C ? w1[tap * g.C + ci] : 0.f;
    }
    for (int i = tid; i < kCK; i += kThreads)
      b1s[i] = ci0 + i < g.C ? b1[ci0 + i] : 0.f;
    for (int i = tid; i < 9 * kCK * kBN; i += kThreads) {
      const int n = i % kBN, rest = i / kBN;
      const int kk = rest % kCK, tap = rest / kCK;
      const int ci = ci0 + kk, co = n0 + n;
      ws[i] = (ci < g.C && co < g.C)
                  ? w2[((int64_t)tap * g.C + ci) * g.C + co] : 0.f;
    }
    __syncthreads();
    // conv1 for this slice over the window; element (kk, r, col)
    for (int i = tid; i < kCK * plane; i += kThreads) {
      const int kk = i / plane, rem = i - kk * plane;
      const int r = rem / win_cols, pc = rem - r * win_cols;
      const int par = pc / g.HW, half = pc - par * g.HW;
      const int col = 2 * half + par;          // window column
      const int t2 = r2_0 + r, f2 = c2_0 + col;
      float val = 0.f;
      if (col < 2 * g.FW + 1 && t2 >= 0 && t2 < g.T2 && f2 >= 0 &&
          f2 < g.F2 && ci0 + kk < g.C) {
        float s = b1s[kk];
        const float* xr = xs + (2 * r) * g.XC + 2 * col;
#pragma unroll
        for (int dt = 0; dt < 3; ++dt)
#pragma unroll
          for (int df = 0; df < 3; ++df)
            s = fmaf(xr[dt * g.XC + df], w1s[(dt * 3 + df) * kCK + kk], s);
        val = fmaxf(s, 0.f);
      }
      h1s[i] = val;
    }
    __syncthreads();
    // the tap-row loop stays rolled: unrolling all 9 taps x kCK made ptxas
    // hoist loads past the 255-register limit and spill
#pragma unroll 1
    for (int dt = 0; dt < 3; ++dt) {
#pragma unroll
      for (int df = 0; df < 3; ++df) {
        const int tap_off = dt * win_cols + (df & 1) * g.HW + (df >> 1);
        const float* wt = ws + (dt * 3 + df) * kCK * kBN + 4 * tx;
#pragma unroll
        for (int kk = 0; kk < kCK; ++kk) {
          const float* hk = h1s + kk * plane + tap_off;
          float a[kTM];
#pragma unroll
          for (int i = 0; i < kTM; ++i) a[i] = hk[base[i]];
          const float4 lo = *reinterpret_cast<const float4*>(wt + kk * kBN);
          const float4 hi =
              *reinterpret_cast<const float4*>(wt + kk * kBN + kBN / 2);
          const float bv[kTN] = {lo.x, lo.y, lo.z, lo.w,
                                 hi.x, hi.y, hi.z, hi.w};
#pragma unroll
          for (int i = 0; i < kTM; ++i)
#pragma unroll
            for (int j = 0; j < kTN; ++j)
              acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    if (!pvalid[i]) continue;
    const int m = ty + 16 * i;
    const int t4 = t4_0 + m / g.FW, f4 = f4_0 + m % g.FW;
    float* orow = out + (((int64_t)b * g.T4 + t4) * g.F4 + f4) * g.C;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int co = n0 + 4 * tx + (j < 4 ? j : kBN / 2 + j - 4);
      if (co < g.C) orow[co] = fmaxf(acc[i][j] + b2[co], 0.f);
    }
  }
}

int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, void* out, int B, int T_, int F, int C,
           cudaStream_t stream) {
  Geometry g;
  g.T = T_;
  g.F = F;
  g.C = C;
  g.T2 = (T_ + 1) / 2;
  g.F2 = (F + 1) / 2;
  g.T4 = (g.T2 + 1) / 2;
  g.F4 = (g.F2 + 1) / 2;
  g.FW = g.F4 < kBM ? g.F4 : kBM;
  g.TT = kBM / g.FW;
  g.tiles_f = (g.F4 + g.FW - 1) / g.FW;
  g.R1 = 2 * g.TT + 1;
  g.HW = g.FW + 1;
  g.XR = 2 * g.R1 + 1;
  g.XC = 2 * (2 * g.FW + 1) + 1;
  const int plane = g.R1 * 2 * g.HW;
  const size_t smem = sizeof(float) * ((size_t)g.XR * g.XC + kCK * plane +
                                       9 * kCK * kBN + 9 * kCK + kCK);
  cudaError_t e = cudaFuncSetAttribute(
      fused_frontend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles_t = (g.T4 + g.TT - 1) / g.TT;
  dim3 grid(tiles_t * g.tiles_f, (C + kBN - 1) / kBN, B);
  fused_frontend_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(out), g);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 route: a warp-specialised, persistent implicit GEMM on wgmma.
//
// One block of 384 threads per SM walks over tiles of 128 output positions
// x 256 output channels, in slices of 32 conv2 input channels. A tile is
// TT rows x FW columns of the (T4, F4) grid (FW <= 64 and TT = 128 / HWp,
// HWp = FW + 1, chosen by make_plan); M row m of the tile is output
// (m / HWp, m % HWp), and rows with m % HWp == FW are padding.
//  - Warp 0 (one thread) keeps TMA copies of w2 in flight: one copy is
//    one tap of one slice, 256 output channels x 32 input channels of the
//    (9, Cout, Cin) packing, 16 KB with the 64-byte swizzle, into a ring
//    of up to 8 stages (full/empty mbarriers). TMA's zero fill covers a
//    partial N or K tile.
//  - Warps 1-3 compute conv1 for the next slice into a two-stage ring, on
//    the tensor cores, once per position of the tile's conv1 window
//    (R1 = 2 TT + 1 rows x 2 FW + 1 columns): the im2col of the input (9
//    taps padded to 16, bf16, exact) is built once per tile; the slice's
//    w1 and b1 come from global memory, so shared memory does not grow
//    with C; w1 is split exactly into bf16 hi + lo and both products
//    accumulate in f32 on mma.sync m16n8k16 (|w1 - hi - lo| <= 2^-16
//    |w1|); then b1, ReLU, zero outside the valid t2/f2 range (conv2's
//    padding), and bf16.
//  - The window is stored as four planes, (row parity, column parity), of
//    rows HWp positions apart, 16 bytes (8 channels) a position and chunk
//    ([chunk][plane][position]): tap (dt, df) of output m is plane
//    (dt & 1, df & 1) at position m + (dt >> 1) HWp + (df >> 1). So the 64
//    A rows of every tap are 64 consecutive 16-byte rows, which the
//    no-swizzle K-major wgmma descriptor addresses from any 16-byte start.
//  - Two consumer warpgroups each own 64 positions x 256 channels (128 f32
//    accumulators a thread) and run wgmma m64n256k16 with A and B by
//    descriptor, both k16 steps of a tap in one asm statement. After each
//    tap a warpgroup waits for the previous tap's products, then frees
//    its w2 stage and, after a slice's last tap, the h1 stage. The
//    epilogue adds b2, applies ReLU and stores bf16 16 bytes a lane after
//    a transpose inside each quad.
// setmaxnreg moves registers from the producer (136) to the consumers
// (184); the block is launched with 168 a thread (384 x 168 = 64,512).
// w2 is read from L2 once per tile: (M / 120) x 9C x 256 x 2 bytes
// ~ 14 GB at the path shape, 85% of the tile intensity of a plain
// 128 x 256 GEMM, which runs near the tensor peak, so no cluster
// multicast.
// What bounds it now (clock64 marks in an instrumented copy on the H100):
// conv1. The consumers spend much of their time waiting for the next h1
// slice. conv1 is recomputed for each of the two 256-channel tiles and for
// the window's halo rows (10 window positions per output position), and
// its non-MMA work runs slower beside the consumers' wgmma than alone.
// Measured slower on the H100 and not kept: conv1 on the CUDA cores (a
// single FFMA warp per scheduler cannot keep the FP32 pipes busy), conv1
// on wgmma from this warpgroup, and two blocks of a cluster sharing conv1
// through shared-memory copies.

constexpr int kTcThreads = 384;
constexpr int kSlice = 32;                  // conv2 input channels / slice
constexpr int kTileN = 256;                 // output channels per tile
constexpr int kTileM = 128;                 // output positions per tile
constexpr int kMaxFW = 64;                  // output columns per tile
constexpr int kWStage = kTileN * kSlice * 2;  // bytes of one w2 copy
constexpr int kMaxWStages = 8;
constexpr int kConv1Warps = 3;              // warps 1-3
constexpr int kConv1Threads = 32 * kConv1Warps;
constexpr int kSmemLimit = 232448;          // 227 KB per block on sm_90
constexpr int kLaunchRegs = 168;            // 65,536 / 384, rounded to 8
constexpr int kSkip = INT32_MIN;            // im2col row past the window

struct PlanTC {
  int B, T, F, C, T2, F2, T4, F4;
  int TT, FW, tiles_f, tiles_t, tiles_n, n_tiles, n_slices;
  int R1, HWp, n_pos, P32;  // window: R1 rows x 2 x HWp; rows padded to 32
  int PP;                   // positions per plane (pitch of the planes)
  int w_stages, h_stage;
  int off_h, off_a1, off_tab, off_bar, smem;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

// Wait for the phase of `bar` with the given parity to complete. A wait
// that lasts 10 s (a protocol fault) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint64_t t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (t0 == 0) t0 = now;
    else if (now - t0 > 10000000000ull) __trap();
  }
}

__device__ __forceinline__ void tma_load_w2(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int ci, int co,
                                            int tap) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(ci), "r"(co),
      "r"(tap)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16 x 8, f32) += a (16 x 16, bf16) * b (16 x 8, bf16)
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// wgmma shared-memory descriptors: B, K-major rows of 64 bytes with the
// 64-byte swizzle (8-row groups 512 bytes apart, LBO unused); A, K-major
// without swizzle: 16-byte rows, 8-row groups 128 bytes apart (SBO), the
// two 8-channel halves of a k16 step `lbo` bytes apart (LBO).
__device__ __forceinline__ uint64_t desc_b(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(512 >> 4) << 32) | ((uint64_t)2 << 62);
}
__device__ __forceinline__ uint64_t desc_a(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 256, f32) += a (64 x 32, bf16) * b (32 x 256, bf16), both by
// shared-memory descriptor, as two k16 steps; scale_d == 0 overwrites d
__device__ __forceinline__ void wgmma_256x2(float* d, uint64_t a0, uint64_t a1,
                                            uint64_t b0, uint64_t b1,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.b32 p, %132, 0;\n"
      "setp.eq.b32 q, %132, %132;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %130, p, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%129, %131, q, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a0), "l"(a1), "l"(b0), "l"(b1), "r"(scale_d));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__host__ __device__ __forceinline__ int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

struct TileIdx {
  int b, t4_0, f4_0, n0;
};

__device__ __forceinline__ TileIdx tile_idx(const PlanTC& p, int tile) {
  TileIdx t;
  t.n0 = (tile % p.tiles_n) * kTileN;
  int rest = tile / p.tiles_n;
  t.f4_0 = (rest % p.tiles_f) * p.FW;
  rest /= p.tiles_f;
  t.t4_0 = (rest % p.tiles_t) * p.TT;
  t.b = rest / p.tiles_t;
  return t;
}

__global__ void __launch_bounds__(kTcThreads, 1)
fused_frontend_wgmma_kernel(const __grid_constant__ CUtensorMap w2map,
                            const __nv_bfloat16* __restrict__ x,
                            const float* __restrict__ w1,
                            const float* __restrict__ b1,
                            const float* __restrict__ b2,
                            __nv_bfloat16* __restrict__ out, PlanTC p) {
  extern __shared__ uint8_t smem_raw[];
  // the swizzled w2 stages want 1024-byte alignment (8 x the swizzle span)
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  const uint32_t w_s = base;            // [w_stages][256 rows][64 B]
  const uint32_t h_s = base + p.off_h;  // [2][4 chunks][4 planes][PP][16 B]
  const uint32_t a1_s = base + p.off_a1;  // im2col: [P32][16 taps] bf16
  int* tab = reinterpret_cast<int*>(sm + p.off_tab);  // [P32]
  const uint32_t bar = base + p.off_bar;
  // barriers: full_w[8], empty_w[8], full_h[2], empty_h[2]
  auto full_w = [&](int s) { return bar + 8u * s; };
  auto empty_w = [&](int s) { return bar + 8u * (kMaxWStages + s); };
  auto full_h = [&](int s) { return bar + 8u * (2 * kMaxWStages + s); };
  auto empty_h = [&](int s) { return bar + 8u * (2 * kMaxWStages + 2 + s); };
  const uint32_t chunk_bytes = 4 * p.PP * 16;  // [chunk] stride: LBO of A

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q = lane & 3, g = lane >> 2;
  if (tid == 0) {
    for (int s = 0; s < p.w_stages; ++s) {
      mbar_init(full_w(s), 1);
      mbar_init(empty_w(s), 8);  // the 8 consumer warps
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(full_h(s), kConv1Threads);
      mbar_init(empty_h(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    // ---------------- producer warpgroup ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 136;\n");
    if (warp == 0) {
      if (lane != 0) return;
      int st = 0;
      uint32_t ph = 0;
      for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
        const int n0 = tile_idx(p, tile).n0;
        for (int s = 0; s < p.n_slices; ++s)
          for (int tap = 0; tap < 9; ++tap) {
            mbar_wait(empty_w(st), ph ^ 1);
            mbar_expect_tx(full_w(st), kWStage);
            tma_load_w2(w_s + st * kWStage, &w2map, full_w(st), s * kSlice,
                        n0, tap);
            if (++st == p.w_stages) { st = 0; ph ^= 1; }
          }
      }
      return;
    }
    // conv1 on warps 1-3
    const int ct = tid - 32, pw = warp - 1;
    const uint16_t* xbits = reinterpret_cast<const uint16_t*>(x);
    int hst = 0;
    uint32_t hph = 0;
    for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
      const TileIdx ti = tile_idx(p, tile);
      const int r2_0 = 2 * ti.t4_0 - 1, c2_0 = 2 * ti.f4_0 - 1;
      const uint16_t* xb = xbits + (int64_t)ti.b * p.T * p.F;
      // the previous tile's slices are done with the im2col and tab
      asm volatile("bar.sync 1, %0;\n" ::"n"(kConv1Threads));
      // im2col row i = window position (r, column 2 half + parity) with
      // i = (2 r + parity) HWp + half; tab[i] = its byte offset in an h1
      // stage, complemented where it lies outside the valid t2/f2 range
      // (stored as 0: conv2's padding), kSkip past the window
      for (int i = ct; i < p.P32; i += kConv1Threads) {
        uint32_t v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
        int off = kSkip;
        if (i < p.n_pos) {
          const int rp = i / p.HWp, half = i - rp * p.HWp;
          const int r = rp >> 1, par = rp & 1, col = 2 * half + par;
          const int t2 = r2_0 + r, f2 = c2_0 + col;
          off = (((r & 1) * 2 + par) * p.PP + (r >> 1) * p.HWp + half) * 16;
          if (col <= 2 * p.FW && t2 >= 0 && t2 < p.T2 && f2 >= 0 &&
              f2 < p.F2) {
#pragma unroll
            for (int t = 0; t < 9; ++t) {
              const int tr = 2 * t2 - 1 + t / 3, fc = 2 * f2 - 1 + t % 3;
              const uint32_t bits =
                  (tr >= 0 && tr < p.T && fc >= 0 && fc < p.F)
                      ? xb[(int64_t)tr * p.F + fc] : 0u;
              v[t >> 1] |= bits << (16 * (t & 1));
            }
          } else {
            off = ~off;
          }
        }
        // 16-byte chunk c of row i at c ^ ((i >> 2) & 1): ldmatrix's 8
        // rows of 32 bytes fall in 8 different bank groups
        uint4* row = reinterpret_cast<uint4*>(sm + p.off_a1 + i * 32);
        const int sw = (i >> 2) & 1;
        row[sw] = make_uint4(v[0], v[1], v[2], v[3]);
        row[sw ^ 1] = make_uint4(v[4], v[5], v[6], v[7]);
        tab[i] = off;
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(kConv1Threads));
      for (int s = 0; s < p.n_slices; ++s) {
        const int ci0 = s * kSlice;
        // B fragments of w1 (taps x 32 channels) split into bf16 hi + lo,
        // and the bias of this lane's accumulator columns
        uint32_t bh[4][2], bl[4][2];
        float bias[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int n = ci0 + 8 * nt + g;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            uint32_t hi2 = 0, lo2 = 0;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int k = 2 * q + e + 8 * j;
              const float w = k < 9 && n < p.C ? __ldg(w1 + k * p.C + n) : 0.f;
              const __nv_bfloat16 hi = __float2bfloat16_rn(w);
              const __nv_bfloat16 lo =
                  __float2bfloat16_rn(w - __bfloat162float(hi));
              hi2 |= (uint32_t)__bfloat16_as_ushort(hi) << (16 * e);
              lo2 |= (uint32_t)__bfloat16_as_ushort(lo) << (16 * e);
            }
            bh[nt][j] = hi2;
            bl[nt][j] = lo2;
          }
          const int col = ci0 + 8 * nt + 2 * q;
          bias[nt][0] = col < p.C ? __ldg(b1 + col) : 0.f;
          bias[nt][1] = col + 1 < p.C ? __ldg(b1 + col + 1) : 0.f;
        }
        mbar_wait(empty_h(hst), hph ^ 1);
        uint8_t* hb = sm + p.off_h + hst * p.h_stage;
        // two m16 tiles at a time (16 independent products), the next
        // pair's im2col fragments and table entries loaded before this
        // pair's products: shared-memory loads wait long beside the
        // consumers' wgmma
        const int n_mt = p.P32 / 16;
        uint32_t an[2][4];
        int tn[2][2];
        auto fetch = [&](int mt) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int ir = (mt + u) * 16 + (lane & 15);
            ldsm_x4(a1_s + ir * 32 + (((lane >> 4) ^ ((ir >> 2) & 1)) << 4),
                    an[u]);
#pragma unroll
            for (int h = 0; h < 2; ++h)
              tn[u][h] = tab[(mt + u) * 16 + g + 8 * h];
          }
        };
        if (2 * pw < n_mt) fetch(2 * pw);
        for (int mt = 2 * pw; mt < n_mt; mt += 2 * kConv1Warps) {
          uint32_t a[2][4];
          int tv[2][2];
          float c[2][4][4];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
#pragma unroll
            for (int e = 0; e < 4; ++e) a[u][e] = an[u][e];
            tv[u][0] = tn[u][0];
            tv[u][1] = tn[u][1];
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) c[u][nt][e] = 0.f;
          }
          if (mt + 2 * kConv1Warps < n_mt) fetch(mt + 2 * kConv1Warps);
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
              mma_16816(c[u][nt], a[u], bh[nt][0], bh[nt][1]);
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
              mma_16816(c[u][nt], a[u], bl[nt][0], bl[nt][1]);
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int v = tv[u][h];
              if (v == kSkip) continue;
              const bool valid = v >= 0;
              uint8_t* dst = hb + (valid ? v : ~v) + 4 * q;
#pragma unroll
              for (int nt = 0; nt < 4; ++nt)
                *reinterpret_cast<uint32_t*>(dst + nt * chunk_bytes) =
                    valid ? pack_bf16(
                                fmaxf(c[u][nt][2 * h] + bias[nt][0], 0.f),
                                fmaxf(c[u][nt][2 * h + 1] + bias[nt][1], 0.f))
                          : 0u;
            }
        }
        // the stores are read by wgmma, through the async proxy
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(full_h(hst));
        if (++hst == 2) { hst = 0; hph ^= 1; }
      }
    }
    return;
  }

  // ---------------- consumer warpgroups ----------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 184;\n");
  const int cw = warp / 4 - 1, wq = warp & 3;
  const int m_valid = p.TT * p.HWp;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  int wst = 0, hst = 0;
  uint32_t wph = 0, hph = 0;
  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    const TileIdx ti = tile_idx(p, tile);
    // the stages read by the tap in flight, freed once it is done (the h1
    // stage only after a slice's last tap)
    int prev_w = -1, prev_h = -1;
    for (int s = 0; s < p.n_slices; ++s) {
      mbar_wait(full_h(hst), hph);
      const uint32_t hb = h_s + hst * p.h_stage;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dt = tap / 3, df = tap % 3;
        const int plane = (dt & 1) * 2 + (df & 1);
        const uint64_t da = desc_a(
            hb + (plane * p.PP + cw * 64 + (dt >> 1) * p.HWp + (df >> 1)) * 16,
            chunk_bytes);
        mbar_wait(full_w(wst), wph);
        const uint64_t db = desc_b(w_s + wst * kWStage);
        wgmma_fence();
        // k 16..31: A two chunks on, B 32 bytes into its rows
        wgmma_256x2(acc, da, da + ((2 * chunk_bytes) >> 4), db, db + 2,
                    s > 0 || tap > 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous tap's products are done
        if (lane == 0) {
          if (prev_w >= 0) mbar_arrive(empty_w(prev_w));
          if (prev_h >= 0) mbar_arrive(empty_h(prev_h));
        }
        prev_w = wst;
        prev_h = tap == 8 ? hst : -1;
        if (++wst == p.w_stages) { wst = 0; wph ^= 1; }
      }
      if (++hst == 2) { hst = 0; hph ^= 1; }
    }
    wgmma_wait<0>();
    if (lane == 0) {
      mbar_arrive(empty_w(prev_w));
      mbar_arrive(empty_h(prev_h));
    }

    // epilogue: b2, ReLU, bf16; a quad swaps words so that each lane holds
    // 8 consecutive channels of one row and stores them as 16 bytes
    int64_t orow[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = cw * 64 + wq * 16 + g + 8 * h;
      const int r = m / p.HWp, c = m - r * p.HWp;
      const int t4 = ti.t4_0 + r, f4 = ti.f4_0 + c;
      orow[h] = (m < m_valid && c < p.FW && t4 < p.T4 && f4 < p.F4)
                    ? (((int64_t)ti.b * p.T4 + t4) * p.F4 + f4) * p.C : -1;
    }
#pragma unroll
    for (int jj = 0; jj < kTileN / 16; ++jj) {
      uint32_t v[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 2 * jj + h, col = ti.n0 + 8 * j + 2 * q;
        const float2 bv = col < p.C
            ? __ldg(reinterpret_cast<const float2*>(b2 + col))
            : make_float2(0.f, 0.f);
        v[2 * h] = pack_bf16(fmaxf(acc[4 * j] + bv.x, 0.f),
                             fmaxf(acc[4 * j + 1] + bv.y, 0.f));
        v[2 * h + 1] = pack_bf16(fmaxf(acc[4 * j + 2] + bv.x, 0.f),
                                 fmaxf(acc[4 * j + 3] + bv.y, 0.f));
      }
      // v[k]: row g + 8 (k & 1), channels 16 jj + 8 (k >> 1) + 2q, +1.
      // Lane q gathers word k = q from the 4 lanes of its quad.
      uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int send = (q - r) & 3, src = (q + r) & 3;
        const uint32_t sv = send == 0 ? v[0] : send == 1 ? v[1]
                            : send == 2 ? v[2] : v[3];
        const uint32_t got = __shfl_sync(0xffffffffu, sv, (lane & ~3) | src);
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = src == i ? got : w[i];
      }
      const int64_t o = orow[q & 1];
      const int co = ti.n0 + 16 * jj + 8 * (q >> 1);
      if (o >= 0 && co < p.C)
        *reinterpret_cast<uint4*>(out + o + co) =
            make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)f;
  }
  return fn;
}


// The geometry of one call; false if C % 8 != 0. The tile: FW columns
// (the fewest column tiles of at most kMaxFW, split evenly) and
// TT = kTileM / HWp rows, HWp = FW + 1.
bool make_plan(PlanTC& p, int B, int T_, int F, int C) {
  p.B = B; p.T = T_; p.F = F; p.C = C;
  p.T2 = (T_ + 1) / 2; p.F2 = (F + 1) / 2;
  p.T4 = (p.T2 + 1) / 2; p.F4 = (p.F2 + 1) / 2;
  if (C % 8 != 0) return false;
  p.tiles_f = (p.F4 + kMaxFW - 1) / kMaxFW;
  const int FW = (p.F4 + p.tiles_f - 1) / p.tiles_f;
  const int TT = kTileM / (FW + 1);
  p.TT = TT; p.FW = FW;
  p.tiles_t = (p.T4 + TT - 1) / TT;
  p.tiles_n = (C + kTileN - 1) / kTileN;
  p.n_tiles = B * p.tiles_t * p.tiles_f * p.tiles_n;
  p.n_slices = (C + kSlice - 1) / kSlice;
  p.R1 = 2 * TT + 1;
  p.HWp = FW + 1;
  p.n_pos = p.R1 * 2 * p.HWp;
  p.P32 = round_up(p.n_pos, 32);
  // a plane holds TT + 1 rows of HWp positions, and the padded M rows of
  // a tile read up to position 127 + HWp + 1
  const int rows = (TT + 1) * p.HWp, reach = kTileM + p.HWp + 1;
  p.PP = round_up(rows > reach ? rows : reach, 8);
  p.h_stage = 4 * 4 * p.PP * 16;
  const int a1_bytes = p.P32 * 32, tab_bytes = p.P32 * 4;
  const int bar_bytes = 8 * (2 * kMaxWStages + 4);
  const int rest = 1024 + 2 * p.h_stage + a1_bytes + tab_bytes + bar_bytes;
  p.w_stages = (kSmemLimit - rest) / kWStage;
  if (p.w_stages > kMaxWStages) p.w_stages = kMaxWStages;
  if (p.w_stages < 2) return false;
  p.off_h = p.w_stages * kWStage;
  p.off_a1 = p.off_h + 2 * p.h_stage;
  p.off_tab = p.off_a1 + a1_bytes;
  p.off_bar = p.off_tab + tab_bytes;
  p.smem = 1024 + p.off_bar + bar_bytes;
  return true;
}

int device_sms(int* n_sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceGetAttribute(n_sms, cudaDevAttrMultiProcessorCount,
                                     dev);
}

int launch_wgmma(const void* x, const void* w1, const void* b1,
                 const void* w2p, const void* b2, void* out, int B, int T_,
                 int F, int C, cudaStream_t stream) {
  int n_sms = 0;
  int e = device_sms(&n_sms);
  if (e != 0) return e;
  PlanTC p;
  if (!make_plan(p, B, T_, F, C)) return (int)cudaErrorInvalidValue;
  // the attribute holds for the function on the current device: set it at
  // the first launch there; the register count is checked then too, since
  // setmaxnreg's hand-over needs the block to start with 168 a thread
  static std::atomic<uint64_t> set_on{0};  // bit i: set on device i
  int dev = 0;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce != cudaSuccess) return (int)ce;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!(set_on.load() >> dev & 1)) {
    cudaFuncAttributes attr;
    ce = cudaFuncGetAttributes(&attr, fused_frontend_wgmma_kernel);
    if (ce != cudaSuccess) return (int)ce;
    if (attr.numRegs != kLaunchRegs) return (int)cudaErrorInvalidKernelImage;
    ce = cudaFuncSetAttribute(fused_frontend_wgmma_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmemLimit);
    if (ce != cudaSuccess) return (int)ce;
    set_on.fetch_or(uint64_t{1} << dev);
  }
  EncodeTiledFn enc = encode_fn();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  // w2 packed (9, Cout, Cin): dims innermost first; one box is one tap's
  // 32 input x 256 output channels, zero filled past C
  CUtensorMap map;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)C, 9};
  const cuuint64_t strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)C * C * 2};
  const cuuint32_t box[3] = {kSlice, kTileN, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  CUresult r = enc(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                   const_cast<void*>(w2p), dims, strides, box, estr,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  const int grid = p.n_tiles < n_sms ? p.n_tiles : n_sms;
  fused_frontend_wgmma_kernel<<<grid, kTcThreads, p.smem, stream>>>(
      map, static_cast<const __nv_bfloat16*>(x),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(b2), static_cast<__nv_bfloat16*>(out), p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (w2 as (9, Cin, Cout)), 1 = bfloat16 (w2 packed
// (9, Cout, Cin), C % 8 == 0). Returns cudaGetLastError() after the launch.
extern "C" int cassnat_fused_conv_frontend(const void* x, const void* w1,
                                           const void* b1, const void* w2,
                                           const void* b2, void* out, int B,
                                           int T, int F, int C, int dtype,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || T < 1 || F < 1 || C < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch(x, w1, b1, w2, b2, out, B, T, F, C, s);
  if (dtype == 1)
    return launch_wgmma(x, w1, b1, w2, b2, out, B, T, F, C, s);
  return (int)cudaErrorInvalidValue;
}

// The bf16 route's plan for one call, for logs: out[0..11] = TT, FW,
// tile positions, tile channels, slice channels, grid, threads, dynamic
// shared memory bytes, w2 stages, h1 stage bytes, tiles, window positions.
// Returns 0, or cudaErrorInvalidValue if C % 8 != 0.
extern "C" int cassnat_fused_frontend_plan(int B, int T, int F, int C,
                                           int* out) {
  int n_sms = 0;
  int e = device_sms(&n_sms);
  if (e != 0) return e;
  PlanTC p;
  if (!make_plan(p, B, T, F, C)) return (int)cudaErrorInvalidValue;
  const int vals[12] = {p.TT, p.FW, kTileM, kTileN, kSlice,
                        p.n_tiles < n_sms ? p.n_tiles : n_sms, kTcThreads,
                        p.smem, p.w_stages, p.h_stage, p.n_tiles, p.n_pos};
  for (int i = 0; i < 12; ++i) out[i] = vals[i];
  return 0;
}
