// Fused conformer encoder layer for sm_90a: four kernels, each with a plain
// C entry bound by ctypes (kernels/conformer_layer.py).
//
// Replaces cassnat_asr_public_tpu/kernels/conformer_layer.py:
//   half_a         <- _layer_half_a_kernel :78  (conformer_layer_fused :225)
//   half_b         <- _layer_half_b_kernel :163 (both variants)
//   half_a_kv      <- _half_a_kv_kernel :322    (conformer_layer_fused_qblocked
//   half_a_qblock  <- _half_a_qblock_kernel :348  :411)
//
// What bounds them. One layer at B=32, T'=184, D=512, F=1024 is ~49 GFLOP of
// products (half A 27.2, half B 21.8) against ~15 MB of activations and
// 7.9 MB of bf16 weights, so on the H100 the bound is arithmetic
// (~0.05 ms in bf16 at 989 TFLOP/s). The TPU kernels keep one batch row's
// whole (T, D) residual stream and every weight in VMEM; on the H100 a block
// has at most 227 KB of shared memory (one row's f32 residual alone is
// 377 KB), so the design here tiles the rows and streams weight tiles:
//
// * half_a, half_b and half_a_kv are persistent cooperative kernels: one
//   launch each, every block resident (cudaLaunchCooperativeKernel sizes the
//   grid by occupancy), walking the phases of the layer with a grid-wide
//   barrier between phases. Inside a phase the blocks share out its work
//   items: output tiles of a product, rows of a LayerNorm (one warp a row,
//   16-byte loads), attention items, (batch, 64-frame, 64-channel)
//   depthwise tiles. Intermediates (LayerNorm outputs, FFN hidden, q/k/v,
//   context, pointwise-1 output, depthwise output) go to a scratch buffer in
//   device memory (its size per kernel is printed by chip_smoke.py phase 2;
//   at the LibriSpeech shape those of half_a and half_b exceed the 50 MB
//   L2); each scratch array is written by one phase of a launch and read by
//   later ones through L2 (ld.global.cg, cp.async.cg or TMA), so no L1 line
//   can be stale.
// * bf16 half_a and half_b (the decode path) run 384 threads, one block an
//   SM (section "bf16 route" below): every product on wgmma with both
//   operands by TMA through a ring of swizzled stages, a producer warp and
//   two consumer warpgroups, the epilogue in registers; attention on
//   mma.sync with one (batch, head, 192-query) item per block.
// * f32 (all four kernels) and the bf16 q-blocked pair (half_a_kv,
//   half_a_qblock) run 256 threads, two blocks an SM: products on 128x64
//   (bf16, WMMA 16x16x16, two cp.async stages) or 64x64 (f32, CUDA cores)
//   tiles staged through an f32 tile in shared memory; attention in items
//   of 16 queries that read the head's K/V from scratch in 16-key chunks.
// * The three dependencies that span a whole row cross the tiles so:
//   attention reads the row's whole K/V; the depthwise conv's (K-1)-frame
//   halo is read from the pointwise-1 output in scratch (GLU applied on the
//   load, zero outside [0, T) as SAME padding); the GroupNorm(1) statistics
//   are per-tile partial sums written to scratch and summed in a fixed order
//   after a barrier, first the mean, then after a second barrier the mean
//   squared deviation.
// * half_a_qblock is an ordinary launch with one block per (q block of tq
//   rows, batch row), as the Pallas grid (b, nq): q projection, attention of
//   its rows over the row's whole K/V (written by half_a_kv), output
//   projection. Rows past T in the last block are never written.
// * Launches per layer: 2 (half_a, half_b) or 3 (half_a_kv, half_a_qblock,
//   half_b), plus one 4-byte memset of the barrier counter per cooperative
//   launch.
//
// Products accumulate in f32 (bf16 on the tensor cores; f32 on the CUDA
// cores in true f32, no TF32). Operands are rounded to the compute type
// where the TPU kernels round them: the inputs of every product, q+u and
// q+v, the attention weights, the half outputs and the stage-1 outputs of
// the q-blocked variant; x1, x2 and the pointwise-1 output stay f32.
// Attention heads of any dk up to 128 are zero-padded to a multiple of 16
// in shared memory (dk = 36 -> 48). LayerNorm: Bessel variance,
// sqrt(var + 1e-12) + 1e-6. Fully-masked rows get zero weights.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <cmath>
#include <initializer_list>
#include <type_traits>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int NT = 256;            // threads per block
constexpr int NW = NT / 32;        // warps per block
constexpr int BN = 64, BK = 32;   // product tile columns and depth
constexpr int LDC = BN + 4;        // f32 staging tile row stride
constexpr int QT = 16;             // query rows per attention item
constexpr int DT = 64;             // depthwise tile: frames and channels
constexpr int MAX_DK = 128;
constexpr int MAX_KERNEL = 65;
constexpr float MASK_MIN = -1e9f;
constexpr size_t SMEM_LIMIT = 232448;

enum Ptr {
  P_X, P_MASKF, P_NORMS, P_W1A, P_B1A, P_W2A, P_B2A, P_WQKV, P_BQKV, P_WO,
  P_BO, P_POS, P_UBIAS, P_W1B, P_B1B, P_W2B, P_B2B, P_PW1, P_PW1B, P_DW,
  P_DWB, P_PW2, P_PW2B, P_X1, P_LN, P_K, P_V, P_OUT, P_SCRATCH, P_COUNT
};
const char* const PTR_NAMES =
    "x,maskf,norms,w1a,b1a,w2a,b2a,wqkv,bqkv,wo,bo,pos,ubias,w1b,b1b,w2b,"
    "b2b,pw1,pw1b,dw,dwb,pw2,pw2b,x1,ln,k,v,out,scratch";

enum Kind { HALF_A = 0, HALF_B = 1, HALF_A_KV = 2, HALF_A_QBLOCK = 3 };

struct Args {
  int B, T, D, F, H, dk, K, P, r, tq;
  float inv_sqrt_dk;
  const void* p[P_COUNT];
};

// ---------------------------------------------------------------- numerics

__device__ __forceinline__ float tof(float x) { return x; }
__device__ __forceinline__ float tof(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T fromf(float x);
template <> __device__ __forceinline__ float fromf<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 fromf<bf16>(float x) {
  return __float2bfloat16(x);
}
// loads of data written earlier in the same launch: bypass L1 (.cg)
__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ldcg(const bf16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ float sigm(float x) {
  return 1.f / (1.f + expf(-x));
}
// sigmoid for results rounded to T: bf16 takes the fast exponential and
// division (a few f32 ulps, far below a bf16 step; exp(-x) = inf gives 0)
template <typename T> __device__ __forceinline__ float sigm_t(float x) {
  if constexpr (std::is_same<T, bf16>::value)
    return __fdividef(1.f, 1.f + __expf(-x));
  return sigm(x);
}
__device__ __forceinline__ float swish_fast(float y) {
  return __fdividef(y, 1.f + __expf(-y));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 16-byte global -> shared copy that bypasses L1; zero-fills when !full
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 16 : 0));
}
// 4-byte global -> shared copy; zero-fills when !full
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int cdiv_c(int a, int b) {
  return (a + b - 1) / b;
}
__host__ __device__ inline size_t align_up(size_t n, size_t a) {
  return (n + a - 1) / a * a;
}

// Bump allocator over a byte range; with base == nullptr it only measures.
struct Carver {
  unsigned char* base;
  size_t off;
  template <typename X>
  __host__ __device__ X* take(size_t n) {
    off = align_up(off, 256);
    X* out = reinterpret_cast<X*>(base + off);
    off += n * sizeof(X);
    return out;
  }
};

// ------------------------------------------------------------ scratch maps

template <typename T>
struct Scratch {
  unsigned int* bar;
  T *h, *m, *ln, *qu, *qv, *k, *v, *ctx, *gs, *h2, *m2;
  float *x1, *pw, *acc, *part, *x2;
};

template <typename T>
__host__ __device__ Scratch<T> carve(int kind, const Args& a,
                                     unsigned char* base, size_t* bytes) {
  Scratch<T> s = {};
  Carver c{base, 0};
  const size_t M = (size_t)a.B * a.T, D = a.D, F = a.F;
  if (kind != HALF_A_QBLOCK) s.bar = c.take<unsigned int>(1);
  if (kind == HALF_A || kind == HALF_A_KV) {
    s.h = c.take<T>(M * D);
    s.m = c.take<T>(M * F);
    s.x1 = c.take<float>(M * D);
  }
  if (kind == HALF_A) s.ln = c.take<T>(M * D);
  if (kind == HALF_A || kind == HALF_A_QBLOCK) {
    s.qu = c.take<T>(M * D);
    s.qv = c.take<T>(M * D);
    s.ctx = c.take<T>(M * D);
  }
  if (kind == HALF_A) {
    s.k = c.take<T>(M * D);
    s.v = c.take<T>(M * D);
  }
  if (kind == HALF_B) {
    const int ntile = cdiv(a.T, DT) * cdiv(a.D, DT);
    s.h = c.take<T>(M * D);
    s.pw = c.take<float>(M * 2 * D);
    s.acc = c.take<float>(M * D);
    s.part = c.take<float>((size_t)2 * a.B * ntile);
    s.gs = c.take<T>(M * D);
    s.x2 = c.take<float>(M * D);
    s.h2 = c.take<T>(M * D);
    s.m2 = c.take<T>(M * F);
  }
  if (bytes) *bytes = c.off;
  return s;
}

// ------------------------------------------------------- shared memory maps

// Product tiles: bf16 128 x 64 (8 warps of 32 x 32, two stages of A/B in
// flight by cp.async), f32 64 x 64 (a 4 x 4 block per thread). The f32
// staging tile of the epilogue overlays the A/B stages.
template <typename T>
struct GemmLayout {
  static constexpr bool MMA = std::is_same<T, bf16>::value;
  static constexpr int V = 16 / sizeof(T);     // elements per 16 bytes
  static constexpr int TM = MMA ? 128 : 64;    // tile rows
  static constexpr int STAGES = MMA ? 2 : 1;
  static constexpr int LDA = BK + V;
  static constexpr int LDB = BN + V;
  static constexpr size_t A_BYTES = (TM * LDA * sizeof(T) + 127) / 128 * 128;
  static constexpr size_t B_BYTES = (BK * LDB * sizeof(T) + 127) / 128 * 128;
  static constexpr size_t OFF_B = STAGES * A_BYTES;
  static constexpr size_t AB_BYTES = OFF_B + STAGES * B_BYTES;
  static constexpr size_t OFF_C = MMA ? 0 : AB_BYTES;
  static constexpr size_t C_BYTES = TM * LDC * sizeof(float);
  static constexpr size_t BYTES =
      MMA ? (AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES) : AB_BYTES + C_BYTES;
};

struct AttnLayout {
  size_t qu, qv, pos, stage, s, w, small, red, bytes;
  int dkp, tp, pp;
};

template <typename T>
__host__ __device__ AttnLayout attn_layout(int T_, int dk, int P) {
  AttnLayout L;
  const bool mma = std::is_same<T, bf16>::value;
  L.dkp = mma ? (dk + 15) / 16 * 16 : dk;
  L.tp = (T_ + 15) / 16 * 16;
  L.pp = mma ? (P + 15) / 16 * 16 : P;
  Carver c{nullptr, 0};
  L.qu = (size_t)c.take<T>(QT * L.dkp);
  L.qv = (size_t)c.take<T>(QT * L.dkp);
  L.pos = (size_t)c.take<T>((size_t)L.pp * L.dkp);
  L.stage = (size_t)c.take<T>(mma ? NW * 16 * L.dkp : 0);
  L.s = (size_t)c.take<float>((size_t)QT * L.tp);
  L.w = (size_t)c.take<T>(mma ? (size_t)QT * L.tp : 0);
  L.small = (size_t)c.take<float>(QT * L.pp);
  L.red = (size_t)c.take<float>(mma ? NW * QT * L.dkp : 0);
  L.bytes = c.off;
  return L;
}

template <typename T>
size_t smem_bytes(int kind, const Args& a) {
  size_t n = GemmLayout<T>::BYTES;
  if (kind == HALF_A || kind == HALF_A_QBLOCK) {
    size_t at = attn_layout<T>(a.T, a.dk, a.P).bytes;
    n = at > n ? at : n;
  }
  if (kind == HALF_B) {
    size_t dw = (size_t)(DT + a.K - 1) * DT * sizeof(float);
    size_t gn = (size_t)2 * a.B * sizeof(float) + 256;
    n = dw > n ? dw : n;
    n = gn > n ? gn : n;
  }
  return n;
}

// ------------------------------------------------------------ grid barrier

__device__ __forceinline__ uint64_t globaltimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// All blocks are resident (cooperative launch), so a counter that every
// block bumps once per barrier and then waits on is safe. The counter is
// zeroed by a memset before each launch. Every thread's generic writes are
// fenced against the async proxy first: the bf16 route's TMA reads, in the
// next phases, what this one stored, and its TMA writes reuse the shared
// memory this one used. A wait that lasts 10 s (a fault) traps instead of
// hanging the card.
__device__ __forceinline__ void grid_sync(unsigned int* bar,
                                          unsigned int& target) {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  target += gridDim.x;
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    const uint64_t t0 = globaltimer();
    while (*reinterpret_cast<volatile unsigned int*>(bar) < target) {
      __nanosleep(32);
      if (globaltimer() - t0 > 10000000000ull) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// ---------------------------------------------------------------- products

// One TM x BN tile of A (M x K, row stride lda) times W (K x N, row stride
// ldw), both in T, accumulated in f32 into the staging tile Cs. Rows past M,
// columns past N and depth past K read as zero. K and N are multiples of
// 16 / sizeof(T) and the rows 16-byte aligned (the wrapper checks).
template <typename T>
__device__ void gemm_tile(const T* A, int lda, const T* W, int ldw, int M,
                          int N, int K, int m0, int n0, unsigned char* smem) {
  typedef GemmLayout<T> L;
  constexpr int V = L::V;
  T* As = reinterpret_cast<T*>(smem);
  float* Cs = reinterpret_cast<float*>(smem + L::OFF_C);
  const int tid = threadIdx.x;

  if constexpr (L::MMA) {
    // stage s of A (TM x BK) and B (BK x BN) for depth k0, by cp.async;
    // rows past M, columns past N and depth past K are zero-filled
    auto load_stage = [&](int st, int k0) {
      T* as = As + st * (L::A_BYTES / sizeof(T));
      T* bs = reinterpret_cast<T*>(smem + L::OFF_B + st * L::B_BYTES);
      for (int i = tid; i < L::TM * BK / V; i += NT) {
        const int r = i / (BK / V), c = (i % (BK / V)) * V;
        const bool ok = m0 + r < M && k0 + c < K;
        cp_async16(as + r * L::LDA + c,
                   ok ? A + (size_t)(m0 + r) * lda + k0 + c : A, ok);
      }
      for (int i = tid; i < BK * BN / V; i += NT) {
        const int r = i / (BN / V), c = (i % (BN / V)) * V;
        const bool ok = k0 + r < K && n0 + c < N;
        cp_async16(bs + r * L::LDB + c,
                   ok ? W + (size_t)(k0 + r) * ldw + n0 + c : W, ok);
      }
      cp_async_commit();
    };
    const int warp = tid / 32;
    const int wr = (warp / 2) * 32, wc = (warp % 2) * 32;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    const int nk = cdiv(K, BK);
    load_stage(0, 0);
    for (int kt = 0; kt < nk; ++kt) {
      if (kt + 1 < nk) {
        load_stage((kt + 1) & 1, (kt + 1) * BK);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const T* as = As + (kt & 1) * (L::A_BYTES / sizeof(T));
      const T* bs =
          reinterpret_cast<const T*>(smem + L::OFF_B + (kt & 1) * L::B_BYTES);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
            fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
            fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], as + (wr + i * 16) * L::LDA + kk,
                                 L::LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], bs + kk * L::LDB + wc + j * 16,
                                 L::LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (wr + i * 16) * LDC + wc + j * 16,
                                acc[i][j], LDC, wmma::mem_row_major);
  } else {
    T* Bs = reinterpret_cast<T*>(smem + L::OFF_B);
    const uint4 zero = make_uint4(0, 0, 0, 0);
    const int tr = tid / 16, tc = tid % 16;
    float acc[4][4] = {};
    for (int k0 = 0; k0 < K; k0 += BK) {
      for (int i = tid; i < L::TM * BK / V; i += NT) {
        const int r = i / (BK / V), c = (i % (BK / V)) * V;
        uint4 val = zero;
        if (m0 + r < M && k0 + c < K)
          val = __ldcg(reinterpret_cast<const uint4*>(
              A + (size_t)(m0 + r) * lda + k0 + c));
        *reinterpret_cast<uint4*>(As + r * L::LDA + c) = val;
      }
      for (int i = tid; i < BK * BN / V; i += NT) {
        const int r = i / (BN / V), c = (i % (BN / V)) * V;
        uint4 val = zero;
        if (k0 + r < K && n0 + c < N)
          val = *reinterpret_cast<const uint4*>(
              W + (size_t)(k0 + r) * ldw + n0 + c);
        *reinterpret_cast<uint4*>(Bs + r * L::LDB + c) = val;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        float av[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = tof(As[(tr * 4 + i) * L::LDA + kk]);
        const float4 bv =
            *reinterpret_cast<const float4*>(Bs + kk * L::LDB + tc * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] = fmaf(av[i], bv.x, acc[i][0]);
          acc[i][1] = fmaf(av[i], bv.y, acc[i][1]);
          acc[i][2] = fmaf(av[i], bv.z, acc[i][2]);
          acc[i][3] = fmaf(av[i], bv.w, acc[i][3]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Cs[(tr * 4 + i) * LDC + tc * 4 + j] = acc[i][j];
  }
  __syncthreads();
}

// All output tiles of one product, shared out as tiles first, first+stride,
// ...; epi(row, col, acc) writes each element.
template <typename T, class Epi>
__device__ void gemm_phase(const T* A, int lda, const T* W, int ldw, int M,
                           int N, int K, unsigned char* smem, int first,
                           int stride, Epi epi) {
  typedef GemmLayout<T> L;
  const float* Cs = reinterpret_cast<const float*>(smem + L::OFF_C);
  const int tn = cdiv(N, BN), ntiles = cdiv(M, L::TM) * tn;
  for (int t = first; t < ntiles; t += stride) {
    const int m0 = (t / tn) * L::TM, n0 = (t % tn) * BN;
    gemm_tile<T>(A, lda, W, ldw, M, N, K, m0, n0, smem);
    for (int i = threadIdx.x; i < L::TM * BN; i += NT) {
      const int r = i / BN, c = i % BN;
      if (m0 + r < M && n0 + c < N) epi(m0 + r, n0 + c, Cs[r * LDC + c]);
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------- LayerNorm

// 16 bytes at p (ld.global.cg) as floats: 4 f32 or 8 bf16
__device__ __forceinline__ void ld16(const float* p, float* v) {
  const float4 q = __ldcg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void ld16(const bf16* p, float* v) {
  const uint4 q = __ldcg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
// E consecutive values to T at p (E * sizeof(T) = 8 or 16 bytes)
template <int E>
__device__ __forceinline__ void st_vec(float* p, const float* v) {
#pragma unroll
  for (int i = 0; i < E; i += 4)
    *reinterpret_cast<float4*>(p + i) =
        make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}
template <int E>
__device__ __forceinline__ void st_vec(bf16* p, const float* v) {
  uint32_t w[E / 2];
#pragma unroll
  for (int i = 0; i < E / 2; ++i) {
    __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<uint32_t*>(&h);
  }
  if constexpr (E == 8)
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  else
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
}

// y = scale * (x - mean) / (sqrt(var_bessel + 1e-12) + 1e-6) + bias, one
// warp per row, 16 bytes of the row a lane per load (D % 8 == 0).
// Rows of up to 512 values are read once into registers, four rows a warp
// at a time with every load issued before the first sum (the phase is
// bound by the latency of those loads); longer rows are read three times.
// Optionally also writes x rounded to T (x_out).
template <typename TI, typename T>
__device__ void layernorm_rows(const TI* x, T* y, const float* scale,
                               const float* bias, int M, int D, T* x_out) {
  constexpr int E = 16 / sizeof(TI), NV = 512 / (32 * E), R = 4;
  const int lane = threadIdx.x % 32, nw = blockDim.x / 32;
  const int stride = gridDim.x * nw;
  const float bessel = (float)((double)D / (D > 1 ? D - 1 : 1));
  if (D <= 32 * E * NV) {
    for (int row0 = blockIdx.x * nw + threadIdx.x / 32; row0 < M;
         row0 += R * stride) {
      float v[R][NV][E];
#pragma unroll
      for (int q = 0; q < R; ++q)
#pragma unroll
        for (int k = 0; k < NV; ++k) {
          const int c = (k * 32 + lane) * E, row = row0 + q * stride;
          if (c < D && row < M) ld16(x + (size_t)row * D + c, v[q][k]);
        }
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int row = row0 + q * stride;
        if (row >= M) break;
        float sm = 0.f;
#pragma unroll
        for (int k = 0; k < NV; ++k)
          if ((k * 32 + lane) * E < D)
#pragma unroll
            for (int e = 0; e < E; ++e) sm += v[q][k][e];
        const float mean = warp_sum(sm) / D;
        float ss = 0.f;
#pragma unroll
        for (int k = 0; k < NV; ++k)
          if ((k * 32 + lane) * E < D)
#pragma unroll
            for (int e = 0; e < E; ++e)
              ss += (v[q][k][e] - mean) * (v[q][k][e] - mean);
        const float var = warp_sum(ss) / D * bessel;
        const float den = sqrtf(var + 1e-12f) + 1e-6f;
#pragma unroll
        for (int k = 0; k < NV; ++k) {
          const int c = (k * 32 + lane) * E;
          if (c >= D) continue;
          float o[E];
#pragma unroll
          for (int e = 0; e < E; ++e)
            o[e] = scale[c + e] * (v[q][k][e] - mean) / den + bias[c + e];
          st_vec<E>(y + (size_t)row * D + c, o);
          if (x_out) st_vec<E>(x_out + (size_t)row * D + c, v[q][k]);
        }
      }
    }
    return;
  }
  for (int row = blockIdx.x * nw + threadIdx.x / 32; row < M; row += stride) {
    const TI* xr = x + (size_t)row * D;
    float v[E];
    float sm = 0.f;
    for (int c = lane * E; c < D; c += 32 * E) {
      ld16(xr + c, v);
#pragma unroll
      for (int e = 0; e < E; ++e) sm += v[e];
    }
    const float mean = warp_sum(sm) / D;
    float ss = 0.f;
    for (int c = lane * E; c < D; c += 32 * E) {
      ld16(xr + c, v);
#pragma unroll
      for (int e = 0; e < E; ++e) ss += (v[e] - mean) * (v[e] - mean);
    }
    const float var = warp_sum(ss) / D * bessel;
    const float den = sqrtf(var + 1e-12f) + 1e-6f;
    for (int c = lane * E; c < D; c += 32 * E) {
      ld16(xr + c, v);
      float o[E];
#pragma unroll
      for (int e = 0; e < E; ++e)
        o[e] = scale[c + e] * (v[e] - mean) / den + bias[c + e];
      st_vec<E>(y + (size_t)row * D + c, o);
      if (x_out) st_vec<E>(x_out + (size_t)row * D + c, v);
    }
  }
}

// ------------------------------------------------------------- attention

// 16 rows of one head into a 16 x ldd tile: dst row i <- src row
// row0 + r0 + i (zero when r0 + i >= r_end), columns col0..col0+dk (zero
// past dk, up to ldd); 8-byte loads when dk allows, bypassing L1.
template <typename T>
__device__ __forceinline__ void load_head_rows(T* dst, int ldd, const T* src,
                                               size_t row0, int r0, int r_end,
                                               int D, int col0, int dk,
                                               int tid, int nthr) {
  constexpr int E = 8 / sizeof(T);
  if (dk % E == 0) {
    const int nv = ldd / E;
    for (int i = tid; i < 16 * nv; i += nthr) {
      const int r = i / nv, d = (i % nv) * E;
      uint2 v = make_uint2(0u, 0u);
      if (r0 + r < r_end && d < dk)
        v = __ldcg(reinterpret_cast<const uint2*>(
            src + (row0 + r0 + r) * D + col0 + d));
      *reinterpret_cast<uint2*>(dst + r * ldd + d) = v;
    }
  } else {
    for (int i = tid; i < 16 * ldd; i += nthr) {
      const int r = i / ldd, d = i % ldd;
      dst[i] = (r0 + r < r_end && d < dk)
                   ? fromf<T>(ldcg(src + (row0 + r0 + r) * D + col0 + d))
                   : fromf<T>(0.f);
    }
  }
}

// Relative-position attention of query rows q0..q0+nq-1 (nq <= QT) of batch
// row b, head h, over all T keys: scores (q+u).k and the compact (q+v).p
// table, expanded by the clamped offset k - q, masked, softmax with zero
// weights for fully-masked rows, weights rounded to T, times V. qu, qv, k,
// v and ctx are (B*T, D) row-major.
template <typename T>
__device__ void attention_item(const Args& a, const T* qu, const T* qv,
                               const T* kk, const T* vv, T* ctx, int b, int h,
                               int q0, int nq, unsigned char* smem) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int T_ = a.T, D = a.D, dk = a.dk, P = a.P;
  const AttnLayout L = attn_layout<T>(T_, dk, P);
  const int dkp = L.dkp, tp = L.tp, pp = L.pp;
  T* qu_s = reinterpret_cast<T*>(smem + L.qu);
  T* qv_s = reinterpret_cast<T*>(smem + L.qv);
  T* pos_s = reinterpret_cast<T*>(smem + L.pos);
  float* s_s = reinterpret_cast<float*>(smem + L.s);
  float* small_s = reinterpret_cast<float*>(smem + L.small);
  const T* pos = reinterpret_cast<const T*>(a.p[P_POS]);
  const float* maskf = reinterpret_cast<const float*>(a.p[P_MASKF]) +
                       (size_t)b * T_;
  const size_t row0 = (size_t)b * T_;
  const int col0 = h * dk;

  load_head_rows<T>(qu_s, dkp, qu, row0, q0, q0 + nq, D, col0, dk, tid, NT);
  load_head_rows<T>(qv_s, dkp, qv, row0, q0, q0 + nq, D, col0, dk, tid, NT);
  for (int i = tid; i < pp * dkp; i += NT) {
    const int o = i / dkp, d = i % dkp;
    pos_s[i] =
        (o < P && d < dk) ? pos[(size_t)o * D + col0 + d] : fromf<T>(0.f);
  }
  __syncthreads();

  if constexpr (std::is_same<T, bf16>::value) {
    T* stage = reinterpret_cast<T*>(smem + L.stage) + warp * 16 * dkp;
    // compact table: small = qv . pos^T, one 16-column block per warp
    for (int c = warp; c < pp / 16; c += NW) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int d = 0; d < dkp; d += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, qv_s + d, dkp);
        wmma::load_matrix_sync(fb, pos_s + c * 16 * dkp + d, dkp);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(small_s + c * 16, acc, pp, wmma::mem_row_major);
    }
    // scores = qu . k^T, one 16-key chunk at a time per warp
    for (int c = warp; c < tp / 16; c += NW) {
      load_head_rows<T>(stage, dkp, kk, row0, c * 16, T_, D, col0, dk, lane,
                        32);
      __syncwarp();
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int d = 0; d < dkp; d += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, qu_s + d, dkp);
        wmma::load_matrix_sync(fb, stage + d, dkp);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(s_s + c * 16, acc, tp, wmma::mem_row_major);
      __syncwarp();
    }
  } else {
    for (int i = tid; i < QT * P; i += NT) {
      const int r = i / P, o = i % P;
      float acc = 0.f;
      for (int d = 0; d < dk; ++d)
        acc = fmaf(tof(qv_s[r * dkp + d]), tof(pos_s[o * dkp + d]), acc);
      small_s[r * pp + o] = acc;
    }
    for (int i = tid; i < nq * T_; i += NT) {
      const int r = i / T_, key = i % T_;
      const T* kr = kk + (row0 + key) * D + col0;
      float acc = 0.f;
      for (int d = 0; d < dk; ++d)
        acc = fmaf(tof(qu_s[r * dkp + d]), ldcg(kr + d), acc);
      s_s[r * tp + key] = acc;
    }
  }
  __syncthreads();

  // masked softmax per query row (one warp per row); weights rounded to T
  T* w_s = std::is_same<T, bf16>::value
               ? reinterpret_cast<T*>(smem + L.w)
               : reinterpret_cast<T*>(s_s);
  const float inv = a.inv_sqrt_dk;
  for (int r = warp; r < QT; r += NW) {
    float* srow = s_s + r * tp;
    T* wrow = w_s + r * tp;
    if (r >= nq) {
      for (int key = lane; key < tp; key += 32) wrow[key] = fromf<T>(0.f);
      continue;
    }
    const int qi = q0 + r;
    float mx = -INFINITY;
    for (int key = lane; key < T_; key += 32) {
      int off = key - qi;
      off = (off < -a.r ? -a.r : (off > a.r ? a.r : off)) + a.r;
      float s = srow[key] * inv + small_s[r * pp + off] * inv;
      if (!(maskf[key] > 0.5f)) s = MASK_MIN;
      srow[key] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int key = lane; key < T_; key += 32) {
      const float e = maskf[key] > 0.5f ? expf(srow[key] - mx) : 0.f;
      srow[key] = e;
      sum += e;
    }
    const float den = fmaxf(warp_sum(sum), 1e-30f);
    __syncwarp();
    for (int key = lane; key < tp; key += 32)
      wrow[key] = fromf<T>(key < T_ ? srow[key] / den : 0.f);
  }
  __syncthreads();

  if constexpr (std::is_same<T, bf16>::value) {
    // ctx = w . v: each warp sums its 16-key chunks, then the warps' partial
    // sums are added in a fixed order
    T* stage = reinterpret_cast<T*>(smem + L.stage) + warp * 16 * dkp;
    float* red = reinterpret_cast<float*>(smem + L.red);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MAX_DK / 16];
    const int nf = dkp / 16;
#pragma unroll
    for (int j = 0; j < MAX_DK / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
    for (int c = warp; c < tp / 16; c += NW) {
      load_head_rows<T>(stage, dkp, vv, row0, c * 16, T_, D, col0, dk, lane,
                        32);
      __syncwarp();
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, w_s + c * 16, tp);
#pragma unroll
      for (int j = 0; j < MAX_DK / 16; ++j) {
        if (j < nf) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
              fb;
          wmma::load_matrix_sync(fb, stage + j * 16, dkp);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
      __syncwarp();
    }
#pragma unroll
    for (int j = 0; j < MAX_DK / 16; ++j)
      if (j < nf)
        wmma::store_matrix_sync(red + warp * QT * dkp + j * 16, acc[j], dkp,
                                wmma::mem_row_major);
    __syncthreads();
    for (int i = tid; i < nq * dk; i += NT) {
      const int r = i / dk, d = i % dk;
      float s = 0.f;
      for (int w = 0; w < NW; ++w) s += red[w * QT * dkp + r * dkp + d];
      ctx[(row0 + q0 + r) * D + col0 + d] = fromf<T>(s);
    }
  } else {
    for (int i = tid; i < nq * dk; i += NT) {
      const int r = i / dk, d = i % dk;
      const T* vc = vv + row0 * D + col0 + d;
      float acc = 0.f;
      for (int key = 0; key < T_; ++key)
        acc = fmaf(tof(w_s[r * tp + key]), ldcg(vc + (size_t)key * D), acc);
      ctx[(row0 + q0 + r) * D + col0 + d] = fromf<T>(acc);
    }
  }
  __syncthreads();
}

// --------------------------------------------------------------- kernels

#define ARG(T, i) reinterpret_cast<const T*>(a.p[i])
#define OUT(T, i) reinterpret_cast<T*>(const_cast<void*>(a.p[i]))

// Pointer P_K/P_V hold k/v for the q-blocked stage 2 and receive them in
// stage 1; half_a keeps them in scratch.
template <typename T>
__device__ void ffn1_phases(const Args& a, Scratch<T>& s, unsigned char* smem,
                            unsigned int& target) {
  const int M = a.B * a.T, D = a.D, F = a.F;
  const T* x = ARG(T, P_X);
  const float* norms = ARG(float, P_NORMS);
  const float* b1 = ARG(float, P_B1A);
  const float* b2 = ARG(float, P_B2A);
  layernorm_rows<T, T>(x, s.h, norms, norms + D, M, D, (T*)nullptr);
  grid_sync(s.bar, target);
  gemm_phase<T>(s.h, D, ARG(T, P_W1A), F, M, F, D, smem, blockIdx.x,
                gridDim.x, [&](int row, int col, float v) {
                  const float y = v + b1[col];
                  s.m[(size_t)row * F + col] = fromf<T>(y * sigm(y));
                });
  grid_sync(s.bar, target);
  gemm_phase<T>(s.m, F, ARG(T, P_W2A), D, M, D, F, smem, blockIdx.x,
                gridDim.x, [&](int row, int col, float v) {
                  const size_t i = (size_t)row * D + col;
                  s.x1[i] = tof(x[i]) + 0.5f * (v + b2[col]);
                });
  grid_sync(s.bar, target);
}

template <typename T>
__global__ void __launch_bounds__(NT, 2) half_a_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  Scratch<T> s = carve<T>(HALF_A, a, OUT(unsigned char, P_SCRATCH), nullptr);
  unsigned int target = 0;
  const int M = a.B * a.T, D = a.D;
  const float* norms = ARG(float, P_NORMS);
  const float* bqkv = ARG(float, P_BQKV);
  const float* ub = ARG(float, P_UBIAS);
  const float* bo = ARG(float, P_BO);
  T* out = OUT(T, P_OUT);

  ffn1_phases<T>(a, s, smem, target);
  layernorm_rows<float, T>(s.x1, s.ln, norms + 2 * D, norms + 3 * D, M, D,
                           (T*)nullptr);
  grid_sync(s.bar, target);
  gemm_phase<T>(s.ln, D, ARG(T, P_WQKV), 3 * D, M, 3 * D, D, smem,
                blockIdx.x, gridDim.x, [&](int row, int col, float v) {
                  const float y = v + bqkv[col];
                  const int seg = col >= 2 * D ? 2 : (col >= D ? 1 : 0), c = col - seg * D;
                  const size_t i = (size_t)row * D + c;
                  if (seg == 0) {
                    s.qu[i] = fromf<T>(y + ub[c]);
                    s.qv[i] = fromf<T>(y + ub[D + c]);
                  } else if (seg == 1) {
                    s.k[i] = fromf<T>(y);
                  } else {
                    s.v[i] = fromf<T>(y);
                  }
                });
  grid_sync(s.bar, target);
  const int nqt = cdiv(a.T, QT);
  for (int it = blockIdx.x; it < a.B * a.H * nqt; it += gridDim.x) {
    const int b = it / (a.H * nqt), h = (it / nqt) % a.H, qt = it % nqt;
    const int q0 = qt * QT;
    attention_item<T>(a, s.qu, s.qv, s.k, s.v, s.ctx, b, h, q0,
                      min(QT, a.T - q0), smem);
  }
  grid_sync(s.bar, target);
  gemm_phase<T>(s.ctx, D, ARG(T, P_WO), D, M, D, D, smem, blockIdx.x,
                gridDim.x, [&](int row, int col, float v) {
                  const size_t i = (size_t)row * D + col;
                  out[i] = fromf<T>(ldcg(s.x1 + i) + (v + bo[col]));
                });
}

template <typename T>
__global__ void __launch_bounds__(NT, 2) half_a_kv_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  Scratch<T> s =
      carve<T>(HALF_A_KV, a, OUT(unsigned char, P_SCRATCH), nullptr);
  unsigned int target = 0;
  const int M = a.B * a.T, D = a.D;
  const float* norms = ARG(float, P_NORMS);
  const float* bqkv = ARG(float, P_BQKV);
  T* ln = OUT(T, P_LN);
  T* k = OUT(T, P_K);
  T* v = OUT(T, P_V);

  ffn1_phases<T>(a, s, smem, target);
  layernorm_rows<float, T>(s.x1, ln, norms + 2 * D, norms + 3 * D, M, D,
                           OUT(T, P_X1));
  grid_sync(s.bar, target);
  // K and V: columns D..3D of the packed q|k|v weight
  gemm_phase<T>(ln, D, ARG(T, P_WQKV) + D, 3 * D, M, 2 * D, D, smem,
                blockIdx.x, gridDim.x, [&](int row, int col, float val) {
                  const float y = val + bqkv[D + col];
                  if (col < D)
                    k[(size_t)row * D + col] = fromf<T>(y);
                  else
                    v[(size_t)row * D + col - D] = fromf<T>(y);
                });
}

template <typename T>
__global__ void __launch_bounds__(NT, 2) half_a_qblock_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  Scratch<T> s =
      carve<T>(HALF_A_QBLOCK, a, OUT(unsigned char, P_SCRATCH), nullptr);
  const int D = a.D, b = blockIdx.y, q0 = blockIdx.x * a.tq;
  const int nrows = min(a.tq, a.T - q0);
  const size_t r0 = (size_t)b * a.T + q0;
  const float* bqkv = ARG(float, P_BQKV);
  const float* ub = ARG(float, P_UBIAS);
  const float* bo = ARG(float, P_BO);
  const T* x1 = ARG(T, P_X1);
  T* out = OUT(T, P_OUT);

  gemm_phase<T>(ARG(T, P_LN) + r0 * D, D, ARG(T, P_WQKV), 3 * D, nrows, D, D,
                smem, 0, 1, [&](int row, int col, float v) {
                  const float y = v + bqkv[col];
                  const size_t i = (r0 + row) * D + col;
                  s.qu[i] = fromf<T>(y + ub[col]);
                  s.qv[i] = fromf<T>(y + ub[D + col]);
                });
  for (int h = 0; h < a.H; ++h)
    for (int q = q0; q < q0 + nrows; q += QT)
      attention_item<T>(a, s.qu, s.qv, ARG(T, P_K), ARG(T, P_V), s.ctx, b, h,
                        q, min(QT, q0 + nrows - q), smem);
  gemm_phase<T>(s.ctx + r0 * D, D, ARG(T, P_WO), D, nrows, D, D, smem, 0, 1,
                [&](int row, int col, float v) {
                  const size_t i = (r0 + row) * D + col;
                  out[i] = fromf<T>(tof(x1[i]) + (v + bo[col]));
                });
}

// block-wide sum, result valid in thread 0; red holds 32 floats
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)blockDim.x / 32; ++w) s += red[w];
  __syncthreads();
  return s;
}

// The conv module between pointwise 1 (s.pw, f32) and pointwise 2: GLU +
// SAME depthwise conv ((K-1)//2 frames low, K//2 high) into s.acc, then
// GroupNorm(1) over each whole (T, D) row from per-tile partial sums in a
// fixed order (the mean, then after a barrier the mean squared deviation),
// scale, bias and swish into s.gs. Two grid barriers inside; the caller
// syncs after it. With `smem_bytes` of shared memory to spare, a block
// keeps its own depthwise tiles there for the two GroupNorm passes instead
// of going through s.acc (same sums in the same order).
template <typename T, int NTH>
__device__ void conv_module_phases(const Args& a, Scratch<T>& s,
                                   unsigned char* smem, size_t smem_bytes,
                                   float* red, unsigned int& target) {
  const int B = a.B, T_ = a.T, M = B * T_, D = a.D, K = a.K;
  constexpr int nt = NTH, ng = NTH / DT, NF = (DT + ng - 1) / ng;
  const float* norms = ARG(float, P_NORMS);
  const float* dw = ARG(float, P_DW);
  const float* dwb = ARG(float, P_DWB);
  const int ntt = cdiv(T_, DT), nct = cdiv(D, DT), ntile = ntt * nct;
  float* part1 = s.part;
  float* part2 = s.part + (size_t)B * ntile;
  const float count = (float)T_ * (float)D;

  // GLU, 4 channels a thread, the tile's pointwise-1 values loaded into
  // registers while the previous tile's taps run; each thread then sums
  // the K taps for its channel at the frames fg, fg + ng, ... of the tile
  // (ng = NTH / DT), one accumulator a frame, in the tap order of the TPU
  // kernel
  const int lo = (K - 1) / 2, nrow = DT + K - 1;
  constexpr int GLU_REGS = cdiv_c((DT + MAX_KERNEL - 1) * (DT / 4), NTH);
  float* g_s = reinterpret_cast<float*>(smem);
  const size_t g_bytes = align_up((size_t)nrow * DT * sizeof(float), 256);
  float* cache = reinterpret_cast<float*>(smem + g_bytes);
  const int mine = cdiv(B * ntile, gridDim.x);  // tiles of the busiest block
  // the cached tiles, then each tile's mean and its warps' partial sums
  float* tile_mean = cache + (size_t)mine * DT * DT;
  float* warp_part = tile_mean + mine;
  const bool cached =
      smem_bytes >= g_bytes + (size_t)mine * (DT * DT + 1 + 32) * 4 &&
      2 * B <= nrow * DT;  // GroupNorm's mean/rstd overlay g_s
  // pointwise-1 rows of tile `it` that this thread turns into GLU values:
  // every nt-th 16-byte group from threadIdx.x, both halves
  float4 u[GLU_REGS], w[GLU_REGS];
  auto load_tile = [&](int it) {
    const int b = it / ntile, tt = (it % ntile) / nct, ct = it % nct;
#pragma unroll
    for (int q = 0; q < GLU_REGS; ++q) {
      const int i = threadIdx.x + q * nt, rr = i / (DT / 4);
      const int t = tt * DT - lo + rr, ch = ct * DT + (i % (DT / 4)) * 4;
      u[q] = w[q] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < nrow * (DT / 4) && t >= 0 && t < T_ && ch < D) {
        const float* pr = s.pw + ((size_t)b * T_ + t) * 2 * D;
        u[q] = __ldcg(reinterpret_cast<const float4*>(pr + ch));
        w[q] = __ldcg(reinterpret_cast<const float4*>(pr + D + ch));
      }
    }
  };
  if (blockIdx.x < B * ntile) load_tile(blockIdx.x);
  for (int it = blockIdx.x, k = 0; it < B * ntile; it += gridDim.x, ++k) {
    const int b = it / ntile, tt = (it % ntile) / nct, ct = it % nct;
    const int t0 = tt * DT, c0 = ct * DT;
#pragma unroll
    for (int q = 0; q < GLU_REGS; ++q) {
      const int i = threadIdx.x + q * nt;
      if (i < nrow * (DT / 4))
        *reinterpret_cast<float4*>(g_s + (i / (DT / 4)) * DT +
                                   (i % (DT / 4)) * 4) =
            make_float4(u[q].x * sigm_t<T>(w[q].x),
                        u[q].y * sigm_t<T>(w[q].y),
                        u[q].z * sigm_t<T>(w[q].z),
                        u[q].w * sigm_t<T>(w[q].w));
    }
    __syncthreads();
    if (it + gridDim.x < B * ntile) load_tile(it + gridDim.x);
    const int c = threadIdx.x % DT, ch = c0 + c, fg = threadIdx.x / DT;
    float acc[NF];
#pragma unroll
    for (int i = 0; i < NF; ++i) acc[i] = 0.f;
    if (ch < D) {
#pragma unroll 2
      for (int j = 0; j < K; ++j) {
        const float tap = dw[j * D + ch];
#pragma unroll
        for (int i = 0; i < NF; ++i) {
          const int rr = fg + ng * i;
          if (rr < DT) acc[i] = acc[i] + g_s[(rr + j) * DT + c] * tap;
        }
      }
    }
    float local = 0.f;
#pragma unroll
    for (int i = 0; i < NF; ++i) {
      const int rr = fg + ng * i, t = t0 + rr;
      if (rr < DT && t < T_ && ch < D) {
        const float v = acc[i] + dwb[ch];
        if (cached)
          cache[(size_t)k * DT * DT + rr * DT + c] = v;
        else
          s.acc[((size_t)b * T_ + t) * D + ch] = v;
        local += v;
      }
    }
    const float tot = block_sum(local, red);
    if (threadIdx.x == 0) part1[it] = tot;
  }
  grid_sync(s.bar, target);

  if (cached) {
    // each tile's batch-row mean, then its squared deviations from the
    // cache: warp sums kept per tile and added in warp order at the end
    // (block_sum's order), with no block barrier per tile
    for (int k = threadIdx.x; k < mine; k += nt) {
      const int it = blockIdx.x + k * gridDim.x;
      if (it >= B * ntile) continue;
      const int b = it / ntile;
      float mean = 0.f;
      for (int i = 0; i < ntile; ++i)
        mean += ldcg(part1 + (size_t)b * ntile + i);
      tile_mean[k] = mean / count;
    }
    __syncthreads();
    for (int it = blockIdx.x, k = 0; it < B * ntile; it += gridDim.x, ++k) {
      const int tt = (it % ntile) / nct, ct = it % nct;
      const int c = threadIdx.x % DT, ch = ct * DT + c, fg = threadIdx.x / DT;
      float local = 0.f;
#pragma unroll
      for (int i = 0; i < NF; ++i) {
        const int rr = fg + ng * i, t = tt * DT + rr;
        if (rr < DT && t < T_ && ch < D) {
          const float d =
              cache[(size_t)k * DT * DT + rr * DT + c] - tile_mean[k];
          local += d * d;
        }
      }
      local = warp_sum(local);
      if (threadIdx.x % 32 == 0) warp_part[k * 32 + threadIdx.x / 32] = local;
    }
    __syncthreads();
    for (int k = threadIdx.x; k < mine; k += nt) {
      const int it = blockIdx.x + k * gridDim.x;
      if (it >= B * ntile) continue;
      float tot = 0.f;
      for (int w = 0; w < nt / 32; ++w) tot += warp_part[k * 32 + w];
      part2[it] = tot;
    }
  } else {
    for (int it = blockIdx.x; it < B * ntile; it += gridDim.x) {
      const int b = it / ntile, tt = (it % ntile) / nct, ct = it % nct;
      float mean = 0.f;
#pragma unroll 8
      for (int i = 0; i < ntile; ++i)
        mean += ldcg(part1 + (size_t)b * ntile + i);
      mean /= count;
      const int c = threadIdx.x % DT, ch = ct * DT + c, fg = threadIdx.x / DT;
      float d[NF];
#pragma unroll
      for (int i = 0; i < NF; ++i) {
        const int rr = fg + ng * i, t = tt * DT + rr;
        d[i] = (rr < DT && t < T_ && ch < D)
                   ? ldcg(s.acc + ((size_t)b * T_ + t) * D + ch) - mean : 0.f;
      }
      float local = 0.f;
#pragma unroll
      for (int i = 0; i < NF; ++i) {
        const int rr = fg + ng * i, t = tt * DT + rr;
        if (rr < DT && t < T_ && ch < D) local += d[i] * d[i];
      }
      const float tot = block_sum(local, red);
      if (threadIdx.x == 0) part2[it] = tot;
    }
  }
  grid_sync(s.bar, target);

  float* mean_s = reinterpret_cast<float*>(smem);
  float* rstd_s = mean_s + B;
  for (int b = threadIdx.x; b < B; b += nt) {
    float m = 0.f, v = 0.f;
    for (int i = 0; i < ntile; ++i) {
      m += ldcg(part1 + (size_t)b * ntile + i);
      v += ldcg(part2 + (size_t)b * ntile + i);
    }
    mean_s[b] = m / count;
    rstd_s[b] = rsqrtf(v / count + 1e-5f);
  }
  __syncthreads();
  // 4 channels a thread (D % 4 == 0, so a quad never straddles a row)
  const float* gsc = norms + 8 * D;
  const float* gbi = norms + 9 * D;
  auto apply = [&](int b, int ch, const float4 v, T* dst) {
    const float vv[4] = {v.x, v.y, v.z, v.w};
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float g = (vv[e] - mean_s[b]) * rstd_s[b];
      g = g * gsc[ch + e] + gbi[ch + e];
      o[e] = g * sigm_t<T>(g);
    }
    st_vec<4>(dst, o);
  };
  if (cached) {
    for (int it = blockIdx.x, k = 0; it < B * ntile; it += gridDim.x, ++k) {
      const int b = it / ntile, tt = (it % ntile) / nct, ct = it % nct;
      for (int i = threadIdx.x; i < DT * DT / 4; i += nt) {
        const int rr = i / (DT / 4), c = (i % (DT / 4)) * 4;
        const int t = tt * DT + rr, ch = ct * DT + c;
        if (t < T_ && ch < D)
          apply(b, ch, *reinterpret_cast<const float4*>(
                           cache + (size_t)k * DT * DT + rr * DT + c),
                s.gs + ((size_t)b * T_ + t) * D + ch);
      }
    }
    return;
  }
  for (size_t i = ((size_t)blockIdx.x * nt + threadIdx.x) * 4;
       i < (size_t)M * D; i += (size_t)gridDim.x * nt * 4)
    apply((int)(i / ((size_t)T_ * D)), (int)(i % D),
          __ldcg(reinterpret_cast<const float4*>(s.acc + i)), s.gs + i);
}

template <typename T>
__global__ void __launch_bounds__(NT, 2) half_b_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[32];
  Scratch<T> s = carve<T>(HALF_B, a, OUT(unsigned char, P_SCRATCH), nullptr);
  unsigned int target = 0;
  const int M = a.B * a.T, D = a.D, F = a.F;
  const T* x = ARG(T, P_X);
  const float* norms = ARG(float, P_NORMS);
  const float* pw1b = ARG(float, P_PW1B);
  const float* pw2b = ARG(float, P_PW2B);
  const float* b1 = ARG(float, P_B1B);
  const float* b2 = ARG(float, P_B2B);
  T* out = OUT(T, P_OUT);

  // conv module: LN -> pointwise 1 -> GLU, depthwise, GroupNorm, swish
  layernorm_rows<T, T>(x, s.h, norms + 4 * D, norms + 5 * D, M, D,
                       (T*)nullptr);
  grid_sync(s.bar, target);
  gemm_phase<T>(s.h, D, ARG(T, P_PW1), 2 * D, M, 2 * D, D, smem, blockIdx.x,
                gridDim.x, [&](int row, int col, float v) {
                  s.pw[(size_t)row * 2 * D + col] = v + pw1b[col];
                });
  grid_sync(s.bar, target);
  conv_module_phases<T, NT>(a, s, smem, 0, red, target);
  grid_sync(s.bar, target);
  gemm_phase<T>(s.gs, D, ARG(T, P_PW2), D, M, D, D, smem, blockIdx.x,
                gridDim.x, [&](int row, int col, float v) {
                  const size_t i = (size_t)row * D + col;
                  s.x2[i] = tof(x[i]) + (v + pw2b[col]);
                });
  grid_sync(s.bar, target);

  // ffn 2 (scale 0.5)
  layernorm_rows<float, T>(s.x2, s.h2, norms + 6 * D, norms + 7 * D, M, D,
                           (T*)nullptr);
  grid_sync(s.bar, target);
  gemm_phase<T>(s.h2, D, ARG(T, P_W1B), F, M, F, D, smem, blockIdx.x,
                gridDim.x, [&](int row, int col, float v) {
                  const float y = v + b1[col];
                  s.m2[(size_t)row * F + col] = fromf<T>(y * sigm(y));
                });
  grid_sync(s.bar, target);
  gemm_phase<T>(s.m2, F, ARG(T, P_W2B), D, M, D, F, smem, blockIdx.x,
                gridDim.x, [&](int row, int col, float v) {
                  const size_t i = (size_t)row * D + col;
                  out[i] = fromf<T>(ldcg(s.x2 + i) + 0.5f * (v + b2[col]));
                });
}

// =============================================================== bf16 route
//
// half_a and half_b in bf16 on Hopper: 384 threads, one block an SM (about
// 200 KB of shared memory), the same phases and grid barriers as above.
// - Products (every one of both halves): tiles of 128 rows x BN columns,
//   BN = 128 or 192 chosen per product on the host (choose_bn: the fewest
//   rounds of tiles over the grid, times BN), walked persistently. Warp 0
//   (one lane) keeps TMA copies in flight: per 64-deep slice, a 128 x 64
//   box of the activations A (row-major in scratch) and a BN x 64 box of
//   the weight (packed (N, K), K-major, by the wrapper), both 128-byte
//   swizzled, into a ring of TC_STAGES stages with full/empty mbarriers.
//   TMA's zero fill covers rows past M, columns past N and depth past K.
//   Warpgroups 1 and 2 each own 64 rows of the tile and run wgmma
//   m64nBNk16 (four k16 steps a slice, A and B by descriptor, f32
//   accumulators in registers); a stage is freed once the next slice's
//   products are issued and the previous ones are done. The epilogue works
//   on the accumulator layout (struct Epi*): bias, activation and residual
//   in f32, two adjacent columns a lane stored as one bf16x2 or float2; the
//   tile's bias columns come into shared memory by cp.async behind its
//   products, the residual pairs of a chunk are read before its stores.
//   The ring's stage and
//   phase follow from a count of slices every thread keeps, so they carry
//   across phases; every full barrier is consumed before a phase ends, so
//   the ring is drained when other phases reuse the memory.
//   What bounds them now (phase_split.py on the H100): the epilogue. With
//   its loads and stores taken out, the eight products run at 600-770
//   TFLOP/s; with them, 150-320. Ring depth (3 to 6 stages) and 16-byte
//   stores after a quad transpose did not help; reading the residuals
//   ahead of the stores and the bias columns through shared memory did,
//   per-thread cp.async of the residual pairs did not.
// - Attention: items of (batch, head, 192 queries), one warp per 16 query
//   rows. The item's q+u and q+v rows, the head's K and V (as many 64-key
//   chunks as fit; the whole row up to T' ~ 500 at dk = 64) and its
//   compact position table go into XOR-swizzled shared memory by cp.async
//   once per item; A fragments by ldmatrix. Each warp computes its compact
//   table small = (q+v) pos^T / sqrt(dk) (mma.sync m16n8k16) into shared
//   memory, then two passes over the keys in 64-key steps: scores
//   (q+u) k^T on the tensor cores, + small[clamp(k - q, -r, r) + r] (a step
//   wholly outside the band reads one column), the key mask (masked ->
//   -1e9, keys past T' left out) in registers; pass 1 keeps the row max and
//   the sum of exp, pass 2 forms the weights exp(s - max) / max(sum, 1e-30),
//   rounds them to bf16 (as the TPU kernel does) and adds P V on the tensor
//   cores. Fully-masked rows get zero weights.
// - LayerNorm, GLU + depthwise and GroupNorm as in the 256-thread kernels,
//   on all 12 warps; the depthwise tiles stay in shared memory for the two
//   GroupNorm passes.

constexpr int TC_THREADS = 384;
constexpr int TC_WARPS = TC_THREADS / 32;
constexpr int TBM = 128;                      // product tile rows
constexpr int TBK = 64;                       // depth slice: 128-byte rows
constexpr int TBN_MAX = 192;
constexpr int TC_A_BYTES = TBM * TBK * 2;     // 16 KB
constexpr int TC_STAGE = TC_A_BYTES + TBN_MAX * TBK * 2;  // 40 KB
constexpr int TC_STAGES = 5;
constexpr int TC_BARS = 1024;                 // mbarriers, before the ring
// after the ring: the epilogues' column vectors (at most 3), per tile
constexpr int EPI_VECS = 3;
constexpr int EPI_VEC_BYTES = EPI_VECS * TBN_MAX * 4;
constexpr int TC_QROWS = 16 * TC_WARPS;       // queries per attention item
constexpr int N_PROD = 4;                     // products per half

// Tensor maps and tile widths of one launch's four products, in phase
// order (half A: W1A, W2A, WQKV, WO; half B: PW1, PW2, W1B, W2B): a[i] is
// product i's activations, w[i] its weight.
struct TcMaps {
  CUtensorMap a[N_PROD];
  CUtensorMap w[N_PROD];
  int bn[N_PROD];
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
// that lasts 2^34 SM clocks (about 10 s; a protocol fault) traps instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (t0 == 0) t0 = now;
    else if (now - t0 > (1ll << 34)) __trap();
  }
}

// box of map at (inner c0, outer c1) into shared memory at dst
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major tile with the 128-byte swizzle: rows of
// 128 bytes, 8-row groups 1024 bytes apart (SBO); LBO unused
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
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

template <int BN>
__device__ void wgmma_k64(float* d, uint64_t a, uint64_t b, int scale_d);

// d (64 x 128, f32) += a (64 x 64) * b (64 x 128), bf16, both by
// descriptor: four k16 steps, 32 bytes apart in the swizzled rows;
// scale_d == 0 overwrites d
template <>
__device__ __forceinline__ void wgmma_k64<128>(float* d, uint64_t a,
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.b32 p, %72, 0;\n"
      "setp.eq.b32 q, %72, %72;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %68, p, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %65, %69, q, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %66, %70, q, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %67, %71, q, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(a + 2), "l"(a + 4), "l"(a + 6), "l"(b), "l"(b + 2),
        "l"(b + 4), "l"(b + 6), "r"(scale_d));
}

// d (64 x 192, f32) += a (64 x 64) * b (64 x 192), bf16, both by
// descriptor: four k16 steps, 32 bytes apart in the swizzled rows;
// scale_d == 0 overwrites d
template <>
__device__ __forceinline__ void wgmma_k64<192>(float* d, uint64_t a,
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.b32 p, %104, 0;\n"
      "setp.eq.b32 q, %104, %104;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
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
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %100, p, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
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
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, %97, %101, q, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
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
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, %98, %102, q, 1, 1, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
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
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, %99, %103, q, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a), "l"(a + 2), "l"(a + 4), "l"(a + 6), "l"(b), "l"(b + 2),
        "l"(b + 4), "l"(b + 6), "r"(scale_d));
}


__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ void st_bf2(bf16* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(lo, hi);
}
__device__ __forceinline__ void st_f2(float* p, float lo, float hi) {
  *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
}
__device__ __forceinline__ float2 ld_bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 ldcg_f2(const float* p) {
  return __ldcg(reinterpret_cast<const float2*>(p));
}

// Shared memory of a bf16-route block: the mbarriers, then the region the
// phases share (the ring of the products, the attention, depthwise and
// GroupNorm buffers), 1024-byte aligned for the swizzled stages.
struct TcSmem {
  uint32_t bars, ring;
  unsigned char* region;  // what the phases share, from the ring on
  unsigned char* epi;     // the products' epilogue operands
  __device__ uint32_t full(int s) const { return bars + 8u * s; }
  __device__ uint32_t empty(int s) const {
    return bars + 8u * (TC_STAGES + s);
  }
};

__device__ TcSmem tc_smem_init(unsigned char* raw) {
  const uint32_t r = smem_u32(raw);
  const uint32_t base = (r + 1023u) & ~1023u;
  TcSmem t;
  t.bars = base;
  t.ring = base + TC_BARS;
  t.region = raw + (base - r) + TC_BARS;
  t.epi = t.region + TC_STAGES * TC_STAGE;
  if (threadIdx.x == 0) {
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(t.full(s), 1);
      mbar_init(t.empty(s), 8);  // lane 0 of the 8 consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return t;
}

// One product over the grid: A (M x K, map ma) times W^T (W is N x K, map
// mw), tiles of TBM x BN walked as blockIdx.x, + gridDim.x, ...; the
// epilogue `epi` (struct Epi* below) turns the f32 sums of columns col and
// col + 1 (col even, both < N) into the pairs of its outputs, stored as one
// bf16x2 or float2 (a quad of lanes writes 16 or 32 bytes of a row). The
// tile's column vectors (bias, u, v) are fetched into shared memory by
// cp.async when the tile starts, behind its products; the residual pairs
// (pre) are read for EPI_CHUNK column pairs of both rows before any of
// their stores, since a load that may alias an earlier store waits for it
// (per-thread cp.async of the pairs measured slower). `it` counts the
// ring's slices; every thread advances it alike.
constexpr int EPI_CHUNK = 4;

__device__ __forceinline__ void store_pair(bf16* p, float2 y) {
  st_bf2(p, y.x, y.y);
}
__device__ __forceinline__ void store_pair(float* p, float2 y) {
  st_f2(p, y.x, y.y);
}

// The products' epilogues. NVEC column vectors: vec(i) (columns 0 ..
// vec_len(i) - 1, zero past them); pre(row, col): the residual pair that
// val adds; nout(col): outputs at column col; val(o, col, v0, v1, vs, r):
// output o's pair, vs pointing at the tile's column vectors at col
// (vector i at vs[i * TBN_MAX]); dst(o, row, col): where it goes.

// out = swish(v + b) (W1A, W1B)
struct EpiSwish {
  static constexpr int NVEC = 1;
  bf16* out;
  const float* b;
  int ld;
  __device__ const float* vec(int) const { return b; }
  __device__ int vec_len(int, int n) const { return n; }
  __device__ float2 pre(int, int) const { return make_float2(0.f, 0.f); }
  __device__ int nout(int) const { return 1; }
  __device__ float2 val(int, int, float v0, float v1, const float* vs,
                        float2) const {
    return make_float2(swish_fast(v0 + vs[0]), swish_fast(v1 + vs[1]));
  }
  __device__ bf16* dst(int, int row, int col) const {
    return out + (size_t)row * ld + col;
  }
};

// out = res + scale (v + b), res an (M, ld) array of R or none (PW1; W2A
// and PW2 into f32 x1, x2; WO and W2B into the bf16 output)
template <typename R, typename O>
struct EpiResidual {
  static constexpr int NVEC = 1;
  const R* res;
  const float* b;
  O* out;
  int ld;
  float scale;
  __device__ const float* vec(int) const { return b; }
  __device__ int vec_len(int, int n) const { return n; }
  __device__ float2 pre(int row, int col) const {
    if (res == nullptr) return make_float2(0.f, 0.f);
    const R* p = res + (size_t)row * ld + col;
    if constexpr (std::is_same<R, bf16>::value) return ld_bf2(p);
    else return ldcg_f2(p);
  }
  __device__ int nout(int) const { return 1; }
  __device__ float2 val(int, int, float v0, float v1, const float* vs,
                        float2 r) const {
    return make_float2(r.x + scale * (v0 + vs[0]),
                       r.y + scale * (v1 + vs[1]));
  }
  __device__ O* dst(int, int row, int col) const {
    return out + (size_t)row * ld + col;
  }
};

// q | k | v + bias: q + u and q + v (two outputs), k, v, each (M, D)
struct EpiQKV {
  static constexpr int NVEC = 3;
  bf16 *qu, *qv, *k, *v;
  const float *b, *ub;
  int D;
  __device__ const float* vec(int i) const {
    return i == 0 ? b : ub + (i - 1) * D;
  }
  __device__ int vec_len(int i, int n) const { return i == 0 ? n : D; }
  __device__ float2 pre(int, int) const { return make_float2(0.f, 0.f); }
  __device__ int nout(int col) const { return col < D ? 2 : 1; }
  __device__ float2 val(int o, int col, float v0, float v1, const float* vs,
                        float2) const {
    const float y0 = v0 + vs[0], y1 = v1 + vs[1];
    if (col >= D) return make_float2(y0, y1);
    const float* u = vs + (1 + o) * TBN_MAX;
    return make_float2(y0 + u[0], y1 + u[1]);
  }
  __device__ bf16* dst(int o, int row, int col) const {
    const int seg = col >= 2 * D ? 2 : (col >= D ? 1 : 0);
    bf16* base = seg == 0 ? (o ? qv : qu) : (seg == 1 ? k : v);
    return base + (size_t)row * D + col - seg * D;
  }
};

template <int BN, class Epi>
__device__ __forceinline__ void tc_gemm(const CUtensorMap* ma,
                                        const CUtensorMap* mw, int M, int N,
                                        int K, const TcSmem& sm, uint32_t& it,
                                        const Epi epi) {
  const int tn = cdiv(N, BN), ntiles = cdiv(M, TBM) * tn, nk = cdiv(K, TBK);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 0) {
    if (lane == 0) {
      // what earlier phases stored is read through the async proxy
      asm volatile("fence.proxy.async.global;\n" ::: "memory");
      uint32_t i = it;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        const int m0 = (t / tn) * TBM, n0 = (t % tn) * BN;
        for (int kb = 0; kb < nk; ++kb, ++i) {
          const int s = i % TC_STAGES;
          const uint32_t ph = (i / TC_STAGES) & 1;
          mbar_wait(sm.empty(s), ph ^ 1);
          mbar_expect_tx(sm.full(s), TC_A_BYTES + BN * TBK * 2);
          const uint32_t st = sm.ring + s * TC_STAGE;
          tma_2d(st, ma, sm.full(s), kb * TBK, m0);
          tma_2d(st + TC_A_BYTES, mw, sm.full(s), kb * TBK, n0);
        }
      }
    }
  } else if (warp >= 4) {
    const int wg = (warp >> 2) - 1;  // rows 64 wg .. 64 wg + 63 of a tile
    const int g = lane >> 2, q = lane & 3;
    float acc[BN / 2];
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
    const int ct = threadIdx.x - 128;  // consumer thread 0 .. 255
    float* vec_s = reinterpret_cast<float*>(sm.epi);
    uint32_t i = it;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const int m0 = (t / tn) * TBM, n0 = (t % tn) * BN;
      // the previous tile's epilogue is done with the column vectors
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
#pragma unroll
      for (int v = 0; v < Epi::NVEC; ++v)
        for (int c = ct; c < BN; c += 256) {
          const bool ok = n0 + c < epi.vec_len(v, N);
          cp_async4(vec_s + v * TBN_MAX + c,
                    ok ? epi.vec(v) + n0 + c : epi.vec(v), ok);
        }
      cp_async_commit();
      int prev = -1;
      for (int kb = 0; kb < nk; ++kb, ++i) {
        const int s = i % TC_STAGES;
        mbar_wait(sm.full(s), (i / TC_STAGES) & 1);
        const uint32_t st = sm.ring + s * TC_STAGE;
        wgmma_fence();
        wgmma_k64<BN>(acc, desc_sw128(st + wg * 64 * 128),
                      desc_sw128(st + TC_A_BYTES), kb > 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous slice's products are done
        if (prev >= 0 && lane == 0) mbar_arrive(sm.empty(prev));
        prev = s;
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(sm.empty(prev));
      cp_async_wait<0>();
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      // accumulator 4 j + 2 h (+ 1): row g + 8 h, column 8 j + 2q (+ 1)
      const int r0 = m0 + wg * 64 + (warp & 3) * 16 + g;
#pragma unroll
      for (int j0 = 0; j0 < BN / 8; j0 += EPI_CHUNK) {
        float2 res[EPI_CHUNK][2];
#pragma unroll
        for (int jj = 0; jj < EPI_CHUNK; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int col = n0 + 8 * (j0 + jj) + 2 * q, row = r0 + 8 * h;
            res[jj][h] = col < N && row < M ? epi.pre(row, col)
                                            : make_float2(0.f, 0.f);
          }
#pragma unroll
        for (int jj = 0; jj < EPI_CHUNK; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = j0 + jj, col = n0 + 8 * j + 2 * q, row = r0 + 8 * h;
            if (col >= N || row >= M) continue;
            for (int o = 0; o < epi.nout(col); ++o)
              store_pair(epi.dst(o, row, col),
                         epi.val(o, col, acc[4 * j + 2 * h],
                                 acc[4 * j + 2 * h + 1], vec_s + (col - n0),
                                 res[jj][h]));
          }
      }
    }
  }
  int mine = 0;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) ++mine;
  it += mine * nk;
}

// product i of the launch, at the tile width the host chose for it
template <class Epi>
__device__ __forceinline__ void tc_product(const TcMaps& mp, int i, int M,
                                           int N, int K, const TcSmem& sm,
                                           uint32_t& it, const Epi epi) {
  if (mp.bn[i] == 192)
    tc_gemm<192>(&mp.a[i], &mp.w[i], M, N, K, sm, it, epi);
  else
    tc_gemm<128>(&mp.a[i], &mp.w[i], M, N, K, sm, it, epi);
}

// ------------------------------------------------ attention on mma.sync

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// c (16 x 8, f32) += a (16 x 16, bf16, row) * (b0, b1) (16 x 8, bf16, col)
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared memory of the attention phase (offsets from the region): the
// item's q+u and q+v rows, K and V chunks of kc keys and the compact
// table, rows of rw bf16 (64 for
// dk <= 64, else 128) in 16-byte chunks XOR-swizzled by the row (chunk c
// of row r at c ^ (r & 7)); each warp's 16 x pp f32 compact scores; the
// key mask row (tp = T' rounded up to 64). kc is the most 64-key chunks
// that fit in `budget` bytes, at most tp; 0 if not even one does.
struct AttnTc {
  int rw, pp, tp, kc;
  size_t qu, qv, k, v, pos, small, mask, bytes;
};

__host__ __device__ inline AttnTc attn_tc_layout(int T_, int dk, int P,
                                                 size_t budget) {
  AttnTc L;
  const int dkp = (dk + 15) / 16 * 16;
  L.rw = dkp <= 64 ? 64 : 128;
  L.pp = (P + 15) / 16 * 16;
  L.tp = (T_ + 63) / 64 * 64;
  const size_t fixed = (size_t)2 * TC_QROWS * L.rw * 2 +
                       (size_t)L.pp * L.rw * 2 +
                       (size_t)TC_WARPS * 16 * L.pp * 4 + (size_t)L.tp * 4 +
                       7 * 256;
  const size_t per64 = (size_t)2 * 64 * L.rw * 2;
  const int n64 = budget > fixed ? (int)((budget - fixed) / per64) : 0;
  L.kc = 64 * (n64 < L.tp / 64 ? n64 : L.tp / 64);
  Carver c{nullptr, 0};
  L.qu = (size_t)c.take<bf16>((size_t)TC_QROWS * L.rw);
  L.qv = (size_t)c.take<bf16>((size_t)TC_QROWS * L.rw);
  L.k = (size_t)c.take<bf16>((size_t)(L.kc > 0 ? L.kc : 64) * L.rw);
  L.v = (size_t)c.take<bf16>((size_t)(L.kc > 0 ? L.kc : 64) * L.rw);
  L.pos = (size_t)c.take<bf16>((size_t)L.pp * L.rw);
  L.small = (size_t)c.take<float>((size_t)TC_WARPS * 16 * L.pp);
  L.mask = (size_t)c.take<float>(L.tp);
  L.bytes = c.off;
  return L;
}

// rows r0 .. r0 + n - 1 of one head (columns col0 .. col0 + dk) of a
// (rows, D) bf16 array into a swizzled tile of RW-wide rows; zero past
// r_end and dk. cp.async (16 bytes) when dk % 8 == 0, else element copies.
template <int RW>
__device__ void load_head_tile(unsigned char* dst, const bf16* src,
                               size_t row0, int r0, int r_end, int n, int D,
                               int col0, int dk) {
  constexpr int NCH = RW / 8;
  if (dk % 8 == 0) {
    for (int i = threadIdx.x; i < n * NCH; i += blockDim.x) {
      const int r = i / NCH, c = i % NCH;
      const bool ok = r0 + r < r_end && c * 8 < dk;
      cp_async16(dst + (r * NCH + (c ^ (r & 7))) * 16,
                 ok ? src + (row0 + r0 + r) * D + col0 + c * 8 : src, ok);
    }
  } else {
    const unsigned short* s16 = reinterpret_cast<const unsigned short*>(src);
    for (int i = threadIdx.x; i < n * RW; i += blockDim.x) {
      const int r = i / RW, d = i % RW;
      const unsigned short v =
          (r0 + r < r_end && d < dk)
              ? __ldcg(s16 + (row0 + r0 + r) * D + col0 + d) : 0;
      *reinterpret_cast<unsigned short*>(
          dst + (r * NCH + ((d >> 3) ^ (r & 7))) * 16 + (d & 7) * 2) = v;
    }
  }
}

template <int RW>
__device__ void attention_tc(const Args& a, const Scratch<bf16>& s,
                             unsigned char* region, size_t budget) {
  constexpr int NCH = RW / 8, KS = RW / 16;  // 16-byte chunks; k16 steps
  const AttnTc L = attn_tc_layout(a.T, a.dk, a.P, budget);
  unsigned char* qu_s = region + L.qu;
  unsigned char* qv_s = region + L.qv;
  unsigned char* k_s = region + L.k;
  unsigned char* v_s = region + L.v;
  unsigned char* pos_s = region + L.pos;
  float* mask_s = reinterpret_cast<float*>(region + L.mask);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  const int T_ = a.T, D = a.D, dk = a.dk, P = a.P, rr = a.r, pp = L.pp;
  const int nks = (dk + 15) / 16;  // k16 steps over the head
  const int nqb = cdiv(T_, TC_QROWS), nchunk = cdiv(T_, L.kc);
  const float inv = a.inv_sqrt_dk;
  float* small_w =
      reinterpret_cast<float*>(region + L.small) + warp * 16 * pp;
  const bf16* pos = ARG(bf16, P_POS);
  const float* maskf = ARG(float, P_MASKF);
  for (int item = blockIdx.x; item < a.B * a.H * nqb; item += gridDim.x) {
    const int b = item / (a.H * nqb), h = (item / nqb) % a.H;
    const int qb0 = (item % nqb) * TC_QROWS;
    const int q0 = qb0 + warp * 16;  // this warp's rows
    const bool active = q0 < T_;
    const size_t row0 = (size_t)b * T_;
    const int col0 = h * dk;
    __syncthreads();  // the previous item is done with shared memory
    load_head_tile<RW>(qu_s, s.qu, row0, qb0, T_, TC_QROWS, D, col0, dk);
    load_head_tile<RW>(qv_s, s.qv, row0, qb0, T_, TC_QROWS, D, col0, dk);
    load_head_tile<RW>(pos_s, pos, 0, 0, P, pp, D, col0, dk);
    load_head_tile<RW>(k_s, s.k, row0, 0, T_, L.kc, D, col0, dk);
    load_head_tile<RW>(v_s, s.v, row0, 0, T_, L.kc, D, col0, dk);
    cp_async_commit();
    for (int i = tid; i < L.tp; i += blockDim.x)
      mask_s[i] = i < T_ ? maskf[row0 + i] : 0.f;
    cp_async_wait<0>();
    __syncthreads();

    // q+u as A fragments, by ldmatrix (k16 step ks: rows g and g + 8,
    // columns 16 ks + 2 qd (+ 8)); q+v only for the compact table
    uint32_t qa[KS][4], qv[KS][4];
    {
      const int r = warp * 16 + (lane & 15);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if (ks >= nks) break;
        const int c = ks * 2 + (lane >> 4);
        const uint32_t off = (r * NCH + (c ^ (r & 7))) * 16;
        ldsm_x4(smem_u32(qu_s + off), qa[ks]);
        ldsm_x4(smem_u32(qv_s + off), qv[ks]);
      }
    }

    // compact table: small = (q+v) pos^T, 16 x pp, into this warp's rows
    if (active) {
      for (int np = 0; np < pp / 16; ++np) {
        float c2[2][4] = {};
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          if (ks >= nks) break;
          const int r = np * 16 + (lane & 7) + ((lane >> 4) << 3);
          const int c = ks * 2 + ((lane >> 3) & 1);
          uint32_t bb[4];
          ldsm_x4(smem_u32(pos_s + (r * NCH + (c ^ (r & 7))) * 16), bb);
          mma_16816(c2[0], qv[ks], bb[0], bb[1]);
          mma_16816(c2[1], qv[ks], bb[2], bb[3]);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {  // scaled by 1/sqrt(dk) as it is used
          const int col = np * 16 + 8 * j + 2 * qd;
          st_f2(small_w + g * pp + col, c2[j][0] * inv, c2[j][1] * inv);
          st_f2(small_w + (g + 8) * pp + col, c2[j][2] * inv, c2[j][3] * inv);
        }
      }
    }
    __syncwarp();

    float o[RW / 8][4];
#pragma unroll
    for (int j = 0; j < RW / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
    for (int pass = 0; pass < 2; ++pass) {
      for (int ch = 0; ch < nchunk; ++ch) {
        if (nchunk > 1 && (pass > 0 || ch > 0)) {  // K/V chunk ch
          __syncthreads();
          load_head_tile<RW>(k_s, s.k, row0, ch * L.kc, T_, L.kc, D, col0,
                             dk);
          load_head_tile<RW>(v_s, s.v, row0, ch * L.kc, T_, L.kc, D, col0,
                             dk);
          cp_async_commit();
          cp_async_wait<0>();
          __syncthreads();
        }
        if (!active) continue;
        const int kbase = ch * L.kc, nk = min(L.kc, T_ - kbase);
        for (int sub = 0; sub < nk; sub += 64) {
          float sc[8][4];
#pragma unroll
          for (int j = 0; j < 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            if (ks >= nks) break;
#pragma unroll
            for (int np = 0; np < 4; ++np) {
              const int r = sub + np * 16 + (lane & 7) + ((lane >> 4) << 3);
              const int c = ks * 2 + ((lane >> 3) & 1);
              uint32_t bb[4];
              ldsm_x4(smem_u32(k_s + (r * NCH + (c ^ (r & 7))) * 16), bb);
              mma_16816(sc[2 * np], qa[ks], bb[0], bb[1]);
              mma_16816(sc[2 * np + 1], qa[ks], bb[2], bb[3]);
            }
          }
          // element e of n-tile j: query row g + 8 (e >> 1), key
          // 8 j + 2 qd + (e & 1) of this step
          // the step's keys k0 .. k0 + 63 against the warp's rows q0 ..
          // q0 + 15: all at offset -r, all at +r, or some in the band
          const int k0 = kbase + sub;
          const int band = k0 + 63 - q0 <= -rr ? 0 : (k0 - q0 - 15 >= rr ? 2 : 1);
          float lo_hi[2] = {small_w[g * pp + (band ? 2 * rr : 0)],
                            small_w[(g + 8) * pp + (band ? 2 * rr : 0)]};
          uint32_t valid = 0;
          float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int key0 = k0 + 8 * j + 2 * qd;
            const bool in0 = key0 < T_, in1 = key0 + 1 < T_;
            const bool ok0 = in0 && mask_s[key0] > 0.5f;
            const bool ok1 = in1 && mask_s[key0 + 1] > 0.5f;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = g + 8 * (e >> 1);
              float sm = lo_hi[e >> 1];
              if (band == 1) {
                int off = key0 + (e & 1) - (q0 + row);
                off = (off < -rr ? -rr : (off > rr ? rr : off)) + rr;
                sm = small_w[row * pp + off];
              }
              float v = -INFINITY;
              if ((e & 1) ? in1 : in0)
                v = ((e & 1) ? ok1 : ok0) ? sc[j][e] * inv + sm : MASK_MIN;
              if ((e & 1) ? ok1 : ok0) valid |= 1u << (4 * j + e);
              sc[j][e] = v;
              mx[e >> 1] = fmaxf(mx[e >> 1], v);
            }
          }
          if (pass == 0) {
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              const float m_new = fmaxf(m_run[h2], mx[h2]);
              const float corr =
                  m_run[h2] == m_new ? 1.f : __expf(m_run[h2] - m_new);
              float sum = 0.f;
#pragma unroll
              for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 2 * h2; e < 2 * h2 + 2; ++e)
                  if ((valid >> (4 * j + e)) & 1u)
                    sum += __expf(sc[j][e] - m_new);
              l_run[h2] = l_run[h2] * corr + sum;
              m_run[h2] = m_new;
            }
            continue;
          }
          // pass 2: weights rounded to bf16, then O += P V; l_run holds
          // 1 / den here
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sc[j][e] = ((valid >> (4 * j + e)) & 1u)
                             ? __expf(sc[j][e] - m_run[e >> 1]) * l_run[e >> 1]
                             : 0.f;
#pragma unroll
          for (int kc = 0; kc < 4; ++kc) {
            uint32_t pa[4];
            pa[0] = pack_bf16(sc[2 * kc][0], sc[2 * kc][1]);
            pa[1] = pack_bf16(sc[2 * kc][2], sc[2 * kc][3]);
            pa[2] = pack_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1]);
            pa[3] = pack_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3]);
            const int r = sub + kc * 16 + (lane & 15);
#pragma unroll
            for (int dp = 0; dp < KS; ++dp) {
              if (dp >= nks) break;
              const int c = dp * 2 + (lane >> 4);
              uint32_t bb[4];
              ldsm_x4_t(smem_u32(v_s + (r * NCH + (c ^ (r & 7))) * 16), bb);
              mma_16816(o[2 * dp], pa, bb[0], bb[1]);
              mma_16816(o[2 * dp + 1], pa, bb[2], bb[3]);
            }
          }
        }
      }
      if (pass == 0) {
        // the row's max and sum over the quad's lanes; den as the TPU
        // kernel's max(sum, 1e-30), its reciprocal kept in l_run
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          float m = m_run[h2];
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
          float l =
              m_run[h2] == m ? l_run[h2] : l_run[h2] * __expf(m_run[h2] - m);
          l += __shfl_xor_sync(0xffffffffu, l, 1);
          l += __shfl_xor_sync(0xffffffffu, l, 2);
          m_run[h2] = m;
          l_run[h2] = 1.f / fmaxf(l, 1e-30f);
        }
      }
    }
    if (active) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int qi = q0 + g + 8 * h2;
        if (qi >= T_) continue;
        bf16* crow = s.ctx + (row0 + qi) * D + col0;
#pragma unroll
        for (int j = 0; j < RW / 8; ++j) {
          const int col = 8 * j + 2 * qd;
          if (col >= dk) continue;
          const float c0 = o[j][2 * h2], c1 = o[j][2 * h2 + 1];
          if ((dk & 1) == 0) {
            st_bf2(crow + col, c0, c1);
          } else {
            crow[col] = __float2bfloat16(c0);
            if (col + 1 < dk) crow[col + 1] = __float2bfloat16(c1);
          }
        }
      }
    }
  }
}

// ------------------------------------------------------------- the kernels

__global__ void __launch_bounds__(TC_THREADS, 1)
half_a_tc_kernel(const __grid_constant__ TcMaps mp, Args a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const TcSmem sm = tc_smem_init(smem_raw);
  Scratch<bf16> s =
      carve<bf16>(HALF_A, a, OUT(unsigned char, P_SCRATCH), nullptr);
  unsigned int target = 0;
  uint32_t it = 0;
  const int M = a.B * a.T, D = a.D, F = a.F;
  const bf16* x = ARG(bf16, P_X);
  const float* norms = ARG(float, P_NORMS);
  const float* b1 = ARG(float, P_B1A);
  const float* b2 = ARG(float, P_B2A);
  const float* bqkv = ARG(float, P_BQKV);
  const float* ub = ARG(float, P_UBIAS);
  const float* bo = ARG(float, P_BO);
  bf16* out = OUT(bf16, P_OUT);

  layernorm_rows<bf16, bf16>(x, s.h, norms, norms + D, M, D, (bf16*)nullptr);
  grid_sync(s.bar, target);
  tc_product(mp, 0, M, F, D, sm, it, EpiSwish{s.m, b1, F});
  grid_sync(s.bar, target);
  tc_product(mp, 1, M, D, F, sm, it,
             EpiResidual<bf16, float>{x, b2, s.x1, D, 0.5f});
  grid_sync(s.bar, target);
  layernorm_rows<float, bf16>(s.x1, s.ln, norms + 2 * D, norms + 3 * D, M, D,
                              (bf16*)nullptr);
  grid_sync(s.bar, target);
  tc_product(mp, 2, M, 3 * D, D, sm, it,
             EpiQKV{s.qu, s.qv, s.k, s.v, bqkv, ub, D});
  grid_sync(s.bar, target);
  const size_t budget = SMEM_LIMIT - 1024 - TC_BARS;
  if (a.dk <= 64)  // attn_tc_layout's row width
    attention_tc<64>(a, s, sm.region, budget);
  else
    attention_tc<128>(a, s, sm.region, budget);
  grid_sync(s.bar, target);
  tc_product(mp, 3, M, D, D, sm, it,
             EpiResidual<float, bf16>{s.x1, bo, out, D, 1.f});
}

__global__ void __launch_bounds__(TC_THREADS, 1)
half_b_tc_kernel(const __grid_constant__ TcMaps mp, Args a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ float red[32];
  const TcSmem sm = tc_smem_init(smem_raw);
  Scratch<bf16> s =
      carve<bf16>(HALF_B, a, OUT(unsigned char, P_SCRATCH), nullptr);
  unsigned int target = 0;
  uint32_t it = 0;
  const int M = a.B * a.T, D = a.D, F = a.F;
  const bf16* x = ARG(bf16, P_X);
  const float* norms = ARG(float, P_NORMS);
  const float* pw1b = ARG(float, P_PW1B);
  const float* pw2b = ARG(float, P_PW2B);
  const float* b1 = ARG(float, P_B1B);
  const float* b2 = ARG(float, P_B2B);
  bf16* out = OUT(bf16, P_OUT);

  layernorm_rows<bf16, bf16>(x, s.h, norms + 4 * D, norms + 5 * D, M, D,
                             (bf16*)nullptr);
  grid_sync(s.bar, target);
  tc_product(mp, 0, M, 2 * D, D, sm, it,
             EpiResidual<float, float>{nullptr, pw1b, s.pw, 2 * D, 1.f});
  grid_sync(s.bar, target);
  conv_module_phases<bf16, TC_THREADS>(
      a, s, sm.region,
      (size_t)TC_STAGES * TC_STAGE + EPI_VEC_BYTES, red,
      target);
  grid_sync(s.bar, target);
  tc_product(mp, 1, M, D, D, sm, it,
             EpiResidual<bf16, float>{x, pw2b, s.x2, D, 1.f});
  grid_sync(s.bar, target);
  layernorm_rows<float, bf16>(s.x2, s.h2, norms + 6 * D, norms + 7 * D, M, D,
                              (bf16*)nullptr);
  grid_sync(s.bar, target);
  tc_product(mp, 2, M, F, D, sm, it, EpiSwish{s.m2, b1, F});
  grid_sync(s.bar, target);
  tc_product(mp, 3, M, D, F, sm, it,
             EpiResidual<float, bf16>{s.x2, b2, out, D, 0.5f});
}

// ------------------------------------------------------------ host side

bool make_args(const unsigned long long* ptrs, const int* dims, Args* a) {
  a->B = dims[0];
  a->T = dims[1];
  a->D = dims[2];
  a->F = dims[3];
  a->H = dims[4];
  a->K = dims[5];
  a->P = dims[6];
  a->tq = dims[7];
  if (a->B < 1 || a->T < 1 || a->H < 1 || a->D % a->H) return false;
  a->dk = a->D / a->H;
  a->r = (a->P - 1) / 2;
  a->inv_sqrt_dk = (float)(1.0 / sqrt((double)a->dk));
  for (int i = 0; i < P_COUNT; ++i)
    a->p[i] = reinterpret_cast<const void*>(ptrs[i]);
  return a->D % 8 == 0 && a->F % 8 == 0 && a->dk <= MAX_DK && a->K >= 1 &&
         a->K <= MAX_KERNEL && a->P >= 1 && a->P % 2 == 1 && a->tq >= 1;
}

template <typename T>
size_t scratch_for(int kind, const Args& a) {
  size_t n = 0;
  carve<T>(kind, a, nullptr, &n);
  return n;
}

template <typename Kern>
int launch_coop(Kern kern, const Args& a, size_t smem, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // the barrier counter is the first word of scratch (see carve)
  e = cudaMemsetAsync(OUT(unsigned int, P_SCRATCH), 0, sizeof(unsigned int),
                      st);
  if (e != cudaSuccess) return (int)e;
  Args copy = a;
  void* params[] = {&copy};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern),
                                  dim3(per_sm * sms), dim3(NT), params, smem,
                                  st);
  return (int)e;
}

// ---------------------------------------------------- bf16 route, host

size_t tc_smem_bytes(int kind, const Args& a) {
  size_t n = (size_t)TC_STAGES * TC_STAGE + EPI_VEC_BYTES;
  if (kind == HALF_A) {
    const size_t at =
        attn_tc_layout(a.T, a.dk, a.P, SMEM_LIMIT - 1024 - TC_BARS).bytes;
    n = at > n ? at : n;
  } else {
    const size_t dw = (size_t)(DT + a.K - 1) * DT * sizeof(float);
    const size_t gn = (size_t)2 * a.B * sizeof(float);
    n = dw > n ? dw : n;
    n = gn > n ? gn : n;
  }
  return 1024 + TC_BARS + n;  // + the slack of the 1024-byte alignment
}

template <typename T>
size_t smem_for(int kind, const Args& a) {
  if constexpr (std::is_same<T, bf16>::value)
    if (kind == HALF_A || kind == HALF_B) return tc_smem_bytes(kind, a);
  return smem_bytes<T>(kind, a);
}

// Tile width of a product: the fewest rounds of tiles over the grid, each
// round costing the tile's width (a partial column tile costs as much as a
// full one); 128 on a tie.
int choose_bn(int M, int N, int grid) {
  int best = 0;
  long best_cost = 0;
  for (int bn : {128, 192}) {
    const long tiles = (long)cdiv(M, TBM) * cdiv(N, bn);
    const long cost = (tiles + grid - 1) / grid * bn;
    if (best == 0 || cost < best_cost) {
      best = bn;
      best_cost = cost;
    }
  }
  return best;
}

// The launch plan of a bf16 half: grid (one block an SM, by occupancy),
// shared memory, and per product (phase order) N, K, tile width, tiles.
struct TcPlan {
  int grid, smem;
  int n[N_PROD], k[N_PROD], bn[N_PROD], tiles[N_PROD];
};

int tc_plan(int kind, const Args& a, TcPlan* p) {
  const void* kern = kind == HALF_A
                         ? reinterpret_cast<const void*>(half_a_tc_kernel)
                         : reinterpret_cast<const void*>(half_b_tc_kernel);
  p->smem = (int)tc_smem_bytes(kind, a);
  if (p->smem > (int)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p->smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                    TC_THREADS, p->smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  p->grid = per_sm * sms;
  const int D = a.D, F = a.F, M = a.B * a.T;
  const int nk_a[N_PROD][2] = {{F, D}, {D, F}, {3 * D, D}, {D, D}};
  const int nk_b[N_PROD][2] = {{2 * D, D}, {D, D}, {F, D}, {D, F}};
  for (int i = 0; i < N_PROD; ++i) {
    p->n[i] = kind == HALF_A ? nk_a[i][0] : nk_b[i][0];
    p->k[i] = kind == HALF_A ? nk_a[i][1] : nk_b[i][1];
    p->bn[i] = choose_bn(M, p->n[i], p->grid);
    p->tiles[i] = cdiv(M, TBM) * cdiv(p->n[i], p->bn[i]);
  }
  return 0;
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

// a row-major (rows, k) bf16 array in boxes of `box_rows` x TBK, 128-byte
// swizzle, zero fill past its edges
bool encode_rows(EncodeTiledFn enc, CUtensorMap* map, const void* base,
                 int k, int rows, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)k * 2};
  const cuuint32_t box[2] = {(cuuint32_t)TBK, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(base), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// bf16 half_a / half_b: the products' tensor maps are encoded per call
// (scratch is allocated per call) and passed as a __grid_constant__
// parameter; the weights are packed (N, K).
int launch_tc(int kind, const Args& a, cudaStream_t st) {
  TcPlan p;
  int err = tc_plan(kind, a, &p);
  if (err != 0) return err;
  EncodeTiledFn enc = encode_fn();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  Scratch<bf16> s = carve<bf16>(kind, a, OUT(unsigned char, P_SCRATCH),
                                nullptr);
  const bf16* acts_a[N_PROD] = {s.h, s.m, s.ln, s.ctx};
  const bf16* acts_b[N_PROD] = {s.h, s.gs, s.h2, s.m2};
  const int w_a[N_PROD] = {P_W1A, P_W2A, P_WQKV, P_WO};
  const int w_b[N_PROD] = {P_PW1, P_PW2, P_W1B, P_W2B};
  const int M = a.B * a.T;
  TcMaps mp;
  for (int i = 0; i < N_PROD; ++i) {
    const bf16* act = kind == HALF_A ? acts_a[i] : acts_b[i];
    const void* w = a.p[kind == HALF_A ? w_a[i] : w_b[i]];
    if (!encode_rows(enc, &mp.a[i], act, p.k[i], M, TBM) ||
        !encode_rows(enc, &mp.w[i], w, p.k[i], p.n[i], p.bn[i]))
      return (int)cudaErrorInvalidValue;
    mp.bn[i] = p.bn[i];
  }
  cudaError_t e = cudaMemsetAsync(OUT(unsigned int, P_SCRATCH), 0,
                                  sizeof(unsigned int), st);
  if (e != cudaSuccess) return (int)e;
  Args copy = a;
  void* params[] = {&mp, &copy};
  const void* kern = kind == HALF_A
                         ? reinterpret_cast<const void*>(half_a_tc_kernel)
                         : reinterpret_cast<const void*>(half_b_tc_kernel);
  e = cudaLaunchCooperativeKernel(kern, dim3(p.grid), dim3(TC_THREADS),
                                  params, p.smem, st);
  return (int)e;
}

template <typename T>
int run(int kind, const Args& a, cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value)
    if (kind == HALF_A || kind == HALF_B) return launch_tc(kind, a, st);
  const size_t smem = smem_bytes<T>(kind, a);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  switch (kind) {
    case HALF_A:
      if constexpr (std::is_same<T, float>::value)
        return launch_coop(half_a_kernel<float>, a, smem, st);
      break;
    case HALF_B:
      if constexpr (std::is_same<T, float>::value)
        return launch_coop(half_b_kernel<float>, a, smem, st);
      break;
    case HALF_A_KV:
      return launch_coop(half_a_kv_kernel<T>, a, smem, st);
    case HALF_A_QBLOCK: {
      cudaError_t e = cudaFuncSetAttribute(
          half_a_qblock_kernel<T>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
      half_a_qblock_kernel<T>
          <<<dim3(cdiv(a.T, a.tq), a.B), NT, smem, st>>>(a);
      return (int)cudaGetLastError();
    }
  }
  return (int)cudaErrorInvalidValue;
}

int entry(int kind, const unsigned long long* ptrs, const int* dims,
          int dtype, void* stream) {
  Args a;
  if (!make_args(ptrs, dims, &a)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<float>(kind, a, st);
  if (dtype == 1) return run<bf16>(kind, a, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Comma-separated names of the pointer slots, in the order the entries take
// them; the Python wrapper checks its own list against it.
const char* cassnat_conformer_ptr_names() { return PTR_NAMES; }

// Bytes of device scratch that `kind` needs (0 if the dims are refused);
// dims = {B, T, D, F, H, K, P, tq}.
unsigned long long cassnat_conformer_scratch_bytes(int kind, const int* dims,
                                                   int dtype) {
  Args a;
  unsigned long long zero[P_COUNT] = {};
  if (!make_args(zero, dims, &a)) return 0;
  return dtype == 1 ? scratch_for<bf16>(kind, a) : scratch_for<float>(kind, a);
}

// Dynamic shared memory per block that `kind` needs at these dims.
unsigned long long cassnat_conformer_smem_bytes(int kind, const int* dims,
                                                int dtype) {
  Args a;
  unsigned long long zero[P_COUNT] = {};
  if (!make_args(zero, dims, &a)) return 0;
  return dtype == 1 ? smem_for<bf16>(kind, a) : smem_for<float>(kind, a);
}

// The bf16 route's launch plan of half_a (kind 0) or half_b (1), for logs:
// out[0..3] = grid, threads, dynamic shared memory bytes, ring stages;
// then per product in phase order (half A: W1A, W2A, WQKV, WO; half B:
// PW1, PW2, W1B, W2B) N, K, tile rows, tile columns, tiles (out[4..23]).
// Returns 0 or a cudaError_t.
int cassnat_conformer_plan(int kind, const int* dims, int* out) {
  Args a;
  unsigned long long zero[P_COUNT] = {};
  if (!make_args(zero, dims, &a) || (kind != HALF_A && kind != HALF_B))
    return (int)cudaErrorInvalidValue;
  TcPlan p;
  const int e = tc_plan(kind, a, &p);
  if (e != 0) return e;
  out[0] = p.grid;
  out[1] = TC_THREADS;
  out[2] = p.smem;
  out[3] = TC_STAGES;
  for (int i = 0; i < N_PROD; ++i) {
    const int v[5] = {p.n[i], p.k[i], TBM, p.bn[i], p.tiles[i]};
    for (int j = 0; j < 5; ++j) out[4 + 5 * i + j] = v[j];
  }
  return 0;
}

int cassnat_conformer_half_a(const unsigned long long* ptrs, const int* dims,
                             int dtype, void* stream) {
  return entry(HALF_A, ptrs, dims, dtype, stream);
}

int cassnat_conformer_half_b(const unsigned long long* ptrs, const int* dims,
                             int dtype, void* stream) {
  return entry(HALF_B, ptrs, dims, dtype, stream);
}

int cassnat_conformer_half_a_kv(const unsigned long long* ptrs,
                                const int* dims, int dtype, void* stream) {
  return entry(HALF_A_KV, ptrs, dims, dtype, stream);
}

int cassnat_conformer_half_a_qblock(const unsigned long long* ptrs,
                                    const int* dims, int dtype,
                                    void* stream) {
  return entry(HALF_A_QBLOCK, ptrs, dims, dtype, stream);
}

}  // extern "C"
