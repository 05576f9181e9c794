// CTC Viterbi (max-product) forced alignment for sm_90a, with the
// backtrace and the collapse-and-shift in the same kernel.
//
// Replaces cassnat_asr_public_tpu/kernels/ctc_viterbi.py:70
// `ctc_viterbi_align_pallas` (Pallas `_viterbi_kernel` :34) and its
// backtrace outside the kernel (:119-147).
//
// One DP block per batch row over the blank-interleaved path of S = 2U+1
// states (path[s] = blank for even s, labels[b, s/2] for odd s), laid out
// as ctc_dp.cuh says: gather blocks (beside the DP blocks in one
// cooperative launch, or in a launch of their own ahead of it) copy lp[b,
// t, path[s]] into a scratch of padded rows, chunk by chunk; the DP
// block's W warps hold K contiguous states a lane in registers (K from S
// alone), take neighbours by __shfl_up_sync and the warps' edge states
// through shared memory with one named barrier of the DP warps a step, and
// load each frame's gathered row AHEAD
// frames before the step that needs it. Whether a state may move from s-2
// (path[s] != path[s-2]) is a register bit.
//
// Per frame t < len_b (frames past the row's length are frozen and their
// offsets are 0):
//   cand = (alpha[s], alpha[s-1], alpha[s-2] unless path[s] == path[s-2])
//   off  = first index of the max (strict > in the order stay, s-1, s-2)
//   new  = (s < 2 U_b + 1 ? max : LOG_ZERO) + lp[t, s]
// Max and add are exact, so alpha, offsets, states and the alignment equal
// the plain PyTorch version bit for bit.
//
// The DP keeps each frame's offsets as bytes in shared memory (flat t S +
// s, as the output). After the last frame thread 0 picks the final state
// (S_b-1 if its alpha beats S_b-2's, else S_b-2) and walks the offsets
// back over all T frames from shared memory, clipping to [0, S-1] as the
// JAX reverse scan does; then every thread writes the offsets to the (B,
// T, S) int32 output in 16-byte stores (beside the backtrace, their loads
// of shared memory slowed its chain of dependent ones; stored from the DP
// as int32, they backed up the memory pipe). Where a row's T x S offset
// bytes do not fit in shared memory, the launch takes the stated other
// branch (`offs_in_smem` = 0): the DP stores the offsets to the output and
// the backtrace reads them back from device memory. Then every thread
// writes aligned_seq_shift for its frames: the token of each segment's
// first frame, moved one frame right.
//
// Bound on the H100: T dependent steps of a few flops per state and a few
// bytes per state and frame; the latency of one step (a shuffle, two max
// and an add: `viterbi_step_probe` measures it) times T is the floor, not
// bytes or operations. Blocks: the gather blocks and B DP blocks.

#include "ctc_dp.cuh"

namespace {

constexpr float LOG_ZERO = -1e10f;

template <int K>
__global__ void __launch_bounds__(32 * ctcdp::MAX_WARPS)
viterbi_kernel(const float* __restrict__ lp, long long sb, long long st,
               const int* __restrict__ labels,
               const int* __restrict__ in_lens,
               const int* __restrict__ lab_lens, int B, int T, int U, int V,
               int blank, int G, int W, int offs_in_smem, float* lp_path,
               int* flags, int* __restrict__ offsets,
               float* __restrict__ alpha_out, int* __restrict__ states,
               int* __restrict__ shift) {
    // frames loaded ahead: an L2 round trip is ~8 steps of one state a lane
    constexpr int AHEAD = K >= 4 ? 4 : 16 / K;
    const int S = 2 * U + 1;
    const int P = 32 * W;                  // DP threads, K * P states
    const int SP = K * P;
    extern __shared__ __align__(16) float smem[];
    if ((int)blockIdx.x < G) {
        ctcdp::gather_chunks(lp, sb, st, labels, in_lens, B, T, U, V, blank,
                             false, SP, lp_path, flags,
                             reinterpret_cast<int*>(smem), blockIdx.x, G);
        CTC_MARK(6);
        return;
    }
    const int b = blockIdx.x - G;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    // offb's offset from a 16-byte boundary, in ints; the byte copy of the
    // offsets starts as far past one, so both are 4-aligned together
    const int mis = (int)(((long long)b * T * S) & 3);
    const size_t obytes =
        offs_in_smem ? (((size_t)T * S + 4 + 15) & ~(size_t)15) : 0;
    unsigned char* offs8 =
        reinterpret_cast<unsigned char*>(smem) + mis;     // [T][S] flat
    float* edges = reinterpret_cast<float*>(
        reinterpret_cast<unsigned char*>(smem) + obytes);  // [2][W][2]
    float* alpha_s = edges + 4 * W;                        // [K P]
    int* st_s = reinterpret_cast<int*>(alpha_s + K * P);   // [T]

    const int* lab = labels + (long long)b * U;
    const int len = in_lens[b];
    const int plen = 2 * lab_lens[b] + 1;
    const int tn = len < T ? (len > 0 ? len : 0) : T;
    const float* lpp = lp_path + (long long)b * T * SP;
    int* offb = offsets + (long long)b * T * S;

    // this lane's states: the s-2 test, the first frames loaded
    const int s0 = tid * K;
    unsigned skip2 = 0;   // bit k: no move from s-2 into state s0 + k
    ctcdp::ChunkGate gate(flags + (long long)b * ctcdp::flag_words(T));
    float buf[AHEAD][K];
    if (warp < W) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const int s = s0 + k;
            if (s < 2 || (s < S && ctcdp::path_at(lab, s, blank)
                          == ctcdp::path_at(lab, s - 2, blank)))
                skip2 |= 1u << k;
        }
        if (tn > 0) {
            gate.wait(AHEAD - 1 < tn - 1 ? AHEAD - 1 : tn - 1);
#pragma unroll
            for (int j = 0; j < AHEAD; ++j)
                ctcdp::load_k<K>(
                    lpp + (long long)(j < tn - 1 ? j : tn - 1) * SP + s0,
                    buf[j]);
        }
    }
    __syncthreads();
    CTC_MARK(1);

    if (warp < W) {
        float a[K];
#pragma unroll
        for (int k = 0; k < K; ++k) a[k] = s0 + k == 0 ? 0.0f : LOG_ZERO;
        ctcdp::Edges edge(edges, W, warp, true);
        for (int i0 = 0; i0 < tn; i0 += AHEAD) {
            // the frames this block of steps loads, AHEAD steps on (past
            // the row's end, its last frame again): the loads are
            // unconditional, so each step waits on its own load only
            gate.wait(i0 + 2 * AHEAD - 1 < tn - 1 ? i0 + 2 * AHEAD - 1
                                                  : tn - 1);
#pragma unroll
            for (int j = 0; j < AHEAD; ++j) {
                const int i = i0 + j;
                float l[K];
#pragma unroll
                for (int k = 0; k < K; ++k) l[k] = buf[j][k];
                const int tf = i + AHEAD < tn - 1 ? i + AHEAD : tn - 1;
                ctcdp::load_k<K>(lpp + (long long)tf * SP + s0, buf[j]);
                if (i >= tn) continue;
                const float2 e = edge.read(i, LOG_ZERO);   // s0-1, s0-2
                float p1 = __shfl_up_sync(ctcdp::FULL, a[K - 1], 1);
                float p2;
                if (K >= 2)
                    p2 = __shfl_up_sync(ctcdp::FULL, a[K >= 2 ? K - 2 : 0],
                                        1);
                else
                    p2 = __shfl_up_sync(ctcdp::FULL, a[0], 2);
                if (lane == 0) { p1 = e.x; p2 = e.y; }
                if (K == 1 && lane == 1) p2 = e.x;
                float na[K];
#pragma unroll
                for (int k = 0; k < K; ++k) {
                    const int s = s0 + k;
                    const float a0 = a[k];
                    float a1 = k >= 1 ? a[k >= 1 ? k - 1 : 0] : p1;
                    float a2 = k >= 2 ? a[k >= 2 ? k - 2 : 0]
                                      : (k == 1 ? p1 : p2);
                    if (s == 0) a1 = LOG_ZERO;
                    if ((skip2 >> k) & 1u) a2 = LOG_ZERO;
                    const float m01 = fmaxf(a0, a1);
                    int off = a1 > a0 ? 1 : 0;
                    float best = fmaxf(m01, a2);
                    if (a2 > m01) off = 2;
                    if (s >= plen) best = LOG_ZERO;
                    na[k] = best + l[k];
                    if (s < S) {
                        if (offs_in_smem)
                            offs8[(size_t)i * S + s] = (unsigned char)off;
                        else
                            offb[(long long)i * S + s] = off;
                    }
                }
#pragma unroll
                for (int k = 0; k < K; ++k) a[k] = na[k];
                // states s0+K-1 and s0+K-2 of lane 31 are the next warp's
                // s-1 and s-2
                float v1;
                if (K >= 2) v1 = a[K >= 2 ? K - 2 : 0];
                else v1 = __shfl_sync(ctcdp::FULL, a[0], 30);
                edge.write(i, warp, lane == 31, a[K - 1], v1);
            }
        }
#pragma unroll
        for (int k = 0; k < K; ++k) alpha_s[s0 + k] = a[k];
    }
    __syncthreads();
    CTC_MARK(2);

    const long long n = (long long)T * S, lim = (long long)tn * S;
    if (!offs_in_smem)
        for (long long q = lim + tid; q < n; q += blockDim.x) offb[q] = 0;
    for (int s = tid; s < S; s += blockDim.x)
        alpha_out[(long long)b * S + s] = alpha_s[s];
    if (tid == 0) {
        const int p1 = plen - 1;
        const int p2 = plen - 2 > 0 ? plen - 2 : 0;
        const float last = alpha_s[p1 < S ? p1 : S - 1];
        const float prev = alpha_s[p2 < S ? p2 : S - 1];
        const int s_final = last > prev ? p1 : p2;
        int carry = s_final;
        for (int t = T - 1; t >= 0; --t) {
            const int cur = t == len - 1 ? s_final : carry;
            st_s[t] = cur;
            const int c = cur < 0 ? 0 : (cur >= S ? S - 1 : cur);
            int off = 0;
            if (t < tn)
                off = offs_in_smem ? offs8[(size_t)t * S + c]
                                   : offb[(long long)t * S + c];
            const int p = cur - off;
            carry = p < 0 ? 0 : (p > S - 1 ? S - 1 : p);
        }
    }
    __syncthreads();
    CTC_MARK(3);

    if (offs_in_smem) {
        // the offsets to the output, 16 bytes a store (after the
        // backtrace: beside it, these loads of shared memory slowed its
        // chain of dependent ones)
        const int nt = blockDim.x, wi = tid;
        const long long h0 = (4 - mis) & 3;
        const long long h = h0 < n ? h0 : n;
        const long long body = h + (n - h) / 4 * 4;
        for (long long q = wi; q < h; q += nt)
            offb[q] = q < lim ? offs8[q] : 0;
        for (long long q = h + 4LL * wi; q < body; q += 4LL * nt) {
            const unsigned w4 = *reinterpret_cast<const unsigned*>(offs8 + q);
            int4 v;
            v.x = q < lim ? (int)(w4 & 0xff) : 0;
            v.y = q + 1 < lim ? (int)((w4 >> 8) & 0xff) : 0;
            v.z = q + 2 < lim ? (int)((w4 >> 16) & 0xff) : 0;
            v.w = q + 3 < lim ? (int)(w4 >> 24) : 0;
            *reinterpret_cast<int4*>(offb + q) = v;
        }
        for (long long q = body + wi; q < n; q += nt)
            offb[q] = q < lim ? offs8[q] : 0;
    }

    // aligned_seq = path[state] on valid frames, blank elsewhere; keep the
    // first frame of each segment, then move it one frame right
    for (int t = tid; t < T; t += blockDim.x) {
        states[(long long)b * T + t] = st_s[t];
        int out = blank;
        if (t >= 1) {
            const int u = t - 1;
            const int tok =
                u < len ? ctcdp::path_at(lab, st_s[u], blank) : blank;
            int before = blank;
            if (u >= 1 && u - 1 < len)
                before = ctcdp::path_at(lab, st_s[u - 1], blank);
            out = tok == before ? blank : tok;
        }
        shift[(long long)b * T + t] = out;
    }
}

// One warp running `steps` Viterbi steps in a dependent chain: a shuffle
// from the neighbouring lane, two max and an add. Writes the elapsed
// %globaltimer ns and clock cycles; the floor of a T-frame DP is T steps.
__global__ void viterbi_step_probe(const float* __restrict__ in, int steps,
                                   float* __restrict__ out,
                                   long long* __restrict__ elapsed) {
    const int lane = threadIdx.x;
    float x = in[lane];
    const float r = in[32 + lane], l = in[64 + lane];
    long long t0, c0, t1, c1;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0) : "f"(x));
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(c0) : "f"(x));
    for (int i = 0; i < steps; ++i) {
        const float p = __shfl_up_sync(ctcdp::FULL, x, 1);
        x = fmaxf(fmaxf(x, p), r) + l;
    }
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(c1) : "f"(x));
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1) : "f"(x));
    out[lane] = x;
    if (lane == 0) {
        elapsed[0] = t1 - t0;
        elapsed[1] = c1 - c0;
    }
}

int max_smem_optin() {
    int dev = 0, v = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return 48 * 1024;
    if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess)
        return 48 * 1024;
    return v;
}

// The gather blocks and the B DP blocks in one cooperative launch, or
// apart where no gather block fits beside the rows (ctc_dp.cuh).
template <int K>
int launch(const float* lp, long long sb, long long st, const int* labels,
           const int* in_lens, const int* lab_lens, int B, int T, int U,
           int V, int blank, int W, float* lp_path, int* flags,
           int* offsets, float* alpha, int* states, int* shift,
           cudaStream_t stream) {
    const int S = 2 * U + 1;
    const int P = 32 * W;
    const int threads = 32 * (W < 4 ? 4 : W);
    const size_t base = ctcdp::edge_bytes(W) + sizeof(float) * (size_t)K * P
        + sizeof(int) * (size_t)T;
    const size_t obytes = ((size_t)T * S + 4 + 15) & ~(size_t)15;
    const size_t limit = (size_t)max_smem_optin();
    int offs_in_smem = base + obytes <= limit;
    const size_t smem = offs_in_smem ? base + obytes : base;
    if (smem > limit) return (int)cudaErrorInvalidValue;
    const void* kern = (const void*)viterbi_kernel<K>;
    cudaError_t e = cudaSuccess;
    if (smem > 48 * 1024)
        e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    ctcdp::LaunchPlan plan;
    if (e == cudaSuccess)
        e = ctcdp::launch_plan(kern, B, T, threads, smem, &plan);
    if (e != cudaSuccess) return (int)e;
    int G = plan.G;
    if (plan.together) {
        void* args[] = {&lp, &sb, &st, &labels, &in_lens, &lab_lens, &B,
                        &T, &U, &V, &blank, &G, &W, &offs_in_smem,
                        &lp_path, &flags, &offsets, &alpha, &states,
                        &shift};
        return (int)cudaLaunchCooperativeKernel(kern, dim3(G + B),
                                                dim3(threads), args, smem,
                                                stream);
    }
    viterbi_kernel<K><<<G, threads, sizeof(int) * (size_t)S, stream>>>(
        lp, sb, st, labels, in_lens, lab_lens, B, T, U, V, blank, G, W,
        offs_in_smem, lp_path, flags, offsets, alpha, states, shift);
    viterbi_kernel<K><<<B, threads, smem, stream>>>(
        lp, sb, st, labels, in_lens, lab_lens, B, T, U, V, blank, 0, W,
        offs_in_smem, lp_path, flags, offsets, alpha, states, shift);
    return (int)cudaGetLastError();
}

}  // namespace

// The layout follows from S (ctcdp::layout_for); lp_path (B, T, SP) f32
// scratch and flags (B, flag words) int32 zeros, of the sizes
// cassnat_ctc_dp_scratch gives
extern "C" int cassnat_ctc_viterbi(const float* lp, long long sb,
                                   long long st, const int* labels,
                                   const int* in_lens, const int* lab_lens,
                                   int B, int T, int U, int V, int blank,
                                   float* lp_path, int* flags, int* offsets,
                                   float* alpha, int* states, int* shift,
                                   void* stream) {
    if (B <= 0 || T <= 0) return 0;
    const ctcdp::Layout L = ctcdp::layout_for(2 * U + 1);
    if (L.W > ctcdp::MAX_WARPS) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (L.K) {
    case 1: return launch<1>(lp, sb, st, labels, in_lens, lab_lens, B, T, U,
                             V, blank, L.W, lp_path, flags, offsets, alpha,
                             states, shift, s);
    case 2: return launch<2>(lp, sb, st, labels, in_lens, lab_lens, B, T, U,
                             V, blank, L.W, lp_path, flags, offsets, alpha,
                             states, shift, s);
    case 4: return launch<4>(lp, sb, st, labels, in_lens, lab_lens, B, T, U,
                             V, blank, L.W, lp_path, flags, offsets, alpha,
                             states, shift, s);
    default: return launch<8>(lp, sb, st, labels, in_lens, lab_lens, B, T,
                              U, V, blank, L.W, lp_path, flags, offsets,
                              alpha, states, shift, s);
    }
}

// The scratch a row of either rebuilt CTC DP needs at T frames and S
// states: sizes[0] floats of gathered path log-probs, sizes[1] int32 words
// of chunk flags. Fails where S does not fit the layout.
extern "C" int cassnat_ctc_dp_scratch(int T, int S, long long* sizes) {
    const ctcdp::Layout L = ctcdp::layout_for(S);
    if (T < 0 || S <= 0 || L.W > ctcdp::MAX_WARPS)
        return (int)cudaErrorInvalidValue;
    sizes[0] = (long long)T * L.SP;
    sizes[1] = ctcdp::flag_words(T);
    return 0;
}

// The probe: `steps` dependent steps on one warp; elapsed[0] ns,
// elapsed[1] clock cycles.
extern "C" int cassnat_ctc_viterbi_step_probe(const float* in, int steps,
                                              float* out, long long* elapsed,
                                              void* stream) {
    viterbi_step_probe<<<1, 32, 0, (cudaStream_t)stream>>>(in, steps, out,
                                                           elapsed);
    return (int)cudaGetLastError();
}
