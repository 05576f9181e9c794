// CTC loss forward (alpha) and backward (beta + posterior gradient) for
// sm_90a.
//
// Replaces cassnat_asr_public_tpu/kernels/ctc_loss.py:209
// `ctc_forward_score_pallas`: `_alpha_kernel` :47, `_beta_grad_kernel` :77
// and the one-hot scatter of the gradient to the vocabulary in its custom
// VJP (:243-245).
//
// ctc_alpha_kernel      one block per batch row, threads over the S = 2U+1
//                       path states, alpha of frames t-1 and t in shared
//                       memory; each thread gathers lp[b, t, path[s]] from
//                       the (B, T, V) log-probs one frame ahead. Per frame
//                       t < len_b: alpha = logaddexp3(stay, s-1, s-2 unless
//                       path[s] == path[s-2]) + lp, LOG_ZERO for s >= 2U_b+1.
//                       Writes the trellis rows t < len_b (the backward
//                       reads no other row) and the score
//                       logaddexp(alpha[S_b-1], alpha[S_b-2] if S_b >= 2).
// ctc_beta_grad_kernel  one block per batch row, frames walked backwards
//                       from len_b-1 by warps with their states in
//                       registers, the emissions gathered by other blocks
//                       of the launch and loaded ahead with the alpha rows
//                       (ctc_dp.cuh, and the note above the kernel): beta
//                       (emission at t included) and
//                       d logZ / d lp_path[t, s] = exp(min(alpha + beta - lp
//                       - logZ, 1)), 0 outside the row's states and for an
//                       impossible row (logZ <= LOG_ZERO / 2). Writes the
//                       (B, T, S) posterior rows t < len_b, and once per row
//                       each state's next state with the same token (or -1)
//                       and whether it is the token's first state.
// ctc_grad_scatter_kernel  one block per (b, t): zero the vocabulary row of
//                       the gradient, then for each token's first state sum
//                       the posteriors of all states with that token in
//                       increasing s, times the row's cotangent, into that
//                       token's column. Every column is written by one
//                       thread in a fixed order: no atomics, and two
//                       backward passes give identical bits.
//
// logaddexp3 clamps to LOG_ZERO when its max is <= LOG_ZERO / 2, as the TPU
// kernel's `_logaddexp3` (:39-44) does. Built without fast math: expf, logf
// and log1pf are the accurate ones.
//
// Bound on the H100: the two DPs are T dependent steps each, latency bound
// like the Viterbi kernel (the alpha DP with one block barrier per frame,
// the beta DP without one; `beta_step_probe` measures the least time of
// one beta step, T of which are its floor); the scatter writes the (B, T,
// V) f32 gradient, which is the bytes of the backward.

#include "ctc_dp.cuh"

namespace {

constexpr float LOG_ZERO = -1e10f;
constexpr int MAXK = 4;   // states per thread: S <= MAXK * blockDim

__device__ __forceinline__ int path_at(const int* lab, int s, int blank) {
    return (s & 1) ? lab[s >> 1] : blank;
}

__device__ __forceinline__ float logaddexp3(float a, float b, float c) {
    float m = fmaxf(fmaxf(a, b), c);
    float out = m + logf(expf(a - m) + expf(b - m) + expf(c - m));
    return m <= LOG_ZERO / 2 ? LOG_ZERO : out;
}

__device__ __forceinline__ float logaddexp2(float a, float b) {
    float m = fmaxf(a, b);
    return m + log1pf(expf(-fabsf(a - b)));
}

__global__ void ctc_alpha_kernel(const float* __restrict__ lp, long long sb,
                                 long long st, const int* __restrict__ labels,
                                 const int* __restrict__ in_lens,
                                 const int* __restrict__ lab_lens, int T,
                                 int U, int V, int blank,
                                 float* __restrict__ alpha_all,
                                 float* __restrict__ score) {
    extern __shared__ float smem[];
    const int S = 2 * U + 1;
    const int b = blockIdx.x;
    float* a_prev = smem;
    float* a_next = smem + S;
    const int* lab = labels + (long long)b * U;
    const int len = in_lens[b];
    const int plen = 2 * lab_lens[b] + 1;
    const int tn = len < T ? (len > 0 ? len : 0) : T;
    const float* lpb = lp + (long long)b * sb;
    float* ab = alpha_all + (long long)b * T * S;

    for (int s = threadIdx.x; s < S; s += blockDim.x)
        a_prev[s] = s == 0 ? 0.0f : LOG_ZERO;
    __syncthreads();

    float lp_cur[MAXK];
    int col[MAXK];    // the state's token
    int vcol[MAXK];   // its column in lp, clamped into [0, V) for safety
    bool skip2[MAXK];
    for (int k = 0; k < MAXK; ++k) {
        int s = threadIdx.x + k * blockDim.x;
        col[k] = s < S ? path_at(lab, s, blank) : 0;
        skip2[k] = s < 2 || (s < S && col[k] == path_at(lab, s - 2, blank));
        vcol[k] = col[k] < 0 ? 0 : (col[k] >= V ? V - 1 : col[k]);
        lp_cur[k] = (s < S && tn > 0) ? lpb[vcol[k]] : 0.0f;
    }
    for (int t = 0; t < tn; ++t) {
        float lp_nxt[MAXK];
        for (int k = 0; k < MAXK; ++k) {
            int s = threadIdx.x + k * blockDim.x;
            lp_nxt[k] = (s < S && t + 1 < tn)
                ? lpb[(long long)(t + 1) * st + vcol[k]] : 0.0f;
        }
        for (int k = 0; k < MAXK; ++k) {
            int s = threadIdx.x + k * blockDim.x;
            if (s >= S) break;
            float a0 = a_prev[s];
            float a1 = s >= 1 ? a_prev[s - 1] : LOG_ZERO;
            float a2 = skip2[k] ? LOG_ZERO : a_prev[s - 2];
            float v = logaddexp3(a0, a1, a2) + lp_cur[k];
            if (s >= plen) v = LOG_ZERO;
            a_next[s] = v;
            ab[(long long)t * S + s] = v;
            lp_cur[k] = lp_nxt[k];
        }
        __syncthreads();
        float* tmp = a_prev; a_prev = a_next; a_next = tmp;
    }
    if (threadIdx.x == 0) {
        int p1 = plen - 1 < S ? plen - 1 : S - 1;
        float last = a_prev[p1];
        float prev = plen >= 2 ? a_prev[plen - 2 < S ? plen - 2 : S - 1]
                               : LOG_ZERO;
        score[b] = logaddexp2(last, prev);
    }
}

// The beta/posterior DP (ctc_dp.cuh's layout): G gather blocks (the
// launch's first, or a launch of their own ahead of it) copy lp[b, t,
// path[s]] into lp_path in the DP's frame order (t descending); the DP
// blocks hold W warps with K contiguous states a lane (K from S alone),
// neighbours s+1 and s+2 by __shfl_down_sync, the warps' edge states
// through shared memory with one named barrier of the DP warps a step; each
// lane loads its states' gathered log-probs and alpha trellis entries
// alpha[b, t, s] AHEAD frames before the step that needs them. Before the
// DP the block builds the token chains from the path's tokens in shared
// memory: each state scans the later states for its token (a blank state
// looks at most two ahead, a label state at the later label states), and
// a state is its token's first exactly when no state chains to it.
template <int K>
__global__ void __launch_bounds__(32 * ctcdp::MAX_WARPS) ctc_beta_grad_kernel(
        const float* __restrict__ lp, long long sb, long long st,
        const int* __restrict__ labels, const int* __restrict__ in_lens,
        const int* __restrict__ lab_lens, const float* __restrict__ alpha_all,
        const float* __restrict__ score, int B, int T, int U, int V,
        int blank, int G, int W, float* lp_path, int* flags,
        float* __restrict__ post,
        int* __restrict__ nxt, int* __restrict__ head) {
    // frames loaded ahead: a beta step is ~100 ns, an L2 round trip less
    // than two; the frame loop is unrolled by as much
    constexpr int AHEAD = 4;
    const int S = 2 * U + 1;
    const int P = 32 * W;                  // DP threads, K * P states
    const int SP = K * P;
    extern __shared__ __align__(16) float smem[];
    if ((int)blockIdx.x < G) {
        ctcdp::gather_chunks(lp, sb, st, labels, in_lens, B, T, U, V, blank,
                             true, SP, lp_path, flags,
                             reinterpret_cast<int*>(smem), blockIdx.x, G);
        CTC_MARK(6);
        return;
    }
    const int b = blockIdx.x - G;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    float* edges = smem;                                   // [2][W][2]
    int* tok_s = reinterpret_cast<int*>(edges + 4 * W);    // [S]
    int* tgt_s = tok_s + S;                                // [S]

    const int* lab = labels + (long long)b * U;
    const int len = in_lens[b];
    const int plen = 2 * lab_lens[b] + 1;
    const int tn = len < T ? (len > 0 ? len : 0) : T;
    const float* lpp = lp_path + (long long)b * T * SP;
    const float* ab = alpha_all + (long long)b * T * S;
    float* pb = post + (long long)b * T * S;
    const float logz = score[b];
    const bool bad_z = logz <= LOG_ZERO / 2;

    // the token chains the scatter walks: next state with the same token
    for (int s = tid; s < S; s += blockDim.x) {
        tok_s[s] = path_at(lab, s, blank);
        tgt_s[s] = 0;
    }
    __syncthreads();
    for (int s = tid; s < S; s += blockDim.x) {
        const int tok = tok_s[s];
        int n = -1;
        if (tok == blank) {
            // s+1 is a blank or a label state; s+2 is then a blank state
            if (s + 1 < S && tok_s[s + 1] == blank) n = s + 1;
            else if (s + 2 < S) n = s + 2;
        } else {
            for (int r = s + 2; r < S; r += 2)
                if (tok_s[r] == tok) { n = r; break; }
        }
        nxt[(long long)b * S + s] = n;
        if (n >= 0) tgt_s[n] = 1;
    }
    __syncthreads();
    for (int s = tid; s < S; s += blockDim.x)
        head[(long long)b * S + s] = tgt_s[s] ? 0 : 1;

    // this lane's states and the first frames loaded (frames tn-1 down)
    const int s0 = tid * K;
    unsigned skip2 = 0;   // bit k: no move s0+k -> s0+k+2
    ctcdp::ChunkGate gate(flags + (long long)b * ctcdp::flag_words(T));
    float lbuf[AHEAD][K], abuf[AHEAD][K];
    if (warp < W) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const int s = s0 + k;
            if (s + 2 >= S || tok_s[s + 2] == tok_s[s]) skip2 |= 1u << k;
        }
        if (tn > 0) {
            gate.wait(AHEAD - 1 < tn - 1 ? AHEAD - 1 : tn - 1);
#pragma unroll
            for (int j = 0; j < AHEAD; ++j) {
                const int t = tn - 1 - (j < tn - 1 ? j : tn - 1);
                ctcdp::load_k<K>(lpp + (long long)t * SP + s0, lbuf[j]);
#pragma unroll
                for (int k = 0; k < K; ++k)
                    abuf[j][k] = s0 + k < S ? ab[(long long)t * S + s0 + k]
                                            : 0.0f;
            }
        }
    }
    CTC_MARK(1);

    if (warp < W) {
        float bv[K];
#pragma unroll
        for (int k = 0; k < K; ++k) bv[k] = LOG_ZERO;
        ctcdp::Edges edge(edges, W, warp, false);
        for (int i0 = 0; i0 < tn; i0 += AHEAD) {
            // the frames this block of steps loads, AHEAD steps on (past
            // the row's start, frame 0 again): the loads are unconditional,
            // so each step waits on its own loads only
            gate.wait(i0 + 2 * AHEAD - 1 < tn - 1 ? i0 + 2 * AHEAD - 1
                                                  : tn - 1);
#pragma unroll
            for (int j = 0; j < AHEAD; ++j) {
                const int i = i0 + j;
                const int t = tn - 1 - i;
                const int tf = tn - 1 - (i + AHEAD < tn - 1 ? i + AHEAD
                                                            : tn - 1);
                float l[K], a[K];
#pragma unroll
                for (int k = 0; k < K; ++k) {
                    l[k] = lbuf[j][k];
                    a[k] = abuf[j][k];
                }
                ctcdp::load_k<K>(lpp + (long long)tf * SP + s0, lbuf[j]);
#pragma unroll
                for (int k = 0; k < K; ++k)
                    abuf[j][k] = s0 + k < S ? ab[(long long)tf * S + s0 + k]
                                            : 0.0f;
                if (i >= tn) continue;
                const float2 e = edge.read(i, LOG_ZERO);   // +1, +2 past
                float n1 = __shfl_down_sync(ctcdp::FULL, bv[0], 1);
                float n2;
                if (K >= 2)
                    n2 = __shfl_down_sync(ctcdp::FULL, bv[K >= 2 ? 1 : 0],
                                          1);
                else
                    n2 = __shfl_down_sync(ctcdp::FULL, bv[0], 2);
                if (lane == 31) { n1 = e.x; n2 = e.y; }
                if (K == 1 && lane == 30) n2 = e.x;
                const bool init = t == len - 1;
                float nb[K];
#pragma unroll
                for (int k = 0; k < K; ++k) {
                    const int s = s0 + k;
                    const bool outside = s >= plen;
                    const float lk = l[k];
                    float beta;
                    if (init) {
                        const bool terminal =
                            s == plen - 1 || (s == plen - 2 && plen >= 2);
                        beta = (terminal && !outside) ? lk : LOG_ZERO;
                    } else {
                        const float l0 = bv[k];
                        float l1 = k + 1 < K ? bv[k + 1 < K ? k + 1 : 0]
                                             : n1;
                        float l2 = k + 2 < K ? bv[k + 2 < K ? k + 2 : 0]
                                             : (k + 1 < K ? n1 : n2);
                        if (s + 1 >= S) l1 = LOG_ZERO;
                        if ((skip2 >> k) & 1u) l2 = LOG_ZERO;
                        beta = outside ? LOG_ZERO
                                       : lk + logaddexp3(l0, l1, l2);
                    }
                    nb[k] = beta;
                    const float g = a[k] + beta - lk - logz;
                    const float p = expf(fminf(g, 1.0f));
                    if (s < S)
                        pb[(long long)t * S + s] =
                            (outside || bad_z) ? 0.0f : p;
                }
#pragma unroll
                for (int k = 0; k < K; ++k) bv[k] = nb[k];
                // states s0 and s0+1 of lane 0 are the previous warp's s+1
                // and s+2
                float v1;
                if (K >= 2) v1 = bv[K >= 2 ? 1 : 0];
                else v1 = __shfl_down_sync(ctcdp::FULL, bv[0], 1);
                edge.write(i, warp, lane == 0, bv[0], v1);
            }
        }
    }
    __syncthreads();
    CTC_MARK(2);
}

// One warp running `steps` beta steps in a dependent chain: a shuffle from
// the neighbouring lane, logaddexp3 (three accurate expf, one logf) and an
// add. Writes the elapsed %globaltimer ns and clock cycles.
__global__ void beta_step_probe(const float* __restrict__ in, int steps,
                                float* __restrict__ out,
                                long long* __restrict__ elapsed) {
    const int lane = threadIdx.x;
    float x = in[lane];
    const float r = in[32 + lane], l = in[64 + lane];
    long long t0, c0, t1, c1;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0) : "f"(x));
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(c0) : "f"(x));
    for (int i = 0; i < steps; ++i) {
        const float p = __shfl_down_sync(ctcdp::FULL, x, 1);
        x = logaddexp3(x, p, r) + l;
    }
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(c1) : "f"(x));
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1) : "f"(x));
    out[lane] = x;
    if (lane == 0) {
        elapsed[0] = t1 - t0;
        elapsed[1] = c1 - c0;
    }
}

__global__ void ctc_grad_scatter_kernel(
        const float* __restrict__ post, const int* __restrict__ labels,
        const int* __restrict__ in_lens, const int* __restrict__ nxt,
        const int* __restrict__ head, const float* __restrict__ cot, int T,
        int U, int V, int blank, float* __restrict__ grad) {
    extern __shared__ float smem[];
    const int S = 2 * U + 1;
    const int t = blockIdx.x;
    const int b = blockIdx.y;
    float* row = grad + ((long long)b * T + t) * V;
    for (int v = threadIdx.x; v < V; v += blockDim.x)
        row[v] = 0.0f;
    int len = in_lens[b];
    if (t >= len) return;
    float* p_s = smem;
    int* n_s = reinterpret_cast<int*>(smem + S);
    const float* pr = post + ((long long)b * T + t) * S;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
        p_s[s] = pr[s];
        n_s[s] = nxt[(long long)b * S + s];
    }
    __syncthreads();
    const int* lab = labels + (long long)b * U;
    const float g = cot[b];
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
        if (!head[(long long)b * S + s]) continue;
        float acc = 0.0f;
        for (int r = s; r >= 0; r = n_s[r])
            acc += p_s[r];
        int tok = path_at(lab, s, blank);
        if (tok >= 0 && tok < V) row[tok] = acc * g;
    }
}

int set_smem(const void* fn, size_t smem) {
    if (smem <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

int threads_for(int S) {
    int threads = ((S + 31) / 32) * 32;
    return threads > 1024 ? 1024 : threads;
}

// The gather blocks and the B DP blocks in one cooperative launch, or
// apart where no gather block fits beside the rows (ctc_dp.cuh).
template <int K>
int launch_beta_grad(const float* lp, long long sb, long long st,
                     const int* labels, const int* in_lens,
                     const int* lab_lens, const float* alpha_all,
                     const float* score, int B, int T, int U, int V,
                     int blank, int W, float* lp_path, int* flags,
                     float* post, int* nxt, int* head, cudaStream_t stream) {
    const int S = 2 * U + 1;
    const int threads = 32 * (W < 4 ? 4 : W);
    const size_t smem = ctcdp::edge_bytes(W) + 2 * sizeof(int) * (size_t)S;
    const void* kern = (const void*)ctc_beta_grad_kernel<K>;
    cudaError_t e = (cudaError_t)set_smem(kern, smem);
    ctcdp::LaunchPlan plan;
    if (e == cudaSuccess)
        e = ctcdp::launch_plan(kern, B, T, threads, smem, &plan);
    if (e != cudaSuccess) return (int)e;
    int G = plan.G;
    if (plan.together) {
        void* args[] = {&lp, &sb, &st, &labels, &in_lens, &lab_lens,
                        &alpha_all, &score, &B, &T, &U, &V, &blank, &G, &W,
                        &lp_path, &flags, &post, &nxt, &head};
        return (int)cudaLaunchCooperativeKernel(kern, dim3(G + B),
                                                dim3(threads), args, smem,
                                                stream);
    }
    ctc_beta_grad_kernel<K><<<G, threads, sizeof(int) * (size_t)S,
                              stream>>>(
        lp, sb, st, labels, in_lens, lab_lens, alpha_all, score, B, T, U, V,
        blank, G, W, lp_path, flags, post, nxt, head);
    ctc_beta_grad_kernel<K><<<B, threads, smem, stream>>>(
        lp, sb, st, labels, in_lens, lab_lens, alpha_all, score, B, T, U, V,
        blank, 0, W, lp_path, flags, post, nxt, head);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cassnat_ctc_alpha(const float* lp, long long sb, long long st,
                                 const int* labels, const int* in_lens,
                                 const int* lab_lens, int B, int T, int U,
                                 int V, int blank, float* alpha_all,
                                 float* score,
                                 void* stream) {
    const int S = 2 * U + 1;
    if (B <= 0 || T <= 0) return 0;
    int threads = threads_for(S);
    if (S > MAXK * threads) return (int)cudaErrorInvalidValue;
    size_t smem = sizeof(float) * 2 * (size_t)S;
    int e = set_smem((const void*)ctc_alpha_kernel, smem);
    if (e) return e;
    ctc_alpha_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
        lp, sb, st, labels, in_lens, lab_lens, T, U, V, blank, alpha_all,
        score);
    return (int)cudaGetLastError();
}

// The layout follows from S (ctcdp::layout_for); lp_path (B, T, SP) f32
// scratch and flags (B, flag words) int32 zeros, of the sizes
// cassnat_ctc_dp_scratch gives
extern "C" int cassnat_ctc_beta_grad(const float* lp, long long sb,
                                     long long st, const int* labels,
                                     const int* in_lens, const int* lab_lens,
                                     const float* alpha_all,
                                     const float* score, int B, int T, int U,
                                     int V, int blank, float* lp_path,
                                     int* flags, float* post, int* nxt,
                                     int* head, void* stream) {
    if (B <= 0 || T <= 0) return 0;
    const ctcdp::Layout L = ctcdp::layout_for(2 * U + 1);
    if (L.W > ctcdp::MAX_WARPS) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (L.K) {
    case 1: return launch_beta_grad<1>(lp, sb, st, labels, in_lens, lab_lens,
                                       alpha_all, score, B, T, U, V, blank,
                                       L.W, lp_path, flags, post, nxt, head,
                                       s);
    case 2: return launch_beta_grad<2>(lp, sb, st, labels, in_lens, lab_lens,
                                       alpha_all, score, B, T, U, V, blank,
                                       L.W, lp_path, flags, post, nxt, head,
                                       s);
    case 4: return launch_beta_grad<4>(lp, sb, st, labels, in_lens, lab_lens,
                                       alpha_all, score, B, T, U, V, blank,
                                       L.W, lp_path, flags, post, nxt, head,
                                       s);
    default: return launch_beta_grad<8>(lp, sb, st, labels, in_lens,
                                        lab_lens, alpha_all, score, B, T, U,
                                        V, blank, L.W, lp_path, flags, post,
                                        nxt, head, s);
    }
}

// The probe: `steps` dependent beta steps on one warp; elapsed[0] ns,
// elapsed[1] clock cycles.
extern "C" int cassnat_ctc_beta_step_probe(const float* in, int steps,
                                           float* out, long long* elapsed,
                                           void* stream) {
    beta_step_probe<<<1, 32, 0, (cudaStream_t)stream>>>(in, steps, out,
                                                        elapsed);
    return (int)cudaGetLastError();
}

extern "C" int cassnat_ctc_grad_scatter(const float* post, const int* labels,
                                        const int* in_lens, const int* nxt,
                                        const int* head, const float* cot,
                                        int B, int T, int U, int V, int blank,
                                        float* grad, void* stream) {
    const int S = 2 * U + 1;
    if (B <= 0 || T <= 0) return 0;
    size_t smem = (sizeof(float) + sizeof(int)) * (size_t)S;
    int e = set_smem((const void*)ctc_grad_scatter_kernel, smem);
    if (e) return e;
    dim3 grid(T, B);
    ctc_grad_scatter_kernel<<<grid, 256, smem, (cudaStream_t)stream>>>(
        post, labels, in_lens, nxt, head, cot, T, U, V, blank, grad);
    return (int)cudaGetLastError();
}
