// Pieces shared by the rebuilt CTC dynamic programs for sm_90a: the Viterbi
// kernel (ctc_viterbi.cu) and the beta/posterior kernel (ctc_loss.cu).
//
// Layout of a row's DP (one block per batch row):
//   - W warps walk the frames; lane `l` of warp `w` holds the K contiguous
//     states s = (32 w + l) K + k, k < K, in registers. Neighbouring states
//     of the same warp come by __shfl_up_sync / __shfl_down_sync.
//   - Across warps the two edge states go through shared memory
//     (`Edges`): after each step every warp stores its pair and the DP
//     warps meet at named barrier 1 (the block's other warps do not take
//     part). A wavefront of warps that waited only on their neighbour's
//     step count, in volatile shared memory, was slower on the card: its
//     polling cost more than the barrier.
//   - The emissions lp[b, t, path[s]] are gathered off the DP's SMs by
//     gather blocks (`gather_chunks`). They write lp_path[b, t, s] (rows
//     padded to SP states, a multiple of 32 floats, so that no cache line
//     holds two frames) chunk by chunk of CHUNK steps in the DP's frame
//     order, chunk 0 of every row first, and raise bit c of row b's flag
//     words with a release `or` once chunk c of row b is written.
//     Gathered inside the DP block, the ~100 scattered 4-byte loads of a
//     frame sat on one SM; spread over G SMs the whole gather ends within
//     the DP's first 10-15 us.
//   - The DP blocks spin on those flags, so every gather block must run
//     while they wait. `launch_plan` sizes the gather blocks by occupancy:
//     where G of them fit on the card beside the B DP blocks, all G + B go
//     in one cooperative launch, which CUDA starts only with every block
//     resident (one launch gives every block the same dynamic shared
//     memory, the DP's, and occupancy counts it). Where not even one fits
//     beside the B rows, the gather blocks take a launch of their own (with
//     the S ints they use) ahead of the DP blocks' on the same stream, and
//     the DP finds every flag raised. A flag that stays down for 10 s (a
//     fault) traps instead of hanging the card.
//   - Each lane loads its own states' values of the gathered rows (and for
//     beta the alpha rows) AHEAD frames before the step that uses them,
//     into a ring of registers (the frame loop is unrolled by AHEAD, so the
//     ring has static register indices), once the chunk's flag is up
//     (`ChunkGate`, checked once a block of AHEAD steps; it reads the next
//     chunk's flag word ahead). The loads are unconditional (past the
//     row's end they repeat its last frame), coalesced and vectorised: K
//     states a lane are K contiguous floats of a padded row. The compiler
//     still waits for all loads in flight at the top of each unrolled
//     block, once every AHEAD steps. Blocks have at most MAX_WARPS warps, so
//     a thread may hold 128 registers and the ring does not spill. Slower
//     on the card: per-lane cp.async copies into a shared ring, prefetches
//     to L1 with loads at the step, and reloading each register after its
//     step.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Phase marks at block-uniform points; an instrumented copy of csrc/
// (phase_split.py) defines CTC_MARK before including this header.
#ifndef CTC_MARK
#define CTC_MARK(slot)
#endif

namespace ctcdp {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_WARPS = 16;    // DP warps a block, 512 threads at most
constexpr int CHUNK = 8;         // steps a gather block hands over at once
constexpr int GATHER_UNROLL = 16;   // loads a gather thread keeps in flight

// The DP layout the two kernels take for S states: the fewest states a lane
// (1, 2, 4 or 8) that fit S in MAX_WARPS warps of 32 lanes; W warps, SP
// padded states a gathered row. W > MAX_WARPS: S is too large.
struct Layout {
    int K, W, SP;
};

__host__ __device__ inline Layout layout_for(int S) {
    int K = 1;
    while (K < 8 && (S + 32 * K - 1) / (32 * K) > MAX_WARPS) K *= 2;
    const int W = (S + 32 * K - 1) / (32 * K);
    return Layout{K, W, 32 * W * K};
}

__host__ __device__ inline int chunk_count(int T) {
    return (T + CHUNK - 1) / CHUNK;
}

// 32-bit flag words a row: bit c of word c / 32 for chunk c, and a word
// past the last for the gate's read ahead
__host__ __device__ inline int flag_words(int T) {
    return chunk_count(T) / 32 + 1;
}

__device__ __forceinline__ int path_at(const int* lab, int s, int blank) {
    return (s & 1) ? lab[s >> 1] : blank;
}

__device__ __forceinline__ unsigned long long globaltimer() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

// A flag word read without ordering (a hint, or a poll before a fence)
__device__ __forceinline__ unsigned flag_relaxed(const int* f) {
    unsigned v;
    asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(f));
    return v;
}

// K contiguous floats of a row (16-byte aligned for K >= 4, 8 for K = 2)
template <int K>
__device__ __forceinline__ void load_k(const float* p, float (&v)[K]) {
    if (K == 1) {
        v[0] = p[0];
    } else if (K == 2) {
        const float2 x = *reinterpret_cast<const float2*>(p);
        v[0] = x.x;
        v[K > 1 ? 1 : 0] = x.y;
    } else {
#pragma unroll
        for (int q = 0; q < K; q += 4) {
            const float4 x = *reinterpret_cast<const float4*>(p + q);
            v[q] = x.x;
            v[q + 1 < K ? q + 1 : 0] = x.y;
            v[q + 2 < K ? q + 2 : 0] = x.z;
            v[q + 3 < K ? q + 3 : 0] = x.w;
        }
    }
}

// Edge exchange between neighbouring warps of one row: after step i the
// writer lane of every warp stores its two edge states to slot i & 1 and
// the W DP warps meet at named barrier 1; before step i+1 a warp reads its
// source warp's pair. A slot is rewritten two steps later, after a barrier
// that every reader of it has passed.
struct Edges {
    float* slots;           // [2][W][2]
    int W;
    int src;                // the warp this one reads edges from, or -1

    __device__ __forceinline__ Edges(float* s, int w_count, int warp,
                                     bool upward)
        : slots(s), W(w_count) {
        src = upward ? warp - 1 : (warp + 1 < w_count ? warp + 1 : -1);
    }

    // the source warp's edge states after step i-1 (before step i)
    __device__ __forceinline__ float2 read(int i, float fill) const {
        if (src < 0 || i == 0) return make_float2(fill, fill);
        const float* e = slots + (((i - 1) & 1) * W + src) * 2;
        return make_float2(e[0], e[1]);
    }

    // this warp's edge states after step i (from lane `writer`), then the
    // barrier
    __device__ __forceinline__ void write(int i, int warp, bool writer,
                                          float v0, float v1) {
        if (W == 1) return;
        if (writer) {
            float* e = slots + ((i & 1) * W + warp) * 2;
            e[0] = v0;
            e[1] = v1;
        }
        asm volatile("bar.sync 1, %0;" :: "r"(32 * W) : "memory");
    }
};

// Gather block g of G: for each (row b, chunk c) item g, g + G, ... in the
// order chunk 0 of every row, then chunk 1, ...: lp_path[b, t, s] =
// lp[b, t, path[s]] for the chunk's steps i (frame t = i, or tn-1-i when
// `backward`) and s < S, then bit c of row b's flag words. The row's
// token columns go to `tok_s` (S ints of shared memory) first; each thread
// keeps GATHER_UNROLL scattered loads in flight.
__device__ __forceinline__ void gather_chunks(
        const float* __restrict__ lp, long long sb, long long st,
        const int* __restrict__ labels, const int* __restrict__ in_lens,
        int B, int T, int U, int V, int blank, bool backward, int SP,
        float* lp_path, int* flags, int* tok_s, int g, int G) {
    const int S = 2 * U + 1;
    const int nchunks = chunk_count(T);
    int row = -1;
    for (int j = g; j < nchunks * B; j += G) {
        const int c = j / B, b = j - c * B;
        const int len = in_lens[b];
        const int tn = len < T ? (len > 0 ? len : 0) : T;
        const int i0 = c * CHUNK;
        if (i0 >= tn) continue;
        const int n = tn - i0 < CHUNK ? tn - i0 : CHUNK;
        const float* lpb = lp + (long long)b * sb;
        float* out = lp_path + (long long)b * T * SP;
        if (b != row) {
            __syncthreads();
            const int* lab = labels + (long long)b * U;
            for (int s = threadIdx.x; s < S; s += blockDim.x) {
                const int tok = path_at(lab, s, blank);
                tok_s[s] = tok < 0 ? 0 : (tok >= V ? V - 1 : tok);
            }
            __syncthreads();
            row = b;
        }
        const int total = n * S;
        for (int e0 = threadIdx.x; e0 < total;
             e0 += GATHER_UNROLL * blockDim.x) {
            float v[GATHER_UNROLL];
            long long dst[GATHER_UNROLL];
#pragma unroll
            for (int u = 0; u < GATHER_UNROLL; ++u) {
                const int e = e0 + u * blockDim.x;
                dst[u] = -1;
                if (e < total) {
                    const int di = e / S, s = e - di * S;
                    const int t = backward ? tn - 1 - (i0 + di) : i0 + di;
                    v[u] = lpb[(long long)t * st + tok_s[s]];
                    dst[u] = (long long)t * SP + s;
                }
            }
#pragma unroll
            for (int u = 0; u < GATHER_UNROLL; ++u)
                if (dst[u] >= 0) out[dst[u]] = v[u];
        }
        // the block's writes, then the flag bit with gpu-scope release
        // semantics (cumulative over the writes the barrier orders before it)
        __syncthreads();
        if (threadIdx.x == 0)
            asm volatile("red.release.gpu.global.or.b32 [%0], %1;" ::
                         "l"(flags + (long long)b * flag_words(T) + (c >> 5)),
                         "r"(1u << (c & 31)) : "memory");
    }
}

// The DP side of the hand-over: wait(i) returns once the gathered frames
// of steps up to i are in lp_path. The flag word of the next chunk is read
// ahead without ordering, so a gather that keeps ahead costs no stall; the
// gate then moves past the wanted chunks and every chunk after them that
// the word shows flagged, and a gpu-scope acquire fence orders this
// thread's loads of them after the gathers' releases. Once the gather has
// ended (within the DP's first ~10 us at the training shape) one move
// covers the rest of the row, so the fence, ~0.5 us on the card, runs a
// few times a row, not once a chunk. A flag still down after 10 s traps.
struct ChunkGate {
    const int* words;   // this row's flag words
    int ready;          // steps < ready are gathered
    unsigned next;      // the word of chunk ready / CHUNK, read ahead

    __device__ __forceinline__ explicit ChunkGate(const int* w)
        : words(w), ready(0) {
        next = flag_relaxed(words);
    }

    __device__ __forceinline__ void wait(int i) {
        if (i < ready) return;
        do {
            const int c = ready / CHUNK;
            unsigned bits = next >> (c & 31);
            if (!(bits & 1u)) {
                const unsigned long long t0 = globaltimer();
                while (!((bits = flag_relaxed(words + (c >> 5)) >> (c & 31))
                         & 1u))
                    if (globaltimer() - t0 > 10000000000ull) __trap();
            }
            // chunk c and the flagged chunks after it in its word
            const unsigned gaps = ~bits;
            ready += (gaps ? __ffs(gaps) - 1 : 32) * CHUNK;
            next = flag_relaxed(words + ((ready / CHUNK) >> 5));
        } while (i >= ready);
        asm volatile("fence.acq_rel.gpu;" ::: "memory");
    }
};

// Bytes of the edge slots for W warps.
__host__ __device__ inline size_t edge_bytes(int W) {
    return sizeof(float) * 4 * (size_t)W;
}

// How the gather blocks run beside the B DP blocks (see the notes above).
struct LaunchPlan {
    int G;              // gather blocks
    bool together;      // one cooperative launch of G + B blocks
};

// G: the SMs the rows leave free (at least half the card), no more than
// there are (row, chunk) items, and, in one launch, no more than fit on
// the card beside the B DP blocks at `threads` and `smem` a block.
inline cudaError_t launch_plan(const void* kernel, int B, int T, int threads,
                               size_t smem, LaunchPlan* p) {
    int dev = 0, sms = 0, occ = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel,
                                                          threads, smem);
    if (e != cudaSuccess) return e;
    const long long items = (long long)chunk_count(T) * B;
    long long g = sms - B > sms / 2 ? sms - B : sms / 2;
    const long long room = (long long)occ * sms - B;
    p->together = room >= 1;
    if (p->together && g > room) g = room;
    if (g > items) g = items;
    p->G = g > 0 ? (int)g : 1;
    return cudaSuccess;
}

}  // namespace ctcdp
