// The row transform split over a thread-block cluster (ntt.cu's kernels).
//
// One row of N = 2^LOGN residues is transformed by a cluster of C = 2^LOGC
// CTAs that exchange it once through distributed shared memory, where the
// single-block core of modarith.cuh gives a row one block: a call of 3-5
// rows then used 3-5 of the card's 132 SMs, and its time was one block's
// latency.  With C CTAs per row the same call runs on C times as many SMs,
// each CTA transforming N / C residues.
//
// Forward (Cooley-Tukey, standard order in, bit-reversed order out):
//   1. CTA c loads its column slab, coalesced: columns i in
//      [c * W, (c + 1) * W), W = N / C^2, and for each i the C values
//      i + k * M, k < C, M = N / C; each thread holds R / C columns;
//   2. the first LOGC stages pair values of one column only: they run in
//      registers, with twiddles tw[1 .. C-1];
//   3. each value i + k * M now belongs to sub-row k: the thread stores it
//      into CTA k's shared memory (`map_shared_rank`), then one
//      `cluster.sync()`; after it no CTA touches another's memory, so
//      none can leave while another still needs it;
//   4. CTA k transforms its contiguous sub-row with the remaining LOGN -
//      LOGC stages: the core of modarith.cuh at size M (Ring<LOGM>, the
//      same passes), the store functor taking output k * M + i.
// Inverse (Gentleman-Sande): the mirror image.  CTA k runs the local
// stages on sub-row k, its last pass storing each value into the receive
// buffer of the CTA that owns its column; `cluster.sync()`; the cross
// stages on the column slab in registers; the store functor takes outputs
// i + k * M, coalesced.  Its receive buffer is apart from the buffer of
// its own passes, which other CTAs may still run while it is written.
// A CTA may write another's shared memory only once that CTA has started:
// the forward arrives on the cluster barrier as it starts and waits on it
// before its stores, the inverse syncs before its passes.
//
// Stage s < LOGC of the global transform pairs column values k and
// k + C / 2^(s+1) with twiddle tw[2^s + (k >> (LOGC - s))]; stage LOGC + u
// on sub-row k reads tw[2^(LOGC+u) + k * 2^u + h] where the core at size M
// reads twk[2^u + h].  So sub-row k sees an ordinary merged table twk of
// size M, and the packed table of a row (kernels/ntt.py `pack_twiddles`
// with the split's LOGC) is C segments of M words: segment k holds twk in
// the core's read order, and its slot 0, which the core never reads,
// holds the cross twiddle tw[k] (k >= 1).  Each CTA's twiddles are
// contiguous.
//
// C is a function of LogN (`Split`): 1 up to LogN 10 (a row fits one
// block's latency budget, and the single-block core runs as it is), then
// N / 1024 up to 8 CTAs: sub-rows of 1024 residues, 128 threads of R = 8,
// up to LogN 13; LogN 14 takes 8 CTAs of 2048 (256 threads), a portable
// cluster size (16 would need a non-portable one).
#pragma once

#include <cooperative_groups.h>

#include "modarith.cuh"

namespace orion {

namespace cg = cooperative_groups;

template <int LOGN>
struct Split {
    static constexpr int LOGC = LOGN <= 10 ? 0 : (LOGN >= 13 ? 3 : LOGN - 10);
    static constexpr int C = 1 << LOGC;          // CTAs per row
    static constexpr int LOGM = LOGN - LOGC;
    static constexpr int M = 1 << LOGM;          // sub-row length
    using Core = Ring<LOGM>;
    static constexpr int T = Core::T;            // threads per CTA
    static constexpr int W = M / C;              // columns per CTA
    static constexpr int CPT = W / T;            // columns per thread
    static constexpr size_t SMEM_FWD = Core::SMEM;
    // the inverse's passes and its receive buffer
    static constexpr size_t SMEM_INV = (C == 1 ? 1 : 2) * Core::SMEM;
    static_assert(C == 1 || CPT * T == W, "columns must split evenly");
};

__device__ __forceinline__ void cluster_arrive_relaxed() {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The twiddle of a cross stage: merged index j < C sits at slot j * M.
template <int LOGN>
__device__ __forceinline__ u64 cross_tw(const u64* tw, int j) {
    return __ldg(tw + ((int64_t)j << Split<LOGN>::LOGM));
}

// Forward NTT of one row by the calling cluster: load(g) -> uint32 input g
// (g < N), store(g, v) takes output g.  twp: the row's packed table in the
// split's order.  s: Split<LOGN>::SMEM_FWD bytes of shared memory.
template <int LOGN, class Load, class Store>
__device__ __forceinline__ void ntt_fwd_split(uint32_t* s, const int64_t* twp,
                                              uint32_t p, Load load,
                                              Store store) {
    using SP = Split<LOGN>;
    if constexpr (SP::C == 1) {
        ntt_fwd_row<LOGN>(s, twp, p, load, store);
    } else {
        constexpr int C = SP::C, LOGC = SP::LOGC, M = SP::M;
        cg::cluster_group cl = cg::this_cluster();
        const int c = (int)cl.block_rank();
        const u64* tw = reinterpret_cast<const u64*>(twp);
        cluster_arrive_relaxed();
        uint32_t x[SP::CPT][C];
#pragma unroll
        for (int r = 0; r < SP::CPT; ++r) {
            const int col = c * SP::W + (int)threadIdx.x + r * SP::T;
#pragma unroll
            for (int k = 0; k < C; ++k) x[r][k] = load(col + k * M);
#pragma unroll
            for (int st = 0; st < LOGC; ++st) {
                const int hs = C >> (st + 1);
#pragma unroll
                for (int k = 0; k < C; ++k) {
                    if (k & hs) continue;
                    const u64 wp = cross_tw<LOGN>(tw, (1 << st)
                                                  + (k >> (LOGC - st)));
                    const uint32_t v = shoup_mul(x[r][k + hs], wp, p);
                    const uint32_t a = x[r][k];
                    x[r][k] = add_mod(a, v, p);
                    x[r][k + hs] = sub_mod(a, v, p);
                }
            }
        }
        cluster_wait();  // every CTA of the cluster has started
#pragma unroll
        for (int r = 0; r < SP::CPT; ++r) {
            const int col = c * SP::W + (int)threadIdx.x + r * SP::T;
#pragma unroll
            for (int k = 0; k < C; ++k)
                cl.map_shared_rank(s, k)[pad(col)] = x[r][k];
        }
        cl.sync();
        auto own = [&](int i) { return s[pad(i)]; };
        auto out = [&](int i, uint32_t v) { store(c * M + i, v); };
        fwd_passes<SP::LOGM, 0>(s, tw + (int64_t)c * M, p, own, out);
    }
}

// Inverse NTT of one row by the calling cluster (without the n^-1 scale):
// load(g) and store(g, v) as above.  s: Split<LOGN>::SMEM_INV bytes.
template <int LOGN, class Load, class Store>
__device__ __forceinline__ void ntt_inv_split(uint32_t* s, const int64_t* itwp,
                                              uint32_t p, Load load,
                                              Store store) {
    using SP = Split<LOGN>;
    if constexpr (SP::C == 1) {
        ntt_inv_row<LOGN>(s, itwp, p, load, store);
    } else {
        constexpr int C = SP::C, LOGC = SP::LOGC, M = SP::M, W = SP::W;
        cg::cluster_group cl = cg::this_cluster();
        const int c = (int)cl.block_rank();
        const u64* tw = reinterpret_cast<const u64*>(itwp);
        uint32_t* recv = s + SP::Core::SMEM / sizeof(uint32_t);
        cl.sync();  // every CTA of the cluster has started
        // local stages on sub-row c; output i goes to the CTA owning
        // column i, as value c of that column
        auto in = [&](int i) { return load(c * M + i); };
        auto push = [&](int i, uint32_t v) {
            cl.map_shared_rank(recv, i / W)[pad(c * W + i % W)] = v;
        };
        inv_passes<SP::LOGM, SP::LOGM - SP::Core::LOGR>(
            s, tw + (int64_t)c * M, p, in, push);
        cl.sync();
#pragma unroll
        for (int r = 0; r < SP::CPT; ++r) {
            const int col = (int)threadIdx.x + r * SP::T;
            uint32_t x[C];
#pragma unroll
            for (int k = 0; k < C; ++k) x[k] = recv[pad(k * W + col)];
#pragma unroll
            for (int st = LOGC - 1; st >= 0; --st) {
                const int hs = C >> (st + 1);
#pragma unroll
                for (int k = 0; k < C; ++k) {
                    if (k & hs) continue;
                    const u64 wp = cross_tw<LOGN>(tw, (1 << st)
                                                  + (k >> (LOGC - st)));
                    const uint32_t a = x[k];
                    const uint32_t b = x[k + hs];
                    x[k] = add_mod(a, b, p);
                    x[k + hs] = shoup_mul(sub_mod(a, b, p), wp, p);
                }
            }
#pragma unroll
            for (int k = 0; k < C; ++k) store(k * M + c * W + col, x[k]);
        }
    }
}

// Launch `kernel` over `rows` rows, one cluster of Split<LOGN>::C CTAs
// per row (grid x = rows * C), on `stream`.  A refused launch returns its
// error: there is no single-block fallback.
template <int LOGN, class... Exp, class... Act>
inline cudaError_t launch_split(void (*kernel)(Exp...), int64_t rows,
                                size_t smem, cudaStream_t stream,
                                Act... args) {
    using SP = Split<LOGN>;
    if (rows < 1 || rows * SP::C > 0x7fffffff) return cudaErrorInvalidValue;
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(rows * SP::C));
    cfg.blockDim = dim3(SP::T);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = SP::C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, kernel, args...);
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
}

}  // namespace orion
