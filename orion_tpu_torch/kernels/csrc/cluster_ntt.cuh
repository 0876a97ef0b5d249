// The row transform split over a thread-block cluster (ntt.cu's kernels and
// the ConjugateInvariant forms of ks_decompose.cu and ks_finish.cu).
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
// before its stores, the inverse syncs before its passes (or, EARLY,
// arrives as it starts and waits before its pushes).
// On the ConjugateInvariant ring `ntt_fwd_lift` builds the 2n lift of n
// converted values inside the split, each value converted once
// (its comment says how).
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
    // ntt_fwd_lift: the forward's, and with a cluster the mirrored upper
    // half of the CTA's columns (M / 2 words)
    static constexpr size_t SMEM_LIFT =
        Core::SMEM + (C == 1 ? 0 : sizeof(uint32_t) * M / 2);
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

// The first LOGC stages of the forward on the C values of one column
// (value k is input col + k * M), in registers.  Only values k < KEEP are
// computed, those of the sub-rows whose outputs are kept (KEEP = C / 2:
// outputs g < N / 2).
template <int LOGN, int KEEP = Split<LOGN>::C>
__device__ __forceinline__ void cross_fwd(uint32_t* x, const u64* tw,
                                          uint32_t p) {
    constexpr int C = Split<LOGN>::C, LOGC = Split<LOGN>::LOGC;
#pragma unroll
    for (int st = 0; st < LOGC; ++st) {
        const int hs = C >> (st + 1);
#pragma unroll
        for (int k = 0; k < KEEP; ++k) {
            if (k & hs) continue;
            const u64 wp = cross_tw<LOGN>(tw, (1 << st) + (k >> (LOGC - st)));
            const uint32_t v = shoup_mul(x[k + hs], wp, p);
            const uint32_t a = x[k];
            x[k] = add_mod(a, v, p);
            if (k + hs < KEEP) x[k + hs] = sub_mod(a, v, p);
        }
    }
}

// After the cross stages: each value of the thread's columns goes to the
// CTA of its sub-row (sub-rows k < KEEP), one cluster barrier, then CTA
// c < KEEP transforms sub-row c with the remaining stages and stores
// output c * M + i; the other CTAs are done.  Every CTA of the cluster
// must have started (the callers wait on a cluster barrier).
template <int LOGN, int KEEP, class Store>
__device__ __forceinline__ void fwd_exchange(
        uint32_t (&x)[Split<LOGN>::CPT][Split<LOGN>::C], uint32_t* s,
        const u64* tw, uint32_t p, int c, Store& store) {
    using SP = Split<LOGN>;
    cg::cluster_group cl = cg::this_cluster();
#pragma unroll
    for (int r = 0; r < SP::CPT; ++r) {
        const int col = c * SP::W + (int)threadIdx.x + r * SP::T;
#pragma unroll
        for (int k = 0; k < KEEP; ++k)
            cl.map_shared_rank(s, k)[pad(col)] = x[r][k];
    }
    cl.sync();
    if (c >= KEEP) return;  // uniform per CTA
    auto own = [&](int i) { return s[pad(i)]; };
    auto out = [&](int i, int slot, uint32_t v) {
        store_at(store, c * SP::M + i, slot, v);
    };
    fwd_passes<SP::LOGM, 0>(s, tw + (int64_t)c * SP::M, p, own, out);
}

// Forward NTT of one row by the calling cluster: load(g) -> uint32 input g
// (g < N), store(g, v) takes output g (or store(g, slot, v): see
// `store_at`; the slots of CTA c's outputs c * M + fwd_out_elem<LOGM>(slot)).
// twp: the row's packed table in the split's order.  s:
// Split<LOGN>::SMEM_FWD bytes of shared memory.
template <int LOGN, class Load, class Store>
__device__ __forceinline__ void ntt_fwd_split(uint32_t* s, const int64_t* twp,
                                              uint32_t p, Load load,
                                              Store store) {
    using SP = Split<LOGN>;
    if constexpr (SP::C == 1) {
        ntt_fwd_row<LOGN>(s, twp, p, load, store);
    } else {
        constexpr int C = SP::C, M = SP::M;
        const int c = (int)cg::this_cluster().block_rank();
        const u64* tw = reinterpret_cast<const u64*>(twp);
        cluster_arrive_relaxed();
        uint32_t x[SP::CPT][C];
#pragma unroll
        for (int r = 0; r < SP::CPT; ++r) {
            const int col = c * SP::W + (int)threadIdx.x + r * SP::T;
#pragma unroll
            for (int k = 0; k < C; ++k) x[r][k] = load(col + k * M);
            cross_fwd<LOGN>(x[r], tw, p);
        }
        cluster_wait();  // every CTA of the cluster has started
        fwd_exchange<LOGN, C>(x, s, tw, p, c, store);
    }
}

// Forward NTT by the calling cluster of the antisymmetric lift of n = N / 2
// values (the ConjugateInvariant ring): input i is a_i (i < n), 0 (i = n)
// or -a_{N-i} mod p (i > n), where a_k = conv(k) is computed once for each
// k < n and its mirror formed by negation; store(g, v) takes output g.
// The CI ring keeps only outputs g < n (the orbit of 5 modulo 2N,
// bit-reversed, lies in the first half: crypto/context.py `ci_keep`), so
// with a cluster the sub-rows k >= C / 2 are not computed and store sees
// g < n only.  The caller does nothing after it: CTAs may return early.
// s: Split<LOGN>::SMEM_LIFT bytes of shared memory.
//
// In the split, input i of CTA c's slab is col + k * M with k < C / 2
// below n.  Its mirror N - i is column M - col (column 0 if col = 0), value
// C - 1 - k (C - k): the upper half of another column, mostly of CTA
// C - 1 - c.  So each CTA converts the lower half of its columns, keeps it
// in registers and writes its negation into the mirror buffer of the CTA
// that owns the mirror (value k >= C / 2 of column lc at slot
// (k - C / 2) * W + lc); after one cluster barrier each thread reads its
// columns' upper halves from its own buffer, and the transform goes on as
// ntt_fwd_split's after its loads.  With one CTA per row the lifted row is
// built in shared memory and the core reads it there.
template <int LOGN, class Conv, class Store>
__device__ __forceinline__ void ntt_fwd_lift(uint32_t* s, const int64_t* twp,
                                             uint32_t p, Conv conv,
                                             Store store) {
    using SP = Split<LOGN>;
    constexpr int N = 1 << LOGN, n = N / 2;
    if constexpr (SP::C == 1) {
        for (int k = (int)threadIdx.x; k < n; k += SP::T) {
            const uint32_t v = conv(k);
            s[pad(k)] = v;
            s[pad(k == 0 ? n : N - k)] = k == 0 ? 0u : neg_mod(v, p);
        }
        __syncthreads();
        ntt_fwd_row<LOGN>(s, twp, p, [&](int i) { return s[pad(i)]; },
                          store);
    } else {
        constexpr int C = SP::C, H = C / 2, M = SP::M, W = SP::W;
        cg::cluster_group cl = cg::this_cluster();
        const int c = (int)cl.block_rank();
        const u64* tw = reinterpret_cast<const u64*>(twp);
        uint32_t* mir = s + SP::Core::SMEM / sizeof(uint32_t);
        cluster_arrive_relaxed();
        uint32_t x[SP::CPT][C];
#pragma unroll
        for (int r = 0; r < SP::CPT; ++r) {
            const int col = c * W + (int)threadIdx.x + r * SP::T;
#pragma unroll
            for (int k = 0; k < H; ++k) x[r][k] = conv(col + k * M);
        }
        cluster_wait();  // every CTA of the cluster has started
#pragma unroll
        for (int r = 0; r < SP::CPT; ++r) {
            const int col = c * W + (int)threadIdx.x + r * SP::T;
#pragma unroll
            for (int k = 0; k < H; ++k) {
                const int g = col + k * M;
                if (g == 0) continue;  // input 0 has no mirror
                const int mc = (N - g) & (M - 1);
                const int mk = (N - g) >> SP::LOGM;
                cl.map_shared_rank(mir, mc / W)[(mk - H) * W + mc % W] =
                    neg_mod(x[r][k], p);
            }
        }
        cl.sync();
#pragma unroll
        for (int r = 0; r < SP::CPT; ++r) {
            const int lc = (int)threadIdx.x + r * SP::T;
#pragma unroll
            for (int k = H; k < C; ++k)
                x[r][k] = c == 0 && lc == 0 && k == H  // input n
                              ? 0u : mir[(k - H) * W + lc];
            cross_fwd<LOGN, H>(x[r], tw, p);
        }
        fwd_exchange<LOGN, H>(x, s, tw, p, c, store);
    }
}

// The first LOGC stages of the inverse on one column's C values (stage
// LOGC - 1 first), in registers.
template <int LOGN>
__device__ __forceinline__ void cross_inv(uint32_t* x, const u64* tw,
                                          uint32_t p) {
    constexpr int C = Split<LOGN>::C, LOGC = Split<LOGN>::LOGC;
#pragma unroll
    for (int st = LOGC - 1; st >= 0; --st) {
        const int hs = C >> (st + 1);
#pragma unroll
        for (int k = 0; k < C; ++k) {
            if (k & hs) continue;
            const u64 wp = cross_tw<LOGN>(tw, (1 << st) + (k >> (LOGC - st)));
            const uint32_t a = x[k];
            const uint32_t b = x[k + hs];
            x[k] = add_mod(a, b, p);
            x[k + hs] = shoup_mul(sub_mod(a, b, p), wp, p);
        }
    }
}

// Inverse NTT of one row by the calling cluster (without the n^-1 scale):
// load(g) and store(g, v) as above.  s: Split<LOGN>::SMEM_INV bytes.
// The CTA syncs with its cluster before its passes (a caller may have
// pushed values into other CTAs' memory that this barrier orders:
// ks_finish.cu's CI inner product); with EARLY it arrives on the barrier
// as it starts and waits on it only before its last local pass pushes
// into the other CTAs' receive buffers, so its loads and first passes run
// while the cluster's other CTAs start.
template <int LOGN, bool EARLY = false, class Load, class Store>
__device__ __forceinline__ void ntt_inv_split(uint32_t* s, const int64_t* itwp,
                                              uint32_t p, Load load,
                                              Store store) {
    using SP = Split<LOGN>;
    if constexpr (SP::C == 1) {
        ntt_inv_row<LOGN>(s, itwp, p, load, store);
    } else {
        constexpr int C = SP::C, M = SP::M, W = SP::W;
        cg::cluster_group cl = cg::this_cluster();
        const int c = (int)cl.block_rank();
        const u64* tw = reinterpret_cast<const u64*>(itwp);
        uint32_t* recv = s + SP::Core::SMEM / sizeof(uint32_t);
        // every CTA of the cluster has started (by the first push)
        if constexpr (EARLY) cluster_arrive_relaxed();
        else cl.sync();
        // local stages on sub-row c; output i goes to the CTA owning
        // column i, as value c of that column
        auto in = [&](int i) { return load(c * M + i); };
        auto push = [&](int i, uint32_t v) {
            cl.map_shared_rank(recv, i / W)[pad(c * W + i % W)] = v;
        };
        constexpr int A0 = SP::LOGM - SP::Core::LOGR;
        const u64* twc = tw + (int64_t)c * M;
        if constexpr (EARLY)
            inv_passes<SP::LOGM, A0>(s, twc, p, in, push,
                                     [] { cluster_wait(); });
        else
            inv_passes<SP::LOGM, A0>(s, twc, p, in, push);
        cl.sync();
#pragma unroll
        for (int r = 0; r < SP::CPT; ++r) {
            const int col = (int)threadIdx.x + r * SP::T;
            uint32_t x[C];
#pragma unroll
            for (int k = 0; k < C; ++k) x[k] = recv[pad(k * W + col)];
            cross_inv<LOGN>(x, tw, p);
#pragma unroll
            for (int k = 0; k < C; ++k) store(k * M + c * W + col, x[k]);
        }
    }
}

// Inverse row transforms by clusters: cluster x handles row x of a (rows,
// W) int64 array whose limb (table row) is x % L, W = row_width<LOGN, CI>;
// on the CI ring through the map (src).  itwc: packed in the split's
// order.  (ntt.cu's ntt_inv; the Q rows of ks_decompose.cu's CI form.)
template <int LOGN, bool CI>
__global__ void __launch_bounds__(Split<LOGN>::T)
ntt_inv_cluster(int64_t* out, const int64_t* in, int L, const int64_t* p,
                const int64_t* itwc, const int64_t* ninv,
                const int64_t* ninv_sh, const int64_t* ci_src) {
    extern __shared__ uint32_t s[];
    constexpr int N = 1 << LOGN;
    constexpr int W = row_width<LOGN, CI>();
    const int64_t row = blockIdx.x / Split<LOGN>::C;
    const int limb = (int)(row % L);
    const uint32_t pl = (uint32_t)p[limb];
    const uint32_t nv = (uint32_t)ninv[limb];
    const uint32_t nv_sh = (uint32_t)ninv_sh[limb];
    const int64_t* src = in + row * W;
    int64_t* dst = out + row * W;
    ntt_inv_split<LOGN>(
        s, itwc + (int64_t)limb * N, pl,
        [&](int i) { return (uint32_t)src[gather_at<CI>(ci_src, i)]; },
        [&](int i, uint32_t v) {
            if (!CI || i < W) dst[i] = shoup_mul(v, nv, nv_sh, pl);
        });
}

// Programmatic dependent launch (sm_90).  A kernel launched with
// PDL = true below may start before the kernel ahead of it on the stream
// has finished: it may run what does not read that kernel's output, then
// `grid_dependency_wait`, which returns once the kernel ahead has
// completed and its writes are visible (at once without the attribute).
// The kernel ahead lets it start by `launch_dependents` from every thread
// after its last store (or by exiting).
__device__ __forceinline__ void grid_dependency_wait() {
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void launch_dependents() {
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Launch `kernel` over a grid of (rows, gy, gz) rows, one cluster of
// Split<LOGN>::C CTAs per row (grid x = rows * C: a CTA's row is
// blockIdx.x / C), on `stream`; with PDL, as a programmatic dependent of
// the kernel ahead of it.  A refused launch returns its error: there is no
// single-block fallback.
template <int LOGN, bool PDL = false, class... Exp, class... Act>
inline cudaError_t launch_split_grid(void (*kernel)(Exp...), int64_t rows,
                                     int gy, int gz, size_t smem,
                                     cudaStream_t stream, Act... args) {
    using SP = Split<LOGN>;
    if (rows < 1 || rows * SP::C > 0x7fffffff || gy < 1 || gy > 65535
        || gz < 1 || gz > 65535)
        return cudaErrorInvalidValue;
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(rows * SP::C), (unsigned)gy, (unsigned)gz);
    cfg.blockDim = dim3(SP::T);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[2];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = SP::C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[1].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = PDL ? 2 : 1;
    e = cudaLaunchKernelEx(&cfg, kernel, args...);
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
}

// The same over `rows` rows alone (a 1-D grid).
template <int LOGN, class... Exp, class... Act>
inline cudaError_t launch_split(void (*kernel)(Exp...), int64_t rows,
                                size_t smem, cudaStream_t stream,
                                Act... args) {
    return launch_split_grid<LOGN>(kernel, rows, 1, 1, smem, stream,
                                   args...);
}

}  // namespace orion
