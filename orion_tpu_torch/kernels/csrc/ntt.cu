// ntt_fwd / ntt_inv: negacyclic NTT and inverse NTT of (rows, N) int64
// residues, one thread-block cluster per row (cluster_ntt.cuh); and the
// rescale epilogues built on them, two launches each:
//   drop_intt:   launch A of mod_drop_rescale and rescale_poly - the
//                inverse NTT of the divisor rows, read in place from the
//                ciphertext through a row map, into a uint32 scratch;
//   drop_ntt:    launch B of mod_drop_rescale - per (item, poly, target
//                row j < l) the fast basis conversion of the scratch rows
//                to q_j in the load functor, the forward NTT, and
//                (acc_j - lift) * (P q_l)^-1 mod q_j in the store functor;
//   rescale_ntt: launch B of rescale_poly - the centered lift of the last
//                limb to q_j, the forward NTT, (c_j - lift) * q_l^-1.
//                rescale_poly launches it as a programmatic dependent of
//                launch A (sm_90): it fetches c's values for its stores,
//                then waits for A's z, so its start and prologue overlap
//                A's end; A lets it start after its last store.
//
// ntt_fwd, ntt_inv, drop_intt and rescale_ntt also come with the
// ConjugateInvariant ring's map (CI = true, modarith.cuh): rows of n
// stored residues, transforms at N = 2n on their lift, as orion_tpu's
// ring_ntt / ring_intt run the Pallas transforms on the CI ring.
// drop_ntt has no CI form: the CI ring builds no drop-down tables.
//
// Replaces orion_tpu/crypto/ks_pallas.py pallas_ntt4 (body _kntt) and
// pallas_intt4 (body _kintt), which run the four-step transform on an
// (R, 128) VMEM tile with rolls and selects, and the jnp epilogues around
// them in orion_tpu/crypto/keyswitch.py (mod_drop_rescale, rescale_poly):
// the concatenation of the divisor rows, the basis conversion and the
// final subtract-and-scale.  Output order equals ntt4's (bit-reversed).
//
// What bounds them: device memory.  A transform reads N residues and
// writes N per row, and reads the row's packed twiddles (N words); the
// LogN * N/2 Shoup butterflies are far below the card's integer rate.
// The fused pair reads the divisor rows and the target rows of acc once,
// writes the output once, and makes one round trip of a uint32 scratch of
// the divisor rows; the conversion re-reads those rows per target row,
// from L2.  Every other value stays in registers and shared memory.
//
// C interface (ctypes): pointers to contiguous device arrays, the CUDA
// stream as an opaque pointer; returns the cudaError_t of the launch.

#include "cluster_ntt.cuh"

using namespace orion;

#define SPLIT_KERNEL(name) \
    template <int LOGN>    \
    __global__ void __launch_bounds__(Split<LOGN>::T) name

// The same, also instantiated with the CI map.
#define SPLIT_KERNEL_CI(name)       \
    template <int LOGN, bool CI>    \
    __global__ void __launch_bounds__(Split<LOGN>::T) name

// Row strides below are W = row_width<LOGN, CI>: N, or n = N / 2 on CI.
SPLIT_KERNEL_CI(ntt_fwd_cluster)(int64_t* out, const int64_t* in, int L,
                                 const int64_t* p, const int64_t* twc,
                                 const int64_t* ci_pos) {
    extern __shared__ uint32_t s[];
    constexpr int N = 1 << LOGN;
    constexpr int W = row_width<LOGN, CI>();
    const int64_t row = blockIdx.x / Split<LOGN>::C;
    const int limb = (int)(row % L);
    const uint32_t pl = (uint32_t)p[limb];
    const int64_t* src = in + row * W;
    int64_t* dst = out + row * W;
    ntt_fwd_split<LOGN>(
        s, twc + (int64_t)limb * N, pl,
        [&](int i) {
            return lift_at<CI>([&](int k) { return (uint32_t)src[k]; }, i,
                               W, pl);
        },
        [&](int i, uint32_t v) {
            keep_at<CI>(ci_pos, i, [&](int j) { dst[j] = v; });
        });
}

// ntt_inv_cluster: cluster_ntt.cuh (ks_decompose.cu's CI form runs it too).

// z (groups, L, W) uint32 = n^-1 iNTT of in[g, rmap[d]], in (groups,
// n_src, W) int64; cluster (g, d) in row-major order.
SPLIT_KERNEL_CI(drop_intt_rows)(uint32_t* z, const int64_t* in, int n_src,
                                int L, const int64_t* rmap, const int64_t* p,
                                const int64_t* itwc, const int64_t* ninv,
                                const int64_t* ninv_sh,
                                const int64_t* ci_src) {
    extern __shared__ uint32_t s[];
    constexpr int N = 1 << LOGN;
    constexpr int W = row_width<LOGN, CI>();
    const int64_t row = blockIdx.x / Split<LOGN>::C;
    const int64_t g = row / L;
    const int d = (int)(row % L);
    const uint32_t pd = (uint32_t)p[d];
    const uint32_t nv = (uint32_t)ninv[d];
    const uint32_t nv_sh = (uint32_t)ninv_sh[d];
    const int64_t* src = in + (g * n_src + rmap[d]) * W;
    uint32_t* dst = z + row * W;
    ntt_inv_split<LOGN>(
        s, itwc + (int64_t)d * N, pd,
        [&](int i) { return (uint32_t)src[gather_at<CI>(ci_src, i)]; },
        [&](int i, uint32_t v) {
            if (!CI || i < W) dst[i] = shoup_mul(v, nv, nv_sh, pd);
        });
    // z is stored: launch B, a programmatic dependent, may start
    launch_dependents();
}

// out (groups, l, N) = (acc[g, j] - NTT(fbc(z[g]) -> q_j)) * scale_j mod
// q_j, acc (groups, n_src, N); z's L rows are the digit's source rows.
SPLIT_KERNEL(drop_lift_ntt)(int64_t* out, const int64_t* acc,
                            const uint32_t* z, int n_src, int l, int L,
                            const int64_t* qi, const int64_t* qi_sh,
                            const int64_t* srcp, const float* srcq,
                            const int64_t* conv, const int64_t* conv_sh,
                            const int64_t* dmod, const int64_t* dmod_sh,
                            const int64_t* p, const int64_t* twc,
                            const int64_t* scale, const int64_t* scale_sh) {
    extern __shared__ uint32_t s[];
    constexpr int N = 1 << LOGN;
    const int64_t row = blockIdx.x / Split<LOGN>::C;
    const int64_t g = row / l;
    const int j = (int)(row % l);
    const uint32_t pj = (uint32_t)p[j];
    const uint32_t dm = (uint32_t)dmod[j];
    const uint32_t dm_sh = (uint32_t)dmod_sh[j];
    const uint32_t sc = (uint32_t)scale[j];
    const uint32_t sc_sh = (uint32_t)scale_sh[j];
    const uint32_t* zg = z + g * L * N;
    const int64_t* a = acc + (g * n_src + j) * N;
    int64_t* dst = out + row * N;
    ntt_fwd_split<LOGN>(
        s, twc + (int64_t)j * N, pj,
        [&](int i) {
            return fbc_one(zg + i, N, L, qi, qi_sh, srcp, srcq, conv + j,
                           conv_sh + j, l, dm, dm_sh, pj);
        },
        [&](int i, uint32_t v) {
            dst[i] = shoup_mul(sub_mod((uint32_t)a[i], v, pj), sc, sc_sh,
                               pj);
        });
}

// out (groups, l, W) = (c[g, j] - NTT(lift_j(z[g]))) * scale_j mod q_j,
// c (groups, n_src, W), z (groups, 1, W) the last limb in coefficients,
// one cluster per (g, j) in row-major order; lift_j(x) = x mod q_j - [x >=
// half] * (q_l mod q_j), the centered lift, its x mod q_j a Shoup product
// by one (one_sh = floor(2^32 / q_j), exact for x < 2^32); on the CI ring
// the lift of each value to 2n is formed once (ntt_fwd_lift, the kept half
// of the outputs only) and stored through the map.  Launched as the
// programmatic dependent of launch A: each thread first fetches the values
// of c its stores need, into registers, and waits for A's z only then, so
// the fetch runs while A ends.  Without the launch attribute the wait
// returns at once.
SPLIT_KERNEL_CI(rescale_lift_ntt)(int64_t* out, const int64_t* c,
                                  const uint32_t* z, int n_src, int l,
                                  int half, const int64_t* p,
                                  const int64_t* twc,
                                  const int64_t* qlast_mod,
                                  const int64_t* one_sh,
                                  const int64_t* scale,
                                  const int64_t* scale_sh,
                                  const int64_t* ci_pos) {
    extern __shared__ uint32_t s[];
    using SP = Split<LOGN>;
    constexpr int N = 1 << LOGN, R = SP::Core::R;
    constexpr int W = row_width<LOGN, CI>();
    // the CTAs that store (on the CI lift with a cluster: the first half)
    constexpr int KEEP = CI && SP::C > 1 ? SP::C / 2 : SP::C;
    const int64_t row = blockIdx.x / SP::C;
    const int64_t g = row / l;
    const int j = (int)(row % l);
    const int cr = SP::C == 1 ? 0 : (int)cg::this_cluster().block_rank();
    const uint32_t pj = (uint32_t)p[j];
    const uint32_t qm = (uint32_t)qlast_mod[j];
    const uint32_t osh = (uint32_t)one_sh[j];
    const uint32_t sc = (uint32_t)scale[j];
    const uint32_t sc_sh = (uint32_t)scale_sh[j];
    const uint32_t* zg = z + g * W;
    const int64_t* a = c + (g * n_src + j) * W;
    int64_t* dst = out + row * W;
    // output cr * M + fwd_out_elem(slot) goes to pos[slot]: itself, or on
    // the CI ring its slot in the map (< 0: dropped)
    int pos[R];
    uint32_t pre[R];
    if (cr < KEEP) {
#pragma unroll
        for (int slot = 0; slot < R; ++slot) {
            const int o = cr * SP::M + fwd_out_elem<SP::LOGM>(slot);
            pos[slot] = CI ? (int)ci_pos[o] : o;
            pre[slot] = !CI || pos[slot] >= 0 ? (uint32_t)a[pos[slot]] : 0u;
        }
    }
    grid_dependency_wait();
    auto lift = [&](int k) {
        const uint32_t x = zg[k];
        const uint32_t v = x >= (uint32_t)half ? qm : 0u;
        return sub_mod(shoup_mul(x, 1u, osh, pj), v, pj);
    };
    auto store = [&](int o, int slot, uint32_t v) {
        const int k = CI ? pos[slot] : o;
        if (CI && k < 0) return;
        dst[k] = shoup_mul(sub_mod(pre[slot], v, pj), sc, sc_sh, pj);
    };
    const int64_t* tw = twc + (int64_t)j * N;
    if constexpr (CI)
        ntt_fwd_lift<LOGN>(s, tw, pj, lift, store);
    else
        ntt_fwd_split<LOGN>(s, tw, pj, lift, store);
}

extern "C" int orion_ntt_cluster_size(int logn) {
    int c = -1;
    with_logn(logn, [&](auto k) {
        c = Split<decltype(k)::value>::C;
        return cudaSuccess;
    });
    return c;
}

template <bool CI>
static int ntt_fwd_launch(int64_t* out, const int64_t* in, int rows, int L,
                          int logn, const int64_t* p, const int64_t* twc,
                          const int64_t* ci_pos, void* stream) {
    return (int)with_logn(logn, [&](auto k) {
        constexpr int LOGN = decltype(k)::value;
        return launch_split<LOGN>(ntt_fwd_cluster<LOGN, CI>, rows,
                                  Split<LOGN>::SMEM_FWD, (cudaStream_t)stream,
                                  out, in, L, p, twc, ci_pos);
    });
}

template <bool CI>
static int ntt_inv_launch(int64_t* out, const int64_t* in, int rows, int L,
                          int logn, const int64_t* p, const int64_t* itwc,
                          const int64_t* ninv, const int64_t* ninv_sh,
                          const int64_t* ci_src, void* stream) {
    return (int)with_logn(logn, [&](auto k) {
        constexpr int LOGN = decltype(k)::value;
        return launch_split<LOGN>(ntt_inv_cluster<LOGN, CI>, rows,
                                  Split<LOGN>::SMEM_INV, (cudaStream_t)stream,
                                  out, in, L, p, itwc, ninv, ninv_sh,
                                  ci_src);
    });
}

template <bool CI>
static int drop_intt_launch(uint32_t* z, const int64_t* in, int groups,
                            int n_src, int L, int logn, const int64_t* rmap,
                            const int64_t* p, const int64_t* itwc,
                            const int64_t* ninv, const int64_t* ninv_sh,
                            const int64_t* ci_src, void* stream) {
    return (int)with_logn(logn, [&](auto k) {
        constexpr int LOGN = decltype(k)::value;
        return launch_split<LOGN>(drop_intt_rows<LOGN, CI>,
                                  (int64_t)groups * L, Split<LOGN>::SMEM_INV,
                                  (cudaStream_t)stream, z, in, n_src, L,
                                  rmap, p, itwc, ninv, ninv_sh, ci_src);
    });
}

// ci_pos / ci_src: the CI ring's map (logn then the lift's, rows of n
// residues), or null on the standard ring.
extern "C" int orion_ntt_fwd(int64_t* out, const int64_t* in, int rows,
                             int L, int logn, const int64_t* p,
                             const int64_t* twc, const int64_t* ci_pos,
                             void* stream) {
    auto launch = ci_pos != nullptr ? ntt_fwd_launch<true>
                                    : ntt_fwd_launch<false>;
    return launch(out, in, rows, L, logn, p, twc, ci_pos, stream);
}

extern "C" int orion_ntt_inv(int64_t* out, const int64_t* in, int rows,
                             int L, int logn, const int64_t* p,
                             const int64_t* itwc, const int64_t* ninv,
                             const int64_t* ninv_sh, const int64_t* ci_src,
                             void* stream) {
    auto launch = ci_src != nullptr ? ntt_inv_launch<true>
                                    : ntt_inv_launch<false>;
    return launch(out, in, rows, L, logn, p, itwc, ninv, ninv_sh, ci_src,
                  stream);
}

extern "C" int orion_drop_intt(uint32_t* z, const int64_t* in, int groups,
                               int n_src, int L, int logn,
                               const int64_t* rmap, const int64_t* p,
                               const int64_t* itwc, const int64_t* ninv,
                               const int64_t* ninv_sh, const int64_t* ci_src,
                               void* stream) {
    auto launch = ci_src != nullptr ? drop_intt_launch<true>
                                    : drop_intt_launch<false>;
    return launch(z, in, groups, n_src, L, logn, rmap, p, itwc, ninv,
                  ninv_sh, ci_src, stream);
}

extern "C" int orion_drop_ntt(
        int64_t* out, const int64_t* acc, const uint32_t* z, int groups,
        int n_src, int l, int L, int logn, const int64_t* qi,
        const int64_t* qi_sh, const int64_t* srcp, const float* srcq,
        const int64_t* conv, const int64_t* conv_sh, const int64_t* dmod,
        const int64_t* dmod_sh, const int64_t* p, const int64_t* twc,
        const int64_t* scale, const int64_t* scale_sh, void* stream) {
    return (int)with_logn(logn, [&](auto k) {
        constexpr int LOGN = decltype(k)::value;
        return launch_split<LOGN>(drop_lift_ntt<LOGN>, (int64_t)groups * l,
                                  Split<LOGN>::SMEM_FWD, (cudaStream_t)stream,
                                  out, acc, z, n_src, l, L, qi, qi_sh, srcp,
                                  srcq, conv, conv_sh, dmod, dmod_sh, p, twc,
                                  scale, scale_sh);
    });
}

// Launched as the programmatic dependent of the kernel ahead of it on the
// stream, launch A of rescale_poly: c was complete before that started.
template <bool CI>
static int rescale_ntt_launch(int64_t* out, const int64_t* c,
                              const uint32_t* z, int groups, int n_src,
                              int l, int logn, int half, const int64_t* p,
                              const int64_t* twc, const int64_t* qlast_mod,
                              const int64_t* one_sh, const int64_t* scale,
                              const int64_t* scale_sh, const int64_t* ci_pos,
                              void* stream) {
    return (int)with_logn(logn, [&](auto k) {
        constexpr int LOGN = decltype(k)::value;
        const size_t smem = CI ? Split<LOGN>::SMEM_LIFT
                               : Split<LOGN>::SMEM_FWD;
        return launch_split_grid<LOGN, true>(
            rescale_lift_ntt<LOGN, CI>, (int64_t)groups * l, 1, 1, smem,
            (cudaStream_t)stream, out, c, z, n_src, l, half, p, twc,
            qlast_mod, one_sh, scale, scale_sh, ci_pos);
    });
}

extern "C" int orion_rescale_ntt(int64_t* out, const int64_t* c,
                                 const uint32_t* z, int groups, int n_src,
                                 int l, int logn, int half, const int64_t* p,
                                 const int64_t* twc, const int64_t* qlast_mod,
                                 const int64_t* one_sh, const int64_t* scale,
                                 const int64_t* scale_sh,
                                 const int64_t* ci_pos, void* stream) {
    auto launch = ci_pos != nullptr ? rescale_ntt_launch<true>
                                    : rescale_ntt_launch<false>;
    return launch(out, c, z, groups, n_src, l, logn, half, p, twc, qlast_mod,
                  one_sh, scale, scale_sh, ci_pos, stream);
}
