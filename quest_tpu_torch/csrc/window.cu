// Window pass (K1), window megakernel (K2), cluster pass (K11) and fused
// segment-swap + cluster pass (K12) for NVIDIA Hopper (sm_90a).
//
// K1 replaces the Pallas kernel quest_tpu/ops/fused.py
// _apply_window_stack_jit (pallas_call at fused.py:497; body _window_kernel
// and _window_block_body).  K2 replaces _apply_megawin_jit (pallas_call at
// fused.py:799; body _mega_window_kernel).  K11 replaces
// _apply_cluster_stack_jit (pallas_call at fused.py:543; body
// _cluster_kernel_rank, pair entry _apply_cluster_pair_jit) and K12
// _apply_swap_cluster_stack_jit (pallas_call at fused.py:271; body
// _cluster_swap_kernel): the paged planner's `fused` and `swapfused` ops.
//
// What they compute.  The state is a real SoA array: the real plane
// x[0 .. 2^n) followed by the imaginary plane x[2^n .. 2^(n+1)); qubit q is
// bit q of the amplitude index.  A window pass with offset k (7 <= k <=
// n-7) views each plane as (hi, 128 w, mid, 128 l) with w = bits [k, k+7),
// l = bits [0, 7), mid = bits [7, k) and hi = bits [k+7, n).  Each
// 128 x 128 complex "slab" X at fixed (h, m) is independent and becomes
//
//     Y = mask (.) sum_r B_r X A_r^T        (dual-side)
//     Y = mask (.) sum_r B_r X              (B-only)
//     Y = mask (.) sum_r X A_r^T            (A-only)
//     Y = mask (.) X                        (mask-only: cross diagonals)
//
// with R = rank <= 4 pairs of complex 128 x 128 matrices (SoA (R,2,128,128))
// and an optional complex (128 w x 128 l) elementwise mask.  A megawin
// group applies a run of such passes whose windows satisfy k <= 7 + g to
// super-blocks of G = 2^g consecutive 128 x 128 canonical rows: every
// window bit of every pass lies inside the super-block, so the passes can
// run back to back on it.
//
// What bounds them on this card.  A dual-side rank-1 pass at 2^26
// amplitudes moves 1.07 GB (0.32 ms at 3.35 TB/s) and does 2^26 * 2048 =
// 1.37e11 real multiply-adds' worth of flops.  Float32-accurate products
// on the tensor cores cost three TF32 products each (below), so the least
// the card needs is 1.37e11 / (495 / 3 = 165 TFLOP/s) = 0.83 ms: bound by
// operations.  Float64 runs on the FP64 tensor cores (DMMA, 67 TFLOP/s):
// 2.05 ms.  A mask-only pass does no products and is bound by bytes.
//
// Design.  One CTA of 256 threads (8 warps, two warpgroups) owns one slab
// and one chunk of LC output lanes (LC = 64 at float32, 2 CTAs a slab;
// 32 at float64, 4): Y[:, chunk] depends on all of X but only on rows
// `chunk` of each A_r.  Per rank the CTA computes T = X A_r^T[:, chunk]
// (M = 128 rows w, N = LC, K = 128 lanes), parks T in shared memory, then
// Y^T += T^T B_r^T (M = LC lanes, N = 128 rows w', K = 128 rows w).  In
// both products the state (X, then T) is the A operand, which the threads
// load from shared memory and split in registers, and the side matrix the
// B operand, K-major as it lies in memory.  Warp j owns rows [16j, 16j +
// 16) of T, and a 16 x LC block of Y^T; the two accumulators stay in
// registers, and rank 0 has code of its own in which they are never live
// together.
//
// * float32: wgmma m64n64k8 TF32 with FP32 accumulation, A from
//   registers, B from shared memory through a matrix descriptor.  The
//   state operand is split with cvt.rna.tf32.f32 into x = x_h + x_m + x_l
//   (exact: x has 24 significant bits, x_h and x_m 11 each, x_l at most
//   2), a side matrix into m = m_h + m_l (on the host side, once per
//   tensor: ops/fused.py tf32_side_split).  Where every entry of the
//   pass's sides is a TF32 value (m_l = 0: the 0/1 permutations of the
//   QFT's bit reversal, the identity, sides of +-1 and +-i), decided on
//   the host and carried in QtPass::exact, a real product is x_l m + x_m m
//   + x_h m: each term exact, so a permutation pass equals its plain
//   version bit for bit.  Otherwise it is the 3xTF32 product x_h m_l +
//   x_m m_h + x_h m_h, about 2^-22 relative per product.  No product runs
//   in TF32 alone.  The tensor cores round each accumulation toward zero:
//   each 8-deep k step starts from zero, small terms first, and is added
//   to the running sum in FP32 (one chain over all of K shrank the norm
//   measurably).
// * float64: mma.sync m16n8k4 DMMA (wgmma has no FP64), one product per
//   real product, rounded to nearest.
//
// Copies.  The K tiles (32 lanes or rows at float32, 16 at float64) of
// X, A_r and B_r stream through a two-stage ring in shared memory, one
// tile ahead of the products that use it, as bulk copies
// (cp.async.bulk) counted on an mbarrier per stage: one copy per X row
// and plane, one per side plane.  The side matrices come from side
// images (ops/fused.py _side_image) that hold each K tile as shared
// memory holds it, wgmma's K-major core-matrix layout at float32.  (With
// one cp.async of 16 bytes per thread and request the ring could not be
// filled in time: the copies, not the products, set the pass's time.)
// The copy engine reads global memory through L2 and the async proxy;
// inside K2 a pass reads what other CTAs of the cluster wrote in the
// previous pass, so the writers fence the async proxy before the cluster
// barrier.  Shared memory per CTA: 208 KB (f32) or 172 KB (f64), one CTA
// per SM.
//
// Out of place.  The CTAs of a slab all read the whole slab, so no CTA
// may overwrite it: both kernels write to a separate output buffer and the
// executor ping-pongs buffers (at 26 qubits f32 the second buffer is
// 512 MB).
//
// K2 runs a persistent grid of thread-block clusters (up to 8 CTAs), no
// more than the card holds at once; each cluster takes super-blocks in
// turn.  On a super-block the cluster walks the group's passes in order;
// within a pass its CTAs share the super-block's (slab, chunk) items, and
// a cluster barrier separates passes.  The first pass reads the state;
// from there the passes alternate between the super-block's place in the
// output buffer and a super-block-sized scratch buffer that belongs to
// the cluster (G = 8: 1 MB at f32), so that the last lands in the output;
// the 50 MB L2 serves both while they are hot.  So K2, like K1, holds the
// state twice (input and output) plus one super-block per resident
// cluster, tens of MB: never a third full-size buffer.
// K1, K2, K11 and K12 run every (slab, chunk) item through the SAME
// device function, window_item, which issues the same products in the
// same order, and the file is compiled with --fmad=false: a megawin group
// is bit-identical to its passes run one by one through K1.
//
// K11 computes K1's function at k = 7, dual-sided, with no mask ("k = 7
// reproduces apply_cluster_stack", fused.py:399), so its device code IS
// K1's: its wrapper (fused.apply_cluster_stack) launches
// window_pass_kernel through qt_window_pass_* with k = 7, under a launch
// count of its own.  It has K1's bound: a rank-R pass at 2^26 amplitudes
// is R * 0.83 ms of float32-accurate tensor-core products against
// 0.32 ms of bytes.  The Pallas kernel's block_rows = 8 tiling, its
// 256 x 256 real representations and its input/output aliasing are TPU
// artifacts; K11 is out of place like K1 (the executor ping-pongs
// buffers).
//
// K12 is the segment swap [h, h+m) <-> [b, b+m) (h >= 14, 7 <= b,
// b + m <= 14) followed by K11's operator.  The TPU kernel brings the 2^m
// slabs the swap mixes into VMEM as one super-block and exchanges the
// slab and row bit fields by an in-VMEM transpose.  Here the swap is a
// gather: output slab g, row w is read from input slab g', row w', where
// the m-bit fields g[h-14, h-14+m) and w[b-7, b-7+m) trade places (an
// involution).  swap_cluster_kernel runs window_item with that row-address
// map on its loads and writes slab g in place in the output buffer; each
// source row is 128 contiguous lanes (512 B at f32), so the gather stays
// one bulk copy a row and plane, any m works unchanged, and the bound is
// K11's.  It issues the same products in the same order as K11, so it is
// bit-identical to the segment swap followed by K11.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int DIM = 128;           // window / lane extent
constexpr int NTHREADS = 256;      // 8 warps
constexpr int STAGES = 2;          // K tiles in flight
constexpr int MAX_MEGA_PASSES = 16;

// Tile shapes per type.  LC: output lanes per CTA; KC: depth of a K tile;
// KS: depth of one mma; SP: row stride of a K tile in shared memory and
// TS of the T tile (elements; padded so that every fragment load of a
// warp hits distinct banks).
template <typename T> struct Cfg;
template <> struct Cfg<float> {
    static constexpr int LC = 64, KC = 32, KS = 8, SP = KC + 4, TS = LC + 8;
};
template <> struct Cfg<double> {
    static constexpr int LC = 32, KC = 16, KS = 4, SP = KC + 4, TS = LC + 4;
};

template <typename T>
__host__ __device__ constexpr int nchunk() {
    return DIM / Cfg<T>::LC;
}

// Elements a side tile takes per row: float32 side tiles are K-major
// TF32 tiles for wgmma, unpadded (rows in 8-row core matrices of 16-byte
// rows); float64 ones padded rows for the DMMA fragment loads.
template <typename T>
__host__ __device__ constexpr int side_rs() {
    return sizeof(T) == 4 ? Cfg<T>::KC : Cfg<T>::SP;
}

// Planes of a side matrix at most: (re, im), and at float32 the low TF32
// parts (re_l, im_l) of a pass whose sides are not exact.
template <typename T>
__host__ __device__ constexpr int max_planes() {
    return sizeof(T) == 4 ? 4 : 2;
}

// One ring stage holds the (re, im) planes of an X tile (128 x KC, padded
// rows) and the planes of an A_r tile (LC x KC), or of a B_r tile (128 x
// KC).
template <typename T>
__host__ __device__ constexpr int stage_elems() {
    using C = Cfg<T>;
    constexpr int P = max_planes<T>();
    return 2 * DIM * C::SP + P * C::LC * side_rs<T>() > P * DIM * side_rs<T>()
               ? 2 * DIM * C::SP + P * C::LC * side_rs<T>()
               : P * DIM * side_rs<T>();
}

// Beside the ring: the T tile.
template <typename T>
__host__ __device__ constexpr size_t smem_bytes() {
    return sizeof(T) * ((size_t)STAGES * stage_elems<T>() +
                        2 * (size_t)DIM * Cfg<T>::TS);
}

}  // namespace

// One window pass as the kernels see it; the same layout as the host-side
// ctypes structure in ops/fused.py.  `a` and `b` are side images
// (ops/fused.py _side_image): per rank, plane and K tile, a block of the
// 128 rows as shared memory holds them, the planes (re, im) where the
// pass is exact or float64 and (re_h, im_h, re_l, im_l), the TF32 split of
// each entry, otherwise.
struct QtPass {
    int k;          // window offset
    int rank;       // number of Kronecker terms R
    int apply_a;    // lane side present
    int apply_b;    // window side present
    int exact;      // every entry of the used sides is a TF32 value
    const void* a;  // lane matrices
    const void* b;  // window matrices
    const void* mask;  // (2, 128, 128) SoA (window, lane) mask, or null
};

struct QtMegaArgs {
    int npass;
    int g_rows;     // G: canonical rows per super-block
    QtPass p[MAX_MEGA_PASSES];
};

template <typename T> struct Vec2;
template <> struct Vec2<float> { using type = float2; };
template <> struct Vec2<double> { using type = double2; };

__device__ __forceinline__ float fma_t(float a, float b, float c) {
    return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
    return fma(a, b, c);
}

// ---------------------------------------------------------------------------
// Tensor-core products
// ---------------------------------------------------------------------------

// How a real product splits into tensor-core products: NS parts of the
// state operand, NM parts of the side operand, NP products, product q
// multiplying state part si(q) by side part mj(q), the small (correction)
// terms first and the large one last.
template <typename T, bool EXACT> struct Split;
template <> struct Split<float, true> {      // x_l m + x_m m + x_h m
    static constexpr int NS = 3, NM = 1, NP = 3;
    __host__ __device__ static constexpr int si(int q) { return 2 - q; }
    __host__ __device__ static constexpr int mj(int) { return 0; }
};
template <> struct Split<float, false> {     // x_h m_l + x_m m_h + x_h m_h
    static constexpr int NS = 2, NM = 2, NP = 3;
    __host__ __device__ static constexpr int si(int q) {
        return q == 1 ? 1 : 0;
    }
    __host__ __device__ static constexpr int mj(int q) {
        return q == 0 ? 1 : 0;
    }
};
template <bool E> struct Split<double, E> {  // one DMMA
    static constexpr int NS = 1, NM = 1, NP = 1;
    __host__ __device__ static constexpr int si(int) { return 0; }
    __host__ __device__ static constexpr int mj(int) { return 0; }
};

// Fragment registers: TF32 bit patterns at float32, doubles at float64.
// A warp's A fragment (16 x KS, row-major) holds AR of them, a DMMA B
// fragment (KS x 8) BR, an accumulator (16 x 8) four.
template <typename T> struct Frag;
template <> struct Frag<float> {
    using reg = uint32_t;
    static constexpr int AR = 4;
};
template <> struct Frag<double> {
    using reg = double;
    static constexpr int AR = 2, BR = 1;
};

// cvt.rna.tf32.f32: round to the nearest TF32 value, ties away from zero;
// the low 13 bits are cleared so that the register holds exactly that
// value (ops/fused.py tf32_round models it).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return r & 0xffffe000u;
}

// The state's parts (x_h, x_m[, x_l]); at float64 the value itself.
template <int N>
__device__ __forceinline__ void split_state(float x, uint32_t (&p)[N]) {
    static_assert(N == 2 || N == 3, "a float32 state splits in 2 or 3");
    p[0] = tf32_rna(x);
    const float r1 = x - __uint_as_float(p[0]);
    p[1] = tf32_rna(r1);
    if constexpr (N == 3) p[2] = __float_as_uint(r1 - __uint_as_float(p[1]));
}
template <int N>
__device__ __forceinline__ void split_state(double x, double (&p)[N]) {
    p[0] = x;
}

__device__ __forceinline__ double neg(double v) { return -v; }

template <typename T, int NT>
__device__ __forceinline__ void zero_tiles(T (&acc)[NT][4]) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0;
}

// DMMA: acc (16 x 8) += a (16 x 4) b (4 x 8), float64.
__device__ __forceinline__ void mma(double (&c)[4], const double (&a)[2],
                                    const double (&b)[1]) {
    asm volatile(
        "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
        : "d"(a[0]), "d"(a[1]), "d"(b[0]));
}

// wgmma: a warpgroup's d (64 x 64, FP32) (+)= a b^T, with a (64 x 8 TF32)
// from registers (warp w of the warpgroup holding rows [16w, 16w + 16) as
// mma.m16n8k8 holds its A fragment) and b (64 x 8 TF32) a K-major tile in
// shared memory named by a matrix descriptor.  scale_d = 0 starts from
// zero; SCALE_A = -1 negates a.  Each warp's d[j] is the 16 x 8 tile of
// columns [8j, 8j + 8) in mma.m16n8k8's accumulator layout.
template <int SCALE_A>
__device__ __forceinline__ void wgmma_tf32(float (&d)[8][4],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, %38, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d), "n"(SCALE_A));
}
__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// The matrix descriptor of a K-major TF32 tile in shared memory without
// swizzle: 8-row core matrices of 16-byte rows (4 TF32) stored as 128
// contiguous bytes, the two 16-byte K chunks of an 8-deep step LBO = 128
// bytes apart, 8-row groups SBO bytes apart.
__device__ __forceinline__ uint64_t kmajor_desc(const void* p, uint32_t sbo) {
    const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
    return (uint64_t)((a >> 4) & 0x3fff) | ((uint64_t)(128 >> 4) << 16) |
           ((uint64_t)((sbo >> 4) & 0x3fff) << 32);
}

// The state's A fragment (rows g, g + 8; columns t, t + 4 at KS = 8) at
// k step ks, split: element (m, kk) at s_re/s_im[m * sm + kk * sk].
template <typename T, int NS>
__device__ __forceinline__ void load_state(
        const T* s_re, const T* s_im, int sm, int sk, int ks, int g, int t,
        typename Frag<T>::reg (&sre)[NS][Frag<T>::AR],
        typename Frag<T>::reg (&sim)[NS][Frag<T>::AR]) {
    using reg = typename Frag<T>::reg;
#pragma unroll
    for (int i = 0; i < Frag<T>::AR; ++i) {
        const int o = (g + 8 * (i & 1)) * sm + (ks + t + 4 * (i >> 1)) * sk;
        reg pr[NS], pi[NS];
        split_state<NS>(s_re[o], pr);
        split_state<NS>(s_im[o], pi);
#pragma unroll
        for (int q = 0; q < NS; ++q) {
            sre[q][i] = pr[q];
            sim[q][i] = pi[q];
        }
    }
}

// acc[c][nt] (c = re, im; 16 x 8 tiles nt) += S M^T over one K tile,
// complex.  S (16 rows of the warp x KC) is the state operand, its element
// (m, kk) at s_re/s_im[m * sm + kk * sk]; M (NT * 8 rows x KC) the side in
// the layout of side_rs, plane p (re_h, im_h, re_l, im_l) at side + p *
// pstride.  Lane (g, t) = (lane / 4, lane % 4).
//
// float32 (wgmma, the warpgroup's 64 rows x 64 columns): each k step's
// products go to accumulators started from zero, small terms first, and
// are then added to acc: the tensor cores round each TF32 accumulation
// toward zero, and a short chain from zero keeps that rounding at the
// size of its last, large terms (one chain per output over all of K
// drifted the norm).  float64 (DMMA, per warp): products accumulate in
// acc directly, rounded to nearest.
template <typename T, bool EXACT, int NT>
__device__ __forceinline__ void product_tile(
        T (&acc)[2][NT][4], const T* s_re, const T* s_im, int sm, int sk,
        const T* side, int pstride, int g, int t) {
    using C = Cfg<T>;
    using S = Split<T, EXACT>;
    using F = Frag<T>;
    using reg = typename F::reg;
    if constexpr (sizeof(T) == 4) {
        static_assert(NT == 8, "wgmma m64n64: 8 tiles of 8 columns");
        constexpr uint32_t SBO = (C::KC / 4) * 128;
        const uint64_t d0 = kmajor_desc(side, SBO);
        const uint64_t plane = (uint64_t)(pstride * 4) >> 4;
        T cre[NT][4], cim[NT][4];
        zero_tiles(cre);
        zero_tiles(cim);
        // one k step at a time: its A registers and accumulators are in
        // flight until the wait
#pragma unroll 1
        for (int ks = 0; ks < C::KC; ks += C::KS) {
            reg sre[S::NS][F::AR], sim[S::NS][F::AR];
            load_state<T, S::NS>(s_re, s_im, sm, sk, ks, g, t, sre, sim);
            // the step's two 16-byte K chunks start ks / 4 chunks in
            const uint64_t dk = (uint64_t)((ks / 4) * 128 >> 4);
            wgmma_fence();
#pragma unroll
            for (int q = 0; q < S::NP; ++q) {
                const int a = S::si(q), b = S::mj(q);
                const uint64_t dre = d0 + dk + 2 * b * plane;
                const uint64_t dim = dre + plane;
                // re += S_re M_re^T - S_im M_im^T; im += S_re M_im^T +
                // S_im M_re^T
                wgmma_tf32<1>(cre, sre[a], dre, q > 0);
                wgmma_tf32<-1>(cre, sim[a], dim, 1);
                wgmma_tf32<1>(cim, sre[a], dim, q > 0);
                wgmma_tf32<1>(cim, sim[a], dre, 1);
            }
            wgmma_commit();
            wgmma_wait_all();
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    acc[0][nt][e] = acc[0][nt][e] + cre[nt][e];
                    acc[1][nt][e] = acc[1][nt][e] + cim[nt][e];
                }
        }
    } else {
        constexpr int BR = F::BR;
        // one k step at a time: unrolled, the loads of the whole tile
        // would be hoisted and spill
#pragma unroll 1
        for (int ks = 0; ks < C::KC; ks += C::KS) {
            reg sre[S::NS][F::AR], sim[S::NS][F::AR], nsi[S::NS][F::AR];
            load_state<T, S::NS>(s_re, s_im, sm, sk, ks, g, t, sre, sim);
#pragma unroll
            for (int i = 0; i < F::AR; ++i) nsi[0][i] = neg(sim[0][i]);
            reg mre[NT][BR], mim[NT][BR];
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int i = 0; i < BR; ++i) {
                    // the side's B fragment: rows t, t + 4 of column g
                    const int o = (nt * 8 + g) * C::SP + ks + t + 4 * i;
                    mre[nt][i] = side[o];
                    mim[nt][i] = side[pstride + o];
                }
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
                mma(acc[0][nt], sre[0], mre[nt]);
                mma(acc[1][nt], sre[0], mim[nt]);
            }
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
                mma(acc[0][nt], nsi[0], mim[nt]);
                mma(acc[1][nt], sim[0], mre[nt]);
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Asynchronous copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// One bulk copy (the copy engine, not the threads, moves the bytes) of
// `bytes` (a multiple of 16) from global to shared memory; its completion
// is counted on the mbarrier `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}
__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                     smem_addr(bar)),
                 "r"(count)
                 : "memory");
}
// This thread's arrival, announcing the bytes its copies will bring.
__device__ __forceinline__ void bar_arrive(uint64_t* bar, uint32_t bytes) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            smem_addr(bar)),
        "r"(bytes)
        : "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done = 0;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(smem_addr(bar)), "r"(parity)
            : "memory");
    } while (!done);
}

// Where a CTA reads row w of the slab it works on.  K1, K2 and K11 read
// their slab's rows in place, at a stride.
struct StridedRows {
    long long base, stride;
    __device__ __forceinline__ long long operator()(int w) const {
        return base + w * stride;
    }
};

// K12: row w of output slab `slab` comes from the input row whose slab
// index bits [hs, hs+m) and row bits [bs, bs+m) are the output's with the
// two fields exchanged (mask = 2^m - 1).
struct SwappedRows {
    long long slab;
    int hs, bs, mask;
    __device__ __forceinline__ long long operator()(int w) const {
        const long long gf = (slab >> hs) & mask;
        const long long wf = (w >> bs) & mask;
        const long long src_slab =
            (slab & ~((long long)mask << hs)) | (wf << hs);
        const long long src_row = (w & ~(mask << bs)) | (gf << bs);
        return (src_slab * DIM + src_row) * DIM;
    }
};

// ---------------------------------------------------------------------------
// One (slab, lane chunk) item
// ---------------------------------------------------------------------------

template <typename T, int NT>
__device__ __forceinline__ void zero_acc(T (&acc)[2][NT][4]) {
    zero_tiles(acc[0]);
    zero_tiles(acc[1]);
}

// The mask's factor on (vr, vi) at (w, l), where there is a mask.
template <typename T>
__device__ __forceinline__ void masked(const T* M, int w, int l, T& vr,
                                       T& vi) {
    if (M == nullptr) return;
    const long long mat = (long long)DIM * DIM;
    const T mr = M[w * DIM + l], mi = M[mat + w * DIM + l];
    const T nr = fma_t(vr, mr, -(vi * mi));
    const T ni = fma_t(vr, mi, vi * mr);
    vr = nr;
    vi = ni;
}

// One (slab, lane chunk) item of one window pass: reads row w of the slab
// at offset src(w) (lane stride 1) of the real and imaginary planes `xr`,
// `xi`, writes output lanes [l0, l0 + LC) of every row w to offset
// base + w * wstride of the planes `yr`, `yi`.  The state is read through
// L2 only (the copy engine, __ldcg), never the non-coherent L1 path:
// inside K2 a pass reads what other CTAs of the cluster wrote in the
// previous pass.
//
// Warp j computes rows [16j, 16j + 16) of T = X A_r^T[:, chunk] (all LC
// columns), and a 16 x LC block of Y^T = T^T B_r^T (rows: chunk lanes
// [16 (j % (LC/16)), +16); columns: rows w' [LC (j / (LC/16)), +LC)):
// in both products the state is the A operand, split once per fragment,
// and the already split side the B operand.
template <typename T, bool EXACT, typename Rows>
__device__ void window_item(const T* xr, const T* xi, T* yr, T* yi,
                            Rows src, long long base, long long wstride,
                            int l0, const QtPass& p, T* smem,
                            uint64_t* bars) {
    using C = Cfg<T>;
    using V2 = typename Vec2<T>::type;
    constexpr int NT = C::LC / 8;          // 16 x 8 tiles per warp
    constexpr int NK = DIM / C::KC;        // K tiles per product
    constexpr int SP = C::SP, TS = C::TS, RS = side_rs<T>();
    // side planes per rank in the side images
    constexpr int NPL = (sizeof(T) == 4 && !EXACT) ? 4 : 2;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int g = lane / 4, t = lane % 4;
    const int row0 = warp * 16;                      // T rows w
    const int c0 = (warp % (C::LC / 16)) * 16;       // Y^T rows (lanes)
    const int n0 = (warp / (C::LC / 16)) * C::LC;    // Y^T columns w'
    const T* M = static_cast<const T*>(p.mask);

    if (!p.apply_a && !p.apply_b) {
        // mask-only: Y = mask (.) X, bound by bytes
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int w = row0 + g + 8 * h;
                const int l = l0 + nt * 8 + 2 * t;
                const long long o = src(w) + l;
                const V2 vr = __ldcg(reinterpret_cast<const V2*>(xr + o));
                const V2 vi = __ldcg(reinterpret_cast<const V2*>(xi + o));
                T r0 = vr.x, r1 = vr.y, i0 = vi.x, i1 = vi.y;
                masked(M, w, l, r0, i0);
                masked(M, w, l + 1, r1, i1);
                const long long d = base + w * wstride + l;
                *reinterpret_cast<V2*>(yr + d) = V2{r0, r1};
                *reinterpret_cast<V2*>(yi + d) = V2{i0, i1};
            }
        return;
    }

    const T* A = static_cast<const T*>(p.a);
    const T* B = static_cast<const T*>(p.b);
    T* t_r = smem + STAGES * stage_elems<T>();   // [DIM][TS]: T = X A^T chunk
    T* t_i = t_r + DIM * TS;
    const int na = p.apply_a ? NK : 0;
    const int per = na + (p.apply_b ? NK : 0);
    const int total = p.rank * per;

    // One stage's tile, of the K-tile stream (per rank, X and A_r tiles,
    // then B_r tiles), in bulk copies counted on the stage's mbarrier:
    // thread i copies row i % 128 of X's plane i / 128 (KC elements);
    // threads 0 .. NPL-1 a side plane's block of the side image, which
    // holds each K tile of each plane as shared memory holds it (the
    // layout of side_rs, 128 rows).  `extra` adds a copy of this thread's
    // (the B-only pass's T tile, with tile 0).
    const int tid = threadIdx.x;
    auto load_tile = [&](int tile, uint32_t extra) {
        T* st = smem + (tile % STAGES) * stage_elems<T>();
        uint64_t* bar = &bars[tile % STAGES];
        const int r = tile / per, j = tile % per;
        const long long img = (long long)DIM * side_rs<T>();  // one block
        uint32_t bytes = extra;
        if (j < na) {
            const int k0 = j * C::KC;
            const int plane = tid / DIM, w = tid % DIM;
            bytes += C::KC * sizeof(T);
            if (tid < NPL) bytes += C::LC * side_rs<T>() * sizeof(T);
            bar_arrive(bar, bytes);
            bulk_copy(st + (plane * DIM + w) * SP,
                      (plane ? xi : xr) + src(w) + k0, C::KC * sizeof(T),
                      bar);
            if (tid < NPL)
                bulk_copy(st + 2 * DIM * SP + tid * C::LC * side_rs<T>(),
                          A + ((long long)(r * NPL + tid) * NK + j) * img +
                              (long long)l0 * side_rs<T>(),
                          C::LC * side_rs<T>() * sizeof(T), bar);
        } else {
            if (tid < NPL) bytes += DIM * side_rs<T>() * sizeof(T);
            bar_arrive(bar, bytes);
            if (tid < NPL)
                bulk_copy(st + tid * DIM * side_rs<T>(),
                          B + ((long long)(r * NPL + tid) * NK + (j - na)) *
                                  img,
                          DIM * side_rs<T>() * sizeof(T), bar);
        }
    };

    T tacc[2][NT][4];
    zero_acc(tacc);

    // fresh barriers for this item: every earlier use has completed
    if (tid < STAGES) bar_init(&bars[tid], NTHREADS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    __syncthreads();
    // B-only: T is the slab's own lane chunk, for every rank; it comes
    // with tile 0, after the arrivals that announce its bytes
    const uint32_t t_bytes = p.apply_a ? 0 : C::LC * sizeof(T);
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s)
        if (s < total) load_tile(s, s == 0 ? t_bytes : 0);
    if (!p.apply_a) {
        const int plane = tid / DIM, w = tid % DIM;
        bulk_copy((plane ? t_i : t_r) + w * TS,
                  (plane ? xi : xr) + src(w) + l0, t_bytes, &bars[0]);
    }
    // Waits for the next tile of the stream, lets every warp finish with
    // the stage the load after it overwrites, issues that load, and
    // returns the tile's stage.  Its barrier also orders T's stores
    // (park_t) before the second product's reads, and the previous rank's
    // reads of T before this rank's stores.
    int tile = 0;
    auto next_stage = [&]() {
        bar_wait(&bars[tile % STAGES], (tile / STAGES) & 1);
        __syncthreads();
        if (tile + STAGES - 1 < total) {
            // the threads' reads of the stage are done (the barrier);
            // order them before the copy engine's writes
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            load_tile(tile + STAGES - 1, 0);
        }
        T* st = smem + (tile % STAGES) * stage_elems<T>();
        ++tile;
        return st;
    };
    // T[w][c] (+)= sum_l X[w][l] A_r[l0 + c][l], one rank's K tiles
    auto first_product = [&](T (&acc)[2][NT][4]) {
        for (int j = 0; j < NK; ++j) {
            const T* st = next_stage();
            product_tile<T, EXACT, NT>(acc, st + row0 * SP,
                                       st + (DIM + row0) * SP, SP, 1,
                                       st + 2 * DIM * SP, C::LC * RS, g, t);
        }
    };
    // Y^T[c][w'] += sum_w T[w][c] B_r[w'][w], one rank's K tiles
    auto second_product = [&](T (&acc)[2][NT][4]) {
        for (int j = 0; j < NK; ++j) {
            const T* st = next_stage();
            product_tile<T, EXACT, NT>(acc, t_r + j * C::KC * TS + c0,
                                       t_i + j * C::KC * TS + c0, 1, TS,
                                       st + n0 * RS, DIM * RS, g, t);
        }
    };
    // T to shared memory for the second product
    auto park_t = [&]() {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int o = (row0 + g + 8 * h) * TS + nt * 8 + 2 * t;
                *reinterpret_cast<V2*>(t_r + o) =
                    V2{tacc[0][nt][2 * h], tacc[0][nt][2 * h + 1]};
                *reinterpret_cast<V2*>(t_i + o) =
                    V2{tacc[1][nt][2 * h], tacc[1][nt][2 * h + 1]};
            }
    };

    if (!p.apply_b) {
        // A-only: Y = sum_r T_r, rows w = row0 + g (+ 8)
        for (int r = 0; r < p.rank; ++r) first_product(tacc);
        __syncthreads();
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int w = row0 + g + 8 * h;
                const int l = l0 + nt * 8 + 2 * t;
                T r0 = tacc[0][nt][2 * h], r1 = tacc[0][nt][2 * h + 1];
                T i0 = tacc[1][nt][2 * h], i1 = tacc[1][nt][2 * h + 1];
                masked(M, w, l, r0, i0);
                masked(M, w, l + 1, r1, i1);
                const long long d = base + w * wstride + l;
                *reinterpret_cast<V2*>(yr + d) = V2{r0, r1};
                *reinterpret_cast<V2*>(yi + d) = V2{i0, i1};
            }
        return;
    }

    // Rank 0 has code of its own, in which T's accumulator and Y's are
    // never live together; later ranks hold both.
    if (p.apply_a) {
        first_product(tacc);
        park_t();
    }
    T yacc[2][NT][4];
    zero_acc(yacc);
    second_product(yacc);
    for (int r = 1; r < p.rank; ++r) {
        if (p.apply_a) {
            zero_acc(tacc);
            first_product(tacc);
            park_t();
        }
        second_product(yacc);
    }
    // every warp is done with the shared tiles before the next item
    __syncthreads();

    // Y^T tiles: lanes c0 + g (+ 8), rows w' = n0 + nt * 8 + 2t (+ 1)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int l = l0 + c0 + g + 8 * (e >> 1);
            const int w = n0 + nt * 8 + 2 * t + (e & 1);
            T vr = yacc[0][nt][e], vi = yacc[1][nt][e];
            masked(M, w, l, vr, vi);
            const long long d = base + w * wstride + l;
            yr[d] = vr;
            yi[d] = vi;
        }
}

// The item with the products the pass's sides call for (float64 has one
// kind).
template <typename T, typename Rows>
__device__ __forceinline__ void run_item(const T* xr, const T* xi, T* yr,
                                         T* yi, Rows src, long long base,
                                         long long wstride, int l0,
                                         const QtPass& p, T* smem,
                                         uint64_t* bars) {
    if constexpr (sizeof(T) == 8)
        window_item<T, true, Rows>(xr, xi, yr, yi, src, base, wstride, l0,
                                   p, smem, bars);
    else if (p.exact)
        window_item<T, true, Rows>(xr, xi, yr, yi, src, base, wstride, l0,
                                   p, smem, bars);
    else
        window_item<T, false, Rows>(xr, xi, yr, yi, src, base, wstride, l0,
                                    p, smem, bars);
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1)
window_pass_kernel(const T* __restrict__ x, T* __restrict__ y,
                   long long plane, QtPass p) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    __shared__ uint64_t bars[STAGES];
    T* smem = reinterpret_cast<T*>(smem_raw);
    const int chunk = blockIdx.x % nchunk<T>();
    const long long slab = blockIdx.x / nchunk<T>();
    const long long mid = 1LL << (p.k - 7);
    const long long h = slab / mid, m = slab % mid;
    const long long base = (h * DIM * mid + m) * DIM;
    run_item<T>(x, x + plane, y, y + plane, StridedRows{base, mid * DIM},
                base, mid * DIM, chunk * Cfg<T>::LC, p, smem, bars);
}

// K12: one (output slab, lane chunk) item per CTA, the slab's rows
// gathered across the segment swap (SwappedRows); k = 7, so the output
// slab is 128 x 128 consecutive amplitudes of each plane.
template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1)
swap_cluster_kernel(const T* __restrict__ x, T* __restrict__ y,
                    long long plane, QtPass p, int hs, int bs, int mask) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    __shared__ uint64_t bars[STAGES];
    T* smem = reinterpret_cast<T*>(smem_raw);
    const int chunk = blockIdx.x % nchunk<T>();
    const long long slab = blockIdx.x / nchunk<T>();
    run_item<T>(x, x + plane, y, y + plane, SwappedRows{slab, hs, bs, mask},
                slab * DIM * DIM, DIM, chunk * Cfg<T>::LC, p, smem, bars);
}

// A super-block of G canonical rows is G * 128 * 128 consecutive
// amplitudes of each plane, and a pass's slabs lie at the same offsets
// relative to its start wherever it is stored: in the state (planes 2^n
// apart) or in a cluster's scratch buffer (planes G * 128 * 128 apart).
template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1)
megawin_kernel(const T* __restrict__ x, T* out, T* scratch, long long plane,
               long long nsb, QtMegaArgs args) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    __shared__ uint64_t bars[STAGES];
    T* smem = reinterpret_cast<T*>(smem_raw);
    cg::cluster_group cluster = cg::this_cluster();
    const int csize = (int)cluster.num_blocks();
    const int crank = (int)cluster.block_rank();
    const long long ncl = gridDim.x / csize;
    const long long cid = blockIdx.x / csize;
    const int G = args.g_rows;
    const int items = G * nchunk<T>();
    const long long sbe = (long long)G * DIM * DIM;
    // this cluster's scratch buffer: both planes of one super-block
    T* const buf = scratch + cid * 2 * sbe;
    for (long long sb = cid; sb < nsb; sb += ncl) {
        const T* sr = x + sb * sbe;
        const T* si = sr + plane;
        for (int pi = 0; pi < args.npass; ++pi) {
            // passes alternate between the super-block's place in `out`
            // and the scratch buffer, so that the last lands in `out`
            const bool to_out = (args.npass - 1 - pi) % 2 == 0;
            T* dr = to_out ? out + sb * sbe : buf;
            T* di = dr + (to_out ? plane : sbe);
            const QtPass& p = args.p[pi];
            const long long mid = 1LL << (p.k - 7);
            for (int it = crank; it < items; it += csize) {
                const int chunk = it % nchunk<T>();
                const long long j = it / nchunk<T>();
                const long long base =
                    ((j / mid) * DIM * mid + j % mid) * DIM;
                run_item<T>(sr, si, dr, di, StridedRows{base, mid * DIM},
                            base, mid * DIM, chunk * Cfg<T>::LC, p, smem,
                            bars);
            }
            // the pass is visible to the whole cluster before the next one
            // reads it (with the copy engine, whose reads go through the
            // async proxy), and before the next super-block's first pass
            // overwrites a buffer this pass may have read
            asm volatile("fence.proxy.async.global;\n" ::: "memory");
            __threadfence();
            cluster.sync();
            asm volatile("fence.proxy.async.global;\n" ::: "memory");
            sr = dr;
            si = di;
        }
    }
}

// The bulk copies move 16-byte multiples from 16-byte boundaries: every
// operand must start on 16 bytes.
static bool aligned16(const void* p) {
    return ((uintptr_t)p & 15) == 0;
}

static bool pass_ok(const QtPass& p, int n) {
    if (p.k < 7 || p.k > n - 7 || p.rank < 1) return false;
    if (p.apply_a && (p.a == nullptr || !aligned16(p.a))) return false;
    if (p.apply_b && (p.b == nullptr || !aligned16(p.b))) return false;
    return true;
}

template <typename T>
static int launch_window_pass(const T* x, T* y, int n, const QtPass* pass,
                              void* stream) {
    if (pass == nullptr || n < 14 || !pass_ok(*pass, n) || !aligned16(x) ||
        !aligned16(y))
        return (int)cudaErrorInvalidValue;
    const size_t smem = smem_bytes<T>();
    cudaError_t err = cudaFuncSetAttribute(
        window_pass_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const long long plane = 1LL << n;
    const long long nslab = 1LL << (n - 14);
    window_pass_kernel<T><<<(unsigned)(nslab * nchunk<T>()), NTHREADS, smem,
                            (cudaStream_t)stream>>>(x, y, plane, *pass);
    return (int)cudaGetLastError();
}

// K12: the segment swap [h, h+m) <-> [bq, bq+m), then K11's operator.
template <typename T>
static int launch_swap_cluster(const T* x, T* y, int n, int rank,
                               const T* a, const T* b, int exact, int h,
                               int bq, int m, void* stream) {
    const QtPass pass{7, rank, 1, 1, exact, a, b, nullptr};
    if (n < 14 || !pass_ok(pass, n) || m < 1 || h < 14 || h + m > n ||
        bq < 7 || bq + m > 14 || !aligned16(x) || !aligned16(y))
        return (int)cudaErrorInvalidValue;
    const size_t smem = smem_bytes<T>();
    cudaError_t err = cudaFuncSetAttribute(
        swap_cluster_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const long long plane = 1LL << n;
    const long long nslab = 1LL << (n - 14);
    swap_cluster_kernel<T><<<(unsigned)(nslab * nchunk<T>()), NTHREADS, smem,
                             (cudaStream_t)stream>>>(
        x, y, plane, pass, h - 14, bq - 7, (1 << m) - 1);
    return (int)cudaGetLastError();
}

// CTAs per cluster for super-blocks of g rows (g * nchunk items).
template <typename T>
static int cluster_size(long long g) {
    const long long items = g * nchunk<T>();
    return (int)(items < 8 ? items : 8);
}

template <typename T>
static void megawin_config(long long g, long long nclusters,
                           cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr, void* stream) {
    const int csize = cluster_size<T>(g);
    *cfg = {};
    cfg->gridDim = dim3((unsigned)(nclusters * csize), 1, 1);
    cfg->blockDim = dim3(NTHREADS, 1, 1);
    cfg->dynamicSmemBytes = smem_bytes<T>();
    cfg->stream = (cudaStream_t)stream;
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = (unsigned)csize;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg->attrs = attr;
    cfg->numAttrs = 1;
}

// How many K2 clusters for super-blocks of g rows the card holds at once.
template <typename T>
static int megawin_max_clusters(int g, int* clusters) {
    if (clusters == nullptr || g < 1) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        megawin_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<T>());
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    megawin_config<T>(g, 1, &cfg, attr, nullptr);
    return (int)cudaOccupancyMaxActiveClusters(clusters, megawin_kernel<T>,
                                               &cfg);
}

// `scratch` holds 2 * G * 128 * 128 elements per cluster (both planes of
// one super-block); groups of one pass need none.
template <typename T>
static int launch_megawin(const T* x, T* out, T* scratch, int nclusters,
                          int n, const QtPass* passes, int npass,
                          void* stream) {
    if (passes == nullptr || n < 14 || npass < 1 ||
        npass > MAX_MEGA_PASSES || nclusters < 1 ||
        (npass > 1 && (scratch == nullptr || !aligned16(scratch))) ||
        !aligned16(x) || !aligned16(out))
        return (int)cudaErrorInvalidValue;
    QtMegaArgs args;
    args.npass = npass;
    int kmax = 7;
    for (int i = 0; i < npass; ++i) {
        const QtPass& p = passes[i];
        if (!pass_ok(p, n)) return (int)cudaErrorInvalidValue;
        kmax = p.k > kmax ? p.k : kmax;
        args.p[i] = p;
    }
    const long long nb = 1LL << (n - 14);
    const long long g = 1LL << (kmax - 7);
    if (g > nb || nclusters > nb / g) return (int)cudaErrorInvalidValue;
    args.g_rows = (int)g;
    cudaError_t err = cudaFuncSetAttribute(
        megawin_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<T>());
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    megawin_config<T>(g, nclusters, &cfg, attr, stream);
    const long long plane = 1LL << n;
    err = cudaLaunchKernelEx(&cfg, megawin_kernel<T>, x, out, scratch, plane,
                             nb / g, args);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

extern "C" {

int qt_max_mega_passes() { return MAX_MEGA_PASSES; }

int qt_window_pass_f32(const float* x, float* y, int n, const QtPass* pass,
                       void* stream) {
    return launch_window_pass<float>(x, y, n, pass, stream);
}

int qt_window_pass_f64(const double* x, double* y, int n,
                       const QtPass* pass, void* stream) {
    return launch_window_pass<double>(x, y, n, pass, stream);
}

int qt_megawin_max_clusters_f32(int g, int* clusters) {
    return megawin_max_clusters<float>(g, clusters);
}

int qt_megawin_max_clusters_f64(int g, int* clusters) {
    return megawin_max_clusters<double>(g, clusters);
}

int qt_megawin_f32(const float* x, float* out, float* scratch, int nclusters,
                   int n, const QtPass* passes, int npass, void* stream) {
    return launch_megawin<float>(x, out, scratch, nclusters, n, passes,
                                 npass, stream);
}

int qt_megawin_f64(const double* x, double* out, double* scratch,
                   int nclusters, int n, const QtPass* passes, int npass,
                   void* stream) {
    return launch_megawin<double>(x, out, scratch, nclusters, n, passes,
                                  npass, stream);
}

int qt_swap_cluster_stack_f32(const float* x, float* y, int n, int rank,
                              const float* a, const float* b, int exact,
                              int h, int bq, int m, void* stream) {
    return launch_swap_cluster<float>(x, y, n, rank, a, b, exact, h, bq, m,
                                      stream);
}

int qt_swap_cluster_stack_f64(const double* x, double* y, int n, int rank,
                              const double* a, const double* b, int exact,
                              int h, int bq, int m, void* stream) {
    return launch_swap_cluster<double>(x, y, n, rank, a, b, exact, h, bq, m,
                                       stream);
}

const char* qt_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
