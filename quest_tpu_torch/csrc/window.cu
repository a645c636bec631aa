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
// operations.  Under "bf16_3x" three bf16 products at 989 TFLOP/s take
// 0.42 ms (operations); under "default" one TF32 product 0.28 ms, so the
// bytes bound it (0.32 ms).  Float64 runs on the FP64 tensor cores (DMMA,
// 67 TFLOP/s): 2.05 ms.  A mask-only pass does no products and is bound
// by bytes.
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
// * float32: wgmma with FP32 accumulation, A from registers, B from
//   shared memory through a matrix descriptor; how each real product
//   splits into tensor-core products is the pass's QtPass::split, which
//   the user's precision mode chooses (ops/fused.py set_matmul_precision;
//   the reference's _PRECISIONS and _kdot, quest_tpu/ops/fused.py:65-119):
//   - "highest", m64n64k8 TF32: the state operand is split with
//     cvt.rna.tf32.f32 into x = x_h + x_m + x_l (exact: x has 24
//     significant bits, x_h and x_m 11 each, x_l at most 2), a side
//     matrix into m = m_h + m_l (on the host side, once per tensor:
//     ops/fused.py tf32_side_split).  Where every entry of the pass's
//     sides is a TF32 value (m_l = 0: the 0/1 permutations of the QFT's
//     bit reversal, the identity, sides of +-1 and +-i), decided on the
//     host (SPLIT_EXACT), a real product is x_l m + x_m m + x_h m: each
//     term exact, so a permutation pass equals its plain version bit for
//     bit.  Otherwise (SPLIT_TF32X3) it is the 3xTF32 product x_h m_l +
//     x_m m_h + x_h m_h, about 2^-22 relative per product.
//   - "default" (SPLIT_TF32), m64n64k8 TF32: one product tf32(x) tf32(m),
//     the side rounded on the host, about 2^-11 relative (JAX's
//     Precision.DEFAULT on an NVIDIA card).
//   - "bf16_3x" (SPLIT_BF16X3), m64n64k16 bf16: the reference's three
//     products x_h m_h + x_h m_l + x_l m_h, x_h = bf16(x) and x_l =
//     bf16(x - x_h) rounded to nearest even (cvt.rn.bf16x2.f32, in
//     registers, packed in wgmma's bf16 A fragment), the side's bf16
//     parts (re_h, im_h, re_l, im_l) from the host in the K-major bf16
//     layout (8 rows of 8 values a core matrix, half a TF32 tile's
//     bytes), about 2^-16 relative.
//   In every mode the intermediate T = X A^T stays float32 and is split
//   again for the second product, as the reference's two _kdot calls do.
//   The tensor cores round each accumulation toward zero: each k step
//   (8 deep, or 16 in bf16) starts from zero, small terms first, and is
//   added to the running sum in FP32 (one chain over all of K shrank the
//   norm measurably).
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
// inside K2 a pass reads what other CTAs wrote in the previous pass, so
// the writers fence the async proxy before they publish their items.
// Shared memory per CTA: 208 KB (f32) or 172 KB (f64), one CTA per SM.
// The ring's mbarriers are initialised once per CTA and their phases run
// on across the items a CTA takes (the `ring` position of window_item).
//
// Out of place.  The CTAs of a slab all read the whole slab, so no CTA
// may overwrite it: both kernels write to a separate output buffer and the
// executor ping-pongs buffers (at 26 qubits f32 the second buffer is
// 512 MB).
//
// K2 is a persistent grid of one CTA per SM (the card's SMs times the
// CTAs an SM holds: 132 at 208 KB) with no clusters and no barrier
// between CTAs.  Its work is a stream of tickets taken in order from one
// global atomic counter; a ticket is two consecutive items (the two lane
// chunks of a slab at float32) of one super-block's pass, and the
// super-blocks are cut into windows of W, within which the tickets run
// pass-major.  Before a ticket of pass p > 0 issues its copies, its
// inputs must be complete: thread 0 reads the super-block's done-counter
// (every item of pass p - 1) with acquire semantics, __nanosleep backoff
// while it waits.  A ticket's stores are published by a fence of the
// async proxy (the next pass's copies read through it) and a release-add
// of its two items to that counter, half way through the CTA's next
// ticket, when they have drained.  A ticket waits only on lower tickets,
// which CTAs that run hold, so the schedule cannot deadlock however many
// CTAs are resident.  The first pass reads the state; from there the
// passes alternate between the super-block's place in the output buffer
// and a scratch slot, so that the last lands in the output.  The
// S = 2W slots form a ring: super-block sb takes slot sb % S, and the
// pass that first writes it waits until every item of sb - S, its
// previous occupant (a lower window), is done.  The host picks W so that
// a pass of a window holds four items for each CTA (G = 8 f32: 33
// super-blocks, 528 items; G = 1: 264, 528): with two, a ticket's inputs
// were often not yet published when a CTA took it, since a ticket is
// published only half way through its CTA's next one.  The slots take
// 66 MB at f32 (ops/fused.py megawin_schedule), so the intermediates
// partly leave L2, which the products do not wait for.
//
// Around the item, K2 differs from K1 in its copies, not its products:
// * X tiles come in TMA tensor copies (one per plane and tile, thread 0
//   alone arriving on the mbarrier), written in 128-byte swizzled rows
//   (SwizzledLay): K1's 256 single-row bulk copies of a tile hold its CTA
//   while they are issued (scripts/k2_segments.py: K1's X-tile steps take
//   about 1 us longer than its side-only steps on an H100).
// * The next item's tile 0 (and a B-only pass's T tile) is issued before
//   the current item's stores, once its inputs are known to be complete
//   (a second item of a ticket always; a new ticket when thread 0's poll,
//   relaxed reads a tile ahead and a fence, finds them done), so an item
//   starts with its first tile in shared memory.
// * At float32 a pass's mask is staged in shared memory during the last
//   K tile (stage_mask), in place of the epilogue's 4-byte mask loads
//   (scripts/k2_segments.py: a masked item's stores).
// What bounds K2 is what bounds K1: the tensor cores' products; the
// schedule removes the per-pass barriers, the idle SMs of cluster
// placement, each item's cold start and its copies' issue.
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

// Register banks.  A BatchedQureg drain (ops/fused.py
// apply_window_stack, apply_window_megastack on a (B, 2, 2^n) bank) runs
// a pass, or a megawin group, over a bank of B registers, a contiguous
// (B, 2, 2^n) array, in ONE launch: the reference runs its Pallas
// kernels under jax.vmap (quest_tpu/fusion.py _plan_runner, batch flags
// 1 and 2), whose batching rule prepends a grid axis; here the element
// index is folded into the grid, and one register is a bank of one.
// K1 (and K11, the same kernel at k = 7) and K12 take a register's
// (slab, chunk) items on blockIdx.x and the element on blockIdx.y (the
// reference's prepended grid axis); K2 numbers element b's
// super-blocks b * SB + s, so that its ticket decode, done-counters and
// slot ring run unchanged over B * SB super-blocks, and mega_operands
// offsets the state and output by the element (its X-tile tensor maps
// span the bank).  Where the elements carry their own sides and masks
// (flag 2: a randomized-compiling bank, trajectories) each pass has one
// QtPass per element in device memory (`elems`), which the CTA stages in
// shared memory with the item: its own side images, mask and split (the
// TF32 split is decided per element, so an element of exact sides takes
// SPLIT_EXACT beside one of inexact sides taking SPLIT_TF32X3 in the same
// launch, each with the bits of its own scalar launch).  That staging is
// the kernels' OWN instantiation; one register, and a bank of shared
// passes, run the other, which reads the pass where a register's launch
// always did (K1's parameter, K2's QtMegaArgs), so that the registers'
// code keeps its registers and spills.  The items run window_item
// unchanged, so every element is bit-identical to its scalar launch; the
// bound is the scalar pass's times B.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// How a float32 pass's real products split into tensor-core products
// (QtPass::split; ops/fused.py SPLIT_*, chosen by the precision mode):
// "highest" takes SPLIT_TF32X3, or SPLIT_EXACT where every side entry is
// a TF32 value; "default" SPLIT_TF32; "bf16_3x" SPLIT_BF16X3.  Float64
// runs one DMMA product in every mode.
enum : int {
    SPLIT_TF32X3 = 0,   // x_h m_l + x_m m_h + x_h m_h, TF32 parts
    SPLIT_EXACT = 1,    // x_l m + x_m m + x_h m, m a TF32 value
    SPLIT_TF32 = 2,     // tf32(x) tf32(m)
    SPLIT_BF16X3 = 3,   // x_h m_l + x_l m_h + x_h m_h, bf16 parts
};

// Elements (of T) a side tile takes per row: float32 side tiles are
// K-major tiles for wgmma, unpadded (rows in 8-row core matrices of
// 16-byte rows: 4 TF32 values, or 8 bf16 values in half the bytes);
// float64 ones padded rows for the DMMA fragment loads.  side_rs is the
// most any split takes.
template <typename T>
__host__ __device__ constexpr int side_rs() {
    return sizeof(T) == 4 ? Cfg<T>::KC : Cfg<T>::SP;
}
template <typename T>
__host__ __device__ constexpr int side_row(int split) {
    return sizeof(T) == 4 && split == SPLIT_BF16X3 ? Cfg<T>::KC / 2
                                                   : side_rs<T>();
}

// Planes of a side matrix: (re, im), and at float32 the low parts (re_l,
// im_l) of a split that multiplies them (side images, ops/fused.py
// _side_planes).
template <typename T>
__host__ __device__ constexpr int side_planes(int split) {
    return sizeof(T) == 4 &&
                   (split == SPLIT_TF32X3 || split == SPLIT_BF16X3)
               ? 4
               : 2;
}
template <typename T>
__host__ __device__ constexpr int max_planes() {
    return sizeof(T) == 4 ? 4 : 2;
}

// The splits a kernel is compiled for, one family per precision mode:
// "highest" (SPLIT_EXACT or SPLIT_TF32X3, chosen pass by pass), or one
// lower mode's split.  Each family is its own instantiation of K1, K2
// and K12, so that the item bodies of the modes a launch cannot run take
// no registers or code in it (K2 with all four bodies ran 20 % slower
// on the "highest" bench groups).
enum : int { FAMILY_HIGHEST = 0, FAMILY_TF32 = 1, FAMILY_BF16 = 2 };
__host__ __device__ constexpr int split_family(int split) {
    return split == SPLIT_TF32     ? FAMILY_TF32
           : split == SPLIT_BF16X3 ? FAMILY_BF16
                                   : FAMILY_HIGHEST;
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
// 128 rows as shared memory holds them: the planes (re, im) at float64,
// under SPLIT_EXACT and (rounded to TF32) under SPLIT_TF32, and (re_h,
// im_h, re_l, im_l), the split parts of each entry (TF32 values, or bf16
// values under SPLIT_BF16X3), otherwise.
struct QtPass {
    int k;          // window offset
    int rank;       // number of Kronecker terms R
    int apply_a;    // lane side present
    int apply_b;    // window side present
    int split;      // SPLIT_*: how a float32 product splits
    const void* a;  // lane matrices
    const void* b;  // window matrices
    const void* mask;  // (2, 128, 128) SoA (window, lane) mask, or null
};

// A megawin group as K2 runs it (built by launch_megawin).
struct QtMegaArgs {
    int npass;
    int g_rows;     // G: canonical rows per super-block
    int ipp;        // items per pass of a super-block: G * nchunk
    int window;     // W: super-blocks per window of tickets
    int slots;      // S >= W scratch slots of one super-block each
    int nsb;        // super-blocks, over the whole bank
    int nsb_elem;   // super-blocks of one register (nsb / B)
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
// terms first and the large one last; BF16: the parts are bf16 values
// and a k step is 16 deep (wgmma k16), else TF32 values, 8 deep.
template <typename T, int SPLIT> struct Split;
template <> struct Split<float, SPLIT_EXACT> {     // x_l m + x_m m + x_h m
    static constexpr int NS = 3, NM = 1, NP = 3;
    static constexpr bool BF16 = false;
    __host__ __device__ static constexpr int si(int q) { return 2 - q; }
    __host__ __device__ static constexpr int mj(int) { return 0; }
};
// x_h m_l + x_m m_h + x_h m_h
template <> struct Split<float, SPLIT_TF32X3> {
    static constexpr int NS = 2, NM = 2, NP = 3;
    static constexpr bool BF16 = false;
    __host__ __device__ static constexpr int si(int q) {
        return q == 1 ? 1 : 0;
    }
    __host__ __device__ static constexpr int mj(int q) {
        return q == 0 ? 1 : 0;
    }
};
template <> struct Split<float, SPLIT_TF32> {      // tf32(x) tf32(m)
    static constexpr int NS = 1, NM = 1, NP = 1;
    static constexpr bool BF16 = false;
    __host__ __device__ static constexpr int si(int) { return 0; }
    __host__ __device__ static constexpr int mj(int) { return 0; }
};
// The reference's "bf16_3x" (quest_tpu/ops/fused.py _kdot): x_h m_l +
// x_l m_h + x_h m_h, x_h = bf16(x), x_l = bf16(x - x_h) rounded to
// nearest even, the x_l m_l term dropped.
template <> struct Split<float, SPLIT_BF16X3> {
    static constexpr int NS = 2, NM = 2, NP = 3;
    static constexpr bool BF16 = true;
    __host__ __device__ static constexpr int si(int q) {
        return q == 1 ? 1 : 0;
    }
    __host__ __device__ static constexpr int mj(int q) {
        return q == 0 ? 1 : 0;
    }
};
template <int S> struct Split<double, S> {         // one DMMA
    static constexpr int NS = 1, NM = 1, NP = 1;
    static constexpr bool BF16 = false;
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
    static_assert(N >= 1 && N <= 3, "a float32 state splits in 1 to 3");
    p[0] = tf32_rna(x);
    if constexpr (N > 1) {
        const float r1 = x - __uint_as_float(p[0]);
        p[1] = tf32_rna(r1);
        if constexpr (N == 3)
            p[2] = __float_as_uint(r1 - __uint_as_float(p[1]));
    }
}

// cvt.rn.bf16x2.f32: two float32 values rounded to the nearest bf16, ties
// to even (JAX's and PyTorch's cast; cvt.rna would round ties away),
// packed with `lo` in the low half: the order of a k pair in wgmma's
// bf16 A fragment.
__device__ __forceinline__ uint32_t bf16x2_rn(float lo, float hi) {
    uint32_t r;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
    return r;
}

// A k pair (x0, x1) of the state as its bf16 parts: h = bf16(x) and l =
// bf16(x - h), each a packed pair (ops/fused.py bf16_split).
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& h,
                                           uint32_t& l) {
    h = bf16x2_rn(x0, x1);
    const float h0 = __uint_as_float(h << 16);
    const float h1 = __uint_as_float(h & 0xffff0000u);
    l = bf16x2_rn(x0 - h0, x1 - h1);
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
// The same product with bf16 operands, 16 deep (m64n64k16): a (64 x 16)
// from registers as packed bf16 pairs (warp w's rows [16w, 16w + 16) as
// mma.m16n8k16 holds its A fragment: register i holds row g + 8 (i & 1),
// columns 2t + 8 (i >> 1) and the next), b (64 x 16) a K-major bf16 tile
// (imm-trans-b = 0).
template <int SCALE_A>
__device__ __forceinline__ void wgmma_bf16(float (&d)[8][4],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, %38, 1, 0;\n}\n"
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

// The matrix descriptor of a K-major TF32 or bf16 tile in shared memory
// without swizzle: 8-row core matrices of 16-byte rows (4 TF32 or 8 bf16
// values) stored as 128 contiguous bytes, the two 16-byte K chunks of a
// k step (8 TF32 or 16 bf16 deep) LBO = 128 bytes apart, 8-row groups SBO
// bytes apart.
__device__ __forceinline__ uint64_t kmajor_desc(const void* p, uint32_t sbo) {
    const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
    return (uint64_t)((a >> 4) & 0x3fff) | ((uint64_t)(128 >> 4) << 16) |
           ((uint64_t)((sbo >> 4) & 0x3fff) << 32);
}

// Where a state operand's element (row m, column kk) lies in shared
// memory, from the operand's first row: at a row and a column stride (the
// padded rows of K1's X tiles and of T), or in the 128-byte-swizzled rows
// that a TMA tensor copy writes (K2's X tiles: 16-byte chunk c of row m
// at chunk c ^ (m % 8); the operand's first row is a multiple of 8 from a
// 1024-byte boundary).
struct StridedLay {
    int sm, sk;
    __device__ __forceinline__ int operator()(int m, int kk) const {
        return m * sm + kk * sk;
    }
};
template <typename T>
struct SwizzledLay {
    __device__ __forceinline__ int operator()(int m, int kk) const {
        constexpr int row = 128 / sizeof(T);
        return m * row + (int)(((kk * sizeof(T)) ^ ((m & 7) << 4)) /
                               sizeof(T));
    }
};

// The state's A fragment (rows g, g + 8; columns t, t + 4 at KS = 8) at
// k step ks, split: element (m, kk) at s_re/s_im[lay(m, kk)].
template <typename T, int NS, typename Lay>
__device__ __forceinline__ void load_state(
        const T* s_re, const T* s_im, Lay lay, int ks, int g, int t,
        typename Frag<T>::reg (&sre)[NS][Frag<T>::AR],
        typename Frag<T>::reg (&sim)[NS][Frag<T>::AR]) {
    using reg = typename Frag<T>::reg;
#pragma unroll
    for (int i = 0; i < Frag<T>::AR; ++i) {
        const int o = lay(g + 8 * (i & 1), ks + t + 4 * (i >> 1));
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

// The state's bf16 A fragment at k step ks (16 deep), split: register i
// of part q holds rows g + 8 (i & 1), columns ks + 2t + 8 (i >> 1) and the
// next (wgmma_bf16), element (m, kk) at s_re/s_im[lay(m, kk)].
template <typename Lay>
__device__ __forceinline__ void load_state_bf16(
        const float* s_re, const float* s_im, Lay lay, int ks, int g, int t,
        uint32_t (&sre)[2][4], uint32_t (&sim)[2][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int m = g + 8 * (i & 1), kk = ks + 2 * t + 8 * (i >> 1);
        const int o0 = lay(m, kk), o1 = lay(m, kk + 1);
        split_bf16(s_re[o0], s_re[o1], sre[0][i], sre[1][i]);
        split_bf16(s_im[o0], s_im[o1], sim[0][i], sim[1][i]);
    }
}

// acc[c][nt] (c = re, im; 16 x 8 tiles nt) += S M^T over one K tile,
// complex.  S (16 rows of the warp x KC) is the state operand, its element
// (m, kk) at s_re/s_im[lay(m, kk)]; M (NT * 8 rows x KC) the side in
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
template <typename T, int SPLIT, int NT, typename Lay>
__device__ __forceinline__ void product_tile(
        T (&acc)[2][NT][4], const T* s_re, const T* s_im, Lay lay,
        const T* side, int pstride, int g, int t) {
    using C = Cfg<T>;
    using S = Split<T, SPLIT>;
    using F = Frag<T>;
    using reg = typename F::reg;
    if constexpr (sizeof(T) == 4) {
        static_assert(NT == 8, "wgmma m64n64: 8 tiles of 8 columns");
        // a side value's bytes, a k step's depth, 16-byte K chunks a row
        constexpr int VB = S::BF16 ? 2 : 4, KS = S::BF16 ? 16 : C::KS;
        constexpr uint32_t SBO = (C::KC * VB / 16) * 128;
        const uint64_t d0 = kmajor_desc(side, SBO);
        const uint64_t plane = (uint64_t)(pstride * 4) >> 4;
        T cre[NT][4], cim[NT][4];
        zero_tiles(cre);
        zero_tiles(cim);
        // one k step at a time: its A registers and accumulators are in
        // flight until the wait
#pragma unroll 1
        for (int ks = 0; ks < C::KC; ks += KS) {
            reg sre[S::NS][F::AR], sim[S::NS][F::AR];
            if constexpr (S::BF16)
                load_state_bf16(s_re, s_im, lay, ks, g, t, sre, sim);
            else
                load_state<T, S::NS>(s_re, s_im, lay, ks, g, t, sre, sim);
            // the step's two 16-byte K chunks start ks * VB / 16 chunks in
            const uint64_t dk = (uint64_t)((ks * VB / 16) * 128 >> 4);
            wgmma_fence();
#pragma unroll
            for (int q = 0; q < S::NP; ++q) {
                const int a = S::si(q), b = S::mj(q);
                const uint64_t dre = d0 + dk + 2 * b * plane;
                const uint64_t dim = dre + plane;
                // re += S_re M_re^T - S_im M_im^T; im += S_re M_im^T +
                // S_im M_re^T
                if constexpr (S::BF16) {
                    wgmma_bf16<1>(cre, sre[a], dre, q > 0);
                    wgmma_bf16<-1>(cre, sim[a], dim, 1);
                    wgmma_bf16<1>(cim, sre[a], dim, q > 0);
                    wgmma_bf16<1>(cim, sim[a], dre, 1);
                } else {
                    wgmma_tf32<1>(cre, sre[a], dre, q > 0);
                    wgmma_tf32<-1>(cre, sim[a], dim, 1);
                    wgmma_tf32<1>(cim, sre[a], dim, q > 0);
                    wgmma_tf32<1>(cim, sim[a], dre, 1);
                }
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
            load_state<T, S::NS>(s_re, s_im, lay, ks, g, t, sre, sim);
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
// One TMA tensor copy of a box of the 4-d tensor that `map` describes,
// at coordinates (c0, c1, c2, c3), counted on the mbarrier `bar`.
__device__ __forceinline__ void tensor_copy(void* dst, const void* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
            smem_addr(dst)),
        "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_addr(bar))
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

// Where an item reads and writes (window_item): row w of its slab at
// offset src(w) (lane stride 1) of the real and imaginary planes `xr`,
// `xi`; output lanes [l0, l0 + LC) of every row w at offset
// base + w * wstride of the planes `yr`, `yi`.  K1, K11 and K12 hold it in
// registers, derived from their parameters; K2 in shared memory, so that
// the item reads each field where it uses it and its persistent loop
// costs the item no registers.
//
// K2 copies its X tiles with TMA tensor copies instead: `map` is the
// tensor map of the buffer the item reads (a 4-d view (lane, m, row w,
// q) of 128-lane rows, ops: launch_megawin), its slab at coordinates
// (., tm_m, 0, tm_q) and, for the imaginary plane, q + tm_qp.
template <typename T, typename Rows>
struct ItemArgs {
    const T* xr;
    const T* xi;
    T* yr;
    T* yi;
    Rows src;
    long long base, wstride;
    int l0;
    const void* map;
    int tm_m, tm_q, tm_qp;
};

// Issues tile `local` of an item's K-tile stream (per rank, X and A_r
// tiles, then B_r tiles) into ring position `pos`, in copies counted on
// the stage's mbarrier; threads 0 .. npl-1 copy a side plane's block of
// the side image, which holds each K tile of each plane as shared memory
// holds it (npl = side_planes planes of 128 rows of rs = side_row
// elements: compile-time constants in window_item, read from the pass
// where K2 issues its next item's first tile).  K1, K11, K12: every thread
// arrives, announcing its bytes (`extra` adds a copy of its own: the
// B-only pass's T row, with tile 0), and thread i copies row i % 128 of
// X's plane i / 128 (KC elements) in one bulk copy.  K2 (TMA): thread 0
// alone arrives, announcing every byte of the tile (`extra`: all of T),
// and copies X's two planes in one tensor copy each, into 128-byte rows
// that the copy swizzles (SwizzledLay).
template <typename T, bool TMA, typename Rows>
__device__ __forceinline__ void issue_tile(T* smem, uint64_t* bars, int pos,
                                           int local,
                                           const ItemArgs<T, Rows>& ia,
                                           const QtPass& p, int npl, int rs,
                                           uint32_t extra) {
    using C = Cfg<T>;
    constexpr int NK = DIM / C::KC;
    const int na = p.apply_a ? NK : 0;
    const int per = na + (p.apply_b ? NK : 0);
    const int tid = threadIdx.x;
    T* st = smem + (pos % STAGES) * stage_elems<T>();
    uint64_t* bar = &bars[pos % STAGES];
    const int r = local / per, j = local % per;
    const long long img = (long long)DIM * rs;  // one block
    uint32_t bytes = extra;
    if (j < na) {
        const int k0 = j * C::KC;
        const uint32_t side = C::LC * rs * sizeof(T);
        if constexpr (TMA) {
            bytes += 2 * DIM * C::KC * sizeof(T) + npl * side;
            if (tid == 0) {
                bar_arrive(bar, bytes);
                tensor_copy(st, ia.map, k0, ia.tm_m, 0, ia.tm_q, bar);
                tensor_copy(st + DIM * C::KC, ia.map, k0, ia.tm_m, 0,
                            ia.tm_q + ia.tm_qp, bar);
            }
        } else {
            const int plane = tid / DIM, w = tid % DIM;
            bytes += C::KC * sizeof(T);
            if (tid < npl) bytes += side;
            bar_arrive(bar, bytes);
            bulk_copy(st + (plane * DIM + w) * C::SP,
                      (plane ? ia.xi : ia.xr) + ia.src(w) + k0,
                      C::KC * sizeof(T), bar);
        }
        if (tid < npl)
            bulk_copy(st + 2 * DIM * C::SP + tid * C::LC * rs,
                      static_cast<const T*>(p.a) +
                          ((long long)(r * npl + tid) * NK + j) * img +
                          (long long)ia.l0 * rs,
                      side, bar);
    } else {
        const uint32_t side = DIM * rs * sizeof(T);
        if constexpr (TMA) {
            if (tid == 0) bar_arrive(bar, bytes + npl * side);
        } else {
            if (tid < npl) bytes += side;
            bar_arrive(bar, bytes);
        }
        if (tid < npl)
            bulk_copy(st + tid * DIM * rs,
                      static_cast<const T*>(p.b) +
                          ((long long)(r * npl + tid) * NK + (j - na)) * img,
                      side, bar);
    }
}

// The bytes an item's tile 0 adds for the B-only pass's T tile: each
// thread's own row, or (TMA) all of them, which thread 0 announces.
template <typename T, bool TMA>
__device__ __forceinline__ uint32_t t_tile_bytes(const QtPass& p) {
    if (p.apply_a) return 0;
    return (TMA ? NTHREADS : 1) * Cfg<T>::LC * sizeof(T);
}

// The B-only pass's T tile, the slab's own lane chunk: thread i copies
// row i % 128 of plane i / 128 (LC elements) with tile 0, on its stage's
// mbarrier (whose arrivals announce these bytes, issue_tile).
template <typename T, typename Rows>
__device__ __forceinline__ void copy_t_tile(T* smem, uint64_t* bar,
                                            const ItemArgs<T, Rows>& ia) {
    const int plane = threadIdx.x / DIM, w = threadIdx.x % DIM;
    T* t_r = smem + STAGES * stage_elems<T>();
    bulk_copy(t_r + (plane * DIM + w) * Cfg<T>::TS,
              (plane ? ia.xi : ia.xr) + ia.src(w) + ia.l0,
              Cfg<T>::LC * sizeof(T), bar);
}

// An item's hooks for the items around it: K1, K11 and K12 run one item
// per CTA and have none (K2: MegaNext).
struct NoNext {
    static constexpr bool enabled = false;
    __device__ void settle() {}
    __device__ void publish() {}
    __device__ void prepoll() {}
    __device__ void poll() {}
    template <typename T>
    __device__ void issue(T*, uint64_t*, int) {}
};

template <typename T, int NT>
__device__ __forceinline__ void zero_acc(T (&acc)[2][NT][4]) {
    zero_tiles(acc[0]);
    zero_tiles(acc[1]);
}

// (vr, vi) times the mask's factor (mr, mi).
template <typename T>
__device__ __forceinline__ void masked4(T& vr, T& vi, T mr, T mi) {
    const T nr = fma_t(vr, mr, -(vi * mi));
    const T ni = fma_t(vr, mi, vi * mr);
    vr = nr;
    vi = ni;
}

// The mask's factor on (vr, vi) at (w, l), where there is a mask.
template <typename T>
__device__ __forceinline__ void masked(const T* M, int w, int l, T& vr,
                                       T& vi) {
    if (M == nullptr) return;
    const long long mat = (long long)DIM * DIM;
    masked4(vr, vi, M[w * DIM + l], M[mat + w * DIM + l]);
}

// K2's float32 mask staging.  The epilogue's mask loads, four bytes
// apiece from L2 (the poll's acquisition empties L1 every ticket), held
// up a masked item's stores; staged, each thread copies 16 pieces of 16
// bytes (cp.async) while the last K tile's products run, into
// the stage that tile frees, as rows [plane][w][MASK_PITCH] of the item's
// LC lanes (pitch 68: the epilogue's reads hit 32 banks).  That stage's
// mbarrier takes an arrival without bytes for the ring position the mask
// holds, so that the ring's phases run on.
constexpr int MASK_PITCH = 68;

template <typename T>
__device__ __forceinline__ void stage_mask(T* dst, const T* M, int l0) {
    static_assert(sizeof(T) == 4, "a float32 mask chunk fills a stage");
    constexpr int LC = Cfg<T>::LC, PIECES = LC / 4;    // 16 bytes each
    static_assert(2 * DIM * MASK_PITCH <= stage_elems<T>(), "mask fits");
#pragma unroll
    for (int k = 0; k < 2 * DIM * PIECES / NTHREADS; ++k) {
        const int q = threadIdx.x + k * NTHREADS;
        const int row = q / PIECES, c = (q % PIECES) * 4;   // row: plane, w
        asm volatile(
            "cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                smem_addr(dst + row * MASK_PITCH + c)),
            "l"(M + (long long)row * DIM + l0 + c)
            : "memory");
    }
}

// One (slab, lane chunk) item of one window pass, where `ia` says.  The state is read through
// L2 only (the copy engine, __ldcg), never the non-coherent L1 path:
// inside K2 a pass reads what other CTAs wrote in the previous pass.
//
// The K-tile stream runs on the CTA's ring from position `ring` (the
// mbarriers are initialised by the kernel, once); where `primed`, the
// previous item already issued tile 0.  `next` (K2) hooks into the
// stream: half way through it publishes the CTA's previous item (whose
// stores have drained by then), at the last two tiles thread 0 polls the
// inputs of the CTA's next ticket, and once
// every warp is done with the shared tiles, before this item's stores,
// it may issue that ticket's tile 0.  Returns the ring position after the
// item.
//
// Warp j computes rows [16j, 16j + 16) of T = X A_r^T[:, chunk] (all LC
// columns), and a 16 x LC block of Y^T = T^T B_r^T (rows: chunk lanes
// [16 (j % (LC/16)), +16); columns: rows w' [LC (j / (LC/16)), +LC)):
// in both products the state is the A operand, split once per fragment,
// and the already split side the B operand.
template <typename T, int SPLIT, typename Rows, typename Next>
__device__ int window_item(const ItemArgs<T, Rows>& ia, const QtPass& p,
                           T* smem, uint64_t* bars, int ring, bool primed,
                           Next& next) {
    using C = Cfg<T>;
    using V2 = typename Vec2<T>::type;
    constexpr int NT = C::LC / 8;          // 16 x 8 tiles per warp
    constexpr int NK = DIM / C::KC;        // K tiles per product
    constexpr int SP = C::SP, TS = C::TS, RS = side_row<T>(SPLIT);
    // side planes per rank in the side images
    constexpr int NPL = side_planes<T>(SPLIT);
    // K2 copies X tiles by TMA (issue_tile), and at float32 stages a
    // dual-side or B-only pass's mask in shared memory (stage_mask)
    constexpr bool TMA = Next::enabled;
    const bool STAGE_MASK =
        TMA && sizeof(T) == 4 && p.apply_b && p.mask != nullptr;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int g = lane / 4, t = lane % 4;
    const int row0 = warp * 16;                      // T rows w
    const int c0 = (warp % (C::LC / 16)) * 16;       // Y^T rows (lanes)
    const int n0 = (warp / (C::LC / 16)) * C::LC;    // Y^T columns w'

    if (!p.apply_a && !p.apply_b) {
        // mask-only: Y = mask (.) X, bound by bytes
        const T* M = static_cast<const T*>(p.mask);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int w = row0 + g + 8 * h;
                const int l = ia.l0 + nt * 8 + 2 * t;
                const long long o = ia.src(w) + l;
                const V2 vr = __ldcg(reinterpret_cast<const V2*>(ia.xr + o));
                const V2 vi = __ldcg(reinterpret_cast<const V2*>(ia.xi + o));
                T r0 = vr.x, r1 = vr.y, i0 = vi.x, i1 = vi.y;
                masked(M, w, l, r0, i0);
                masked(M, w, l + 1, r1, i1);
                const long long d = ia.base + w * ia.wstride + l;
                *reinterpret_cast<V2*>(ia.yr + d) = V2{r0, r1};
                *reinterpret_cast<V2*>(ia.yi + d) = V2{i0, i1};
            }
        return ring;
    }

    T* t_r = smem + STAGES * stage_elems<T>();   // [DIM][TS]: T = X A^T chunk
    T* t_i = t_r + DIM * TS;
    const int na = p.apply_a ? NK : 0;
    const int per = na + (p.apply_b ? NK : 0);
    const int total = p.rank * per;

    const int tid = threadIdx.x;
    auto load_tile = [&](int tile, uint32_t extra) {
        issue_tile<T, TMA>(smem, bars, ring + tile, tile, ia, p, NPL, RS,
                           extra);
    };

    T tacc[2][NT][4];
    zero_acc(tacc);

    // B-only: T is the slab's own lane chunk, for every rank; it comes
    // with tile 0, after the arrivals that announce its bytes
    if (!primed) {
#pragma unroll
        for (int s = 0; s < STAGES - 1; ++s)
            if (s < total) load_tile(s, s == 0 ? t_tile_bytes<T, TMA>(p) : 0);
        if (!p.apply_a) copy_t_tile(smem, &bars[ring % STAGES], ia);
    }
    // Waits for the next tile of the stream, lets every warp finish with
    // the stage the load after it overwrites, issues that load, and
    // returns the tile's stage.  Its barrier also orders T's stores
    // (park_t) before the second product's reads, and the previous rank's
    // reads of T before this rank's stores.
    int tile = 0;
    auto next_stage = [&]() {
        const int pos = ring + tile;
        bar_wait(&bars[pos % STAGES], (pos / STAGES) & 1);
        if constexpr (Next::enabled) {
            if (tile == total / 2) next.settle();
            if (tile == total - 2 && tid == 0) next.prepoll();
            if (tile == total - 1 && tid == 0) next.poll();
        }
        __syncthreads();
        if constexpr (Next::enabled) {
            if (tile == total / 2 && tid == 0) next.publish();
        }
        if (tile + STAGES - 1 < total) {
            // the threads' reads of the stage are done (the barrier);
            // order them before the copy engine's writes
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            load_tile(tile + STAGES - 1, 0);
        } else if constexpr (TMA && sizeof(T) == 4) {
            if (STAGE_MASK && tile == total - 1) {
                // the mask's lane chunk into the stage this tile frees
                stage_mask<T>(smem + ((pos + 1) % STAGES) * stage_elems<T>(),
                              static_cast<const T*>(p.mask), ia.l0);
                if (tid == 0) bar_arrive(&bars[(pos + 1) % STAGES], 0);
            }
        }
        T* st = smem + (pos % STAGES) * stage_elems<T>();
        ++tile;
        return st;
    };
    // T[w][c] (+)= sum_l X[w][l] A_r[l0 + c][l], one rank's K tiles
    auto first_product = [&](T (&acc)[2][NT][4]) {
        for (int j = 0; j < NK; ++j) {
            const T* st = next_stage();
            if constexpr (TMA)
                product_tile<T, SPLIT, NT>(
                    acc, st + row0 * C::KC, st + (DIM + row0) * C::KC,
                    SwizzledLay<T>{}, st + 2 * DIM * SP, C::LC * RS, g, t);
            else
                product_tile<T, SPLIT, NT>(
                    acc, st + row0 * SP, st + (DIM + row0) * SP,
                    StridedLay{SP, 1}, st + 2 * DIM * SP, C::LC * RS, g, t);
        }
    };
    // Y^T[c][w'] += sum_w T[w][c] B_r[w'][w], one rank's K tiles
    auto second_product = [&](T (&acc)[2][NT][4]) {
        for (int j = 0; j < NK; ++j) {
            const T* st = next_stage();
            product_tile<T, SPLIT, NT>(acc, t_r + j * C::KC * TS + c0,
                                       t_i + j * C::KC * TS + c0,
                                       StridedLay{1, TS}, st + n0 * RS,
                                       DIM * RS, g, t);
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
        if constexpr (Next::enabled) next.issue(smem, bars, ring + total);
        const T* M = static_cast<const T*>(p.mask);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int w = row0 + g + 8 * h;
                const int l = ia.l0 + nt * 8 + 2 * t;
                T r0 = tacc[0][nt][2 * h], r1 = tacc[0][nt][2 * h + 1];
                T i0 = tacc[1][nt][2 * h], i1 = tacc[1][nt][2 * h + 1];
                masked(M, w, l, r0, i0);
                masked(M, w, l + 1, r1, i1);
                const long long d = ia.base + w * ia.wstride + l;
                *reinterpret_cast<V2*>(ia.yr + d) = V2{r0, r1};
                *reinterpret_cast<V2*>(ia.yi + d) = V2{i0, i1};
            }
        return ring + total;
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
    // every warp is done with the shared tiles before the next item (and,
    // where the mask was staged, each thread's copies of it have landed)
    if (STAGE_MASK) asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    // a staged mask holds one more ring position
    const int end = ring + total + (STAGE_MASK ? 1 : 0);
    if constexpr (Next::enabled) next.issue(smem, bars, end);

    // Y^T tiles: lanes c0 + g (+ 8), rows w' = n0 + nt * 8 + 2t (+ 1)
    const T* M = static_cast<const T*>(p.mask);
    const T* Ms = smem + ((ring + total) % STAGES) * stage_elems<T>();
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int c = c0 + g + 8 * (e >> 1);
            const int l = ia.l0 + c;
            const int w = n0 + nt * 8 + 2 * t + (e & 1);
            T vr = yacc[0][nt][e], vi = yacc[1][nt][e];
            if (STAGE_MASK)
                masked4(vr, vi, Ms[w * MASK_PITCH + c],
                        Ms[(DIM + w) * MASK_PITCH + c]);
            else
                masked(M, w, l, vr, vi);
            const long long d = ia.base + w * ia.wstride + l;
            ia.yr[d] = vr;
            ia.yi[d] = vi;
        }
    return end;
}

// The item with the products the pass's split calls for, among those of
// the kernel's family (float64 has one kind).
template <typename T, int FAM, typename Rows, typename Next>
__device__ __forceinline__ int run_item(const ItemArgs<T, Rows>& ia,
                                        const QtPass& p, T* smem,
                                        uint64_t* bars, int ring,
                                        bool primed, Next& next) {
    if constexpr (sizeof(T) == 8)
        return window_item<T, SPLIT_EXACT>(ia, p, smem, bars, ring, primed,
                                           next);
    else if constexpr (FAM == FAMILY_TF32)
        return window_item<T, SPLIT_TF32>(ia, p, smem, bars, ring, primed,
                                          next);
    else if constexpr (FAM == FAMILY_BF16)
        return window_item<T, SPLIT_BF16X3>(ia, p, smem, bars, ring, primed,
                                            next);
    else if (p.split == SPLIT_EXACT)
        return window_item<T, SPLIT_EXACT>(ia, p, smem, bars, ring, primed,
                                           next);
    else
        return window_item<T, SPLIT_TF32X3>(ia, p, smem, bars, ring, primed,
                                            next);
}

// The ring's mbarriers, once per CTA, before any copy: `count` arrivals
// complete a phase (every thread, or K2's thread 0).
__device__ __forceinline__ void init_ring(uint64_t* bars, int count) {
    if (threadIdx.x < STAGES) bar_init(&bars[threadIdx.x], count);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    __syncthreads();
}

// One item of K1 or K12 over a bank: element b = blockIdx.y, whose
// state and output lie 2 * plane elements on, with source rows `src`.
// The pass is the shared `p`, or with OWN (a bank whose elements carry
// their own passes) element b's descriptor elems[b] (its sides, mask and
// split), staged in shared memory; one register, or a bank of shared
// passes, runs the OWN = false kernel, whose pass stays a kernel
// parameter.
template <typename T, int FAM, bool OWN, typename Rows>
__device__ __forceinline__ void run_bank_item(
        const T* __restrict__ x, T* __restrict__ y, long long plane,
        Rows src, long long base, long long wstride, int chunk,
        const QtPass& p, const QtPass* __restrict__ elems) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    __shared__ uint64_t bars[STAGES];
    T* smem = reinterpret_cast<T*>(smem_raw);
    const T* xe = x + (long long)blockIdx.y * 2 * plane;
    T* ye = y + (long long)blockIdx.y * 2 * plane;
    const ItemArgs<T, Rows> ia{xe, xe + plane, ye, ye + plane, src, base,
                               wstride, chunk * Cfg<T>::LC};
    NoNext none;
    if constexpr (OWN) {
        __shared__ QtPass ep;
        if (threadIdx.x == 0) ep = elems[blockIdx.y];
        init_ring(bars, NTHREADS);      // its barrier publishes `ep`
        run_item<T, FAM>(ia, ep, smem, bars, 0, false, none);
    } else {
        init_ring(bars, NTHREADS);
        run_item<T, FAM>(ia, p, smem, bars, 0, false, none);
    }
}

// K1 (and K11): one (slab, lane chunk) item per CTA, blockIdx.x, of the
// pass's strided slabs; over a bank as run_bank_item says.
template <typename T, int FAM, bool OWN>
__global__ void __launch_bounds__(NTHREADS, 1)
window_pass_kernel(const T* __restrict__ x, T* __restrict__ y,
                   long long plane, QtPass p,
                   const QtPass* __restrict__ elems) {
    const int chunk = blockIdx.x % nchunk<T>();
    const long long slab = blockIdx.x / nchunk<T>();
    const long long mid = 1LL << (p.k - 7);
    const long long h = slab / mid, m = slab % mid;
    const long long base = (h * DIM * mid + m) * DIM;
    run_bank_item<T, FAM, OWN>(x, y, plane, StridedRows{base, mid * DIM},
                               base, mid * DIM, chunk, p, elems);
}

// K12: one (output slab, lane chunk) item per CTA, the slab's rows
// gathered across the segment swap (SwappedRows); k = 7, so the output
// slab is 128 x 128 consecutive amplitudes of each plane.  Over a bank
// as run_bank_item says.
template <typename T, int FAM, bool OWN>
__global__ void __launch_bounds__(NTHREADS, 1)
swap_cluster_kernel(const T* __restrict__ x, T* __restrict__ y,
                    long long plane, QtPass p,
                    const QtPass* __restrict__ elems, int hs, int bs,
                    int mask) {
    const int chunk = blockIdx.x % nchunk<T>();
    const long long slab = blockIdx.x / nchunk<T>();
    run_bank_item<T, FAM, OWN>(x, y, plane,
                               SwappedRows{slab, hs, bs, mask},
                               slab * DIM * DIM, DIM, chunk, p, elems);
}

// ---------------------------------------------------------------------------
// K2: the window megakernel's dataflow schedule
// ---------------------------------------------------------------------------

// Items per ticket: a ticket is two consecutive items of one super-block's
// pass (the two lane chunks of a slab at float32), run back to back, so
// that the schedule's gpu-scope synchronisation (a poll, a publication;
// each about an L2 round trip on the issuing thread, which the whole CTA
// then waits for) is paid once per two items.
constexpr int MEGA_TICKET_ITEMS = 2;

// The tensor maps of K2's X tiles, one per pass: the buffer the pass
// reads (the state, the output or the slots) as a 4-d tensor (lane l,
// m, row w, q) of strides (1, 128, 128 mid, 128^2 mid) elements, mid =
// 2^(k-7): element l of row w of slab (h, m) at q = h in the plane, with
// the planes and slots further along q (launch_megawin).  The copy's box
// is (KC, 1, 128, 1), one X tile of one plane.
struct MegaMaps {
    CUtensorMap m[MAX_MEGA_PASSES];
};

// A launch of K2 as every thread reads it, and the CTA's schedule: in
// shared memory, so that a pass is looked up at a dynamic index without a
// local copy of the parameters, and the schedule's state takes no
// registers while an item runs.  `work` holds the ticket counter, then one
// done-counter per super-block (items finished, over all passes); the
// wrapper zeroes it.  The item operands rotate through three slots: the
// item that runs, the next (written while it runs), and the one before,
// whose stores other threads may still be issuing.
template <typename T>
struct MegaLaunch {
    const T* x;
    T* out;
    T* slots;
    unsigned* tickets;
    int* done;
    long long plane;
    unsigned ticket;    // the ticket of the CTA's next item to start
    unsigned next;      // thread 0: the CTA's following ticket
    int pending;        // thread 0: the super-block of the CTA's last
                        // ticket while it is not yet published, else -1
    int go;             // the next item's tile 0 is issued early, its
    int go_slot;        // operand slot and whether it is a ticket's
    int go_first;       // first item
    int slot, first;    // thread 0: the running item's slot, and whether
                        // it is its ticket's first item
    int pass[3];        // per operand slot: the item's pass and
    int sb[3];          // super-block
    ItemArgs<T, StridedRows> ia[3];
    QtPass ep[3];       // per operand slot, with OWN (a bank whose
                        // elements carry their own passes), the item's
                        // element's pass
    const QtPass* elems;   // bank: B * npass passes (element-major), or
                           // null when the elements share `a.p`
    const MegaMaps* maps;
    QtMegaArgs a;
};

struct MegaItem {
    int sb, pass, it;
};

// Ticket t: windows of W super-blocks in order (the last may hold fewer),
// within a window pass by pass, within a pass super-block by super-block
// and two items at a time; `it` is the ticket's first item
// (ops/fused.py megawin_decode is its twin).
__device__ __forceinline__ MegaItem mega_decode(unsigned t,
                                                const QtMegaArgs& a) {
    const unsigned tpp = (unsigned)a.ipp / MEGA_TICKET_ITEMS;
    const unsigned per_win = (unsigned)(a.window * a.npass) * tpp;
    const unsigned win = t / per_win;
    const unsigned r = t - win * per_win;
    const int w0 = (int)win * a.window;
    const int ws = min(a.window, a.nsb - w0);
    const unsigned per_pass = (unsigned)ws * tpp;
    MegaItem m;
    m.pass = (int)(r / per_pass);
    const unsigned q = r - (unsigned)m.pass * per_pass;
    m.sb = w0 + (int)(q / tpp);
    m.it = (int)(q % tpp) * MEGA_TICKET_ITEMS;
    return m;
}

__device__ __forceinline__ unsigned mega_tickets(const QtMegaArgs& a) {
    return (unsigned)a.nsb * (unsigned)a.npass *
           ((unsigned)a.ipp / MEGA_TICKET_ITEMS);
}

// Passes alternate between a super-block's place in `out` and its slot,
// so that the last lands in `out`; with an even count the first pass
// writes the slot, with an odd one the second (one pass: never).
__device__ __forceinline__ bool mega_to_out(int pass, int npass) {
    return (npass - 1 - pass) % 2 == 0;
}
__device__ __forceinline__ int mega_first_slot_pass(int npass) {
    return npass % 2 == 0 ? 0 : 1;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
    int v;
    asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
                 : "=r"(v)
                 : "l"(p)
                 : "memory");
    return v;
}
__device__ __forceinline__ int ld_relaxed(const int* p) {
    int v;
    asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];\n"
                 : "=r"(v)
                 : "l"(p)
                 : "memory");
    return v;
}
__device__ __forceinline__ void red_release(int* p, int v) {
    asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n" ::"l"(p),
                 "r"(v)
                 : "memory");
}

// The done-counts item m needs: the super-block's own, through its
// previous pass (need0), and where its pass first writes the slot, the
// slot's previous occupant's, through its last pass (need1 on counter
// m.sb - S).  Both cover lower tickets only.
__device__ __forceinline__ void mega_needs(const MegaItem& m,
                                           const QtMegaArgs& a, int& need0,
                                           int& need1) {
    need0 = m.pass * a.ipp;
    need1 = (m.pass == mega_first_slot_pass(a.npass) && m.sb >= a.slots)
                ? a.npass * a.ipp
                : 0;
}

// Thread 0 waits until item m may start, reading the counters with
// acquire semantics.
template <typename T>
__device__ __forceinline__ void mega_wait(const MegaItem& m,
                                          const MegaLaunch<T>& L) {
    int need0, need1;
    mega_needs(m, L.a, need0, need1);
    unsigned ns = 32;
    while ((need0 && ld_acquire(L.done + m.sb) < need0) ||
           (need1 && ld_acquire(L.done + m.sb - L.a.slots) < need1)) {
        __nanosleep(ns);
        ns = ns < 1024 ? 2 * ns : ns;
    }
}

// Operand slot s of L for item m: where pass m.pass of super-block m.sb
// reads (where the pass before wrote, the first the state) and writes
// (its place in `out`, planes 2^n apart, or its slot, both planes of one
// super-block G * 128 * 128 apart), and item m.it's slab in the
// super-block (mid = 2^(k-7) slabs interleaved row by row) and lane
// chunk.
template <typename T, bool OWN>
__device__ __forceinline__ void mega_operands(MegaLaunch<T>& L, int s,
                                              const MegaItem& m) {
    const QtMegaArgs& a = L.a;
    const long long sbe = (long long)a.g_rows * DIM * DIM;
    // the bank element and its own super-block (one element: sb itself)
    const int eb = m.sb / a.nsb_elem, es = m.sb - eb * a.nsb_elem;
    const long long ebase = (long long)eb * 2 * L.plane + es * sbe;
    auto place = [&](int pass, long long& pstride) -> T* {
        if (mega_to_out(pass, a.npass)) {
            pstride = L.plane;
            return L.out + ebase;
        }
        pstride = sbe;
        return L.slots + (long long)(m.sb % a.slots) * 2 * sbe;
    };
    ItemArgs<T, StridedRows>& ia = L.ia[s];
    long long ps = L.plane, pd;
    ia.xr = m.pass > 0 ? place(m.pass - 1, ps) : L.x + ebase;
    ia.xi = ia.xr + ps;
    ia.yr = place(m.pass, pd);
    ia.yi = ia.yr + pd;
    const int shift = a.p[m.pass].k - 7;
    const long long j = m.it / nchunk<T>();
    ia.base =
        ((j >> shift) * DIM * (1LL << shift) + (j & ((1LL << shift) - 1))) *
        DIM;
    ia.wstride = (1LL << shift) * DIM;
    ia.src = StridedRows{ia.base, ia.wstride};
    ia.l0 = (m.it % nchunk<T>()) * Cfg<T>::LC;
    // the slab in the source's tensor map: q counts 128^2 mid-element
    // blocks, G / mid to a super-block
    const int per_sb = a.g_rows >> shift;
    const int hh = (int)(j >> shift);
    ia.map = &L.maps->m[m.pass];
    ia.tm_m = (int)(j & ((1LL << shift) - 1));
    if (m.pass > 0 && !mega_to_out(m.pass - 1, a.npass)) {
        ia.tm_q = (m.sb % a.slots) * 2 * per_sb + hh;
        ia.tm_qp = per_sb;
    } else {
        // element eb's real plane starts 2 * plane / (128^2 mid) blocks
        // on
        ia.tm_qp = (int)(L.plane / ((long long)DIM * DIM << shift));
        ia.tm_q = eb * 2 * ia.tm_qp + es * per_sb + hh;
    }
    L.pass[s] = m.pass;
    L.sb[s] = m.sb;
    if constexpr (OWN) L.ep[s] = L.elems[eb * a.npass + m.pass];
}

// The pass an operand slot's item runs: the group's, or with OWN the one
// staged for the slot.
template <bool OWN, typename T>
__device__ __forceinline__ const QtPass& mega_pass(const MegaLaunch<T>& L,
                                                   int s) {
    if constexpr (OWN) return L.ep[s];
    else return L.a.p[L.pass[s]];
}

// K2's hooks in an item's K-tile stream (window_item).  Their state lies
// in shared memory (L.slot, L.first, L.go, L.go_slot), so that the item's
// products run with K1's registers; only thread 0's next ticket, taken
// as a ticket's first item begins, stays in a register.  The first item
// of a ticket hands on to the second, which is always ready; the second
// to the CTA's next ticket, whose inputs thread 0 polls.
template <typename T, bool OWN>
struct MegaNext {
    static constexpr bool enabled = true;
    MegaLaunch<T>& L;
    unsigned ticket;    // thread 0, first item: the CTA's next ticket
    int seen0, seen1;   // thread 0: the counters read ahead

    // Half way through a ticket's first item, before the tile's barrier
    // (every thread): the CTA's previous ticket's stores, drained by now,
    // reach the async proxy, which the next pass's copies read.
    __device__ void settle() {
        if (L.first) asm volatile("fence.proxy.async.global;\n" ::: "memory");
    }
    // After that barrier (thread 0): publish the previous ticket.
    __device__ void publish() {
        if (!L.first) return;
        if (L.pending >= 0)
            red_release(L.done + L.pending, MEGA_TICKET_ITEMS);
        L.pending = -1;
    }
    // Two tiles before the end (thread 0): a first item keeps its next
    // ticket; a second item reads the counters the CTA's next ticket
    // needs, relaxed, a tile ahead of their use, and sets out its
    // operands.
    __device__ void prepoll() {
        if (L.first) {
            L.next = ticket;
            return;
        }
        L.ticket = L.next;
        seen0 = seen1 = 0;
        if (L.next >= mega_tickets(L.a)) return;
        const MegaItem m = mega_decode(L.next, L.a);
        int need0, need1;
        mega_needs(m, L.a, need0, need1);
        if (need0) seen0 = ld_relaxed(L.done + m.sb);
        if (need1) seen1 = ld_relaxed(L.done + m.sb - L.a.slots);
        mega_operands<T, OWN>(L, L.slot == 2 ? 0 : L.slot + 1, m);
    }
    // The last tile, before its barrier (thread 0): whether the next
    // item's tile 0 goes out now; for a new ticket, whether its inputs
    // are complete, and if so the fence makes the relaxed reads an
    // acquisition of them.
    __device__ void poll() {
        int go = 0;
        if (L.first) {
            go = 1;
        } else if (L.ticket < mega_tickets(L.a)) {
            const MegaItem m = mega_decode(L.ticket, L.a);
            int need0, need1;
            mega_needs(m, L.a, need0, need1);
            const QtPass& p = L.a.p[m.pass];
            go = (p.apply_a || p.apply_b) && seen0 >= need0 &&
                 seen1 >= need1;
            if (go) asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
        }
        L.go = go;
        L.go_slot = L.slot == 2 ? 0 : L.slot + 1;
        L.go_first = L.first;
    }
    // After the item's last barrier, before its stores (every thread):
    // the next item's tile 0 (and a B-only pass's T tile) into the free
    // stage at ring position `pos`.
    __device__ void issue(T* smem, uint64_t* bars, int pos) {
        if (!L.go) return;
        const int s = L.go_slot;
        const ItemArgs<T, StridedRows>& ia = L.ia[s];
        const QtPass& p = mega_pass<OWN>(L, s);
        // a new ticket's inputs, acquired (poll), before the copy
        // engine's reads; the threads' reads of shared memory before its
        // writes
        if (!L.go_first)
            asm volatile("fence.proxy.async.global;\n" ::: "memory");
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        issue_tile<T, true>(smem, bars, pos, 0, ia, p,
                            side_planes<T>(p.split), side_row<T>(p.split),
                            t_tile_bytes<T, true>(p));
        if (!p.apply_a) copy_t_tile(smem, &bars[pos % STAGES], ia);
    }
};

// K2: a persistent grid that takes tickets until they run out.  An item
// whose tile 0 its predecessor issued (primed) starts at once; the first
// item of a ticket publishes the CTA's previous ticket half way through,
// when that ticket's stores have drained (a fence right after them waits
// for about 64 KB to reach L2 at the SM's share of the write rate).  Any
// other item first publishes the previous ticket (it may wait on it) and
// then waits for its inputs.
template <typename T, int FAM, bool OWN>
__global__ void __launch_bounds__(NTHREADS, 1)
megawin_kernel(const T* __restrict__ x, T* out, T* slots, unsigned* work,
               long long plane, QtMegaArgs args,
               const __grid_constant__ MegaMaps maps,
               const QtPass* __restrict__ elems) {
    // the swizzled X tiles start on 1024 bytes; a base the compiler knows
    // keeps the tiles' addresses out of registers
    extern __shared__ __align__(1024) unsigned char mega_smem[];
    __shared__ uint64_t bars[STAGES];
    __shared__ MegaLaunch<T> L;
    T* smem = reinterpret_cast<T*>(mega_smem);
    const int tid = threadIdx.x;
    if (smem_addr(mega_smem) % 1024) __trap();
    if (tid == 0) {
        L.maps = &maps;
        L.x = x;
        L.out = out;
        L.slots = slots;
        L.tickets = work;
        L.done = reinterpret_cast<int*>(work + 1);
        L.plane = plane;
        L.pending = -1;
        L.elems = elems;
        L.a = args;
        L.ticket = atomicAdd(work, 1u);
    }
    init_ring(bars, 1);
    int ring = 0, slot = 0;
    bool primed = false, first = true;
    for (;;) {
        if (!primed) {
            // publish the CTA's last ticket before any wait: its next may
            // depend on it
            asm volatile("fence.proxy.async.global;\n" ::: "memory");
            __syncthreads();
            if (tid == 0) {
                if (L.pending >= 0)
                    red_release(L.done + L.pending, MEGA_TICKET_ITEMS);
                L.pending = -1;
            }
            if (first) {
                if (L.ticket >= mega_tickets(L.a)) break;
                if (tid == 0) {
                    const MegaItem m = mega_decode(L.ticket, L.a);
                    mega_operands<T, OWN>(L, slot, m);
                    mega_wait(m, L);
                }
            }
            __syncthreads();
            // the inputs' acquisition before this item's copies (the
            // async proxy), the last item's reads of shared memory
            // before the copy engine's writes
            asm volatile("fence.proxy.async.global;\n" ::: "memory");
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        }
        const int nslot = slot == 2 ? 0 : slot + 1;
        MegaNext<T, OWN> next{L, 0u, 0, 0};
        if (tid == 0) {
            L.slot = slot;
            L.first = first;
        }
        if (first && tid == 0) {
            next.ticket = atomicAdd(L.tickets, 1u);
            // the ticket's second item: the slab's next lane chunk
            L.ia[nslot] = L.ia[slot];
            L.ia[nslot].l0 += Cfg<T>::LC;
            L.pass[nslot] = L.pass[slot];
            L.sb[nslot] = L.sb[slot];
            if constexpr (OWN) L.ep[nslot] = L.ep[slot];
        }
        const QtPass& p = mega_pass<OWN>(L, slot);
        ring = run_item<T, FAM>(L.ia[slot], p, smem, bars, ring, primed,
                                next);
        // every thread reads the flag after the item's last barrier;
        // thread 0 writes it next in the next item's poll
        primed = (p.apply_a || p.apply_b) && L.go;
        if (tid == 0) {
            // a mask-only item has no K tiles, so no prepoll moved the
            // tickets on
            if (!p.apply_a && !p.apply_b) {
                if (first) L.next = next.ticket;
                else L.ticket = L.next;
            }
            if (!first) L.pending = L.sb[slot];
        }
        slot = nslot;
        first = !first;
    }
}

// The bulk copies move 16-byte multiples from 16-byte boundaries: every
// operand must start on 16 bytes.
static bool aligned16(const void* p) {
    return ((uintptr_t)p & 15) == 0;
}

static bool pass_ok(const QtPass& p, int n) {
    if (p.k < 7 || p.k > n - 7 || p.rank < 1) return false;
    if (p.split < SPLIT_TF32X3 || p.split > SPLIT_BF16X3) return false;
    if (p.apply_a && (p.a == nullptr || !aligned16(p.a))) return false;
    if (p.apply_b && (p.b == nullptr || !aligned16(p.b))) return false;
    return true;
}

// A bank element's pass must match the launch's shape: the same window,
// rank, sides present and precision family; its own sides, mask and
// split.
static bool same_shape(const QtPass& e, const QtPass& p) {
    return e.k == p.k && e.rank == p.rank && e.apply_a == p.apply_a &&
           e.apply_b == p.apply_b && (e.mask == nullptr) == (p.mask == nullptr) &&
           split_family(e.split) == split_family(p.split);
}

template <typename T, int FAM>
static int launch_window_pass_as(const T* x, T* y, int n, int nbank,
                                 const QtPass& pass, const QtPass* elems,
                                 void* stream) {
    const size_t smem = smem_bytes<T>();
    const auto kernel = elems != nullptr ? window_pass_kernel<T, FAM, true>
                                         : window_pass_kernel<T, FAM, false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const long long plane = 1LL << n;
    const dim3 grid((unsigned)((1LL << (n - 14)) * nchunk<T>()),
                    (unsigned)nbank);
    kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(x, y, plane, pass,
                                                         elems);
    return (int)cudaGetLastError();
}

// K1 over a bank of `nbank` registers (x and y: (nbank, 2, 2^n); one
// register is nbank = 1).  With `elems_host` (nbank passes, host) the
// elements run their own passes, which the kernel reads from
// `elems_dev`, a device copy the wrapper made; `pass` is then element
// 0's, for the launch's shape.
template <typename T>
static int launch_window_pass(const T* x, T* y, int n, int nbank,
                              const QtPass* pass, const QtPass* elems_host,
                              const QtPass* elems_dev, void* stream) {
    if (pass == nullptr || n < 14 || nbank < 1 || nbank > 65535 ||
        !pass_ok(*pass, n) || !aligned16(x) || !aligned16(y) ||
        (elems_host == nullptr) != (elems_dev == nullptr))
        return (int)cudaErrorInvalidValue;
    for (int b = 0; elems_host != nullptr && b < nbank; ++b)
        if (!pass_ok(elems_host[b], n) || !same_shape(elems_host[b], *pass))
            return (int)cudaErrorInvalidValue;
    if constexpr (sizeof(T) == 8) {
        return launch_window_pass_as<T, FAMILY_HIGHEST>(x, y, n, nbank, *pass,
                                                        elems_dev, stream);
    } else {
        switch (split_family(pass->split)) {
            case FAMILY_TF32:
                return launch_window_pass_as<T, FAMILY_TF32>(
                    x, y, n, nbank, *pass, elems_dev, stream);
            case FAMILY_BF16:
                return launch_window_pass_as<T, FAMILY_BF16>(
                    x, y, n, nbank, *pass, elems_dev, stream);
            default:
                return launch_window_pass_as<T, FAMILY_HIGHEST>(
                    x, y, n, nbank, *pass, elems_dev, stream);
        }
    }
}

// K12: the segment swap [h, h+m) <-> [bq, bq+m), then K11's operator,
// over a bank of `nbank` registers, as K1.
template <typename T, int FAM>
static int launch_swap_cluster_as(const T* x, T* y, int n, int nbank,
                                  const QtPass& pass, const QtPass* elems,
                                  int h, int bq, int m, void* stream) {
    const size_t smem = smem_bytes<T>();
    const auto kernel = elems != nullptr ? swap_cluster_kernel<T, FAM, true>
                                         : swap_cluster_kernel<T, FAM, false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const long long plane = 1LL << n;
    const long long nslab = 1LL << (n - 14);
    const dim3 grid((unsigned)(nslab * nchunk<T>()), (unsigned)nbank);
    kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
        x, y, plane, pass, elems, h - 14, bq - 7, (1 << m) - 1);
    return (int)cudaGetLastError();
}

// K12 over a bank (one register is nbank = 1): `pass` holds the rank,
// the side images and the split (element 0's, with `elems_host`, whose
// device copy `elems_dev` the elements read), k = 7, both sides, no
// mask.
template <typename T>
static int launch_swap_cluster(const T* x, T* y, int n, int nbank,
                               const QtPass* pass, const QtPass* elems_host,
                               const QtPass* elems_dev, int h, int bq, int m,
                               void* stream) {
    if (pass == nullptr || n < 14 || nbank < 1 || nbank > 65535 ||
        !pass_ok(*pass, n) || pass->k != 7 || !pass->apply_a ||
        !pass->apply_b || pass->mask != nullptr || m < 1 || h < 14 ||
        h + m > n || bq < 7 || bq + m > 14 || !aligned16(x) ||
        !aligned16(y) || (elems_host == nullptr) != (elems_dev == nullptr))
        return (int)cudaErrorInvalidValue;
    for (int b = 0; elems_host != nullptr && b < nbank; ++b)
        if (!pass_ok(elems_host[b], n) || !same_shape(elems_host[b], *pass))
            return (int)cudaErrorInvalidValue;
    if constexpr (sizeof(T) == 8) {
        return launch_swap_cluster_as<T, FAMILY_HIGHEST>(
            x, y, n, nbank, *pass, elems_dev, h, bq, m, stream);
    } else {
        switch (split_family(pass->split)) {
            case FAMILY_TF32:
                return launch_swap_cluster_as<T, FAMILY_TF32>(
                    x, y, n, nbank, *pass, elems_dev, h, bq, m, stream);
            case FAMILY_BF16:
                return launch_swap_cluster_as<T, FAMILY_BF16>(
                    x, y, n, nbank, *pass, elems_dev, h, bq, m, stream);
            default:
                return launch_swap_cluster_as<T, FAMILY_HIGHEST>(
                    x, y, n, nbank, *pass, elems_dev, h, bq, m, stream);
        }
    }
}

// K2's shared memory: the window kernels'.
template <typename T>
static size_t mega_smem_bytes() {
    return smem_bytes<T>();
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link
// against the driver library).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

static EncodeTiled tensor_map_encoder() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
        const cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
        if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// The tensor map of a buffer that a pass with 2^shift slabs interleaved
// row by row reads (MegaMaps), `q_extent` blocks of 128^2 2^shift
// elements long.
template <typename T>
static bool mega_map(CUtensorMap* map, const T* buf, long long q_extent,
                     int shift) {
    const EncodeTiled encode = tensor_map_encoder();
    if (encode == nullptr) return false;
    const cuuint64_t row = DIM * sizeof(T);
    const cuuint64_t dims[4] = {DIM, 1ull << shift, DIM,
                                (cuuint64_t)q_extent};
    const cuuint64_t strides[3] = {row, row << shift, (row * DIM) << shift};
    const cuuint32_t box[4] = {(cuuint32_t)Cfg<T>::KC, 1, DIM, 1};
    const cuuint32_t step[4] = {1, 1, 1, 1};
    return encode(map,
                  sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT64,
                  4, const_cast<T*>(buf), dims, strides, box, step,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The CTAs of K2's persistent grid: every SM times the CTAs an SM holds
// (the families' instantiations share the shared memory and the launch
// bounds that set it).
template <typename T>
static int megawin_ctas(int* ctas) {
    if (ctas == nullptr) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        megawin_kernel<T, FAMILY_HIGHEST, false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)mega_smem_bytes<T>());
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0, per = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per, megawin_kernel<T, FAMILY_HIGHEST, false>, NTHREADS,
        mega_smem_bytes<T>());
    if (err != cudaSuccess) return (int)err;
    *ctas = sms * per;
    return (int)cudaSuccess;
}

template <typename T, int FAM>
static int launch_megawin_as(const T* x, T* out, T* slots, unsigned* work,
                             int ctas, int n, const QtMegaArgs& args,
                             const MegaMaps& maps, const QtPass* elems,
                             void* stream) {
    // the elements' own passes (OWN), or the group's
    const auto kernel = elems != nullptr ? megawin_kernel<T, FAM, true>
                                         : megawin_kernel<T, FAM, false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)mega_smem_bytes<T>());
    if (err != cudaSuccess) return (int)err;
    const long long plane = 1LL << n;
    kernel<<<(unsigned)ctas, NTHREADS, mega_smem_bytes<T>(),
             (cudaStream_t)stream>>>(x, out, slots, work, plane, args, maps,
                                     elems);
    return (int)cudaGetLastError();
}

// `slots` holds S * 2 * G * 128 * 128 elements (groups of one pass need
// none); `work` 1 + nsb zeroed counters, nsb over the whole bank of
// `nbank` registers (x and out: (nbank, 2, 2^n)).  W and S come from the
// wrapper (ops/fused.py megawin_schedule).  With `elems_host` (nbank *
// npass passes, element-major, host) the elements run their own passes
// from `elems_dev`, the wrapper's device copy; `passes` are then element
// 0's, for the group's shape.
template <typename T>
static int launch_megawin(const T* x, T* out, T* slots, unsigned* work,
                          int ctas, int window, int nslots, int n,
                          const QtPass* passes, int npass, int nbank,
                          const QtPass* elems_host, const QtPass* elems_dev,
                          void* stream) {
    if (nbank < 1 || (elems_host == nullptr) != (elems_dev == nullptr))
        return (int)cudaErrorInvalidValue;
    for (int b = 0; elems_host != nullptr && b < nbank; ++b)
        for (int i = 0; passes != nullptr && i < npass; ++i)
            if (!pass_ok(elems_host[b * npass + i], n) ||
                !same_shape(elems_host[b * npass + i], passes[i]))
                return (int)cudaErrorInvalidValue;
    if (passes == nullptr || n < 14 || npass < 1 ||
        npass > MAX_MEGA_PASSES || ctas < 1 || work == nullptr ||
        ((uintptr_t)work & 3) ||
        (npass > 1 && (slots == nullptr || !aligned16(slots))) ||
        !aligned16(x) || !aligned16(out))
        return (int)cudaErrorInvalidValue;
    QtMegaArgs args;
    args.npass = npass;
    int kmax = 7;
    // one family a launch: the passes of a group share the precision mode
    const int fam = sizeof(T) == 8 ? FAMILY_HIGHEST
                                   : split_family(passes[0].split);
    for (int i = 0; i < npass; ++i) {
        const QtPass& p = passes[i];
        if (!pass_ok(p, n)) return (int)cudaErrorInvalidValue;
        if (sizeof(T) == 4 && split_family(p.split) != fam)
            return (int)cudaErrorInvalidValue;
        kmax = p.k > kmax ? p.k : kmax;
        args.p[i] = p;
    }
    const long long nb = 1LL << (n - 14);
    const long long g = 1LL << (kmax - 7);
    if (g > nb) return (int)cudaErrorInvalidValue;
    const long long nsb = nb / g * nbank;
    const long long ipp = g * nchunk<T>();
    // the slot ring must span a window (a slot's previous occupant then
    // lies in a lower window), and the tickets fit the 32-bit counter
    if (window < 1 || window > nsb ||
        (npass > 1 && (nslots < window || nslots > nsb)) ||
        nsb * npass * ipp >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    args.g_rows = (int)g;
    args.ipp = (int)ipp;
    args.window = window;
    args.slots = npass > 1 ? nslots : 1;
    args.nsb = (int)nsb;
    args.nsb_elem = (int)(nb / g);
    // each pass's source: the state, then where the pass before wrote
    // (the state and output maps span the bank)
    MegaMaps maps;
    for (int i = 0; i < npass; ++i) {
        const int shift = args.p[i].k - 7;
        const bool slot = i > 0 && (npass - i) % 2 == 1;
        const bool ok =
            slot ? mega_map<T>(&maps.m[i], slots, (2 * nslots * g) >> shift,
                               shift)
                 : mega_map<T>(&maps.m[i], i == 0 ? x : out,
                               (2 * nb * nbank) >> shift, shift);
        if (!ok) return (int)cudaErrorInvalidValue;
    }
    if constexpr (sizeof(T) == 8) {
        return launch_megawin_as<T, FAMILY_HIGHEST>(x, out, slots, work, ctas,
                                                    n, args, maps, elems_dev,
                                                    stream);
    } else {
        switch (fam) {
            case FAMILY_TF32:
                return launch_megawin_as<T, FAMILY_TF32>(x, out, slots, work,
                                                         ctas, n, args, maps,
                                                         elems_dev, stream);
            case FAMILY_BF16:
                return launch_megawin_as<T, FAMILY_BF16>(x, out, slots, work,
                                                         ctas, n, args, maps,
                                                         elems_dev, stream);
            default:
                return launch_megawin_as<T, FAMILY_HIGHEST>(x, out, slots, work,
                                                            ctas, n, args, maps,
                                                            elems_dev, stream);
        }
    }
}

extern "C" {

int qt_max_mega_passes() { return MAX_MEGA_PASSES; }

// K1 (and K11) over a bank of nbank registers in one launch; one
// register is nbank = 1 with no element passes.
int qt_window_pass_f32(const float* x, float* y, int n, int nbank,
                       const QtPass* pass, const QtPass* elems_host,
                       const void* elems_dev, void* stream) {
    return launch_window_pass<float>(x, y, n, nbank, pass, elems_host,
                                     static_cast<const QtPass*>(elems_dev),
                                     stream);
}

int qt_window_pass_f64(const double* x, double* y, int n, int nbank,
                       const QtPass* pass, const QtPass* elems_host,
                       const void* elems_dev, void* stream) {
    return launch_window_pass<double>(x, y, n, nbank, pass, elems_host,
                                      static_cast<const QtPass*>(elems_dev),
                                      stream);
}

int qt_megawin_ctas_f32(int* ctas) { return megawin_ctas<float>(ctas); }

int qt_megawin_ctas_f64(int* ctas) { return megawin_ctas<double>(ctas); }

int qt_megawin_f32(const float* x, float* out, float* slots, unsigned* work,
                   int ctas, int window, int nslots, int n,
                   const QtPass* passes, int npass, int nbank,
                   const QtPass* elems_host, const void* elems_dev,
                   void* stream) {
    return launch_megawin<float>(x, out, slots, work, ctas, window, nslots,
                                 n, passes, npass, nbank, elems_host,
                                 static_cast<const QtPass*>(elems_dev),
                                 stream);
}

int qt_megawin_f64(const double* x, double* out, double* slots,
                   unsigned* work, int ctas, int window, int nslots, int n,
                   const QtPass* passes, int npass, int nbank,
                   const QtPass* elems_host, const void* elems_dev,
                   void* stream) {
    return launch_megawin<double>(x, out, slots, work, ctas, window, nslots,
                                  n, passes, npass, nbank, elems_host,
                                  static_cast<const QtPass*>(elems_dev),
                                  stream);
}

int qt_qtpass_size() { return (int)sizeof(QtPass); }

// K12 over a bank of nbank registers in one launch, as qt_window_pass_*
// (the pass at k = 7), then the segment swap's h, bq and m.
int qt_swap_cluster_stack_f32(const float* x, float* y, int n, int nbank,
                              const QtPass* pass, const QtPass* elems_host,
                              const void* elems_dev, int h, int bq, int m,
                              void* stream) {
    return launch_swap_cluster<float>(x, y, n, nbank, pass, elems_host,
                                      static_cast<const QtPass*>(elems_dev),
                                      h, bq, m, stream);
}

int qt_swap_cluster_stack_f64(const double* x, double* y, int n, int nbank,
                              const QtPass* pass, const QtPass* elems_host,
                              const void* elems_dev, int h, int bq, int m,
                              void* stream) {
    return launch_swap_cluster<double>(x, y, n, nbank, pass, elems_host,
                                       static_cast<const QtPass*>(elems_dev),
                                       h, bq, m, stream);
}

const char* qt_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
