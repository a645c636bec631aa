// QFT ladder layers (K6-K9) and the bit reversal's in-place double
// bit-block swap (K10) for NVIDIA Hopper (sm_90a).
//
// Three kernels under five entries:
//
//   qft_hi_kernel<K>     K8: replaces the Pallas kernel
//                        quest_tpu/ops/fused.py _qft_multi_hi_jit (pallas_call
//                        at fused.py:1127; body _qft_multi_hi_kernel), K
//                        consecutive layers t_hi..t_lo >= 14 in one pass;
//                        K6: replaces _qft_ladder_jit (pallas_call at
//                        fused.py:887), the same kernel with K = 1.
//   qft_sublane_kernel   K9: replaces _qft_cluster_multi_jit (pallas_call at
//                        fused.py:1228), the seven layers 13..7 in one pass;
//                        K7: replaces _qft_ladder_lo_jit (pallas_call at
//                        fused.py:1003), the same kernel with one layer.
//   sigma_swap_kernel    K10: replaces quest_tpu/ops/bigstate.py
//                        _sigma_swap_jit (pallas_call at bigstate.py:108).
//
// What they compute.  The state is a real SoA array, the real plane x[0 ..
// 2^n) then the imaginary plane x[2^n .. 2^(n+1)); qubit q is bit q of the
// amplitude index.  One QFT layer on target t maps each pair (x0, x1)
// across bit t to
//
//     y0 = (x0 + x1) / sqrt2,   y1 = (x0 - x1) / sqrt2 * ph,
//     ph = e^{i sgn pi low / 2^t},  low = the index's bits [0, t).
//
// The phase factorises, and every factor comes from tables built on the
// host in float64 and rounded to float32 (ops/fused.py), which the plain
// versions read too:
//   * t >= 14: ph = (m * c) * ctab[p][e], e = bits [0, 14), m = mlo[p][j mod
//     2^11] * mhi[p][j div 2^11] over the block index j = bits [14, t_lo),
//     c = e^{i sgn pi clo / 2^p} over the pass's own block bits below layer
//     p (a constant per pair, handed over by value: the reference's
//     compile-time Python floats rounded to float32);
//   * 7 <= t <= 13: the pair bit is row bit t - 7 of a 128 x 128 block (rows
//     = bits [7, 14), lanes = bits [0, 7)) and ph = tab[row mod 2^(t-7)]
//     [lane].
// sigma swaps amp bits [0, g) <-> [n-g, n) and [g, 2g) <-> [n-2g, n-g).
//
// What bounds them on this card.  Each reads and writes the state once and
// does tens of flops an amplitude: all three are bound by bytes.  At 30
// qubits in float32 (8.59 GB) a pass takes at least 2 * 8.59 GB /
// 3.35 TB/s = 5.13 ms.  The tables (<= 896 KB) stay in L2.
//
// Design.
//   * qft_hi_kernel: one thread owns one in-block position e of one block
//     group (j, i) and loads the 2^K amplitudes e + j 2^14 + c 2^t_lo +
//     i 2^(t_hi+1), c < 2^K, of both planes into registers (K is a template
//     parameter, so 2^K complex stay in registers: 32 at K = 5); it runs
//     the K butterfly layers there and stores in place.  Neighbouring
//     threads take neighbouring e: every load and store is coalesced.  The
//     TPU kernel held 2^K (128, 128) slabs in VMEM; here the same
//     co-residency is per thread.
//   * qft_sublane_kernel: one CTA takes a 128-row x 32-lane slice of one
//     block, both planes (32 KB of shared memory, 7 CTAs an SM), loads it
//     with 16-byte accesses, runs the layers t_hi..t_lo in shared memory
//     with a barrier between layers (a lane column's rows pair up only with
//     each other, so slices are independent) and stores it back.
//   * sigma_swap_kernel: slab (c, d) of the view [ch, G2, G1, b, s, l] (G1
//     = c, s = d, a G x G matrix over (G2, l)) maps onto slab (d, c)
//     transposed.  A CTA takes a 32 x 32 tile (x0, y0) of slab (c, d) and
//     the tile (y0, x0) of slab (d, c), both planes, loads both along l
//     (coalesced), transposes them through padded shared memory and writes
//     them swapped.  The grid enumerates unordered pairs c <= d (host
//     tables) and, for c == d, only tiles with x0 <= y0: every element pair
//     is moved by exactly one CTA, so the swap runs in place with no second
//     buffer.  A diagonal tile (c == d, x0 == y0) swaps with its own
//     transpose: both halves are loaded before the barrier and the two
//     stores write the same values.
//
// Bit identity.  The products are taken in the order of the plain versions
// (ops/fused.py _hi_layers_plain, _sublane_layer) and the file is compiled
// with --fmad=false, so each kernel equals its plain version bit for bit.
// Indices are 64-bit: the imaginary plane starts at 2^30 floats at n = 30.

#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int BLOCK_BITS = 14;                  // a 128 x 128 block
constexpr u64 BLOCK = 1ull << BLOCK_BITS;
constexpr int TL_SPLIT_BITS = 11;               // mlo / mhi split of j
constexpr int HI_THREADS = 256;
constexpr int SUB_LANES = 32;                   // lanes per sublane CTA
constexpr int SUB_THREADS = 256;
constexpr int SIG_TILE = 32;
constexpr int SIG_THREADS = 256;
constexpr float INV_SQRT2 = 0.7071067811865476f;

// e^{i sgn pi clo / 2^p} at index 2^p - 1 + clo, for p < 5
struct BlockConsts {
    float re[32];
    float im[32];
};

template <int K>
__global__ void __launch_bounds__(HI_THREADS)
qft_hi_kernel(float* __restrict__ x, u64 num_amps, int t_hi, int t_lo,
              const float* __restrict__ ctab, const float* __restrict__ mlo,
              int nlo, const float* __restrict__ mhi, int nhi,
              BlockConsts cs) {
    constexpr int C = 1 << K;
    const int m_bits = t_lo - BLOCK_BITS;
    const u64 g = (u64)blockIdx.x * HI_THREADS + threadIdx.x;
    const u64 e = g & (BLOCK - 1);
    const u64 j = (g >> BLOCK_BITS) & ((1ull << m_bits) - 1ull);
    const u64 i = g >> (BLOCK_BITS + m_bits);
    const u64 base = e + (j << BLOCK_BITS) + (i << (t_hi + 1));
    float re[C], im[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
        const u64 a = base + ((u64)c << t_lo);
        re[c] = x[a];
        im[c] = x[num_amps + a];
    }
    const int jl = (int)(j & ((1ull << TL_SPLIT_BITS) - 1ull));
    const int jh = (int)(j >> TL_SPLIT_BITS);
#pragma unroll
    for (int p = K - 1; p >= 0; --p) {
        const float ar = mlo[(2 * p) * nlo + jl];
        const float ai = mlo[(2 * p + 1) * nlo + jl];
        const float br = mhi[(2 * p) * nhi + jh];
        const float bi = mhi[(2 * p + 1) * nhi + jh];
        const float mr = ar * br - ai * bi;
        const float mi = ar * bi + ai * br;
        const float ctr = ctab[(u64)(2 * p) * BLOCK + e];
        const float cti = ctab[(u64)(2 * p + 1) * BLOCK + e];
#pragma unroll
        for (int c0 = 0; c0 < C; ++c0) {
            if ((c0 >> p) & 1) continue;
            const int c1 = c0 | (1 << p);
            const int q = (1 << p) - 1 + (c0 & ((1 << p) - 1));
            const float sr = mr * cs.re[q] - mi * cs.im[q];
            const float si = mr * cs.im[q] + mi * cs.re[q];
            const float phr = sr * ctr - si * cti;
            const float phi = sr * cti + si * ctr;
            const float s0r = (re[c0] + re[c1]) * INV_SQRT2;
            const float s0i = (im[c0] + im[c1]) * INV_SQRT2;
            const float dr = (re[c0] - re[c1]) * INV_SQRT2;
            const float di = (im[c0] - im[c1]) * INV_SQRT2;
            re[c0] = s0r;
            im[c0] = s0i;
            re[c1] = dr * phr - di * phi;
            im[c1] = dr * phi + di * phr;
        }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
        const u64 a = base + ((u64)c << t_lo);
        x[a] = re[c];
        x[num_amps + a] = im[c];
    }
}

__global__ void __launch_bounds__(SUB_THREADS)
qft_sublane_kernel(float* __restrict__ x, u64 num_amps, int t_hi, int t_lo,
                   const float* __restrict__ tab, u64 layer_stride,
                   u64 chan_stride) {
    constexpr int ROWS = 128;                   // rows of a block, and
                                                // lanes of a row
    constexpr int VEC = SUB_LANES / 4;          // float4 per row slice
    __shared__ __align__(16) float sm[2][ROWS][SUB_LANES];
    const u64 block = blockIdx.x / (ROWS / SUB_LANES);
    const int lane0 = (int)(blockIdx.x % (ROWS / SUB_LANES)) * SUB_LANES;
    const u64 base = (block << BLOCK_BITS) + lane0;
    for (int r = threadIdx.x; r < 2 * ROWS * VEC; r += SUB_THREADS) {
        const int ch = r / (ROWS * VEC);
        const int row = (r / VEC) % ROWS;
        const int v = r % VEC;
        *reinterpret_cast<float4*>(&sm[ch][row][4 * v]) =
            *reinterpret_cast<const float4*>(
                x + ch * num_amps + base + (u64)row * ROWS + 4 * v);
    }
    __syncthreads();
    const int lane = threadIdx.x % SUB_LANES;
    const int rg = threadIdx.x / SUB_LANES;     // 8 row groups
    for (int t = t_hi; t >= t_lo; --t) {
        const int b = t - 7;                    // the pair's row bit
        const float* tr_tab = tab + (u64)(t_hi - t) * layer_stride;
        const float* ti_tab = tr_tab + chan_stride;
        for (int pidx = rg; pidx < ROWS / 2; pidx += SUB_THREADS / SUB_LANES) {
            const int s0 = ((pidx >> b) << (b + 1)) | (pidx & ((1 << b) - 1));
            const int s1 = s0 | (1 << b);
            const int sl = s0 & ((1 << b) - 1);
            const float tr = tr_tab[sl * ROWS + lane0 + lane];
            const float ti = ti_tab[sl * ROWS + lane0 + lane];
            const float x0r = sm[0][s0][lane], x0i = sm[1][s0][lane];
            const float x1r = sm[0][s1][lane], x1i = sm[1][s1][lane];
            const float y0r = (x0r + x1r) * INV_SQRT2;
            const float y0i = (x0i + x1i) * INV_SQRT2;
            const float dr = (x0r - x1r) * INV_SQRT2;
            const float di = (x0i - x1i) * INV_SQRT2;
            sm[0][s0][lane] = y0r;
            sm[1][s0][lane] = y0i;
            sm[0][s1][lane] = dr * tr - di * ti;
            sm[1][s1][lane] = dr * ti + di * tr;
        }
        __syncthreads();
    }
    for (int r = threadIdx.x; r < 2 * ROWS * VEC; r += SUB_THREADS) {
        const int ch = r / (ROWS * VEC);
        const int row = (r / VEC) % ROWS;
        const int v = r % VEC;
        *reinterpret_cast<float4*>(x + ch * num_amps + base + (u64)row * ROWS +
                                   4 * v) =
            *reinterpret_cast<const float4*>(&sm[ch][row][4 * v]);
    }
}

// grid: (tiles of a slab, unordered pairs c <= d, b); view [ch, G2, G1, b,
// s, l] with slab (c, d) = (G1 = c, s = d), element (x, y) = (G2, l).
__global__ void __launch_bounds__(SIG_THREADS)
sigma_swap_kernel(float* __restrict__ x, u64 num_amps, int n, int g,
                  const int* __restrict__ ctab, const int* __restrict__ dtab) {
    __shared__ float ta[2][SIG_TILE][SIG_TILE + 1];
    __shared__ float tb[2][SIG_TILE][SIG_TILE + 1];
    const int G = 1 << g;
    const int T = G < SIG_TILE ? G : SIG_TILE;
    const int nt = G / T;
    const int ti = blockIdx.x / nt, tj = blockIdx.x % nt;
    const int c = ctab[blockIdx.y], d = dtab[blockIdx.y];
    if (c == d && ti > tj) return;              // its partner CTA moves it
    const u64 sS = (u64)G;                      // s stride
    const u64 sB = (u64)G * G;                  // b stride
    const u64 sG1 = sB << (n - 4 * g);          // G1 stride
    const u64 sG2 = sG1 * G;                    // G2 stride
    const u64 b = blockIdx.z;
    const u64 base_a = (u64)c * sG1 + b * sB + (u64)d * sS;   // slab (c, d)
    const u64 base_b = (u64)d * sG1 + b * sB + (u64)c * sS;   // slab (d, c)
    const int x0 = ti * T, y0 = tj * T;
    const int tx = threadIdx.x % SIG_TILE;
    const int ty = threadIdx.x / SIG_TILE;
    const int rows_step = SIG_THREADS / SIG_TILE;
    if (tx < T) {
        for (int ch = 0; ch < 2; ++ch) {
            float* plane = x + ch * num_amps;
            for (int r = ty; r < T; r += rows_step) {
                ta[ch][r][tx] = plane[base_a + (u64)(x0 + r) * sG2 + y0 + tx];
                tb[ch][r][tx] = plane[base_b + (u64)(y0 + r) * sG2 + x0 + tx];
            }
        }
    }
    __syncthreads();
    if (tx < T) {
        for (int ch = 0; ch < 2; ++ch) {
            float* plane = x + ch * num_amps;
            for (int r = ty; r < T; r += rows_step) {
                // new slab (c, d)[x][y] = old slab (d, c)[y][x], and back
                plane[base_a + (u64)(x0 + r) * sG2 + y0 + tx] = tb[ch][tx][r];
                plane[base_b + (u64)(y0 + r) * sG2 + x0 + tx] = ta[ch][tx][r];
            }
        }
    }
}

template <int K>
static int launch_hi(float* x, int n, int t_hi, int t_lo, const float* ctab,
                     const float* mlo, int nlo, const float* mhi, int nhi,
                     const BlockConsts& cs, cudaStream_t stream) {
    const u64 threads = 1ull << (n - K);
    qft_hi_kernel<K><<<(unsigned)(threads / HI_THREADS), HI_THREADS, 0,
                       stream>>>(x, 1ull << n, t_hi, t_lo, ctab, mlo, nlo,
                                 mhi, nhi, cs);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K8 over layers t_hi..t_lo (K = t_hi - t_lo + 1 in 1..5; K = 1 is K6):
// ctab (K, 2, 128, 128), mlo (K, 2, nlo), mhi (K, 2, nhi) on the card;
// cre / cim the 2^K - 1 block constants on the host.
int qt_qft_hi_f32(float* x, int n, int t_hi, int t_lo, const float* ctab,
                  const float* mlo, int nlo, const float* mhi, int nhi,
                  const float* cre, const float* cim, void* stream) {
    const int k = t_hi - t_lo + 1;
    if (t_lo < BLOCK_BITS || t_hi >= n || k < 1 || k > 5 || n > 40 ||
        nlo != (1 << (t_lo - BLOCK_BITS < TL_SPLIT_BITS
                          ? t_lo - BLOCK_BITS : TL_SPLIT_BITS)) ||
        nhi < 1 || ((long long)nhi << TL_SPLIT_BITS) <
                       (1ll << (t_lo - BLOCK_BITS)))
        return (int)cudaErrorInvalidValue;
    BlockConsts cs;
    for (int q = 0; q < 32; ++q) {
        cs.re[q] = q < (1 << k) - 1 ? cre[q] : 0.0f;
        cs.im[q] = q < (1 << k) - 1 ? cim[q] : 0.0f;
    }
    cudaStream_t s = (cudaStream_t)stream;
    switch (k) {
        case 1: return launch_hi<1>(x, n, t_hi, t_lo, ctab, mlo, nlo, mhi,
                                    nhi, cs, s);
        case 2: return launch_hi<2>(x, n, t_hi, t_lo, ctab, mlo, nlo, mhi,
                                    nhi, cs, s);
        case 3: return launch_hi<3>(x, n, t_hi, t_lo, ctab, mlo, nlo, mhi,
                                    nhi, cs, s);
        case 4: return launch_hi<4>(x, n, t_hi, t_lo, ctab, mlo, nlo, mhi,
                                    nhi, cs, s);
        default: return launch_hi<5>(x, n, t_hi, t_lo, ctab, mlo, nlo, mhi,
                                     nhi, cs, s);
    }
}

// K9 over layers t_hi..t_lo, 7 <= t_lo <= t_hi <= 13 (one layer is K7):
// layer t's table at tab + (t_hi - t) * layer_stride, its imaginary half
// chan_stride floats on, rows of 128 lanes.
int qt_qft_sublane_f32(float* x, int n, int t_hi, int t_lo, const float* tab,
                       long long layer_stride, long long chan_stride,
                       void* stream) {
    if (n < BLOCK_BITS || n > 40 || t_lo < 7 || t_hi > 13 || t_lo > t_hi ||
        layer_stride < 0 || chan_stride <= 0)
        return (int)cudaErrorInvalidValue;
    const u64 blocks = (1ull << (n - BLOCK_BITS)) * (128 / SUB_LANES);
    if (blocks > 0x7fffffffull) return (int)cudaErrorInvalidValue;
    qft_sublane_kernel<<<(unsigned)blocks, SUB_THREADS, 0,
                         (cudaStream_t)stream>>>(
        x, 1ull << n, t_hi, t_lo, tab, (u64)layer_stride, (u64)chan_stride);
    return (int)cudaGetLastError();
}

// K10: sigma over the unordered pairs (ctab[i], dtab[i]), c <= d, on the
// card (ops/bigstate.py sigma_pair_tables).
int qt_sigma_swap_f32(float* x, int n, int g, const int* ctab,
                      const int* dtab, int npairs, void* stream) {
    if (g < 1 || g > 8 || 4 * g > n || n > 40 ||
        npairs != ((1 << g) * ((1 << g) + 1)) / 2 ||
        (n - 4 * g) > 15)
        return (int)cudaErrorInvalidValue;
    const int G = 1 << g;
    const int T = G < SIG_TILE ? G : SIG_TILE;
    const dim3 grid((G / T) * (G / T), npairs, 1u << (n - 4 * g));
    sigma_swap_kernel<<<grid, SIG_THREADS, 0, (cudaStream_t)stream>>>(
        x, 1ull << n, n, g, ctab, dtab);
    return (int)cudaGetLastError();
}

}  // extern "C"
