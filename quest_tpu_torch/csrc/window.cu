// Window pass (K1) and window megakernel (K2) for NVIDIA Hopper (sm_90a).
//
// K1 replaces the Pallas kernel quest_tpu/ops/fused.py
// _apply_window_stack_jit (pallas_call at fused.py:497; body _window_kernel
// and _window_block_body).  K2 replaces _apply_megawin_jit (pallas_call at
// fused.py:799; body _mega_window_kernel).
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
//
// with R = rank <= 4 pairs of complex 128 x 128 matrices (SoA (R,2,128,128))
// and an optional complex (128 w x 128 l) elementwise mask.  A megawin
// group applies a run of such passes whose windows satisfy k <= 7 + g to
// super-blocks of G = 2^g consecutive 128 x 128 canonical rows: every
// window bit of every pass lies inside the super-block, so the passes can
// run back to back on it.
//
// What bounds them on this card.  A dual-side rank-1 pass at 2^26
// amplitudes moves 1.07 GB (0.32 ms at 3.35 TB/s) but does 2^26 * 2048 =
// 1.37e11 real flops (2.0 ms at the 67 TFLOP/s FP32 rate of the CUDA
// cores): the kernels are bound by operations, not by device memory.
// This first design runs the products on the CUDA cores in full FP32
// (or FP64) with explicit fma; the tensor cores (3xTF32 split, DMMA for
// FP64) are left to a later change.  No TF32 anywhere.
//
// Design.  One CTA of 256 threads owns one slab and one 32-lane chunk of
// its output columns (4 CTAs per slab): Y[:, chunk] depends on all of X
// but only on rows `chunk` of each A_r, so the chunks are independent.
// The CTA computes T = X A_r^T[:, chunk] with K (the lane contraction)
// streamed through shared memory in 32-wide tiles, parks T (128 x 32
// complex) in shared memory, then accumulates B_r T with B streamed the
// same way.  Each thread owns a 4 x 4 register tile of outputs.  Shared
// memory per CTA: 76 KB (f32) or 152 KB (f64); a full 128 x 128 slab plus
// an intermediate would not fit in the 227 KB a block may use at f64.
//
// Out of place.  The 4 CTAs of a slab all read the whole slab, so no CTA
// may overwrite it: both kernels write to a separate output buffer and the
// executor ping-pongs buffers (at 26 qubits f32 the second buffer is
// 512 MB).
//
// K2 runs a persistent grid of thread-block clusters (4 CTAs each for
// G = 1, 8 for G >= 2), no more than the card holds at once; each cluster
// takes super-blocks in turn.  On a super-block the cluster walks the
// group's passes in order; within a pass its CTAs share the super-block's
// 4G (slab, chunk) items, and a cluster barrier separates passes.  The
// first pass reads the state; from there the passes alternate between the
// super-block's place in the output buffer and a super-block-sized scratch
// buffer that belongs to the cluster (G = 8: 1 MB at f32), so that the
// last lands in the output; the 50 MB L2 serves both while they are hot.
// So K2, like K1, holds the state twice (input and output) plus one
// super-block per resident cluster, tens of MB: never a third full-size
// buffer.
// Both kernels run every (slab, chunk) item through the SAME device
// function, slab_chunk_pass, whose inner products are explicit fma in a
// fixed order, and the file is compiled with --fmad=false: a megawin group
// is bit-identical to its passes run one by one through K1.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int DIM = 128;           // window / lane extent
constexpr int LC = 32;             // output lanes per CTA
constexpr int NCHUNK = DIM / LC;   // CTAs per slab
constexpr int KC = 32;             // contraction tile
constexpr int NTHREADS = 256;
// CTAs per SM the kernels are compiled for: shared memory admits two at
// f32 and one at f64.  Saying so (with the contraction loops unrolled by
// two) lets ptxas keep the next step's operands in flight; left to itself
// it gave K2 fewer registers, and K2 ran 8 % slower on an H100.
template <typename T>
constexpr int ctas_per_sm() { return sizeof(T) == 4 ? 2 : 1; }
constexpr int MPAD = KC + 1;       // row stride (complex) of the K tiles
constexpr int TPAD = LC + 1;       // row stride (complex) of the T tile
constexpr int MAX_MEGA_PASSES = 16;

}  // namespace

// One window pass as the kernels see it; the same layout as the host-side
// ctypes structure in ops/fused.py.
struct QtPass {
    int k;          // window offset
    int rank;       // number of Kronecker terms R
    int apply_a;    // lane side present
    int apply_b;    // window side present
    const void* a;  // (R, 2, 128, 128) SoA lane matrices
    const void* b;  // (R, 2, 128, 128) SoA window matrices
    const void* mask;  // (2, 128, 128) SoA (window, lane) mask, or null
};

struct QtMegaArgs {
    int npass;
    int g_rows;     // G: canonical rows per super-block
    QtPass p[MAX_MEGA_PASSES];
};

template <typename T> struct Cplx;
template <> struct Cplx<float> { using type = float2; };
template <> struct Cplx<double> { using type = double2; };

__device__ __forceinline__ float fma_t(float a, float b, float c) {
    return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
    return fma(a, b, c);
}

// acc += x * y (complex), four fma in a fixed order.
template <typename V>
__device__ __forceinline__ void cmac(V& acc, const V x, const V y) {
    acc.x = fma_t(x.x, y.x, acc.x);
    acc.x = fma_t(-x.y, y.y, acc.x);
    acc.y = fma_t(x.x, y.y, acc.y);
    acc.y = fma_t(x.y, y.x, acc.y);
}

template <typename T>
constexpr size_t smem_bytes() {
    return sizeof(typename Cplx<T>::type) *
           (size_t)(DIM * MPAD + KC * TPAD + DIM * TPAD);
}

// One (slab, lane chunk) item of one window pass: reads the slab at
// `base` (row stride `wstride`, lane stride 1) of the real and imaginary
// planes `xr`, `xi`, writes output lanes [l0, l0 + LC) of every row to the
// same place in the planes `yr`, `yi`.  The state is read with __ldcg (L2
// only, never the non-coherent L1 path): inside K2 a pass reads what other
// CTAs of the cluster wrote in the previous pass.
template <typename T>
__device__ void slab_chunk_pass(const T* xr, const T* xi, T* yr, T* yi,
                                long long base, long long wstride, int l0,
                                const QtPass& p,
                                typename Cplx<T>::type* smem) {
    using V = typename Cplx<T>::type;
    V* tile_m = smem;                     // [DIM][MPAD]: X or B K-tile
    V* tile_a = tile_m + DIM * MPAD;      // [KC][TPAD]: A K-tile, transposed
    V* tile_t = tile_a + KC * TPAD;       // [DIM][TPAD]: T = X A^T chunk
    const int tid = threadIdx.x;
    const int lg = tid % 8;               // lanes lg + 8 j
    const int wg = tid / 8;               // rows wg + 32 i
    const long long mat = (long long)DIM * DIM;
    const T* A = static_cast<const T*>(p.a);
    const T* B = static_cast<const T*>(p.b);

    V yacc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) yacc[i][j] = V{0, 0};

    for (int r = 0; r < p.rank; ++r) {
        if (p.apply_a) {
            // T[w][lc] = sum_l X[w][l] A_r[l0 + lc][l]
            const T* Ar = A + (long long)r * 2 * mat;
            V tacc[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) tacc[i][j] = V{0, 0};
            for (int k0 = 0; k0 < DIM; k0 += KC) {
                __syncthreads();
#pragma unroll 4
                for (int e = 0; e < DIM * KC / NTHREADS; ++e) {
                    const int idx = tid + e * NTHREADS;
                    const int w = idx / KC, kk = idx % KC;
                    const long long off = base + w * wstride + k0 + kk;
                    tile_m[w * MPAD + kk] = V{__ldcg(xr + off),
                                              __ldcg(xi + off)};
                }
#pragma unroll
                for (int e = 0; e < LC * KC / NTHREADS; ++e) {
                    const int idx = tid + e * NTHREADS;
                    const int lc = idx / KC, kk = idx % KC;
                    const long long o = (long long)(l0 + lc) * DIM + k0 + kk;
                    tile_a[kk * TPAD + lc] = V{Ar[o], Ar[o + mat]};
                }
                __syncthreads();
#pragma unroll 2
                for (int kk = 0; kk < KC; ++kk) {
                    V av[4], xv[4];
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        av[j] = tile_a[kk * TPAD + lg + 8 * j];
#pragma unroll
                    for (int i = 0; i < 4; ++i)
                        xv[i] = tile_m[(wg + 32 * i) * MPAD + kk];
#pragma unroll
                    for (int i = 0; i < 4; ++i)
#pragma unroll
                        for (int j = 0; j < 4; ++j)
                            cmac(tacc[i][j], xv[i], av[j]);
                }
            }
            if (!p.apply_b) {
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        yacc[i][j].x = yacc[i][j].x + tacc[i][j].x;
                        yacc[i][j].y = yacc[i][j].y + tacc[i][j].y;
                    }
                continue;
            }
            // every thread finished the previous rank's reads of tile_t
            // at the first barrier of the K loop above
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    tile_t[(wg + 32 * i) * TPAD + lg + 8 * j] = tacc[i][j];
        } else {
            // B-only: T is the slab's own lane chunk
            __syncthreads();
#pragma unroll 4
            for (int e = 0; e < DIM * LC / NTHREADS; ++e) {
                const int idx = tid + e * NTHREADS;
                const int w = idx / LC, lc = idx % LC;
                const long long off = base + w * wstride + l0 + lc;
                tile_t[w * TPAD + lc] = V{__ldcg(xr + off),
                                          __ldcg(xi + off)};
            }
        }
        // yacc[w'][lc] += sum_w B_r[w'][w] T[w][lc]
        const T* Br = B + (long long)r * 2 * mat;
        for (int k0 = 0; k0 < DIM; k0 += KC) {
            __syncthreads();
#pragma unroll 4
            for (int e = 0; e < DIM * KC / NTHREADS; ++e) {
                const int idx = tid + e * NTHREADS;
                const int w = idx / KC, kk = idx % KC;
                const long long o = (long long)w * DIM + k0 + kk;
                tile_m[w * MPAD + kk] = V{Br[o], Br[o + mat]};
            }
            __syncthreads();
#pragma unroll 2
            for (int kk = 0; kk < KC; ++kk) {
                V bv[4], tv[4];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    bv[i] = tile_m[(wg + 32 * i) * MPAD + kk];
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    tv[j] = tile_t[(k0 + kk) * TPAD + lg + 8 * j];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        cmac(yacc[i][j], bv[i], tv[j]);
            }
        }
    }
    // every thread is done with the shared tiles before the next item
    __syncthreads();

    const T* M = static_cast<const T*>(p.mask);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int w = wg + 32 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int l = l0 + lg + 8 * j;
            T vr = yacc[i][j].x, vi = yacc[i][j].y;
            if (M != nullptr) {
                const T mr = M[w * DIM + l], mi = M[mat + w * DIM + l];
                const T nr = fma_t(vr, mr, -(vi * mi));
                const T ni = fma_t(vr, mi, vi * mr);
                vr = nr;
                vi = ni;
            }
            const long long off = base + w * wstride + l;
            yr[off] = vr;
            yi[off] = vi;
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS, ctas_per_sm<T>())
window_pass_kernel(const T* __restrict__ x, T* __restrict__ y,
                   long long plane, QtPass p) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    auto* smem = reinterpret_cast<typename Cplx<T>::type*>(smem_raw);
    const int chunk = blockIdx.x % NCHUNK;
    const long long slab = blockIdx.x / NCHUNK;
    const long long mid = 1LL << (p.k - 7);
    const long long h = slab / mid, m = slab % mid;
    slab_chunk_pass<T>(x, x + plane, y, y + plane,
                       (h * DIM * mid + m) * DIM, mid * DIM, chunk * LC, p,
                       smem);
}

// A super-block of G canonical rows is G * 128 * 128 consecutive
// amplitudes of each plane, and a pass's slabs lie at the same offsets
// relative to its start wherever it is stored: in the state (planes 2^n
// apart) or in a cluster's scratch buffer (planes G * 128 * 128 apart).
template <typename T>
__global__ void __launch_bounds__(NTHREADS, ctas_per_sm<T>())
megawin_kernel(const T* __restrict__ x, T* out, T* scratch, long long plane,
               long long nsb, QtMegaArgs args) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    auto* smem = reinterpret_cast<typename Cplx<T>::type*>(smem_raw);
    cg::cluster_group cluster = cg::this_cluster();
    const int csize = (int)cluster.num_blocks();
    const int crank = (int)cluster.block_rank();
    const long long ncl = gridDim.x / csize;
    const long long cid = blockIdx.x / csize;
    const int G = args.g_rows;
    const int items = G * NCHUNK;
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
                const int chunk = it % NCHUNK;
                const long long j = it / NCHUNK;
                slab_chunk_pass<T>(sr, si, dr, di,
                                   ((j / mid) * DIM * mid + j % mid) * DIM,
                                   mid * DIM, chunk * LC, p, smem);
            }
            // the pass is visible to the whole cluster before the next one
            // reads it, and before the next super-block's first pass
            // overwrites a buffer this pass may have read
            __threadfence();
            cluster.sync();
            sr = dr;
            si = di;
        }
    }
}

template <typename T>
static int launch_window_pass(const T* x, T* y, int n, const QtPass* pass,
                              void* stream) {
    if (pass == nullptr || n < 14 || pass->k < 7 || pass->k > n - 7 ||
        pass->rank < 1 || !(pass->apply_a || pass->apply_b))
        return (int)cudaErrorInvalidValue;
    const size_t smem = smem_bytes<T>();
    cudaError_t err = cudaFuncSetAttribute(
        window_pass_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const long long plane = 1LL << n;
    const long long nslab = 1LL << (n - 14);
    window_pass_kernel<T><<<(unsigned)(nslab * NCHUNK), NTHREADS, smem,
                            (cudaStream_t)stream>>>(x, y, plane, *pass);
    return (int)cudaGetLastError();
}

// CTAs per cluster for super-blocks of g rows (4g (slab, chunk) items).
static int cluster_size(long long g) { return (int)(4 * g < 8 ? 4 * g : 8); }

template <typename T>
static void megawin_config(long long g, long long nclusters,
                           cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr, void* stream) {
    const int csize = cluster_size(g);
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
        (npass > 1 && scratch == nullptr))
        return (int)cudaErrorInvalidValue;
    QtMegaArgs args;
    args.npass = npass;
    int kmax = 7;
    for (int i = 0; i < npass; ++i) {
        const QtPass& p = passes[i];
        if (p.k < 7 || p.k > n - 7 || p.rank < 1 ||
            !(p.apply_a || p.apply_b))
            return (int)cudaErrorInvalidValue;
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

const char* qt_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
