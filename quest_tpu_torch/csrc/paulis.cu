// Direct Pauli rotation (K3) and Pauli-term expectation (K4) for NVIDIA
// Hopper (sm_90a).
//
// K3 replaces the Pallas kernel quest_tpu/ops/paulis.py
// _direct_rotation_pallas (pallas_call at paulis.py:625; body
// _pl_rotation_kernel on _pl_flip_signed, inputs _pl_term_inputs, grid
// _pl_grid_spec).  K4 replaces _expec_term_pallas (pallas_call at
// paulis.py:602; body _pl_expec_kernel).
//
// What they compute.  The state is a real SoA array: the real plane
// x[0 .. 2^n) followed by the imaginary plane x[2^n .. 2^(n+1)); qubit q is
// bit q of the amplitude index.  A Pauli string P is given on the host as
// fm (the bits of its X and Y factors), zm (the bits of its Y and Z
// factors) and c = (-i)^{#Y}, whose imaginary part is negated for the
// conjugated bra twin of a density matrix.  Then
//
//     (P psi)[i] = c * (-1)^{popc(i & zm)} * psi[i ^ fm]
//
// K3:  psi <- cos(theta/2) psi - i sin(theta/2) (P psi), in place;
// K4:  partial[b] = sum over the amplitudes block b visits of
//      Re(conj(psi[i]) (P psi)[i]), summed by the caller.
//
// What bounds them on this card.  Each amplitude is read once (K3, K4)
// and written once (K3), for about ten flops: both are bound by bytes.
// At 30 qubits in float32 the state is 8.59 GB, so a K3 term takes at
// least 2 * 8.59 GB / 3.35 TB/s = 5.13 ms and a K4 term 2.56 ms.
//
// Design.  The TPU kernel moved the flip with 256 x 256 and 128 x 128
// permutation matmuls (Mosaic has no lane reversal) and a block-index XOR
// in its BlockSpec (DMA redirection); here the whole flip is one XOR on the
// load address.  When fm != 0 one thread owns the pair {i, i ^ fm}, i being
// the member whose bit h = highbit(fm) is clear: the pair index p gets a
// zero bit inserted at h, so neighbouring threads touch neighbouring
// addresses, and the thread reads both amplitudes from both planes and
// writes both.  No other thread touches the pair, so K3 runs in place: the
// state is read once and written once (the reference's out-of-place form
// moves it three times) and no second buffer is allocated.  When fm = 0 (a
// Z-only or all-identity term) one thread owns one amplitude.  Indices are
// 64-bit and the grid is a fixed number of blocks walking the index space
// in a grid-stride loop: a 32-qubit state has 2^32 amplitudes.
//
// Bit identity.  K3 takes its products in the order of its plain version
// (ops/paulis.py direct_rotation_plain), and the file is compiled with
// --fmad=false, so no multiply and add fuse:
//     pr = s * (c_re * f0 - c_im * f1),  pi = s * (c_re * f1 + c_im * f0),
//     out0 = co * x0 + si * pi,          out1 = co * x1 - si * pr,
// with (f0, f1) the partner amplitude and s = +-1.  co and si arrive from
// the host, computed once per term in the state's type, the same scalars
// the plain version uses.
//
// K4 accumulates in float64 for both types (a pass bound by bytes leaves
// the FP64 rate to spare), reduces each block by warp shuffles and shared
// memory, and writes one partial per block: the grid is fixed, there are
// no float atomics, and the result is the same from run to run.  The
// wrapper sums the partials with torch.sum, as the TPU kernel's per-block
// partials were summed outside it (paulis.py:609).

#include <cuda_runtime.h>

namespace {

constexpr int PAULI_THREADS = 256;

typedef unsigned long long u64;

template <typename T>
struct PauliTerm {
    u64 fm;     // flip mask: X and Y bits
    u64 zm;     // sign mask: Y and Z bits
    int h;      // highest set bit of fm (unused when fm == 0)
    T c_re;     // (-i)^{#Y}, conjugated for the bra twin
    T c_im;
};

__device__ __forceinline__ u64 insert_zero_bit(u64 p, int h) {
    const u64 low = (1ull << h) - 1ull;
    return ((p & ~low) << 1) | (p & low);
}

template <typename T>
__device__ __forceinline__ T parity_sign(u64 i, u64 zm) {
    return (__popcll(i & zm) & 1) ? T(-1) : T(1);
}

// (pr, pi) = c * s * (f0 + i f1): P psi at an index whose partner
// amplitude is (f0, f1) and whose parity sign is s.
template <typename T>
__device__ __forceinline__ void signed_partner(T f0, T f1, T s,
                                               const PauliTerm<T>& t,
                                               T& pr, T& pi) {
    pr = s * (t.c_re * f0 - t.c_im * f1);
    pi = s * (t.c_re * f1 + t.c_im * f0);
}

template <typename T>
__global__ void __launch_bounds__(PAULI_THREADS)
pauli_rotation_kernel(T* __restrict__ re, T* __restrict__ im, u64 num_amps,
                      PauliTerm<T> t, T co, T si) {
    const u64 stride = (u64)gridDim.x * blockDim.x;
    const u64 first = (u64)blockIdx.x * blockDim.x + threadIdx.x;
    if (t.fm == 0) {
        for (u64 i = first; i < num_amps; i += stride) {
            const T x0 = re[i], x1 = im[i];
            T pr, pi;
            signed_partner(x0, x1, parity_sign<T>(i, t.zm), t, pr, pi);
            re[i] = co * x0 + si * pi;
            im[i] = co * x1 - si * pr;
        }
        return;
    }
    const u64 num_pairs = num_amps >> 1;
    for (u64 p = first; p < num_pairs; p += stride) {
        const u64 i = insert_zero_bit(p, t.h);
        const u64 j = i ^ t.fm;
        const T xi0 = re[i], xi1 = im[i];
        const T xj0 = re[j], xj1 = im[j];
        T pri, pii, prj, pij;
        signed_partner(xj0, xj1, parity_sign<T>(i, t.zm), t, pri, pii);
        signed_partner(xi0, xi1, parity_sign<T>(j, t.zm), t, prj, pij);
        re[i] = co * xi0 + si * pii;
        im[i] = co * xi1 - si * pri;
        re[j] = co * xj0 + si * pij;
        im[j] = co * xj1 - si * prj;
    }
}

// Sum of a block's per-thread values; thread 0 gets the total.
__device__ __forceinline__ double block_sum(double v) {
    __shared__ double warp_sums[PAULI_THREADS / 32];
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if (lane == 0) warp_sums[warp] = v;
    __syncthreads();
    v = 0.0;
    if (warp == 0) {
        if (lane < PAULI_THREADS / 32) v = warp_sums[lane];
        for (int off = 16; off > 0; off >>= 1)
            v += __shfl_down_sync(0xffffffffu, v, off);
    }
    return v;
}

template <typename T>
__device__ __forceinline__ double re_product(T x0, T x1, T pr, T pi) {
    return (double)x0 * (double)pr + (double)x1 * (double)pi;
}

template <typename T>
__global__ void __launch_bounds__(PAULI_THREADS)
pauli_expec_kernel(const T* __restrict__ re, const T* __restrict__ im,
                   u64 num_amps, PauliTerm<T> t,
                   double* __restrict__ partials) {
    const u64 stride = (u64)gridDim.x * blockDim.x;
    const u64 first = (u64)blockIdx.x * blockDim.x + threadIdx.x;
    double acc = 0.0;
    if (t.fm == 0) {
        for (u64 i = first; i < num_amps; i += stride) {
            const T x0 = re[i], x1 = im[i];
            T pr, pi;
            signed_partner(x0, x1, parity_sign<T>(i, t.zm), t, pr, pi);
            acc += re_product(x0, x1, pr, pi);
        }
    } else {
        const u64 num_pairs = num_amps >> 1;
        for (u64 p = first; p < num_pairs; p += stride) {
            const u64 i = insert_zero_bit(p, t.h);
            const u64 j = i ^ t.fm;
            const T xi0 = re[i], xi1 = im[i];
            const T xj0 = re[j], xj1 = im[j];
            T pri, pii, prj, pij;
            signed_partner(xj0, xj1, parity_sign<T>(i, t.zm), t, pri, pii);
            signed_partner(xi0, xi1, parity_sign<T>(j, t.zm), t, prj, pij);
            acc += re_product(xi0, xi1, pri, pii);
            acc += re_product(xj0, xj1, prj, pij);
        }
    }
    acc = block_sum(acc);
    if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

template <typename T>
static int make_term(long long num_amps, u64 fm, u64 zm, T c_re, T c_im,
                     int blocks, PauliTerm<T>* t) {
    if (num_amps < 2 || (num_amps & (num_amps - 1)) != 0 || blocks < 1 ||
        fm >= (u64)num_amps || zm >= (u64)num_amps)
        return (int)cudaErrorInvalidValue;
    t->fm = fm;
    t->zm = zm;
    t->h = fm ? 63 - __builtin_clzll(fm) : 0;
    t->c_re = c_re;
    t->c_im = c_im;
    return 0;
}

template <typename T>
static int launch_rotation(T* x, long long num_amps, u64 fm, u64 zm,
                           T c_re, T c_im, T co, T si, int blocks,
                           void* stream) {
    PauliTerm<T> t;
    const int bad = make_term(num_amps, fm, zm, c_re, c_im, blocks, &t);
    if (bad) return bad;
    pauli_rotation_kernel<T><<<blocks, PAULI_THREADS, 0,
                               (cudaStream_t)stream>>>(
        x, x + num_amps, (u64)num_amps, t, co, si);
    return (int)cudaGetLastError();
}

template <typename T>
static int launch_expec(const T* x, long long num_amps, u64 fm, u64 zm,
                        T c_re, T c_im, double* partials, int blocks,
                        void* stream) {
    PauliTerm<T> t;
    const int bad = make_term(num_amps, fm, zm, c_re, c_im, blocks, &t);
    if (bad) return bad;
    pauli_expec_kernel<T><<<blocks, PAULI_THREADS, 0,
                            (cudaStream_t)stream>>>(
        x, x + num_amps, (u64)num_amps, t, partials);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int qt_pauli_threads() { return PAULI_THREADS; }

int qt_pauli_rotation_f32(float* x, long long num_amps, u64 fm, u64 zm,
                          float c_re, float c_im, float co, float si,
                          int blocks, void* stream) {
    return launch_rotation<float>(x, num_amps, fm, zm, c_re, c_im, co, si,
                                  blocks, stream);
}

int qt_pauli_rotation_f64(double* x, long long num_amps, u64 fm, u64 zm,
                          double c_re, double c_im, double co, double si,
                          int blocks, void* stream) {
    return launch_rotation<double>(x, num_amps, fm, zm, c_re, c_im, co, si,
                                   blocks, stream);
}

int qt_pauli_expec_f32(const float* x, long long num_amps, u64 fm, u64 zm,
                       float c_re, float c_im, double* partials, int blocks,
                       void* stream) {
    return launch_expec<float>(x, num_amps, fm, zm, c_re, c_im, partials,
                               blocks, stream);
}

int qt_pauli_expec_f64(const double* x, long long num_amps, u64 fm, u64 zm,
                       double c_re, double c_im, double* partials, int blocks,
                       void* stream) {
    return launch_expec<double>(x, num_amps, fm, zm, c_re, c_im, partials,
                                blocks, stream);
}

}  // extern "C"
