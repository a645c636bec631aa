// Fused pair-channel sweep (K5) for NVIDIA Hopper (sm_90a).
//
// K5 replaces the Pallas kernel quest_tpu/ops/fused.py _chan_sweep_pass
// (pallas_call at fused.py:1440; body _chan_sweep_kernel, :1375; entry
// apply_pair_channel_sweep, :1474).
//
// What it computes.  The state is a float32 SoA array: the real plane
// x[0 .. 2^nn) followed by the imaginary plane.  An ordered list of
// depolarise / damping channels acts on it; channel c has a ket bit t_c
// and a bra bit b_c and combines every element i with its partner
// i ^ m_c, m_c = (1 << t_c) | (1 << b_c):
//
//     x'[i] = w1_c(kt, kb) * x[i] + w2_c(kt, kb) * x[i ^ m_c]
//
// where (kt, kb) are bits t_c and b_c of i.  The weights are real, so the
// two planes transform alike.  The host passes each channel's eight
// weights, evaluated in float32 by the reference's own formulas at the
// four bit patterns (ops/fused.py channel_entry_tables): the exact select
// of fused.py:1413-1416 for a channel whose bra bit is a grid bit of the
// TPU kernel, and wd + (ws0 - wd) k0b0 + (ws1 - wd) k1b1 (:1400) for one
// whose bra bit lies in the TPU's 128 x 128 block.
//
// What bounds it on this card.  Each launch reads and writes the state
// once and does a few flops per element and channel: it is bound by
// bytes.  One launch at 2^28 amplitudes (a 14-qubit density matrix, the
// config-4 noise layer) moves 4.29 GB: at least 1.28 ms at 3.35 TB/s.
//
// Design.  The TPU kernel held 2^3 bra-bit slabs of 128 x 128 co-resident
// in VMEM and moved each partner with sublane reshapes and an exact
// three-term bf16 lane-permutation matmul; here the partner is an XOR on
// the index.  An element's result depends only on its orbit under the
// group generated by the launch's masks: 2^r elements, r being the masks'
// rank over GF(2).  One thread owns one orbit.  The host reduces the masks
// to echelon form, each basis vector with its own pivot bit (always a bra
// bit), and passes the pivots, the 2^r XOR offsets of the orbit and, per
// channel, the subset s_c of basis vectors whose XOR is m_c.  A thread's
// representative index is its orbit index with a zero inserted at each
// pivot, in 64-bit arithmetic; it loads the orbit's 2^r complex values into
// registers, applies the channels in call order (the partner of orbit
// member j under channel c is member j ^ s_c, resolved at compile time by
// a switch on s_c), and stores them back: one read and one write of the
// state per launch, in place, no shared memory and no scratch.  The
// pivots are bra bits, so neighbouring threads touch neighbouring
// addresses; a ket bit below 5 permutes the addresses inside a warp's
// 128-byte segments and costs nothing more.
//
// The channel table is a __grid_constant__ kernel parameter: a channel
// picked by a run-time index is read from the parameter bank, not copied
// to each thread's local memory.
//
// Rank cap.  r <= MAX_RANK = 4 (16 complex values a thread; ptxas -v gives
// the registers).  The wrapper splits a sweep whose masks have a larger
// rank, or more than MAX_ENTRIES channels, into consecutive launches in
// call order: a sweep is only its channels applied one after another, so
// the split is exact.
//
// Register banks.  A density bank (a BatchedQureg of B density
// registers, a contiguous (B, 2, 2^nn) array) under a captured noise
// layer runs each launch once for the whole bank, as the reference's
// jax.vmap of _chan_sweep_pass prepends a grid axis (the channel
// probabilities, hence the weights, are shared across the bank,
// quest_tpu/fusion.py _plan_runner's in_axes): orbit q of the grid-stride
// loop is orbit q mod 2^(nn - r) of element q >> (nn - r), whose planes
// lie 2 * 2^nn floats on per element.  One register is a bank of one.
// The bound is the scalar launch's times B.
//
// Bit identity.  x * w1 and partner * w2 are rounded, then their sum:
// with --fmad=false (ops/build.py) no multiply and add fuse, and the plain
// version (ops/fused.py pair_channel_sweep_plain) takes the same three
// roundings from the same float32 tables.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_RANK = 4;
constexpr int MAX_ENTRIES = 32;
constexpr int CHAN_THREADS = 256;

typedef unsigned long long u64;

struct ChanEntry {
    int t;          // ket bit
    int b;          // bra bit
    int s;          // subset of the basis whose XOR is (1 << t) | (1 << b)
    float w1[4];    // w1 at (kt, kb) = (0,0), (0,1), (1,0), (1,1)
    float w2[4];
};

struct ChanArgs {
    int nent;
    int pivots[MAX_RANK];           // ascending
    u64 orbit[1 << MAX_RANK];       // XOR of the basis vectors in subset j
    ChanEntry e[MAX_ENTRIES];
};

__device__ __forceinline__ float pick(const float (&w)[4], int kt, int kb) {
    return kt ? (kb ? w[3] : w[2]) : (kb ? w[1] : w[0]);
}

// One channel on an orbit held in registers: every member pair
// (j, j ^ S) with j < j ^ S, both members updated from the old values.
template <int R, int S>
__device__ __forceinline__ void apply_pairs(float (&xr)[1 << R],
                                            float (&xi)[1 << R],
                                            const u64 (&idx)[1 << R],
                                            const ChanEntry& e) {
    const float a00 = e.w1[0], a01 = e.w1[1], a10 = e.w1[2], a11 = e.w1[3];
    const float c00 = e.w2[0], c01 = e.w2[1], c10 = e.w2[2], c11 = e.w2[3];
    const float w1[4] = {a00, a01, a10, a11};
    const float w2[4] = {c00, c01, c10, c11};
#pragma unroll
    for (int j = 0; j < (1 << R); ++j) {
        const int p = j ^ S;
        if (j < p) {
            const int kt = (int)((idx[j] >> e.t) & 1ull);
            const int kb = (int)((idx[j] >> e.b) & 1ull);
            // the partner has both bits flipped
            const float w1j = pick(w1, kt, kb), w2j = pick(w2, kt, kb);
            const float w1p = pick(w1, kt ^ 1, kb ^ 1);
            const float w2p = pick(w2, kt ^ 1, kb ^ 1);
            const float rj = xr[j], ij = xi[j], rp = xr[p], ip = xi[p];
            xr[j] = rj * w1j + rp * w2j;
            xi[j] = ij * w1j + ip * w2j;
            xr[p] = rp * w1p + rj * w2p;
            xi[p] = ip * w1p + ij * w2p;
        }
    }
}

// switch on the runtime subset s = 1 .. 2^R - 1
template <int R, int S>
struct Dispatch {
    __device__ __forceinline__ static void run(float (&xr)[1 << R],
                                               float (&xi)[1 << R],
                                               const u64 (&idx)[1 << R],
                                               const ChanEntry& e) {
        if (e.s == S)
            apply_pairs<R, S>(xr, xi, idx, e);
        else
            Dispatch<R, S - 1>::run(xr, xi, idx, e);
    }
};

template <int R>
struct Dispatch<R, 0> {
    __device__ __forceinline__ static void run(float (&)[1 << R],
                                               float (&)[1 << R],
                                               const u64 (&)[1 << R],
                                               const ChanEntry&) {}
};

template <int R>
__global__ void __launch_bounds__(CHAN_THREADS)
chan_sweep_kernel(float* __restrict__ x, u64 num_amps, int orbit_bits,
                  u64 num_orbits, const __grid_constant__ ChanArgs a) {
    constexpr int M = 1 << R;
    const u64 stride = (u64)gridDim.x * blockDim.x;
    for (u64 q = (u64)blockIdx.x * blockDim.x + threadIdx.x; q < num_orbits;
         q += stride) {
        // the bank element and its planes
        float* re = x + (q >> orbit_bits) * 2 * num_amps;
        float* im = re + num_amps;
        u64 rep = q & ((1ull << orbit_bits) - 1ull);
#pragma unroll
        for (int j = 0; j < R; ++j) {
            const u64 low = (1ull << a.pivots[j]) - 1ull;
            rep = ((rep & ~low) << 1) | (rep & low);
        }
        u64 idx[M];
        float xr[M], xi[M];
#pragma unroll
        for (int j = 0; j < M; ++j) {
            idx[j] = rep ^ a.orbit[j];
            xr[j] = re[idx[j]];
            xi[j] = im[idx[j]];
        }
        for (int c = 0; c < a.nent; ++c)
            Dispatch<R, M - 1>::run(xr, xi, idx, a.e[c]);
#pragma unroll
        for (int j = 0; j < M; ++j) {
            re[idx[j]] = xr[j];
            im[idx[j]] = xi[j];
        }
    }
}

template <int R>
static int launch(float* x, long long num_amps, int nbits, int nbank,
                  const ChanArgs& a, int blocks, void* stream) {
    chan_sweep_kernel<R><<<blocks, CHAN_THREADS, 0, (cudaStream_t)stream>>>(
        x, (u64)num_amps, nbits - R, ((u64)num_amps >> R) * (u64)nbank, a);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int qt_chan_max_rank() { return MAX_RANK; }

int qt_chan_max_entries() { return MAX_ENTRIES; }

int qt_chan_threads() { return CHAN_THREADS; }

// x: the bank (nbank states of 2 * num_amps floats, in place; one
// register is nbank = 1); pivots: r ascending bit positions; orbit: 2^r
// offsets; per entry: t, b, s and eight weights (w1[4] then w2[4]).
int qt_chan_sweep_f32(float* x, long long num_amps, int nbank, int r,
                      const int* pivots, const u64* orbit, int nent,
                      const int* t, const int* b, const int* s,
                      const float* w, int blocks, void* stream) {
    if (x == nullptr || num_amps < 2 || (num_amps & (num_amps - 1)) != 0 ||
        nbank < 1 || r < 1 || r > MAX_RANK || nent < 1 ||
        nent > MAX_ENTRIES || blocks < 1)
        return (int)cudaErrorInvalidValue;
    int nbits = 0;
    while ((1LL << nbits) < num_amps) ++nbits;
    ChanArgs a;
    a.nent = nent;
    for (int j = 0; j < r; ++j) {
        if (pivots[j] < 0 || pivots[j] >= nbits ||
            (j > 0 && pivots[j] <= pivots[j - 1]))
            return (int)cudaErrorInvalidValue;
        a.pivots[j] = pivots[j];
    }
    for (int j = 0; j < (1 << r); ++j) {
        if (orbit[j] >= (u64)num_amps) return (int)cudaErrorInvalidValue;
        a.orbit[j] = orbit[j];
    }
    for (int c = 0; c < nent; ++c) {
        if (t[c] < 0 || t[c] >= nbits || b[c] < 0 || b[c] >= nbits ||
            t[c] == b[c] || s[c] < 1 || s[c] >= (1 << r))
            return (int)cudaErrorInvalidValue;
        a.e[c].t = t[c];
        a.e[c].b = b[c];
        a.e[c].s = s[c];
        for (int k = 0; k < 4; ++k) {
            a.e[c].w1[k] = w[8 * c + k];
            a.e[c].w2[k] = w[8 * c + 4 + k];
        }
    }
    switch (r) {
        case 1: return launch<1>(x, num_amps, nbits, nbank, a, blocks, stream);
        case 2: return launch<2>(x, num_amps, nbits, nbank, a, blocks, stream);
        case 3: return launch<3>(x, num_amps, nbits, nbank, a, blocks, stream);
        default:
            return launch<4>(x, num_amps, nbits, nbank, a, blocks, stream);
    }
}


}  // extern "C"
