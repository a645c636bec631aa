// The HBM stream pass (P1) for NVIDIA Hopper (sm_90a).
//
// P1 replaces the Pallas kernel of the TPU probe
// scripts/probes/profile_dma.py (pallas_call at profile_dma.py:52, built
// by make_pallas_chain; bodies copy_kernel :39 and scale_kernel :43).  The
// probe asked what rate a plain stream of the state reaches, as the
// roofline every pass bound by bytes is judged against.
//
// What it computes.  The state is a real SoA array: the real plane
// x[0 .. 2^n) followed by the imaginary plane x[2^n .. 2^(n+1)), seen as
// the canonical view (2, hi, 128, 128) with hi = 2^(n - 14).  The pass is
// out = x (copy) or out = s * x (scale; the probe's s is 2), in place (the
// reference's input_output_aliases={0: 0}) or into a separate output.  The
// reference walked the view in grid steps of R rows of 128 x 128
// amplitudes of both planes; here one CTA takes one such tile, so the grid
// is hi / R CTAs.  R changes only the tiling, never the result.
//
// What bounds it on this card.  Each amplitude is read once and written
// once, with at most one multiply: the pass is bound by bytes.  At 26
// qubits in float32 it moves 2 * 2 * 4 * 2^26 bytes (1.074 GB: 0.537 GB
// read plus 0.537 GB written), so it takes at least 1.074 GB / 3.35 TB/s
// = 0.321 ms.
//
// Design.  16-byte vector loads and stores (float4), neighbouring threads
// on neighbouring vectors.  Each thread loads STREAM_UNROLL vectors, then
// stores them, so a few loads are in flight per thread.  A thread writes
// only the vectors it has read itself, so in place is safe: no other
// thread reads what it writes.  The pointers carry no __restrict__ for the
// same reason (in place they alias).  No multiply-add can form (one
// multiply at most), so a scaled value rounds as its plain version's
// float32 product does: the kernel equals its plain version bit for bit.
// At large R the grid under-fills the card: 2^26 amplitudes make 4096
// rows, so R = 64 is 64 CTAs for 132 SMs.  That is the answer to the
// probe's question about the block size, and it is kept.

#include <cuda_runtime.h>

namespace {

constexpr int STREAM_THREADS = 512;
constexpr int STREAM_UNROLL = 4;
constexpr int ROW_VECS = 128 * 128 / 4;   // float4 vectors in one row

template <bool SCALE>
__global__ void __launch_bounds__(STREAM_THREADS)
stream_pass_kernel(const float4* in, float4* out, long long plane_vecs,
                   int tile_vecs, float scale) {
    const long long first = (long long)blockIdx.x * tile_vecs;
    for (int plane = 0; plane < 2; ++plane) {
        const long long base = plane * plane_vecs + first;
        for (int v0 = threadIdx.x; v0 < tile_vecs;
             v0 += STREAM_THREADS * STREAM_UNROLL) {
            float4 r[STREAM_UNROLL];
#pragma unroll
            for (int u = 0; u < STREAM_UNROLL; ++u) {
                const int v = v0 + u * STREAM_THREADS;
                if (v < tile_vecs) r[u] = in[base + v];
            }
#pragma unroll
            for (int u = 0; u < STREAM_UNROLL; ++u) {
                const int v = v0 + u * STREAM_THREADS;
                if (v < tile_vecs) {
                    float4 x = r[u];
                    if (SCALE) {
                        x.x *= scale;
                        x.y *= scale;
                        x.z *= scale;
                        x.w *= scale;
                    }
                    out[base + v] = x;
                }
            }
        }
    }
}

}  // namespace

extern "C" {

// One stream pass over a (2, hi, 128, 128) float32 state: op 0 copies, op
// 1 scales by ``scale``; ``out`` may equal ``in`` (in place).  ``rows`` is
// R, the rows of 128 x 128 amplitudes one CTA takes (at most 4096); it
// must divide hi.
int qt_stream_pass(const float* in, float* out, long long hi, int rows,
                   int op, float scale, void* stream) {
    if (hi < 1 || rows < 1 || rows > 4096 || hi % rows != 0 ||
        (op != 0 && op != 1) || hi / rows > 0x7fffffffLL ||
        ((unsigned long long)in | (unsigned long long)out) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    const long long plane_vecs = hi * ROW_VECS;
    const int tile_vecs = rows * ROW_VECS;
    const dim3 grid((unsigned)(hi / rows));
    const float4* src = reinterpret_cast<const float4*>(in);
    float4* dst = reinterpret_cast<float4*>(out);
    if (op == 0)
        stream_pass_kernel<false><<<grid, STREAM_THREADS, 0,
                                    (cudaStream_t)stream>>>(
            src, dst, plane_vecs, tile_vecs, scale);
    else
        stream_pass_kernel<true><<<grid, STREAM_THREADS, 0,
                                   (cudaStream_t)stream>>>(
            src, dst, plane_vecs, tile_vecs, scale);
    return (int)cudaGetLastError();
}

}  // extern "C"
