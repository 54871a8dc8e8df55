// K3 — a per-channel bias, an optional residual and an optional ReLU as one
// pass over a 16-bit activation, hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel. In the JAX package XLA fuses eval BatchNorm's
// affine, the residual add and the ReLU into the operations around each
// convolution, so no Pallas kernel computes them. The port folds BN's scale
// into the convolution's weight (stdd_torch/models/i3d.py::Conv3dBN) and
// runs what is left of BN, the residual and the ReLU as this one pass: its
// counterpart of XLA's fusion.
//
// What it computes, in place, over y viewed as [N, C] with C innermost (a
// channels_last_3d NCTHW tensor, whose memory is [B, T, H, W, C]):
//
//   y[n, c] <- act(y[n, c] + b[c] (+ r[n, c]))
//
// y and r bf16 or fp16 of the same shape and layout, b float32 [C], act the
// identity or ReLU. The arithmetic is float32: t = float(y) + b[c], then
// t + float(r), each add rounded to float32 (__fadd_rn), ReLU as PyTorch's
// (NaN kept, else fmaxf(t, 0)), and one rounding to the element type at the
// end (round to nearest even). The plain version
// (stdd_torch/ops/bias_act.py::bias_act_reference) does the same operations
// in the same order, so the two agree bit for bit.
//
// Bound: memory. The card must read y (and r) once and write y once: 4 (6)
// bytes an element. At the I3D's widest pass, s2's last convolution at a
// batch of 8 clips ([8, 256, 32, 56, 56], 205.5 M elements, with its
// residual), that is 1.23 GB, 0.368 ms at 3.35 TB/s; its stem's
// ([8, 64, 32, 112, 112], no residual) 0.82 GB, 0.245 ms. The arithmetic
// (two adds and a max an element) is far below any compute bound.
//
// Design against that bound:
// - 16-byte accesses: a thread takes 8 consecutive elements (one uint4 of
//   y, one of r), which C % 8 == 0 keeps inside one position's channels, so
//   every warp access is 512 contiguous bytes in whole 32-byte sectors.
// - The bias in registers: the grid is a grid-stride loop whose stride (in
//   8-element vectors) is a multiple of C / 8, so each thread meets the same
//   8 channels at every step and loads their 8 float32 biases once.
// - Bytes in flight: each step of the loop issues kUnroll = 4 independent
//   loads of y (and of r) before it computes or stores any, 64 (128) bytes a
//   thread. The grid is one wave: as many blocks of 256 threads as the
//   occupancy calculator lets an SM keep resident (5 at 48 registers
//   without r, 4 at 64 with it, as ptxas reports), times the SMs, so the
//   132 SMs of an H100 keep about 11 (17) MB in flight, far more than the
//   HBM's bandwidth-latency product (about 3 MB), and no block waits for a
//   second wave.
// - r is read through the read-only path (ld.global.nc); y, which the same
//   thread writes back, through the ordinary one.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;            // independent 16-byte vectors a thread has in flight

__device__ __forceinline__ float2 to_float2(uint32_t v, __nv_bfloat16) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
__device__ __forceinline__ float2 to_float2(uint32_t v, __half) {
    return __half22float2(*reinterpret_cast<const __half2*>(&v));
}
__device__ __forceinline__ uint32_t from_float2(float a, float b, __nv_bfloat16) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t from_float2(float a, float b, __half) {
    const __half2 h = __floats2half2_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
}

// PyTorch's ReLU on the card (clamp_min(0)): NaN stays NaN
__device__ __forceinline__ float relu(float t) { return isnan(t) ? t : fmaxf(t, 0.f); }

// one element: float32 adds in the plain version's order, ReLU, no rounding yet
template <bool kRelu, bool kRes>
__device__ __forceinline__ float act(float y, float b, float r) {
    float t = __fadd_rn(y, b);
    if (kRes) t = __fadd_rn(t, r);
    return kRelu ? relu(t) : t;
}

// 8 elements (one uint4) of one position: channels 8 g .. 8 g + 7
template <typename T, bool kRelu, bool kRes>
__device__ __forceinline__ uint4 apply8(uint4 v, uint4 rv, const float* b) {
    const uint32_t* vw = reinterpret_cast<const uint32_t*>(&v);
    const uint32_t* rw = reinterpret_cast<const uint32_t*>(&rv);
    uint4 out;
    uint32_t* ow = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const float2 y2 = to_float2(vw[k], T());
        const float2 r2 = kRes ? to_float2(rw[k], T()) : make_float2(0.f, 0.f);
        ow[k] = from_float2(act<kRelu, kRes>(y2.x, b[2 * k], r2.x),
                            act<kRelu, kRes>(y2.y, b[2 * k + 1], r2.y), T());
    }
    return out;
}

// grid-stride over the nvec 8-element vectors of y; gridDim.x * kThreads is
// a multiple of cvec = C / 8 (the host picks the grid), so vector i always
// holds channels 8 (i % cvec) .. + 7 of this thread
template <typename T, bool kRelu, bool kRes>
__global__ void __launch_bounds__(kThreads)
bias_act_kernel(uint4* __restrict__ y, const uint4* __restrict__ r,
                const float* __restrict__ bias, long long nvec, int cvec) {
    const long long stride = static_cast<long long>(gridDim.x) * kThreads;
    long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    if (i >= nvec) return;
    const float4* b4 = reinterpret_cast<const float4*>(bias) + 2 * (i % cvec);
    const float4 lo = __ldg(b4), hi = __ldg(b4 + 1);
    const float b[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    for (; i < nvec; i += kUnroll * stride) {
        uint4 v[kUnroll], rv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const long long j = i + u * stride;
            if (j < nvec) {
                v[u] = y[j];
                rv[u] = kRes ? __ldg(r + j) : make_uint4(0, 0, 0, 0);
            }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const long long j = i + u * stride;
            if (j < nvec) y[j] = apply8<T, kRelu, kRes>(v[u], rv[u], b);
        }
    }
}

long long gcd(long long a, long long b) {
    while (b) {
        const long long t = a % b;
        a = b;
        b = t;
    }
    return a;
}

// one wave of blocks over every SM (fewer for a small tensor), rounded up so
// that the grid's threads are a multiple of cvec
template <typename T, bool kRelu, bool kRes>
cudaError_t launch_one(uint4* y, const uint4* r, const float* bias, long long nvec, int cvec,
                       cudaStream_t st) {
    auto kernel = bias_act_kernel<T, kRelu, kRes>;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    const long long wave = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
    long long want = (nvec + static_cast<long long>(kThreads) * kUnroll - 1) /
                     (static_cast<long long>(kThreads) * kUnroll);
    want = want < wave ? want : wave;
    const long long m = cvec / gcd(cvec, kThreads);
    const long long grid = (want + m - 1) / m * m;
    if (grid > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    kernel<<<static_cast<int>(grid), kThreads, 0, st>>>(y, r, bias, nvec, cvec);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch(void* y, const void* r, const float* bias, long long nvec, int cvec, int relu,
                   cudaStream_t st) {
    uint4* yv = static_cast<uint4*>(y);
    const uint4* rv = static_cast<const uint4*>(r);
    if (relu && rv) return launch_one<T, true, true>(yv, rv, bias, nvec, cvec, st);
    if (relu) return launch_one<T, true, false>(yv, rv, bias, nvec, cvec, st);
    if (rv) return launch_one<T, false, true>(yv, rv, bias, nvec, cvec, st);
    return launch_one<T, false, false>(yv, rv, bias, nvec, cvec, st);
}

}  // namespace

// Plain C entry point (bound with ctypes). y (and r, or null) hold
// n_elems 16-bit elements with C = channels innermost; the wrapper has
// checked C % 8 == 0, 16-byte alignment and that r does not overlap y.
// half: 0 bf16, 1 fp16. Launches on `stream`, does not synchronise, and
// returns the cudaError_t of the launch.
extern "C" int bias_act_launch(void* y, const void* r, const float* bias, long long n_elems,
                               int channels, int half, int relu, void* stream) {
    if (n_elems == 0) return 0;
    const long long nvec = n_elems / 8;
    const int cvec = channels / 8;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const cudaError_t err = half ? launch<__half>(y, r, bias, nvec, cvec, relu, st)
                                 : launch<__nv_bfloat16>(y, r, bias, nvec, cvec, relu, st);
    return static_cast<int>(err);
}
