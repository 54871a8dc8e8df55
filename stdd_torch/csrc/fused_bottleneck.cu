// K2 — fused eval-time I3D bottleneck, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel stdd_tpu/ops/bottleneck_pallas.py::fused_bottleneck
// (kernel body _kernel). It computes the same function, not the TPU
// kernel's nine-BlockSpec halo scheme: one stride-1 I3D bottleneck with its
// BatchNorms folded into the weights,
//
//   xa = relu(a(x) + ba)        a: tk x 1 x 1 conv, zero padding in T (tk 1 or 3)
//   xb = relu(b(xa) + bb)       b: 1 x 3 x 3 conv, zero padding in H and W
//   y  = relu(c(xb) + bc + s)   c: 1 x 1 x 1 conv; s = x, or x.ws + bs
//
// over x [B,T,H,W,Cin] (the memory of a channels_last_3d NCTHW tensor) in
// bf16 or float32, weights in the same type (wa [tk,Cin,Ci], wb
// [3,3,Ci,Ci], wc [Ci,Co], ws [Cin,Co]) and float32 biases. Every product is
// summed in float32; xa and xb are rounded to the element type once, after
// their bias and ReLU, and y once at the end — the TPU kernel's rounding
// points. Two traps the TPU kernel documents are kept: xa on haloed rows
// and columns outside the image is ZERO (b's zero padding applies to xa, so
// a's bias must not leak through), while the T padding only zeroes a's
// input, so xa at t = 0 and t = T-1 is relu(ba + the valid taps). Any T, H
// and W are taken; the ragged edge is masked.
//
// Bound: memory. At the serving shape (one clip: T=32, H=W=56, bf16,
// 100,352 positions) the card must read x once and write y once: block 0
// (Cin 64 -> Co 256, projection) moves 12.8 + 51.4 MB, 19.2 us at 3.35 TB/s,
// against 1.64e10 flops (16.6 us on the bf16 tensor cores); blocks 1-2
// (256 -> 256, identity) move 51.4 + 51.4 MB, 30.7 us, against 2.06e10 flops
// (20.8 us). Weights are under 0.2 MB a block.
//
// Design, simple first: one block of 256 threads per (b, t, 14 x 14 output
// tile). Stage a computes xa over the 16 x 16 haloed tile into shared
// memory, streaming x through Cin 16 channels at a time; stage b computes
// xb for the 196 outputs into shared memory, one 3x3 tap's weights staged
// at a time; stage c adds the shortcut and writes y straight to global
// memory, 64 output channels per pass. Each thread keeps an 8-position x
// 8-channel (a) or 7 x 8 (b, c) tile of float32 accumulators and runs
// scalar FMAs on the CUDA cores; the 64-channel intermediates never touch
// device memory. What it leaves on the table: the tensor cores. Its 5.75e10
// scalar flops a clip need at least 0.86 ms at 67 TFLOP/s, far above the
// 0.08 ms byte bound; the 1.56x recompute of xa on the halo and the
// re-read of x per 64-channel pass of the projection come on top. mma/wgmma
// tiles fed by TMA are the next step.

#include <cstdint>
#include <cstring>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 14;                  // output rows and columns of a block
constexpr int kHalo = kTile + 2;           // 16: b's taps reach one position further
constexpr int kPixA = kHalo * kHalo;       // 256 haloed positions of xa
constexpr int kPixB = kTile * kTile;       // 196 output positions
constexpr int kPixBPad = 224;              // 7 x 32: 7 output positions per thread
constexpr int kThreads = 256;
constexpr int kCi = 64;                    // the inner width the kernel takes
constexpr int kChunk = 16;                 // input channels staged per step
constexpr int kCoChunk = 64;               // output channels per pass of c
constexpr int kCPT = 8;                    // channels per thread: 8 groups x 8 = 64
constexpr int kPA = kPixA / 32;            // 8 haloed positions per thread in a
constexpr int kPB = kPixBPad / 32;         // 7 output positions per thread in b and c
constexpr int kMaxTk = 3;

// shared memory, in elements. Region A: xa [Ci][256], later the
// projection's x chunk [16][224]. Region B: a's x chunks [tk][16][256],
// later xb [Ci][224]. Region W: one staged weight slice (at most 64 x 64).
constexpr int kRegionA = kCi * kPixA;
constexpr int kRegionB = kCi * kPixBPad;
constexpr int kRegionW = kCi * kCoChunk;
constexpr int kSmemElems = kRegionA + kRegionB + kRegionW;
static_assert(kMaxTk * kChunk * kPixA <= kRegionB, "a's x chunks fit region B");
static_assert(kMaxTk * kChunk * kCi <= kRegionW, "a's weight chunk fits region W");
static_assert(kChunk * kPixBPad <= kRegionA, "the projection's x chunk fits region A");
static_assert(kPixBPad <= kThreads, "one thread stages each output position");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename E> __device__ __forceinline__ E from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}

// N elements through 16-byte vectors; the address is 16-byte aligned
template <typename E, int N>
__device__ __forceinline__ void load_vec(const E* src, E (&dst)[N]) {
    static_assert((N * sizeof(E)) % 16 == 0, "whole 16-byte vectors");
    constexpr int kV = N * sizeof(E) / 16;
    uint4 v[kV];
    const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
    for (int i = 0; i < kV; ++i) v[i] = s[i];
    memcpy(dst, v, sizeof(v));
}

template <typename E, int N>
__device__ __forceinline__ void store_vec(E* dst, const E (&src)[N]) {
    static_assert((N * sizeof(E)) % 16 == 0, "whole 16-byte vectors");
    constexpr int kV = N * sizeof(E) / 16;
    uint4 v[kV];
    memcpy(v, src, sizeof(v));
    uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
    for (int i = 0; i < kV; ++i) d[i] = v[i];
}

// eight consecutive elements (16-byte aligned) as float32
template <typename E>
__device__ __forceinline__ void load8(const E* p, float (&o)[kCPT]) {
    E v[kCPT];
    load_vec<E, kCPT>(p, v);
#pragma unroll
    for (int c = 0; c < kCPT; ++c) o[c] = to_f32(v[c]);
}

template <typename E, bool kProject>
__global__ void __launch_bounds__(kThreads)
fused_bottleneck_kernel(const E* __restrict__ x, const E* __restrict__ wa,
                        const float* __restrict__ ba, const E* __restrict__ wb,
                        const float* __restrict__ bb, const E* __restrict__ wc,
                        const float* __restrict__ bc, const E* __restrict__ ws,
                        const float* __restrict__ bs, E* __restrict__ y,
                        int nT, int H, int W, int Cin, int Co, int tk, int tiles_w) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    E* sA = reinterpret_cast<E*>(smem_raw);
    E* sB = sA + kRegionA;
    E* sW = sB + kRegionB;

    const int tid = threadIdx.x;
    const int lane = tid & 31;             // position group: positions lane + 32 j
    const int cg = tid >> 5;               // channel group: channels cg*8 .. cg*8+7
    const int h0 = (blockIdx.x / tiles_w) * kTile;
    const int w0 = (blockIdx.x % tiles_w) * kTile;
    const int t = blockIdx.y;
    const int b = blockIdx.z;
    const E zero = from_f32<E>(0.f);

    // element offset of position (b, tt, h, w), channel 0, in a tensor of C channels
    auto at = [&](int tt, int h, int w, int C) -> size_t {
        return (((static_cast<size_t>(b) * nT + tt) * H + h) * W + w) * C;
    };

    // ---- a: xa over the haloed tile ------------------------------------
    {
        float acc[kPA][kCPT];
#pragma unroll
        for (int j = 0; j < kPA; ++j)
#pragma unroll
            for (int c = 0; c < kCPT; ++c) acc[j][c] = 0.f;
        // the haloed position this thread stages
        const int ph = h0 - 1 + (tid >> 4);
        const int pw = w0 - 1 + (tid & 15);
        const bool p_in = ph >= 0 && ph < H && pw >= 0 && pw < W;
        for (int k0 = 0; k0 < Cin; k0 += kChunk) {
            __syncthreads();                           // the previous chunk is consumed
            for (int dt = 0; dt < tk; ++dt) {
                const int tt = t + dt - tk / 2;        // zero T padding of a's input
                E v[kChunk];
                if (p_in && tt >= 0 && tt < nT) {
                    load_vec<E, kChunk>(x + at(tt, ph, pw, Cin) + k0, v);
                } else {
#pragma unroll
                    for (int k = 0; k < kChunk; ++k) v[k] = zero;
                }
#pragma unroll
                for (int k = 0; k < kChunk; ++k) sB[(dt * kChunk + k) * kPixA + tid] = v[k];
            }
            // wa[dt, k0 .. k0+15, :] is one contiguous [16][64] slice per dt
            for (int i = tid; i < tk * kChunk * kCi; i += kThreads) {
                const int dt = i / (kChunk * kCi);
                const int r = i - dt * (kChunk * kCi);
                sW[i] = wa[(static_cast<size_t>(dt) * Cin + k0) * kCi + r];
            }
            __syncthreads();
            for (int dt = 0; dt < tk; ++dt) {
#pragma unroll 4
                for (int k = 0; k < kChunk; ++k) {
                    const E* xr = sB + (dt * kChunk + k) * kPixA + lane;
                    float xv[kPA], wv[kCPT];
#pragma unroll
                    for (int j = 0; j < kPA; ++j) xv[j] = to_f32(xr[32 * j]);
                    load8(sW + (dt * kChunk + k) * kCi + cg * kCPT, wv);
#pragma unroll
                    for (int j = 0; j < kPA; ++j)
#pragma unroll
                        for (int c = 0; c < kCPT; ++c) acc[j][c] = fmaf(xv[j], wv[c], acc[j][c]);
                }
            }
        }
        // bias and ReLU, rounded once; outside the image xa is 0
#pragma unroll
        for (int j = 0; j < kPA; ++j) {
            const int p = lane + 32 * j;
            const int hh = h0 - 1 + (p >> 4);
            const int ww = w0 - 1 + (p & 15);
            const bool in = hh >= 0 && hh < H && ww >= 0 && ww < W;
#pragma unroll
            for (int c = 0; c < kCPT; ++c) {
                const int ch = cg * kCPT + c;
                const float v = fmaxf(acc[j][c] + __ldg(ba + ch), 0.f);
                sA[ch * kPixA + p] = in ? from_f32<E>(v) : zero;
            }
        }
    }
    __syncthreads();

    // ---- b: xb for the output tile ---------------------------------------
    {
        float acc[kPB][kCPT];
        int base[kPB];                             // haloed index of each output's top-left tap
#pragma unroll
        for (int j = 0; j < kPB; ++j) {
            const int o = lane + 32 * j;
            const int oc = o < kPixB ? o : 0;      // padded slots compute a discarded copy
            base[j] = (oc / kTile) * kHalo + (oc % kTile);
#pragma unroll
            for (int c = 0; c < kCPT; ++c) acc[j][c] = 0.f;
        }
        for (int tap = 0; tap < 9; ++tap) {
            const int off = (tap / 3) * kHalo + (tap % 3);
            __syncthreads();                           // region W is free
            for (int i = tid; i < kCi * kCi; i += kThreads) sW[i] = wb[tap * kCi * kCi + i];
            __syncthreads();
#pragma unroll 4
            for (int k = 0; k < kCi; ++k) {
                const E* xr = sA + k * kPixA + off;
                float xv[kPB], wv[kCPT];
#pragma unroll
                for (int j = 0; j < kPB; ++j) xv[j] = to_f32(xr[base[j]]);
                load8(sW + k * kCi + cg * kCPT, wv);
#pragma unroll
                for (int j = 0; j < kPB; ++j)
#pragma unroll
                    for (int c = 0; c < kCPT; ++c) acc[j][c] = fmaf(xv[j], wv[c], acc[j][c]);
            }
        }
        // region B held a's x chunks until the barrier after stage a
#pragma unroll
        for (int j = 0; j < kPB; ++j) {
            const int o = lane + 32 * j;
            if (o < kPixB) {
#pragma unroll
                for (int c = 0; c < kCPT; ++c) {
                    const int ch = cg * kCPT + c;
                    sB[ch * kPixBPad + o] = from_f32<E>(fmaxf(acc[j][c] + __ldg(bb + ch), 0.f));
                }
            }
        }
    }

    // ---- c + shortcut + ReLU, 64 output channels per pass -----------------
    int oh[kPB], ow[kPB];
    bool out_ok[kPB];
#pragma unroll
    for (int j = 0; j < kPB; ++j) {
        const int o = lane + 32 * j;
        oh[j] = h0 + o / kTile;
        ow[j] = w0 + o % kTile;
        out_ok[j] = o < kPixB && oh[j] < H && ow[j] < W;
    }
    // the output position this thread stages for the projection
    const int so = tid;
    const int soh = h0 + so / kTile, sow = w0 + so % kTile;
    const bool s_in = so < kPixB && soh < H && sow < W;

    for (int co0 = 0; co0 < Co; co0 += kCoChunk) {
        float acc[kPB][kCPT];
#pragma unroll
        for (int j = 0; j < kPB; ++j)
#pragma unroll
            for (int c = 0; c < kCPT; ++c) acc[j][c] = 0.f;
        __syncthreads();                               // xb is complete; region W is free
        for (int i = tid; i < kCi * kCoChunk; i += kThreads) {
            const int r = i / kCoChunk;
            sW[i] = wc[static_cast<size_t>(r) * Co + co0 + (i - r * kCoChunk)];
        }
        __syncthreads();
#pragma unroll 4
        for (int k = 0; k < kCi; ++k) {
            const E* xr = sB + k * kPixBPad + lane;
            float xv[kPB], wv[kCPT];
#pragma unroll
            for (int j = 0; j < kPB; ++j) xv[j] = to_f32(xr[32 * j]);
            load8(sW + k * kCoChunk + cg * kCPT, wv);
#pragma unroll
            for (int j = 0; j < kPB; ++j)
#pragma unroll
                for (int c = 0; c < kCPT; ++c) acc[j][c] = fmaf(xv[j], wv[c], acc[j][c]);
        }
        if (kProject) {
            // x . ws summed into the same float32 accumulators as c
            for (int k0 = 0; k0 < Cin; k0 += kChunk) {
                __syncthreads();                       // regions A and W are consumed
                if (so < kPixBPad) {
                    E v[kChunk];
                    if (s_in) {
                        load_vec<E, kChunk>(x + at(t, soh, sow, Cin) + k0, v);
                    } else {
#pragma unroll
                        for (int k = 0; k < kChunk; ++k) v[k] = zero;
                    }
#pragma unroll
                    for (int k = 0; k < kChunk; ++k) sA[k * kPixBPad + so] = v[k];
                }
                for (int i = tid; i < kChunk * kCoChunk; i += kThreads) {
                    const int r = i / kCoChunk;
                    sW[i] = ws[static_cast<size_t>(k0 + r) * Co + co0 + (i - r * kCoChunk)];
                }
                __syncthreads();
#pragma unroll 4
                for (int k = 0; k < kChunk; ++k) {
                    const E* xr = sA + k * kPixBPad + lane;
                    float xv[kPB], wv[kCPT];
#pragma unroll
                    for (int j = 0; j < kPB; ++j) xv[j] = to_f32(xr[32 * j]);
                    load8(sW + k * kCoChunk + cg * kCPT, wv);
#pragma unroll
                    for (int j = 0; j < kPB; ++j)
#pragma unroll
                        for (int c = 0; c < kCPT; ++c) acc[j][c] = fmaf(xv[j], wv[c], acc[j][c]);
                }
            }
        }
        float bias[kCPT];
#pragma unroll
        for (int c = 0; c < kCPT; ++c) {
            const int ch = co0 + cg * kCPT + c;
            bias[c] = __ldg(bc + ch);
            if (kProject) bias[c] += __ldg(bs + ch);
        }
#pragma unroll
        for (int j = 0; j < kPB; ++j) {
            if (!out_ok[j]) continue;
            float res[kCPT];
            if (kProject) {
#pragma unroll
                for (int c = 0; c < kCPT; ++c) res[c] = 0.f;
            } else {
                load8(x + at(t, oh[j], ow[j], Cin) + co0 + cg * kCPT, res);
            }
            E o[kCPT];
#pragma unroll
            for (int c = 0; c < kCPT; ++c) o[c] = from_f32<E>(fmaxf((acc[j][c] + bias[c]) + res[c], 0.f));
            store_vec<E, kCPT>(y + at(t, oh[j], ow[j], Co) + co0 + cg * kCPT, o);
        }
    }
}

template <typename E, bool kProject>
int launch(const void* x, const void* wa, const void* ba, const void* wb, const void* bb,
           const void* wc, const void* bc, const void* ws, const void* bs, void* y,
           int B, int T, int H, int W, int Cin, int Co, int tk, cudaStream_t st) {
    const int smem = kSmemElems * static_cast<int>(sizeof(E));
    cudaError_t err = cudaFuncSetAttribute(fused_bottleneck_kernel<E, kProject>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int tiles_h = (H + kTile - 1) / kTile;
    const int tiles_w = (W + kTile - 1) / kTile;
    const dim3 grid(tiles_h * tiles_w, T, B);
    fused_bottleneck_kernel<E, kProject><<<grid, kThreads, smem, st>>>(
        static_cast<const E*>(x), static_cast<const E*>(wa), static_cast<const float*>(ba),
        static_cast<const E*>(wb), static_cast<const float*>(bb), static_cast<const E*>(wc),
        static_cast<const float*>(bc), static_cast<const E*>(ws), static_cast<const float*>(bs),
        static_cast<E*>(y), T, H, W, Cin, Co, tk, tiles_w);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes). ws and bs are null for an
// identity shortcut. Launches on `stream`, does not synchronise, and returns
// the cudaError_t of the launch.
extern "C" int fused_bottleneck_launch(int bf16, const void* x, const void* wa, const void* ba,
                                       const void* wb, const void* bb, const void* wc,
                                       const void* bc, const void* ws, const void* bs, void* y,
                                       int B, int T, int H, int W, int Cin, int Co, int tk,
                                       void* stream) {
    if (B == 0 || T == 0 || H == 0 || W == 0 || Co == 0) return 0;
    if (tk != 1 && tk != kMaxTk) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool project = ws != nullptr;
    if (bf16) {
        return project ? launch<__nv_bfloat16, true>(x, wa, ba, wb, bb, wc, bc, ws, bs, y, B, T, H,
                                                     W, Cin, Co, tk, st)
                       : launch<__nv_bfloat16, false>(x, wa, ba, wb, bb, wc, bc, ws, bs, y, B, T,
                                                      H, W, Cin, Co, tk, st);
    }
    return project ? launch<float, true>(x, wa, ba, wb, bb, wc, bc, ws, bs, y, B, T, H, W, Cin,
                                         Co, tk, st)
                   : launch<float, false>(x, wa, ba, wb, bb, wc, bc, ws, bs, y, B, T, H, W, Cin,
                                          Co, tk, st);
}
