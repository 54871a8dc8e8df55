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
// Two kernels, picked by the element type at the C entry points below and
// never one in place of the other: bf16 runs on the tensor cores
// (fused_bottleneck_mma_kernel), float32 on the CUDA cores
// (fused_bottleneck_kernel, scalar float32 FMAs, whose sums the float32
// tolerance of 1e-5 relative needs; unchanged from the first version).
//
// Bound, on an H100 SXM (3.35 TB/s, 989 TFLOP/s dense bf16): at the serving
// shape (one clip: T=32, H=W=56, bf16, 100,352 positions) the card must
// read x once and write y once: block 0 (Cin 64 -> Co 256, projection)
// moves 12.8 + 51.4 MB, 19.2 us, against 1.64e10 flops (16.6 us); blocks
// 1-2 (256 -> 256, identity) move 51.4 + 51.4 MB, 30.7 us, against 2.06e10
// flops (20.8 us). Weights are under 0.2 MB a block. So bytes bound it, but
// only just: a kernel has to keep the tensor cores busy to come near.
//
// Both kernels: one block of 256 threads per (b, t, 14 x 14 output tile).
// Stage a computes xa over the 16 x 16 haloed tile into shared memory;
// stage b computes xb for the 196 outputs from xa; stage c adds the
// shortcut and writes y, 64 output channels per pass. The 64-channel
// intermediates never touch device memory; xa is recomputed on the halo
// (1.31x a's work).
//
// The scalar kernel keeps an 8 x 8 (a) or 7 x 8 (b, c) tile of float32
// accumulators a thread; its shared operands are read one element at a
// time. Its 5.75e10 scalar flops a clip cannot run faster than 0.86 ms at
// 67 TFLOP/s, far above the byte bound (block 1 took 0.90 ms a clip on an
// H100 80GB HBM3 at a 700 W power limit).
//
// The bf16 kernel runs the three products as warp-level tensor-core tiles
// (mma.sync m16n8k16, bf16 in, float32 sums) fed by ldmatrix from shared
// memory laid out as rows of 64 channels (128 bytes) whose 16-byte chunks
// are XOR-swizzled by row, so ldmatrix is free of bank conflicts:
// - a: M 256 haloed positions x N 64 x K tk*Cin. x is staged 64 channels of
//   one time step at a time (zero where t or the position lies outside the
//   clip) with wa's matching [64][64] slice; a warp owns 32 rows x 64
//   columns (2 x 8 m16n8 tiles, 64 float32 accumulators a thread).
// - b: an implicit GEMM, M 196 outputs (padded to 224) x N 64 x K 9 taps x
//   64. ldmatrix takes one row address per lane, so each lane points at the
//   haloed xa row of its output position plus the tap's offset: the 3 x 3
//   gather costs nothing. Padded rows point at a valid row; their results
//   are dropped. wb is staged six taps at a time.
// - c: per 64 output channels, xb . wc[:, chunk] and, for the projection,
//   x[outputs] . ws[:, chunk] in one set of accumulators; the identity
//   residual is staged from x beside them and added in float32. y leaves
//   through shared memory, 16 bytes a thread and 128 contiguous bytes a
//   position.
// Staging is synchronous (global -> registers -> shared); two blocks fit on
// an SM (109 KB of shared memory each), so one block's loads overlap the
// other's products. On an H100 80GB HBM3 at a 700 W power limit the
// kernel reaches 13-18% of the bf16 rate and about a fifth of its byte
// bound at a batch of 8 clips; the exposed staging latency is the first
// suspect (not yet measured apart from the mma.sync throughput). wgmma fed
// by TMA, with the loads in flight, is the next step.

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

// ---- the float32 kernel: scalar FMAs on the CUDA cores ----------------------
//
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

template <typename E> __device__ __forceinline__ E from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }

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


// ---- the bf16 kernel on the tensor cores ------------------------------------
//
// Shared memory is rows of 64 bf16 channels (128 bytes, eight 16-byte
// chunks); chunk c of row r is stored at chunk c ^ (r & 7), so the eight
// row addresses of one ldmatrix 8x8 matrix hit eight different chunks — all
// 32 banks — and the loads are free of bank conflicts. Regions, in rows:
//   XA [256]  xa over the haloed tile (stage a's output, stage b's input);
//             in stage c, x at the output positions (the projection's
//             operand, or the identity residual)
//   XB [224]  xb for the 196 outputs, padded to 14 m-tiles of 16
//   XS [256]  stage a's x rows for one (dt, 64-channel chunk); then wb taps
//             0-3 (and 6-8); in stage c, the y tile on its way out
//   W  [128]  stage a's wa slice; then wb taps 4-5; in stage c, wc's and
//             ws's 64-column slices
// 864 rows and a table of the output positions, 109 KB: two blocks fit on
// an SM.

constexpr int kRowBytes = 128;
constexpr int kMmaMT = 14;                 // m-tiles of 16 over the 196 outputs
constexpr int kRowsXB = kMmaMT * 16;       // 224
constexpr int kXA = 0;
constexpr int kXB = kXA + kPixA;
constexpr int kXS = kXB + kRowsXB;
constexpr int kW = kXS + kPixA;
constexpr int kMmaRows = kW + 2 * kCi;
// after the rows: the position (h * W + w, or -1 outside the tile or the
// image) of each of the 224 output rows, read back in stage c on every pass
// rather than held in registers
constexpr int kPosTable = kMmaRows * kRowBytes;
constexpr int kMmaSmem = kPosTable + kRowsXB * 4;
constexpr int kTapsPerRound = (kPixA + 2 * kCi) / kCi;   // 6 taps of wb fill XS and W
static_assert(kXS + kTapsPerRound * kCi == kMmaRows, "taps fill XS and W exactly");
static_assert(kXB % 8 == 0 && kXS % 8 == 0 && kW % 8 == 0,
              "regions start on a multiple of 8 rows, so row & 7 is the row's offset & 7");
static_assert(kMmaSmem <= 113 * 1024, "two blocks fit on an SM");
static_assert(kPixA == 32 * (kThreads / 32), "stage a: 32 haloed rows a warp");
constexpr int kStageLoads = kPixA * 8 / kThreads;          // 8 x chunks a thread per step of a
static_assert(kThreads == 256 && kHalo == 16, "stage a's staging map: 2 haloed rows a pass");

// byte offset of 16-byte chunk c of row r (the XOR swizzle); where r & 7
// is known, the row's start plus chunk(c, r & 7)
__device__ __forceinline__ uint32_t chunk(int c, int r7) {
    return static_cast<uint32_t>((c ^ r7) << 4);
}

__device__ __forceinline__ uint32_t swz(int r, int c) {
    return static_cast<uint32_t>(r * kRowBytes) + chunk(c, r & 7);
}

__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                 :: "r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w));
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
    uint4 v;
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr));
    return v;
}

__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
    asm volatile("st.shared.u32 [%0], %1;\n" :: "r"(addr), "r"(v));
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
    uint32_t v;
    asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
    return v;
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d += a (16x16, row) . b (16x8, col), bf16 in, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo at the lower address
    uint32_t u;
    memcpy(&u, &v, sizeof(u));
    return u;
}

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t u) {
    __nv_bfloat162 v;
    memcpy(&v, &u, sizeof(u));
    return __bfloat1622float2(v);
}

// One warp: acc[mt] (16 rows x 64 columns each) += A[rows] . B[64 x 64].
// arow[mt] is the shared-memory row this lane addresses for m-tile mt —
// row (lane & 7) + 8 ((lane >> 3) & 1) of the tile, which ldmatrix.x4 hands
// out as the fragments a0..a3; stage b passes the haloed row of the lane's
// output position plus the tap's offset, so the 3x3 gather is only an
// address. B (rows k, 64 columns n, n contiguous) is read with .trans, which
// gives the col-major fragment the mma takes.
template <int MT>
__device__ __forceinline__ void warp_gemm_k64(float (&acc)[MT][8][4], uint32_t sbase,
                                              const int (&arow)[MT], int brow, int lane) {
    const int hi = lane >> 4;                       // A: k chunk; B: n chunk within a pair
    // B: k row brow + 16 ks + (lane & 15), and brow is a multiple of 8
    const uint32_t b_row = sbase + (brow + (lane & 15)) * kRowBytes;
    uint32_t a_row[MT];
    int a_r7[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
        a_row[mt] = sbase + arow[mt] * kRowBytes;
        a_r7[mt] = arow[mt] & 7;
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) ldsm_x4(a_row[mt] + chunk(2 * ks + hi, a_r7[mt]), a[mt]);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
            uint32_t b[4];
            ldsm_x4_trans(b_row + 16 * ks * kRowBytes + chunk(2 * np + hi, lane & 7), b);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
                mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
            }
        }
    }
}

// rows [0, kRows) of a matrix with 64 bf16 columns at src (row stride
// `stride` elements) into shared rows dst_row.., zero from row `valid` on;
// thread tid stages chunk tid & 7 of rows 32 j + (tid >> 3)
template <int kRows>
__device__ __forceinline__ void stage_rows(uint32_t sbase, int dst_row,
                                           const __nv_bfloat16* __restrict__ src, int stride,
                                           int valid, int tid) {
    static_assert(kRows % 32 == 0, "whole passes of 256 threads");
    const int c = tid & 7;
#pragma unroll
    for (int j = 0; j < kRows / 32; ++j) {
        const int r = 32 * j + (tid >> 3);
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (r < valid)
            v = __ldg(reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * stride + c * 8));
        sts128(sbase + swz(dst_row + r, c), v);
    }
}

template <bool kProject>
__global__ void __launch_bounds__(kThreads, 2)
fused_bottleneck_mma_kernel(const __nv_bfloat16* __restrict__ x,
                            const __nv_bfloat16* __restrict__ wa, const float* __restrict__ ba,
                            const __nv_bfloat16* __restrict__ wb, const float* __restrict__ bb,
                            const __nv_bfloat16* __restrict__ wc, const float* __restrict__ bc,
                            const __nv_bfloat16* __restrict__ ws, const float* __restrict__ bs,
                            __nv_bfloat16* __restrict__ y, int nT, int H, int W, int Cin,
                            int Co, int tk, int tiles_w) {
    extern __shared__ __align__(128) unsigned char mma_smem[];
    const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(mma_smem));

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int lrow = lane & 15;                            // the row this lane addresses in a tile
    const int g = lane >> 2;                               // accumulator rows g and g + 8
    const int cp = 2 * (lane & 3);                         // accumulator columns cp, cp + 1
    const int h0 = (blockIdx.x / tiles_w) * kTile;
    const int w0 = (blockIdx.x % tiles_w) * kTile;
    const int t = blockIdx.y;
    const int b = blockIdx.z;
    const int n_kc = (Cin + kCi - 1) / kCi;                // 64-channel chunks of x

    // element offset of position (tt, h, w), channel 0, in a tensor of C channels
    auto at = [&](int tt, int h, int w, int C) -> size_t {
        return (((static_cast<size_t>(b) * nT + tt) * H + h) * W + w) * C;
    };
    if (tid < kRowsXB) {
        const int oh = h0 + tid / kTile, ow = w0 + tid % kTile;
        sts32(sbase + kPosTable + 4 * tid,
              tid < kPixB && oh < H && ow < W ? static_cast<uint32_t>(oh * W + ow) : ~0u);
    }                                                      // read after stage a's first barrier
    // x at the 224 output rows (zero outside the tile or the image),
    // channels c0 .. c0+63 (zero from Cin on) into XA: chunk tid & 7 of
    // output rows 32 j + (tid >> 3)
    auto stage_x_out = [&](int c0) {
        const int c = tid & 7;
        const __nv_bfloat16* xt = x + at(t, 0, 0, Cin) + c0 + c * 8;
#pragma unroll
        for (int j = 0; j < kRowsXB / 32; ++j) {
            const int o = 32 * j + (tid >> 3);
            const int pos = static_cast<int>(lds32(sbase + kPosTable + 4 * o));
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            if (pos >= 0 && c0 + c * 8 < Cin)
                v = __ldg(reinterpret_cast<const uint4*>(xt + static_cast<size_t>(pos) * Cin));
            sts128(sbase + swz(kXA + o, c), v);
        }
    };

    // ---- a: xa over the 16 x 16 haloed tile, M 256 x N 64 x K tk*Cin ------
    {
        float acc[2][8][4] = {};
        int arow[2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) arow[mt] = kXS + warp * 32 + mt * 16 + lrow;
        const int s_c = tid & 7;                              // the x chunk this thread stages
        const int s_pw = w0 - 1 + ((tid >> 3) & 15);
        const int s_ph0 = h0 - 1 + (tid >> 7);
        for (int dt = 0; dt < tk; ++dt) {
            const int tt = t + dt - tk / 2;                  // zero T padding of a's input
            const bool t_in = tt >= 0 && tt < nT;
            for (int kc = 0; kc < n_kc; ++kc) {
                const int c0 = kc * kCi;
                __syncthreads();                              // XS and W are consumed
                // thread tid stages chunk tid & 7 of haloed rows p = 32 j + (tid >> 3):
                // one column pw, rows ph = h0 - 1 + 2 j + (tid >> 7); four loads in flight
                const bool col_in = t_in && s_pw >= 0 && s_pw < W && c0 + s_c * 8 < Cin;
                const __nv_bfloat16* src =
                    x + at(t_in ? tt : 0, 0, col_in ? s_pw : 0, Cin) + c0 + s_c * 8;
#pragma unroll
                for (int j0 = 0; j0 < kStageLoads; j0 += kStageLoads / 2) {
                    uint4 v[kStageLoads / 2];
#pragma unroll
                    for (int j = 0; j < kStageLoads / 2; ++j) {
                        const int ph = s_ph0 + 2 * (j0 + j);
                        v[j] = make_uint4(0u, 0u, 0u, 0u);
                        if (col_in && ph >= 0 && ph < H)
                            v[j] = __ldg(reinterpret_cast<const uint4*>(
                                src + static_cast<size_t>(ph) * W * Cin));
                    }
#pragma unroll
                    for (int j = 0; j < kStageLoads / 2; ++j)
                        sts128(sbase + swz(kXS + 32 * (j0 + j) + (tid >> 3), s_c), v[j]);
                }
                stage_rows<kCi>(sbase, kW, wa + (static_cast<size_t>(dt) * Cin + c0) * kCi, kCi,
                                Cin - c0, tid);
                __syncthreads();
                warp_gemm_k64<2>(acc, sbase, arow, kW, lane);
            }
        }
        __syncthreads();                                      // XS and W are consumed
        // bias and ReLU, rounded once; outside the image xa is 0. The
        // accumulator rows warp*32 + mt*16 + 8 half + g all have r & 7 == g
        const uint32_t xa_row = sbase + (kXA + warp * 32 + g) * kRowBytes + cp * 2;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int p = warp * 32 + mt * 16 + g + 8 * half;
                const int ph = h0 - 1 + (p >> 4), pw = w0 - 1 + (p & 15);
                const bool in = ph >= 0 && ph < H && pw >= 0 && pw < W;
#pragma unroll
                for (int nt = 0; nt < 8; ++nt) {
                    const int n = nt * 8 + cp;
                    const float v0 = fmaxf(acc[mt][nt][2 * half] + __ldg(ba + n), 0.f);
                    const float v1 = fmaxf(acc[mt][nt][2 * half + 1] + __ldg(ba + n + 1), 0.f);
                    sts32(xa_row + (mt * 16 + 8 * half) * kRowBytes + chunk(nt, g),
                          in ? pack_bf16x2(v0, v1) : 0u);
                }
            }
        }
        // wb's first taps into XS and W (free since the barrier above)
        stage_rows<kTapsPerRound * kCi>(sbase, kXS, wb, kCi, kTapsPerRound * kCi, tid);
        __syncthreads();
    }

    // ---- b: xb for the outputs, M 224 x N 64 x K 9*64 (implicit GEMM) -----
    // warps 0-6 take two m-tiles each; warp 7 has none in stages b and c
    const bool has_rows = warp < kMmaMT / 2;
    {
        float acc[2][8][4] = {};
        int hrow[2];                          // the haloed row of the lane's output, tap (0, 0)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
            const int o = warp * 32 + mt * 16 + lrow;
            const int oc = o < kPixB ? o : 0;   // padded rows read a valid row; dropped later
            hrow[mt] = kXA + (oc / kTile) * kHalo + oc % kTile;
        }
        // taps 0-5 were staged with stage a's epilogue, taps 6-8 follow
        auto taps = [&](int tap0, int tap1) {
            if (!has_rows) return;
            for (int tap = tap0; tap < tap1; ++tap) {
                const int off = (tap / 3) * kHalo + tap % 3;
                const int arow[2] = {hrow[0] + off, hrow[1] + off};
                warp_gemm_k64<2>(acc, sbase, arow, kXS + (tap - tap0) * kCi, lane);
            }
        };
        taps(0, kTapsPerRound);
        __syncthreads();                                          // taps 0-5 are consumed
        stage_rows<(9 - kTapsPerRound) * kCi>(sbase, kXS, wb + kTapsPerRound * kCi * kCi, kCi,
                                              (9 - kTapsPerRound) * kCi, tid);
        __syncthreads();
        taps(kTapsPerRound, 9);
        if (has_rows) {
            const uint32_t xb_row = sbase + (kXB + warp * 32 + g) * kRowBytes + cp * 2;
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
                for (int half = 0; half < 2; ++half) {
#pragma unroll
                    for (int nt = 0; nt < 8; ++nt) {
                        const int n = nt * 8 + cp;
                        const float v0 = fmaxf(acc[mt][nt][2 * half] + __ldg(bb + n), 0.f);
                        const float v1 = fmaxf(acc[mt][nt][2 * half + 1] + __ldg(bb + n + 1), 0.f);
                        sts32(xb_row + (mt * 16 + 8 * half) * kRowBytes + chunk(nt, g),
                              pack_bf16x2(v0, v1));
                    }
                }
            }
        }
    }

    // ---- c + shortcut + ReLU, 64 output channels per pass -----------------
    int xrow[2], brow[2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
        xrow[mt] = kXA + warp * 32 + mt * 16 + lrow;
        brow[mt] = kXB + warp * 32 + mt * 16 + lrow;
    }
    for (int co0 = 0; co0 < Co; co0 += kCoChunk) {
        __syncthreads();                       // xb is complete; XA, XS and W are free
        stage_rows<kCi>(sbase, kW, wc + co0, Co, kCi, tid);
        if (kProject) {
            stage_x_out(0);
            stage_rows<kCi>(sbase, kW + kCi, ws + co0, Co, Cin, tid);
        } else {
            stage_x_out(co0);                  // the identity residual
        }
        __syncthreads();
        float acc[2][8][4] = {};
        if (has_rows) {
            warp_gemm_k64<2>(acc, sbase, brow, kW, lane);
            if (kProject) warp_gemm_k64<2>(acc, sbase, xrow, kW + kCi, lane);
        }
        if (kProject) {
            // x . ws over the rest of Cin, summed into the same accumulators
            for (int kc = 1; kc < n_kc; ++kc) {
                __syncthreads();
                stage_x_out(kc * kCi);
                stage_rows<kCi>(sbase, kW + kCi, ws + static_cast<size_t>(kc) * kCi * Co + co0,
                                Co, Cin - kc * kCi, tid);
                __syncthreads();
                if (has_rows) warp_gemm_k64<2>(acc, sbase, xrow, kW + kCi, lane);
            }
        }
        if (has_rows) {
            const uint32_t res_row = sbase + (kXA + warp * 32 + g) * kRowBytes + cp * 2;
            const uint32_t y_row = sbase + (kXS + warp * 32 + g) * kRowBytes + cp * 2;
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
                const int n = nt * 8 + cp;
                float bias0 = __ldg(bc + co0 + n), bias1 = __ldg(bc + co0 + n + 1);
                if (kProject) {
                    bias0 += __ldg(bs + co0 + n);
                    bias1 += __ldg(bs + co0 + n + 1);
                }
#pragma unroll
                for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
                    for (int half = 0; half < 2; ++half) {
                        const uint32_t off = (mt * 16 + 8 * half) * kRowBytes + chunk(nt, g);
                        float2 res = make_float2(0.f, 0.f);
                        if (!kProject) res = unpack_bf16x2(lds32(res_row + off));
                        const float v0 = fmaxf((acc[mt][nt][2 * half] + bias0) + res.x, 0.f);
                        const float v1 = fmaxf((acc[mt][nt][2 * half + 1] + bias1) + res.y, 0.f);
                        sts32(y_row + off, pack_bf16x2(v0, v1));
                    }
                }
            }
        }
        __syncthreads();
        // the y tile out of XS, 16 bytes a thread, 128 contiguous bytes a
        // position: chunk tid & 7 of output rows 32 j + (tid >> 3)
        __nv_bfloat16* yt = y + at(t, 0, 0, Co) + co0 + (tid & 7) * 8;
#pragma unroll
        for (int j = 0; j < (kPixB + 31) / 32; ++j) {
            const int o = 32 * j + (tid >> 3);
            const int pos = static_cast<int>(lds32(sbase + kPosTable + 4 * o));
            if (pos >= 0)
                *reinterpret_cast<uint4*>(yt + static_cast<size_t>(pos) * Co) =
                    lds128(sbase + swz(kXS + o, tid & 7));
        }
    }
}

template <bool kProject>
int launch_mma(const void* x, const void* wa, const void* ba, const void* wb, const void* bb,
               const void* wc, const void* bc, const void* ws, const void* bs, void* y, int B,
               int T, int H, int W, int Cin, int Co, int tk, cudaStream_t st) {
    auto kernel = fused_bottleneck_mma_kernel<kProject>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           kMmaSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int tiles_h = (H + kTile - 1) / kTile;
    const int tiles_w = (W + kTile - 1) / kTile;
    const dim3 grid(tiles_h * tiles_w, T, B);
    using bf = __nv_bfloat16;
    kernel<<<grid, kThreads, kMmaSmem, st>>>(
        static_cast<const bf*>(x), static_cast<const bf*>(wa), static_cast<const float*>(ba),
        static_cast<const bf*>(wb), static_cast<const float*>(bb), static_cast<const bf*>(wc),
        static_cast<const float*>(bc), static_cast<const bf*>(ws), static_cast<const float*>(bs),
        static_cast<bf*>(y), T, H, W, Cin, Co, tk, tiles_w);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes), one per kernel: the wrapper
// picks by dtype. ws and bs are null for an identity shortcut. Each
// launches on `stream`, does not synchronise, and returns the cudaError_t of
// the launch.
extern "C" int fused_bottleneck_bf16_launch(const void* x, const void* wa, const void* ba,
                                            const void* wb, const void* bb, const void* wc,
                                            const void* bc, const void* ws, const void* bs,
                                            void* y, int B, int T, int H, int W, int Cin, int Co,
                                            int tk, void* stream) {
    if (B == 0 || T == 0 || H == 0 || W == 0 || Co == 0) return 0;
    if (tk != 1 && tk != kMaxTk) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return ws != nullptr
        ? launch_mma<true>(x, wa, ba, wb, bb, wc, bc, ws, bs, y, B, T, H, W, Cin, Co, tk, st)
        : launch_mma<false>(x, wa, ba, wb, bb, wc, bc, ws, bs, y, B, T, H, W, Cin, Co, tk, st);
}

extern "C" int fused_bottleneck_f32_launch(const void* x, const void* wa, const void* ba,
                                           const void* wb, const void* bb, const void* wc,
                                           const void* bc, const void* ws, const void* bs,
                                           void* y, int B, int T, int H, int W, int Cin, int Co,
                                           int tk, void* stream) {
    if (B == 0 || T == 0 || H == 0 || W == 0 || Co == 0) return 0;
    if (tk != 1 && tk != kMaxTk) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return ws != nullptr
        ? launch<float, true>(x, wa, ba, wb, bb, wc, bc, ws, bs, y, B, T, H, W, Cin, Co, tk, st)
        : launch<float, false>(x, wa, ba, wb, bb, wc, bc, ws, bs, y, B, T, H, W, Cin, Co, tk, st);
}
