// K1 — batched affine clip warp, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel stdd_tpu/ops/warp_pallas.py::warp_clip_pallas
// (kernel body _warp_kernel). The TPU kernel recast the warp as banded
// matmuls to feed the MXU, which made it exact only inside a rotation
// envelope; this kernel is the exact gather for every affine, with no band
// and no fallback.
//
// What it computes: for each of N frames an [S,S,3] float32 image whose
// pixel (r, c) is the bilinear sample of the [H,W,3] crop (uint8 or float32)
// at x = m00*c + m01*r + m02, y = m10*c + m11*r + m12, with the per-frame
// parameters [N,8] from pack_warp_params (m00 m01 m02 m10 m11 m12 pad pad,
// the per-frame scale already folded in). Taps outside the image weigh 0
// (cv2 BORDER_CONSTANT 0); a non-finite coordinate (padded batch slots fit
// to NaN) samples nothing, so it gives 0 and never an out-of-bounds read.
//
// Arithmetic order: every coordinate, weight, product and sum is rounded in
// the same order as the plain PyTorch version
// (stdd_torch/ops/align.py::bilinear_sample), with the _rn intrinsics so
// nvcc cannot contract a multiply-add into an FMA — kernel and plain
// version agree bit for bit on the same inputs. Each pixel is computed on
// its own from (r, c), never incrementally along the row.
//
// Bound: memory. Per launch the card must read the crops once and write the
// output once. At one face of the main path (B=1: N=32 frames, H=W=256
// float32 in, S=224 float32 out) that is 25.2 MB read + 19.3 MB written,
// 0.0133 ms at 3.35 TB/s (0.0265 ms at N=64); the arithmetic (47 flops per
// output pixel) is far below the float32 rate.
//
// What held the first version back: one pixel per thread ended in three
// 4-byte stores at a 12-byte stride, so each warp store instruction wrote
// 384 bytes as 12 partly written 32-byte sectors, three instructions a
// pixel. Design against that: each thread computes 4 output pixels and a
// warp a strip of 128 consecutive pixels of one frame (in row-major order,
// so a strip may cross a row), lane l taking pixels l, l+32, l+64, l+96:
// each load instruction of the warp still gathers the taps of 32 adjacent
// pixels, as in the first version. (Four adjacent pixels a thread, tried
// first, spread each load instruction over 4x the span and ran slower on
// the H100.) The warp writes its strip's 384 floats to shared
// memory (a 12-byte stride: conflict-free) and reads them back as 96
// float4, so every global store is a full 16-byte vector and each warp
// store instruction writes 512 contiguous bytes in 16 whole sectors, three
// a thread. That needs the strip 16-byte aligned, which holds for even S
// (a frame is S*S*12 bytes, a multiple of 16); for odd S (never on the
// served path) the pixels are stored as scalars. Each pixel's sample is
// branch-free (taps clamped into the frame, validity applied by select), so
// the loads of a thread's four pixels are in flight together. A block of
// 256 threads covers 1024 pixels of one frame, and a frame's blocks are
// consecutive in blockIdx.x under one blockIdx.y, so they launch together
// and the frame's crop stays L2-resident while they run (192 KiB as uint8,
// 768 KiB as float32).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPx = 4;                   // output pixels a thread: lane + 32 k of its warp's strip
constexpr int kStrip = 32 * kPx;         // consecutive pixels of a warp: 128
constexpr int kBlockPx = kThreads * kPx; // 1024 pixels a block
constexpr int kF4 = (kStrip * 3 / 4 + 31) / 32;   // float4 stores a thread: 3

__device__ __forceinline__ float load_px(const uint8_t* p) { return static_cast<float>(__ldg(p)); }
__device__ __forceinline__ float load_px(const float* p) { return __ldg(p); }

// (v * a) * b, each product rounded: the plain version's tap * w1 * w2
__device__ __forceinline__ float wmul(float v, float a, float b) {
    return __fmul_rn(__fmul_rn(v, a), b);
}

// the bilinear sample of output pixel (r, c) of frame `img` into acc[0..2];
// branch-free, so the loads of several pixels can be in flight together
template <typename T>
__device__ __forceinline__ void sample_px(const T* __restrict__ img, const float* m, int H, int W,
                                          int r, int c, float* acc) {
    const float cf = static_cast<float>(c);
    const float rf = static_cast<float>(r);
    // ((m00*c) + (m01*r)) + m02, as the plain version's tensor expression
    const float x = __fadd_rn(__fadd_rn(__fmul_rn(m[0], cf), __fmul_rn(m[1], rf)), m[2]);
    const float y = __fadd_rn(__fadd_rn(__fmul_rn(m[3], cf), __fmul_rn(m[4], rf)), m[5]);
    const float x0 = floorf(x);
    const float y0 = floorf(y);
    // some tap lies inside only when x0 in [-1, W-1] and y0 in [-1, H-1]
    // (false for a non-finite coordinate); otherwise the sample is exactly 0
    const bool any = x0 >= -1.f && x0 <= static_cast<float>(W - 1) &&
                     y0 >= -1.f && y0 <= static_cast<float>(H - 1);
    const float wx = __fsub_rn(x, x0);
    const float wy = __fsub_rn(y, y0);
    const float omx = __fsub_rn(1.f, wx);
    const float omy = __fsub_rn(1.f, wy);
    const int xi = any ? static_cast<int>(x0) : 0;
    const int yi = any ? static_cast<int>(y0) : 0;
    const bool vx0 = xi >= 0, vx1 = xi + 1 < W;
    const bool vy0 = yi >= 0, vy1 = yi + 1 < H;
    // xi or yi may be -1 (or the far tap may lie past the edge): clamp the
    // rows and columns so every tap read lies inside the frame; all four are
    // read, and the validity flags zero those outside
    const T* row0 = img + static_cast<size_t>(max(yi, 0)) * W * 3;
    const T* row1 = img + static_cast<size_t>(min(yi + 1, H - 1)) * W * 3;
    const int c0 = max(xi, 0) * 3;
    const int c1 = min(xi + 1, W - 1) * 3;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
        const float t00 = load_px(row0 + c0 + ch), t01 = load_px(row0 + c1 + ch);
        const float t10 = load_px(row1 + c0 + ch), t11 = load_px(row1 + c1 + ch);
        const float v00 = (vy0 && vx0) ? t00 : 0.f;
        const float v01 = (vy0 && vx1) ? t01 : 0.f;
        const float v10 = (vy1 && vx0) ? t10 : 0.f;
        const float v11 = (vy1 && vx1) ? t11 : 0.f;
        const float sum = __fadd_rn(__fadd_rn(__fadd_rn(wmul(v00, omx, omy), wmul(v01, wx, omy)),
                                              wmul(v10, omx, wy)),
                                    wmul(v11, wx, wy));
        acc[ch] = any ? sum : 0.f;
    }
}

// grid (ceil(S*S / 1024), N): block x of frame n covers its pixels
// 1024 x .. 1024 x + 1023 in row-major order, warp w the strip of 128 from
// 1024 x + 128 w
template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_affine_kernel(const T* __restrict__ crops, const float* __restrict__ params,
                   float* __restrict__ out, int H, int W, int S) {
    __shared__ float m[6];
    __shared__ __align__(16) float stage[kWarps][kStrip * 3];
    const int n = blockIdx.y;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    if (tid < 6) m[tid] = params[static_cast<size_t>(n) * 8 + tid];
    __syncthreads();

    const int npx = S * S;
    const int q0 = blockIdx.x * kBlockPx + warp * kStrip;     // the strip's first pixel
    const int live = min(kStrip, npx - q0);                     // its pixels inside the frame
    const T* img = crops + static_cast<size_t>(n) * H * W * 3;
    float v[kPx][3];
#pragma unroll
    for (int k = 0; k < kPx; ++k) {
        // pixels past the frame's end sample its last one; they are not stored
        const int q = min(q0 + lane + 32 * k, npx - 1);
        const int r = q / S;
        sample_px(img, m, H, W, r, q - r * S, v[k]);
    }

    float* frame = out + static_cast<size_t>(n) * npx * 3;
    if (S % 2 == 0) {
        // the strip is 16-byte aligned and `live` a multiple of 4: pass it
        // through shared memory, then 16 bytes a thread, 512 bytes a store
#pragma unroll
        for (int k = 0; k < kPx; ++k) {
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) stage[warp][(lane + 32 * k) * 3 + ch] = v[k][ch];
        }
        __syncwarp();
        const float4* src = reinterpret_cast<const float4*>(stage[warp]);
        float4* dst = reinterpret_cast<float4*>(frame + static_cast<size_t>(q0) * 3);
#pragma unroll
        for (int k = 0; k < kF4; ++k) {
            const int j = lane + 32 * k;
            if (j < live * 3 / 4) dst[j] = src[j];
        }
    } else {
        // odd S: a frame is not 16-byte aligned; scalar stores
#pragma unroll
        for (int k = 0; k < kPx; ++k) {
            if (lane + 32 * k < live) {
                float* o = frame + static_cast<size_t>(q0 + lane + 32 * k) * 3;
                o[0] = v[k][0];
                o[1] = v[k][1];
                o[2] = v[k][2];
            }
        }
    }
}

}  // namespace

// Plain C entry point (bound with ctypes). `out` is 16-byte aligned (the
// wrapper allocates it). Launches on `stream`, does not synchronise, and
// returns the cudaError_t of the launch.
extern "C" int warp_affine_launch(const void* crops, int crops_u8, const float* params,
                                  float* out, int n, int h, int w, int s, void* stream) {
    if (n == 0 || s == 0) return 0;
    const dim3 grid((s * s + kBlockPx - 1) / kBlockPx, n);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (crops_u8) {
        warp_affine_kernel<uint8_t><<<grid, kThreads, 0, st>>>(
            static_cast<const uint8_t*>(crops), params, out, h, w, s);
    } else {
        warp_affine_kernel<float><<<grid, kThreads, 0, st>>>(
            static_cast<const float*>(crops), params, out, h, w, s);
    }
    return static_cast<int>(cudaGetLastError());
}
