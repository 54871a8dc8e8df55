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
// version agree bit for bit on the same inputs.
//
// Bound: memory. Per launch the card must read the crops once and write the
// output once. At a full batch of the main path (batch_clips=2: N=64 frames,
// H=W=256 float32 in, S=224 float32 out) that is 50.3 MB read + 38.5 MB
// written, about 26 us at 3.35 TB/s (one face ships B=1, N=32: half that);
// the arithmetic (47 flops per output pixel) is far below the float32 rate.
// Design against that bound: one thread per output pixel; a block of 32x8
// pixels covers one frame, so its 6 parameters are read once
// per block into shared memory; the 4 taps x 3 channels are read through the
// read-only path from the crop, which stays L2-resident while its frame's
// blocks run (blockIdx.z is the frame, so one frame's tiles launch
// together; a 256x256x3 frame is 192 KiB as uint8, 768 KiB as float32);
// stores are coalesced along the output column (a warp writes 32 adjacent
// pixels, 384 contiguous bytes). Making it faster is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileX = 32;  // output columns per block: one warp
constexpr int kTileY = 8;   // output rows per block

__device__ __forceinline__ float load_px(const uint8_t* p) { return static_cast<float>(__ldg(p)); }
__device__ __forceinline__ float load_px(const float* p) { return __ldg(p); }

// (v * a) * b, each product rounded: the plain version's tap * w1 * w2
__device__ __forceinline__ float wmul(float v, float a, float b) {
    return __fmul_rn(__fmul_rn(v, a), b);
}

template <typename T>
__global__ void __launch_bounds__(kTileX * kTileY)
warp_affine_kernel(const T* __restrict__ crops, const float* __restrict__ params,
                   float* __restrict__ out, int H, int W, int S) {
    __shared__ float m[6];
    const int n = blockIdx.z;
    const int tid = threadIdx.y * kTileX + threadIdx.x;
    if (tid < 6) m[tid] = params[static_cast<size_t>(n) * 8 + tid];
    __syncthreads();

    const int c = blockIdx.x * kTileX + threadIdx.x;
    const int r = blockIdx.y * kTileY + threadIdx.y;
    if (c >= S || r >= S) return;
    const float cf = static_cast<float>(c);
    const float rf = static_cast<float>(r);
    // ((m00*c) + (m01*r)) + m02, as the plain version's tensor expression
    const float x = __fadd_rn(__fadd_rn(__fmul_rn(m[0], cf), __fmul_rn(m[1], rf)), m[2]);
    const float y = __fadd_rn(__fadd_rn(__fmul_rn(m[3], cf), __fmul_rn(m[4], rf)), m[5]);

    float acc[3] = {0.f, 0.f, 0.f};
    if (isfinite(x) && isfinite(y)) {
        const float x0 = floorf(x);
        const float y0 = floorf(y);
        // some tap lies inside only when x0 in [-1, W-1] and y0 in [-1, H-1];
        // otherwise every tap weighs 0 and the sample is exactly 0
        if (x0 >= -1.f && x0 <= static_cast<float>(W - 1) &&
            y0 >= -1.f && y0 <= static_cast<float>(H - 1)) {
            const float wx = __fsub_rn(x, x0);
            const float wy = __fsub_rn(y, y0);
            const float omx = __fsub_rn(1.f, wx);
            const float omy = __fsub_rn(1.f, wy);
            const int xi = static_cast<int>(x0);
            const int yi = static_cast<int>(y0);
            const bool vx0 = xi >= 0, vx1 = xi + 1 < W;
            const bool vy0 = yi >= 0, vy1 = yi + 1 < H;
            // xi or yi may be -1 (or the far tap may lie past the edge):
            // clamp the rows and columns so every pointer formed lies inside
            // the frame; the validity flags zero those taps
            const T* img = crops + static_cast<size_t>(n) * H * W * 3;
            const T* row0 = img + static_cast<size_t>(max(yi, 0)) * W * 3;
            const T* row1 = img + static_cast<size_t>(min(yi + 1, H - 1)) * W * 3;
            const int c0 = max(xi, 0) * 3;
            const int c1 = min(xi + 1, W - 1) * 3;
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) {
                const float v00 = (vy0 && vx0) ? load_px(row0 + c0 + ch) : 0.f;
                const float v01 = (vy0 && vx1) ? load_px(row0 + c1 + ch) : 0.f;
                const float v10 = (vy1 && vx0) ? load_px(row1 + c0 + ch) : 0.f;
                const float v11 = (vy1 && vx1) ? load_px(row1 + c1 + ch) : 0.f;
                acc[ch] = __fadd_rn(__fadd_rn(__fadd_rn(wmul(v00, omx, omy), wmul(v01, wx, omy)),
                                              wmul(v10, omx, wy)),
                                    wmul(v11, wx, wy));
            }
        }
    }
    float* o = out + ((static_cast<size_t>(n) * S + r) * S + c) * 3;
    o[0] = acc[0];
    o[1] = acc[1];
    o[2] = acc[2];
}

}  // namespace

extern "C" int warp_affine_launch(const void* crops, int crops_u8, const float* params,
                                  float* out, int n, int h, int w, int s, void* stream) {
    if (n == 0 || s == 0) return 0;
    const dim3 block(kTileX, kTileY);
    const dim3 grid((s + kTileX - 1) / kTileX, (s + kTileY - 1) / kTileY, n);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (crops_u8) {
        warp_affine_kernel<uint8_t><<<grid, block, 0, st>>>(
            static_cast<const uint8_t*>(crops), params, out, h, w, s);
    } else {
        warp_affine_kernel<float><<<grid, block, 0, st>>>(
            static_cast<const float*>(crops), params, out, h, w, s);
    }
    return static_cast<int>(cudaGetLastError());
}
