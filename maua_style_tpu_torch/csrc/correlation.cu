// Cost-volume correlation for Hopper (sm_90a), the PWC-Net / LiteFlowNet /
// FlowNetC layer:
//
//   out[b, k, h, w] = sum_c f1[b, c, h, w] * f2[b, c, h + dy_k - d, w + dx_k - d] / C
//
// with f2 zero outside the frame, k = iy * n + ix, dy = iy * s, dx = ix * s,
// n = 2d/s + 1 (so dy is the outer index).  f1, f2: (B, C, H, W) f32
// contiguous; out: (B, K, H, W) f32, K = n * n.  Inference only.
//
// Replaces the TPU kernel maua_style_tpu/ops/correlation.py:_corr_kernel
// (driven by correlation_pallas).
//
// Bound: bytes.  Per pixel the function reads 2*C floats and writes K; the
// operations are 2*C*K per pixel, so at d = 4 (K = 81) there are about
// 2*C*81 / (4*(2*C + 81)) operations per byte: 15 at C = 32, 32 at C = 196.
// Against the H100's FP32 SIMT balance (67 TFLOP/s over 3.35 TB/s = 20 per
// byte) the small-C levels are bound by bytes and the output write (81 f32
// per pixel) is the largest single term; the C = 196 level leans to
// operations.
//
// Design, and what differs from the TPU kernel:
// - The TPU kernel pads f1/f2 with jnp.pad (H to a tile multiple, W to 8,
//   C to 128, and a d-wide zero halo) and DMAs one overlapping halo window of
//   f2 per row tile into VMEM.  Here each block owns a TH x TW pixel tile and
//   a group of G displacements; it stages a chunk of CC channels of f1's
//   tile and of f2's (TH + 2d) x (TW + 2d) halo window in shared memory, with
//   the zero halo and the ragged H/W/C edges masked in the loads: no padded
//   copy.  Channel chunks loop inside the block.
// - One thread per output pixel keeps G = 32 displacement sums in registers
//   (f32 FMA) and the group's offsets into the halo window in registers
//   (computed once per block).  A warp covers 32 consecutive
//   columns, so halo reads, f1 reads and the output stores are all
//   consecutive addresses.  Each group of G re-stages the channels, so
//   K = 81 reads f1 and f2 three times (from L2 for all but the first).
// - General (d, s): the halo is (TH + 2d) x (TW + 2d) whatever the stride,
//   and the host picks CC so that the staging fits.  Above 48 KB of shared
//   memory the kernel opts in with cudaFuncSetAttribute; a refused opt-in or
//   launch returns its error code, which the wrapper raises.
// - Deterministic: each output is one thread's sum in a fixed channel order,
//   written once; no atomics.
// - The sum is divided by the true C (the TPU kernel pads C to 128 and
//   divides by true_c).
// Plain SIMT, no TMA or tensor cores yet.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8;         // tile rows
constexpr int TW = 32;        // tile columns (one warp per row)
constexpr int THREADS = TH * TW;
constexpr int G = 32;         // displacements per block

// grid (tiles_w * groups, tiles_h, B); dynamic shared memory
// CC * (TH * TW + HH * HW) floats, HH = TH + 2d, HW = TW + 2d.
__global__ void __launch_bounds__(THREADS)
correlation_kernel(const float* __restrict__ f1, const float* __restrict__ f2, float* __restrict__ out,
                   int C, int H, int W, int d, int s, int n, int tiles_w, int cc, float inv_c) {
  extern __shared__ float smem[];
  __shared__ int offs[G];

  const int K = n * n;
  const int HH = TH + 2 * d;
  const int HW = TW + 2 * d;
  const int halo = HH * HW;
  float* f1s = smem;                 // [cc][TH * TW]
  float* f2s = smem + cc * THREADS;  // [cc][HH * HW]

  const int tile_w = blockIdx.x % tiles_w;
  const int group = blockIdx.x / tiles_w;
  const int h0 = blockIdx.y * TH;
  const int w0 = tile_w * TW;
  const int b = blockIdx.z;
  const int k0 = group * G;

  const int tid = threadIdx.x;
  const int ty = tid / TW;
  const int tx = tid % TW;

  if (tid < G) {
    const int k = k0 + tid;
    // displacements past K read the window's corner and are never stored
    offs[tid] = (k < K) ? (k / n) * s * HW + (k % n) * s : 0;
  }
  __syncthreads();
  int off[G];  // the group's offsets into the halo window, in registers
#pragma unroll
  for (int j = 0; j < G; ++j) off[j] = offs[j];

  const int64_t plane = (int64_t)H * W;
  const float* f1b = f1 + (int64_t)b * C * plane;
  const float* f2b = f2 + (int64_t)b * C * plane;

  float acc[G];
#pragma unroll
  for (int j = 0; j < G; ++j) acc[j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += cc) {
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = tid; i < cc * THREADS; i += THREADS) {
      const int c = c0 + i / THREADS;
      const int p = i % THREADS;
      const int y = h0 + p / TW;
      const int x = w0 + p % TW;
      f1s[i] = (c < C && y < H && x < W) ? f1b[c * plane + (int64_t)y * W + x] : 0.f;
    }
    for (int i = tid; i < cc * halo; i += THREADS) {
      const int c = c0 + i / halo;
      const int q = i % halo;
      const int y = h0 - d + q / HW;
      const int x = w0 - d + q % HW;
      f2s[i] = (c < C && y >= 0 && y < H && x >= 0 && x < W) ? f2b[c * plane + (int64_t)y * W + x] : 0.f;
    }
    __syncthreads();
    const int cn = min(cc, C - c0);
    for (int c = 0; c < cn; ++c) {
      const float a = f1s[c * THREADS + tid];
      const float* win = f2s + c * halo + ty * HW + tx;
#pragma unroll
      for (int j = 0; j < G; ++j) acc[j] = fmaf(a, win[off[j]], acc[j]);
    }
  }

  const int y = h0 + ty;
  const int x = w0 + tx;
  if (y >= H || x >= W) return;
  float* ob = out + (int64_t)b * K * plane + (int64_t)y * W + x;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int k = k0 + j;
    if (k < K) ob[k * plane] = acc[j] * inv_c;
  }
}

// Shared memory the kernel needs for a channel chunk of cc (bytes).
int64_t smem_bytes(int max_disp, int cc) {
  const int64_t halo = (int64_t)(TH + 2 * max_disp) * (TW + 2 * max_disp);
  return (int64_t)cc * (THREADS + halo) * (int64_t)sizeof(float);
}

}  // namespace

// f1, f2: (B, C, H, W) f32 contiguous; out: (B, K, H, W) f32, K = (2d/s + 1)^2.
// cc: channels staged per chunk.  Returns the cudaError_t (0 = ok).
extern "C" int correlation_forward(const void* f1, const void* f2, void* out, int B, int C, int H, int W,
                                   int max_disp, int stride, int cc, void* stream) {
  const int n = 2 * max_disp / stride + 1;
  const int K = n * n;
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  const int groups = (K + G - 1) / G;
  const int64_t smem = smem_bytes(max_disp, cc);
  cudaError_t err = cudaFuncSetAttribute(correlation_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(tiles_w * groups, tiles_h, B);
  correlation_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f1), static_cast<const float*>(f2), static_cast<float*>(out), C, H, W,
      max_disp, stride, n, tiles_w, cc, 1.0f / static_cast<float>(C));
  return static_cast<int>(cudaGetLastError());
}
