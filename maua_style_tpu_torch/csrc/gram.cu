// Gram kernel for Hopper (sm_90a): G[b] = F[b] F[b]^T, F[b] of shape (C, N)
// with N contiguous (an NCHW activation viewed as (B, C, H*W)), f32 or bf16
// in, f32 out.
//
// Replaces the TPU kernel maua_style_tpu/ops/pallas_gram.py:_gram_kernel
// (driven by _gram_pallas_fwd / gram_pallas / gram_nhwc).
//
// Bound: G is symmetric, so the function needs N*C*(C+1) operations (the
// C(C+1)/2 entries on and above the diagonal) against 4*N*C input bytes
// (f32), i.e. (C+1)/4 operations per byte.  Against the H100's FP32 SIMT
// balance (67 TFLOP/s over 3.35 TB/s = 20 per byte), the f32 Gram at C = 64
// (relu1_1) is bound by bytes and at C = 128..512 by operations; bf16 inputs
// against the bf16 tensor-core rate are bound by bytes at every style layer.
//
// Design, and what differs from the TPU kernel:
// - The TPU kernel carries the sum over N across a sequential grid in a VMEM
//   scratch.  Blocks here run in parallel and in no order, and at C = 64 the
//   whole output is one 64x64 tile, so N is split across enough blocks to
//   fill the SMs (split-K).  Each block writes its partial tile; a second
//   kernel sums the partials in a fixed order.  No float atomics: two runs
//   give bit-identical Grams.
// - No padding copies: the TPU kernel pads C to 128 and N to a tile multiple
//   with jnp.pad (a 268 MB copy at relu1_1, 1024^2, f32).  Here the ragged
//   edges of C and N are masked in the loads.
// - Symmetry: only tiles (ti <= tj) are computed; the reduce pass mirrors
//   the off-diagonal tiles.
// - Each block stages TK-deep slices of its two 64-row channel ranges in
//   shared memory, loaded along N so a warp reads 32 consecutive elements
//   (coalesced); 256 threads each accumulate a 4x4 sub-tile in f32
//   registers with FMA.  bf16 inputs are widened to f32 on load.
// Plain SIMT, no tensor cores, TMA or wgmma yet.
//
// The host wrapper (maua_style_tpu_torch/ops/gram.py) allocates the output
// and the partials, chooses the split, and checks the returned error code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;      // output tile edge
constexpr int TK = 32;        // depth along N of one shared-memory stage
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Linear index over the upper-triangular tile pairs -> (ti, tj), ti <= tj.
__device__ __forceinline__ void tile_pair(int t, int n_tiles, int& ti, int& tj) {
  int i = 0;
  while (t >= n_tiles - i) {
    t -= n_tiles - i;
    ++i;
  }
  ti = i;
  tj = i + t;
}

// grid (pairs, splits, B): partial[split][b][pair][64][64] = F_i[k range] F_j[k range]^T
template <typename T>
__global__ void __launch_bounds__(THREADS)
gram_partial_kernel(const T* __restrict__ f, int C, int64_t N, int n_tiles, int64_t chunk,
                    float* __restrict__ partial) {
  __shared__ float As[TK][TILE + 1];
  __shared__ float Bs[TK][TILE + 1];

  int ti, tj;
  tile_pair(blockIdx.x, n_tiles, ti, tj);
  const int split = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t k_begin = (int64_t)split * chunk;
  const int64_t k_end = (k_begin + chunk < N) ? k_begin + chunk : N;
  const T* fb = f + (int64_t)b * C * N;
  const int i0 = ti * TILE;
  const int j0 = tj * TILE;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int lk = tid % TK;  // load lane along N
  const int lr = tid / TK;  // load row group, 0..7

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int64_t k0 = k_begin; k0 < k_end; k0 += TK) {
    const int64_t k = k0 + lk;
    const bool k_in = k < k_end;
#pragma unroll
    for (int r = 0; r < TILE / 8; ++r) {
      const int row = lr + 8 * r;
      const int gi = i0 + row;
      const int gj = j0 + row;
      As[lk][row] = (k_in && gi < C) ? to_f32(fb[(int64_t)gi * N + k]) : 0.f;
      Bs[lk][row] = (k_in && gj < C) ? to_f32(fb[(int64_t)gj * N + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = As[kk][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = Bs[kk][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }

  float* out = partial + (((int64_t)split * gridDim.z + b) * gridDim.x + blockIdx.x) * (TILE * TILE);
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) out[(ty + 16 * r) * TILE + tx + 16 * c] = acc[r][c];
}

// One thread per (b, pair, element): sum the splits in order, write G and
// its mirror.
__global__ void gram_reduce_kernel(const float* __restrict__ partial, int splits, int B, int pairs,
                                   int n_tiles, int C, float* __restrict__ out) {
  const int64_t per_split = (int64_t)B * pairs * TILE * TILE;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= per_split) return;
  const int e = (int)(idx % (TILE * TILE));
  const int64_t rest = idx / (TILE * TILE);
  const int pair = (int)(rest % pairs);
  const int b = (int)(rest / pairs);
  int ti, tj;
  tile_pair(pair, n_tiles, ti, tj);
  const int gi = ti * TILE + e / TILE;
  const int gj = tj * TILE + e % TILE;
  if (gi >= C || gj >= C) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += partial[sp * per_split + idx];
  out[((int64_t)b * C + gi) * C + gj] = s;
  if (ti != tj) out[((int64_t)b * C + gj) * C + gi] = s;
}

}  // namespace

// f: (B, C, N) contiguous, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1).
// partial: splits * B * pairs * 64 * 64 f32, pairs = T (T + 1) / 2, T = ceil(C / 64).
// out: (B, C, C) f32.  Returns the cudaError_t of the launches (0 = ok).
extern "C" int gram_forward(const void* f, int is_bf16, int B, int C, int64_t N, int splits,
                            int64_t chunk, void* partial, void* out, void* stream) {
  const int n_tiles = (C + TILE - 1) / TILE;
  const int pairs = n_tiles * (n_tiles + 1) / 2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(pairs, splits, B);
  if (is_bf16) {
    gram_partial_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(f), C, N, n_tiles, chunk, static_cast<float*>(partial));
  } else {
    gram_partial_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(f), C, N, n_tiles, chunk, static_cast<float*>(partial));
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = (int64_t)B * pairs * TILE * TILE;
  const int blocks = (int)((total + 255) / 256);
  gram_reduce_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(partial), splits, B, pairs,
                                             n_tiles, C, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
