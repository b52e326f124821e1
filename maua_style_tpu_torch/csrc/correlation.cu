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
// byte) the large PWC levels (C = 32, 64) are bound by bytes, and the output
// write (81 f32 per pixel) is the largest single term.  The design moves each
// input byte from device memory once per block and keeps the FMA loop off the
// shared-memory port:
//
// - Register blocking.  A block owns a TH x TW pixel tile of one frame.  A
//   computing thread owns 4 consecutive pixels of a row x ROWS displacement
//   rows x NX displacement columns: 4 * ROWS * NX f32 sums in registers.  Per
//   channel it reads f1 as one float4 and, for each of its rows, one aligned
//   segment of f2 as SEG float4s; at d = 4 (ROWS = 3, NX = 9) that is 10
//   16-byte shared-memory loads for 108 FMAs.  The block's thread groups
//   cover GROUPS * ROWS displacement rows; where n is larger (FlowNetC's
//   d = 20, s = 2) the grid splits the rows (and, past the register budget,
//   the columns) over blocks, each staging only the halo rows it reads.
// - Staging: a ring of STAGES chunks of CC channels, so chunk t + 2 is in
//   flight while chunk t is computed; one __syncthreads per chunk.  The
//   halo's column 0 is at x = w0 - d - OFF + ix0 * s with OFF = (-d) mod 4,
//   16-byte aligned.  Where W % 4 == 0 and the inputs are 16-byte aligned
//   (TMA = true) one thread copies a chunk with two TMA tensor copies (f1's
//   tile and f2's halo, each a box of CC channels) that complete on an
//   mbarrier; TMA writes zeros outside the tensor, so the frame's zero halo
//   and ragged edges cost nothing.  Otherwise (W = 30 at level 6 of a
//   1920x1088 frame; an unaligned view) every thread issues 4-byte cp.async
//   copies, zero-filled by a source size of 0, from source offsets it
//   computes once per block; the same layout.
// - Small levels: the host picks the tile from H and W (a 1 x 1 level stages
//   a 1 x 4 tile and its 9 x 12 halo, not 8 x 32 and 16 x 40), and splits C
//   across blocks where the grid would not fill the SMs; each split writes a
//   partial cost volume and correlation_reduce sums them in split order.
// - Stores: float4 along x where W % 4 == 0, scalar otherwise, streaming
//   (st.global.cs); the sum is scaled by 1/C once, in the epilogue.
// - Deterministic: each output is one thread's sum in channel order (and the
//   splits' partials in split order), written once; no atomics.
// - Compile-time shape: the stride S, NX, ROWS and OFF (the -D defines
//   CORR_S, CORR_NX, CORR_ROWS, CORR_OFF), so the sums and the segment stay
//   in registers; the host builds one library per (d, s) family at first use
//   (maua_style_tpu_torch/ops/correlation.py, launch_plan).  d, n, the tile
//   and everything else are run-time arguments.
// Plain SIMT FP32: the function has no dense product worth the tensor cores
// (an f32-accurate one would take 3xTF32 over a banded matrix).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef CORR_S
#define CORR_S 1
#endif
#ifndef CORR_NX
#define CORR_NX 9
#endif
#ifndef CORR_ROWS
#define CORR_ROWS 3
#endif
#ifndef CORR_OFF
#define CORR_OFF 0
#endif

namespace {

constexpr int S = CORR_S;        // displacement stride
constexpr int NX = CORR_NX;      // displacement columns per thread
constexpr int ROWS = CORR_ROWS;  // displacement rows per thread
constexpr int OFF = CORR_OFF;    // (-d) mod 4: the halo's column 0 is 16-byte aligned
constexpr int PX = 4;            // pixels per thread, along x
constexpr int SEG = (OFF + PX + (NX - 1) * S + 3) / 4;  // float4s of f2 a thread reads per row
constexpr int STAGES = 3;        // chunks of channels in the ring
constexpr int MAX_THREADS = 192;
static_assert(S >= 1 && NX >= 1 && ROWS >= 1 && OFF >= 0 && OFF < 4, "bad compile-time shape");

// The run-time shape of a launch (see correlation_forward).
struct Geom {
  int B, C, H, W, d, n;
  int th, tw, tiles_w;   // pixel tile
  int groups;            // thread groups of ROWS displacement rows per block
  int dy_blocks;         // blocks along the displacement rows (blockIdx.y = dx group * dy_blocks + dy block)
  int chunk_c;           // channels per split (blockIdx.z = split * B + b)
  int cc;                // channels per ring stage
  int hh, hws;           // halo rows and columns staged
  int f1_floats;         // a stage's f1 tiles (cc * th * tw), rounded up to 128 bytes
  int slot_floats;       // a stage: f1_floats + f2's halos (cc * hh * hws), rounded up to 128 bytes
  int computing;         // threads that compute: th * tw / 4 * groups
  float scale;           // 1/C, or 1 for a split's partial sums
};

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" : : "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" : : "n"(N) : "memory");
}

__device__ __forceinline__ void mbarrier_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" : : "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbarrier_arrive_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" : : "r"(bar), "r"(bytes) : "memory");
}
// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbarrier_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n"
      :
      : "r"(bar), "r"(parity)
      : "memory");
}
// A box of the 3-D tensor (x, y, z) = (column, row, frame * C + channel)
// into shared memory at dst; out-of-tensor elements are written as zeros.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int x, int y, int z, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :
      : "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(bar)
      : "memory");
}

// grid (tiles, dx_groups * dy_blocks, splits * B).  Dynamic shared memory,
// from its first 128-byte boundary: STAGES slots of slot_floats (f1's tiles
// [cc][th][tw], then f2's halos [cc][hh][hws]), STAGES mbarriers, and the
// 4-byte path's source offsets (th * tw + hh * hws ints).
template <bool TMA>
__global__ void __launch_bounds__(MAX_THREADS, 2)
correlation_blocked(const float* __restrict__ f1, const float* __restrict__ f2, float* __restrict__ out, const Geom g,
                    const __grid_constant__ CUtensorMap map1, const __grid_constant__ CUtensorMap map2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t pad = (128u - (raw & 127u)) & 127u;
  const uint32_t sbase = raw + pad;
  const float* smem = reinterpret_cast<const float*>(smem_raw + pad);
  const uint32_t bars = sbase + STAGES * g.slot_floats * 4;
  int* tab1 = reinterpret_cast<int*>(smem_raw + pad + STAGES * g.slot_floats * 4 + STAGES * 8);
  int* tab2 = tab1 + g.th * g.tw;

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int h0 = (blockIdx.x / g.tiles_w) * g.th;
  const int w0 = (blockIdx.x % g.tiles_w) * g.tw;
  const int iy0 = (blockIdx.y % g.dy_blocks) * ROWS * g.groups;
  const int ix0 = (blockIdx.y / g.dy_blocks) * NX;
  const int b = blockIdx.z % g.B;
  const int split = blockIdx.z / g.B;
  const int c_begin = split * g.chunk_c;
  const int c_end = min(g.C, c_begin + g.chunk_c);
  const int hy0 = h0 - g.d + iy0 * S;        // frame row of halo row 0
  const int hx0 = w0 - g.d - OFF + ix0 * S;  // frame column of halo column 0
  const int64_t plane = static_cast<int64_t>(g.H) * g.W;
  const int chunks = (c_end - c_begin + g.cc - 1) / g.cc;

  if constexpr (TMA) {
    if (tid == 0) {
      for (int s = 0; s < STAGES; ++s) mbarrier_init(bars + 8 * s, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  } else {
    // Source offsets within a channel's plane, once per block; -1 is outside
    // the frame (zero-filled).  A thread reads only the entries it wrote
    // (e = tid, tid + nthreads, ...), so no barrier is needed.
    for (int e = tid; e < g.th * g.tw; e += nthreads) {
      const int y = h0 + e / g.tw, x = w0 + e % g.tw;
      tab1[e] = (y < g.H && x < g.W) ? y * g.W + x : -1;
    }
    for (int e = tid; e < g.hh * g.hws; e += nthreads) {
      const int y = hy0 + e / g.hws, x = hx0 + e % g.hws;
      tab2[e] = (y >= 0 && y < g.H && x >= 0 && x < g.W) ? y * g.W + x : -1;
    }
  }

  // Copy chunk t (channels c_begin + t * cc ...) into ring slot t % STAGES;
  // with TMA, thread 0 alone.
  const CUtensorMap* m1 = &map1;
  const CUtensorMap* m2 = &map2;
  auto load = [&](int t) {
    const int c0 = c_begin + t * g.cc;
    const int slot = t % STAGES;
    const uint32_t d1 = sbase + slot * g.slot_floats * 4;
    const uint32_t d2 = d1 + g.f1_floats * 4;
    if constexpr (TMA) {
      const uint32_t bar = bars + 8 * slot;
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // after the block's reads of the slot
      mbarrier_arrive_expect_tx(bar, 4 * g.cc * (g.th * g.tw + g.hh * g.hws));
      tma_load_3d(d1, m1, w0, h0, b * g.C + c0, bar);
      tma_load_3d(d2, m2, hx0, hy0, b * g.C + c0, bar);
    } else {
      const int cn = min(g.cc, c_end - c0);
      const float* s1 = f1 + (static_cast<int64_t>(b) * g.C + c0) * plane;
      const float* s2 = f2 + (static_cast<int64_t>(b) * g.C + c0) * plane;
      for (int c = 0; c < cn; ++c, s1 += plane, s2 += plane) {
        const uint32_t e1 = d1 + c * g.th * g.tw * 4;
        const uint32_t e2 = d2 + c * g.hh * g.hws * 4;
        for (int e = tid; e < g.th * g.tw; e += nthreads) {
          const int o = tab1[e];
          cp_async4(e1 + e * 4, s1 + max(o, 0), o >= 0 ? 4 : 0);
        }
        for (int e = tid; e < g.hh * g.hws; e += nthreads) {
          const int o = tab2[e];
          cp_async4(e2 + e * 4, s2 + max(o, 0), o >= 0 ? 4 : 0);
        }
      }
    }
  };

  // This thread's pixels and displacement rows (threads past `computing`
  // only copy).
  const bool computes = tid < g.computing;
  const int quads_w = g.tw / PX;
  const int quads = g.th * quads_w;
  const int grp = tid / quads;
  const int ty = (tid % quads) / quads_w;
  const int tx = (tid % quads) % quads_w;
  const int rows_here = g.n - (iy0 + grp * ROWS);  // rows r < rows_here are displacement rows < n
  const int f1off = ty * g.tw + PX * tx;
  const int f2off = g.f1_floats + (ty + grp * ROWS * S) * g.hws + PX * tx;

  float acc[ROWS][NX][PX];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int p = 0; p < PX; ++p) acc[r][i][p] = 0.f;

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if constexpr (TMA) {
      if (tid == 0 && t < chunks) load(t);
    } else {
      if (t < chunks) load(t);
      cp_async_commit();
    }
  }
  for (int t = 0; t < chunks; ++t) {
    if constexpr (TMA) {
      __syncthreads();  // everyone is done with chunk t - 1, whose slot chunk t + 2 takes
      if (tid == 0 && t + STAGES - 1 < chunks) load(t + STAGES - 1);
      mbarrier_wait(bars + 8 * (t % STAGES), (t / STAGES) & 1);  // chunk t has landed
    } else {
      cp_async_wait<STAGES - 2>();  // this thread's copies of chunk t have landed
      __syncthreads();              // everyone's have, and everyone is done with chunk t - 1
      if (t + STAGES - 1 < chunks) load(t + STAGES - 1);
      cp_async_commit();
    }
    if (!computes) continue;
    const float* st = smem + (t % STAGES) * g.slot_floats;
    const int cn = min(g.cc, c_end - (c_begin + t * g.cc));
    const float* p1 = st + f1off;
    const float* p2 = st + f2off;
#pragma unroll 2
    for (int c = 0; c < cn; ++c, p1 += g.th * g.tw, p2 += g.hh * g.hws) {
      const float4 a4 = *reinterpret_cast<const float4*>(p1);
      const float a[PX] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r >= rows_here) break;
        const float4* seg = reinterpret_cast<const float4*>(p2 + r * S * g.hws);
#pragma unroll
        for (int v = 0; v < SEG; ++v) {
          const float4 q = seg[v];
          const float sv[4] = {q.x, q.y, q.z, q.w};
          // f2 at segment position j serves every (pixel p, column i) with
          // OFF + p + i * S == j
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int p = 0; p < PX; ++p) {
              const int m = 4 * v + j - OFF - p;
              if (m >= 0 && m % S == 0 && m / S < NX) acc[r][m / S][p] = fmaf(a[p], sv[j], acc[r][m / S][p]);
            }
          }
        }
      }
    }
  }

  if (!computes) return;
  const int y = h0 + ty;
  const int x = w0 + PX * tx;
  if (y >= g.H || x >= g.W) return;
  const int K = g.n * g.n;
  float* ob = out + (static_cast<int64_t>(split) * g.B + b) * K * plane + static_cast<int64_t>(y) * g.W + x;
  const bool vec = (g.W & 3) == 0;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r >= rows_here) break;
    const int iy = iy0 + grp * ROWS + r;
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      if (ix0 + i >= g.n) break;
      float* o = ob + static_cast<int64_t>(iy * g.n + ix0 + i) * plane;
      if (vec) {
        __stcs(reinterpret_cast<float4*>(o), make_float4(acc[r][i][0] * g.scale, acc[r][i][1] * g.scale,
                                                         acc[r][i][2] * g.scale, acc[r][i][3] * g.scale));
      } else {
#pragma unroll
        for (int p = 0; p < PX; ++p)
          if (x + p < g.W) __stcs(o + p, acc[r][i][p] * g.scale);
      }
    }
  }
}

// out[i] = scale * sum_j part[j * total + i], j = 0 .. splits - 1 in order.
__global__ void correlation_reduce(const float* __restrict__ part, float* __restrict__ out, int64_t total, int splits,
                                   float scale) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  if ((total & 3) == 0) {
    const float4* p4 = reinterpret_cast<const float4*>(part);
    float4* o4 = reinterpret_cast<float4*>(out);
    const int64_t total4 = total / 4;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total4; i += stride) {
      float4 s = __ldcs(p4 + i);
      for (int j = 1; j < splits; ++j) {
        const float4 v = __ldcs(p4 + j * total4 + i);
        s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
      }
      __stcs(o4 + i, make_float4(s.x * scale, s.y * scale, s.z * scale, s.w * scale));
    }
  } else {
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total; i += stride) {
      float s = __ldcs(part + i);
      for (int j = 1; j < splits; ++j) s += __ldcs(part + j * total + i);
      __stcs(out + i, s * scale);
    }
  }
}

// Opt `kernel` in to `smem` bytes of dynamic shared memory on the current
// device, once per kernel, device and size (`opted`: the largest so far).
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int smem, int (&opted)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (smem <= 48 * 1024 || smem <= opted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) opted[dev] = smem;
  return err;
}

int opted_tma[64];
int opted_f32[64];

// cuTensorMapEncodeTiled, looked up once through the CUDA runtime (so the
// library needs no link to libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (B, C, H, W) f32 as the 3-D tensor (W, H, B * C), boxes of bx x by x bz.
bool tensor_map(CUtensorMap* map, const void* base, int B, int C, int H, int W, int bx, int by, int bz) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B) * C};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(W) * 4, static_cast<cuuint64_t>(H) * W * 4};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(bx), static_cast<cuuint32_t>(by), static_cast<cuuint32_t>(bz)};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// f1, f2: (B, C, H, W) f32 contiguous; out: (B, K, H, W) f32, K = n^2,
// n = 2 * max_disp / CORR_S + 1.  The launch plan (ops/correlation.py,
// launch_plan): a th x tw pixel tile, `groups` thread groups of CORR_ROWS
// displacement rows, dy_blocks x dx_groups blocks over the displacements,
// `splits` channel splits of chunk_c channels (part: splits * B * K * H * W
// f32 of partial sums, used when splits > 1), cc channels per ring stage,
// TMA copies if tma (else 4-byte cp.async), `threads` per block, smem_bytes
// of dynamic shared memory.  Returns the cudaError_t (0 = ok).
extern "C" int correlation_forward(const void* f1, const void* f2, void* out, void* part, int B, int C, int H, int W,
                                   int max_disp, int th, int tw, int groups, int dy_blocks, int dx_groups, int splits,
                                   int chunk_c, int cc, int tma, int threads, int smem_bytes, void* stream) {
  const int d = max_disp;
  const int n = 2 * d / S + 1;
  Geom g;
  g.B = B, g.C = C, g.H = H, g.W = W, g.d = d, g.n = n;
  g.th = th, g.tw = tw, g.tiles_w = (W + tw - 1) / tw;
  g.groups = groups, g.dy_blocks = dy_blocks, g.chunk_c = chunk_c, g.cc = cc;
  g.hh = th + (ROWS * groups - 1) * S;
  g.hws = tw - PX + 4 * SEG;
  g.f1_floats = (cc * th * tw + 31) / 32 * 32;
  g.slot_floats = g.f1_floats + (cc * g.hh * g.hws + 31) / 32 * 32;
  g.computing = th * (tw / PX) * groups;
  g.scale = splits > 1 ? 1.0f : 1.0f / static_cast<float>(C);
  const int64_t need = 128 + (static_cast<int64_t>(STAGES) * g.slot_floats + 2 * STAGES + th * tw + g.hh * g.hws) * 4;
  const bool ok = d >= 0 && (2 * d) % S == 0 && (d + OFF) % 4 == 0 && B >= 1 && C >= 1 && H >= 1 && W >= 1 &&
                  th >= 1 && tw >= PX && tw % PX == 0 && groups >= 1 && dy_blocks * ROWS * groups >= n &&
                  dx_groups * NX >= n && splits >= 1 && chunk_c >= 1 && static_cast<int64_t>(splits) * chunk_c >= C &&
                  cc >= 1 && threads >= g.computing && threads <= MAX_THREADS && threads % 32 == 0 &&
                  need <= smem_bytes && static_cast<int64_t>(splits) * B <= 65535 &&
                  static_cast<int64_t>(dx_groups) * dy_blocks <= 65535 &&
                  (!tma || (W % 4 == 0 && (dx_groups == 1 || (NX * S) % 4 == 0) && g.hh <= 256 && g.hws <= 256 &&
                            tw <= 256 && th <= 256 && cc <= 256));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);

  CUtensorMap map1 = {}, map2 = {};
  if (tma && !(tensor_map(&map1, f1, B, C, H, W, tw, th, cc) && tensor_map(&map2, f2, B, C, H, W, g.hws, g.hh, cc)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(splits > 1 ? part : out);
  const dim3 grid(g.tiles_w * ((H + th - 1) / th), dx_groups * dy_blocks, splits * B);
  cudaError_t err;
  if (tma) {
    err = opt_in(correlation_blocked<true>, smem_bytes, opted_tma);
    if (err != cudaSuccess) return static_cast<int>(err);
    correlation_blocked<true><<<grid, threads, smem_bytes, st>>>(static_cast<const float*>(f1),
                                                                 static_cast<const float*>(f2), dst, g, map1, map2);
  } else {
    err = opt_in(correlation_blocked<false>, smem_bytes, opted_f32);
    if (err != cudaSuccess) return static_cast<int>(err);
    correlation_blocked<false><<<grid, threads, smem_bytes, st>>>(static_cast<const float*>(f1),
                                                                  static_cast<const float*>(f2), dst, g, map1, map2);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int64_t total = static_cast<int64_t>(B) * n * n * H * W;
  const int64_t work = (total & 3) == 0 ? total / 4 : total;
  const int blocks = static_cast<int>(work < 1024 * 256 ? (work + 255) / 256 : 1024);
  correlation_reduce<<<blocks, 256, 0, st>>>(static_cast<const float*>(part), static_cast<float*>(out), total, splits,
                                             1.0f / static_cast<float>(C));
  return static_cast<int>(cudaGetLastError());
}
