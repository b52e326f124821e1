// Gram kernel for Hopper (sm_90a): G[b] = F[b] F[b]^T, F[b] of shape (C, N)
// with N contiguous (an NCHW activation viewed as (B, C, H*W)), f32 or bf16
// in, f32 out.
//
// Replaces the TPU kernel maua_style_tpu/ops/pallas_gram.py:_gram_kernel
// (driven by _gram_pallas_fwd / gram_pallas / gram_nhwc).
//
// Bound: G is symmetric, so the function needs the C(C+1)/2 entries on and
// above the diagonal.  On the tensor cores an f32-accurate product takes
// three TF32 products (below), 3*N*C*(C+1) operations against 495 TFLOP/s,
// beside 4*N*C input bytes against 3.35 TB/s: relu1_1 and relu2_1 of a
// 1024^2 image are bound by bytes, relu3_1..relu5_1 by operations.  bf16
// inputs (N*C*(C+1) operations at 989 TFLOP/s) are bound by bytes at every
// style layer.
//
// Design:
// - Tensor cores: a block computes a BN x BN output tile, BN = 64 (one
//   warpgroup) for C <= 64 and 128 (two) otherwise.  Each warpgroup issues
//   wgmma.mma_async m64nBNk8 (tf32) or m64nBNk16 (bf16) for its 64 rows,
//   with f32 accumulators in registers.  F's layout (channels in rows, N
//   contiguous) makes both A = F[i-tile] and B = F[j-tile] K-major, the only
//   layout TF32 wgmma takes, so nothing is transposed.  128-row tiles stage
//   each row of F half as often as 64-row ones (the re-reads from L2 bound
//   C = 256..512 otherwise).
// - f32 through 3xTF32: x = hi + lo with hi = x truncated to TF32 and
//   lo = tf32(x - hi) (rounded to nearest); every k-step issues lo*hi, hi*lo,
//   then hi*hi into one accumulator, small terms first.  The lo*lo term
//   (2^-20 of the product at most) is dropped.  The tensor cores read only
//   the 19 high bits of a TF32 operand, so a stage of raw f32 values as it
//   landed is already hi: only B's lo is written to shared memory, and A is
//   split in registers (wgmma takes A from registers).  A diagonal tile
//   (A = B) needs no shared-memory split at all: it sums lo*hi + (hi/2)*hi
//   and adds the transpose in the epilogue, two products per k-step.  bf16
//   products are exact in f32 and need no split.
// - Each stage's wgmmas sum into a fresh accumulator, which is added into an
//   f32 register accumulator once they are retired ("promotion" every 32 f32
//   or 64 bf16 positions of N): the tensor cores' own accumulation is not
//   f32-exact, and a long chain of wgmmas on one accumulator drifts.
// - Loads: a ring of STAGES stages filled by cp.async, so the next slices of
//   N are in flight while the tensor cores run, and the next stage's lo is
//   written while the current one's wgmmas run.  A stage holds 128 bytes of
//   each of BN rows in wgmma's 128-byte-swizzled K-major layout, so a warp
//   copies whole 128-byte lines of 4 rows and writes them without bank
//   conflicts.  16-byte copies where a row is 16-byte aligned (N % 4 == 0 for
//   f32, N % 8 == 0 for bf16); otherwise 4-byte copies (f32) or loads through
//   registers (bf16 rows are then only 2-byte aligned).  The ragged edges of
//   C and N are zero-filled in the copy (its source size), so there is no
//   padded copy of F.
// - Symmetry and split-K: only tiles (ti <= tj) are computed, and a diagonal
//   tile stages its operand once and uses it as both A and B.  N is split
//   across blocks so the SMs are busy even at C = 64 (one tile); each block
//   writes its partial tile and a second kernel sums the partials in a fixed
//   order and mirrors the off-diagonal tiles.  No float atomics: two runs
//   give bit-identical Grams.
//
// The host wrapper (maua_style_tpu_torch/ops/gram.py) allocates the output
// and the partials, chooses the split, and checks the returned error code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROW_BYTES = 128;          // bytes of one row per stage: 32 f32 or 64 bf16
constexpr int KSTEPS = ROW_BYTES / 32;  // wgmma k-steps per stage (32 bytes of K each)

// A block computes a BN x BN output tile: BN = 64 with one warpgroup for
// C <= 64, BN = 128 with two (each 64 rows x 128 columns) otherwise, which
// stages each row of F half as often.
template <int BN>
struct Tile {
  static constexpr int THREADS = 2 * BN;  // BN / 64 warpgroups
  static constexpr int STAGE_BYTES = BN * ROW_BYTES;  // one operand's stage
  static constexpr int STAGES = BN == 64 ? 6 : 4;  // slots of the cp.async ring
  // Stages in flight ahead of the one being prepared: of the other two slots
  // one is being prepared and one is still read by the previous stage's wgmma.
  static constexpr int AHEAD = STAGES - 2;
  // the ring of A and B stages, then two buffers of B's lo: 112 KB (two
  // blocks fit on an SM) or 160 KB
  static constexpr int SMEM_BYTES = (2 * STAGES + 2) * STAGE_BYTES;
};

// how a stage is copied in
constexpr int LOAD_VEC16 = 0;  // 16-byte cp.async
constexpr int LOAD_F32 = 1;    // 4-byte cp.async
constexpr int LOAD_BF16 = 2;   // 2-byte loads through registers

// Shared-memory layout of one operand's stage: wgmma's K-major layout with
// the 128-byte swizzle.  Row r's 128 bytes sit at r * 128, its 16-byte
// chunk c at slot c ^ (r % 8) within them; 8 rows make a 1024-byte atom
// (the descriptor's stride byte offset).  A k-step's 32 bytes start at
// 32 * k-step within the rows.
__device__ __forceinline__ uint32_t swizzled(int r, int c) { return r * ROW_BYTES + ((c ^ (r & 7)) << 4); }

__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

#define GRAM_D32(d)                                                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),          \
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]),           \
      "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),           \
      "+f"(d[30]), "+f"(d[31])
#define GRAM_D64(d)                                                                                         \
  GRAM_D32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]),   \
      "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), \
      "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), \
      "+f"(d[63])
#define GRAM_REGS32                                                                  \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define GRAM_REGS64                                                                           \
  GRAM_REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, " \
              "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

// d (+)= A B^T, A (64 x 16 bf16) and B (BN x 16) in shared memory; scale_d = 0 overwrites d.
template <int BN>
__device__ __forceinline__ void wgmma_bf16(float (&d)[BN / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (BN == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" GRAM_REGS32 "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : GRAM_D32(d)
        : "l"(da), "l"(db), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" GRAM_REGS64 "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : GRAM_D64(d)
        : "l"(da), "l"(db), "r"(scale_d));
  }
}

// d (+)= A B^T, A (64 x 8 tf32) in registers in wgmma's fragment layout (a
// thread holds rows m, m + 8 and columns q, q + 4 of the k-step, m = 16 warp
// + lane / 4 within its warpgroup's 64 rows, q = lane % 4), B (BN x 8) in
// shared memory.
template <int BN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[BN / 2], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  if constexpr (BN == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" GRAM_REGS32
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : GRAM_D32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {" GRAM_REGS64
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : GRAM_D64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
// generic-proxy writes to shared memory (cp.async, st.shared) made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" : : "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" : : "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" : : "n"(N) : "memory");
}

// TF32 halves of x, in integer instructions (they issue faster than cvt):
// hi = x with the 13 low bits cleared (what the tensor cores read of x), and
// lo = x - hi (exact in f32) rounded to the nearest TF32, ties away from
// zero: half a TF32 ulp added to the magnitude bits, then the 13 low bits
// cleared.
__device__ __forceinline__ float tf32_hi(float x) { return __uint_as_float(__float_as_uint(x) & 0xFFFFE000u); }
__device__ __forceinline__ float tf32_lo(float x) {
  return __uint_as_float((__float_as_uint(x - tf32_hi(x)) + 0x1000u) & 0xFFFFE000u);
}

// acc += part, for a wgmma accumulator that a wait has retired; the empty
// asm keeps the compiler from reading part before that wait.
template <int N>
__device__ __forceinline__ void add_retired(float (&acc)[N], float (&part)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    asm volatile("" : "+f"(part[i]) : : "memory");
    acc[i] += part[i];
  }
}

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

// Copy rows row0..row0+BN-1, positions k0..k0+ROW_BYTES/sizeof(T)-1 of fb
// into one operand's stage at dst, zero-filling rows >= C and positions >=
// k_end.  Lane l of warp w takes chunk l % 8 of row 16w + 4i + l/8: a warp
// copies 4 whole 128-byte rows, and a quarter-warp fills one row's 128
// swizzled bytes (no bank conflicts).
template <typename T, int LOAD>
__device__ __forceinline__ void load_tile(uint32_t dst, uint8_t* dst_ptr, const T* fb, int row0, int C, int64_t N,
                                          int64_t k0, int64_t k_end) {
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = lane % 8;
  const int64_t k = k0 + c * EPC;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 16 * warp + 4 * i + lane / 8;
    const bool row_ok = row0 + r < C;
    const T* src = fb + static_cast<int64_t>(row_ok ? row0 + r : 0) * N;
    const uint32_t off = swizzled(r, c);
    if constexpr (LOAD == LOAD_VEC16) {
      const bool ok = row_ok && k < k_end;  // a 16-byte-aligned row's chunk is wholly in or out
      cp_async16(dst + off, ok ? src + k : fb, ok ? 16 : 0);
    } else if constexpr (LOAD == LOAD_F32) {
#pragma unroll
      for (int e = 0; e < EPC; ++e) {
        const bool ok = row_ok && k + e < k_end;
        cp_async4(dst + off + 4 * e, ok ? src + k + e : fb, ok ? 4 : 0);
      }
    } else {
      const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < EPC; e += 2) {
        const uint32_t lo = (row_ok && k + e < k_end) ? __ldg(s + k + e) : 0u;
        const uint32_t hi = (row_ok && k + e + 1 < k_end) ? __ldg(s + k + e + 1) : 0u;
        w[e / 2] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(dst_ptr + off) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// One block's partial tile of pair (ti, tj) over positions [k_begin, k_end)
// of frame fb, in acc (the accumulator fragment of wgmma).
template <typename T, int LOAD, int BN, bool DIAG>
__device__ __forceinline__ void tile_partial(uint8_t* smem, const T* fb, int ti, int tj, int C, int64_t N,
                                             int64_t k_begin, int64_t k_end, float (&acc)[BN / 2]) {
  using Cfg = Tile<BN>;
  constexpr bool BF16 = sizeof(T) == 2;
  constexpr int64_t KS = ROW_BYTES / sizeof(T);  // positions of N per stage
  const int n_stages = static_cast<int>((k_end - k_begin + KS - 1) / KS);  // >= 1: no split is empty
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  // offsets into smem of stage t's A and B (raw, as copied in) and B's lo
  auto slot_a = [](int t) { return static_cast<uint32_t>(2 * (t % Cfg::STAGES) * Cfg::STAGE_BYTES); };
  auto slot_b = [&](int t) { return DIAG ? slot_a(t) : slot_a(t) + Cfg::STAGE_BYTES; };
  auto lo_b = [](int t) { return static_cast<uint32_t>((2 * Cfg::STAGES + t % 2) * Cfg::STAGE_BYTES); };

  auto load_stage = [&](int t) {
    const int64_t k0 = k_begin + t * KS;
    load_tile<T, LOAD>(base + slot_a(t), smem + slot_a(t), fb, ti * BN, C, N, k0, k_end);
    if (!DIAG) load_tile<T, LOAD>(base + slot_b(t), smem + slot_b(t), fb, tj * BN, C, N, k0, k_end);
  };
  // Wait for stage t's copies, start those of stage t + AHEAD (into the slot
  // of stage t - 2, whose wgmmas are done), and write B's lo of stage t.
  auto prepare = [&](int t) {
    cp_async_wait<Cfg::AHEAD - 1>();  // this thread's copies of stage t have landed
    fence_proxy_async();
    __syncthreads();  // everyone's have
    if (t + Cfg::AHEAD < n_stages) load_stage(t + Cfg::AHEAD);
    cp_async_commit();
    if constexpr (!BF16 && !DIAG) {
      const float4* x = reinterpret_cast<const float4*>(smem + slot_b(t));
      float4* lo = reinterpret_cast<float4*>(smem + lo_b(t));
#pragma unroll
      for (int i = 0; i < Cfg::STAGE_BYTES / 16 / Cfg::THREADS; ++i) {
        const int u = threadIdx.x + i * Cfg::THREADS;
        const float4 v = x[u];
        lo[u] = make_float4(tf32_lo(v.x), tf32_lo(v.y), tf32_lo(v.z), tf32_lo(v.w));
      }
      fence_proxy_async();
      __syncthreads();
    }
  };
  float part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.f;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m = 16 * warp + lane / 4;                   // A-fragment rows m, m + 8 of the tile
  const int q = 4 * (lane % 4);                         // byte of the A-fragment column in its 16-byte chunk
  const uint32_t wg_rows = (warp / 4) * 64 * ROW_BYTES;  // this warpgroup's 64 rows of A
  // Stage t's wgmmas, into a fresh accumulator.
  auto issue = [&](int t) {
    if constexpr (BF16) {
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        const uint32_t o = base + 32 * ks;
        wgmma_bf16<BN>(part, smem_desc(o + slot_a(t) + wg_rows), smem_desc(o + slot_b(t)), ks > 0);
      }
    } else {
      // A's fragments, split in registers; a diagonal tile halves hi
      uint32_t a_hi[KSTEPS][4], a_lo[KSTEPS][4];
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = m + 8 * (j & 1);
          const float x = *reinterpret_cast<const float*>(smem + slot_a(t) + swizzled(r, 2 * ks + j / 2) + q);
          a_hi[ks][j] = __float_as_uint(DIAG ? 0.5f * tf32_hi(x) : tf32_hi(x));
          a_lo[ks][j] = __float_as_uint(tf32_lo(x));
        }
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        const uint32_t o = base + 32 * ks;
        wgmma_tf32<BN>(part, a_lo[ks], smem_desc(o + slot_b(t)), ks > 0);
        if (!DIAG) wgmma_tf32<BN>(part, a_hi[ks], smem_desc(o + lo_b(t)), 1);
        wgmma_tf32<BN>(part, a_hi[ks], smem_desc(o + slot_b(t)), 1);
      }
    }
    wgmma_commit();
  };

  // prologue: AHEAD stages in flight, one commit group each
#pragma unroll
  for (int t = 0; t < Cfg::AHEAD; ++t) {
    if (t < n_stages) load_stage(t);
    cp_async_commit();
  }
  // Stage t is prepared while stage t - 1's wgmmas run.  The loop body has
  // no branch around its wgmmas, so part keeps its registers and the
  // compiler need not wait for the wgmmas before the next prepare.
  prepare(0);
  issue(0);
  for (int t = 1; t < n_stages; ++t) {
    prepare(t);
    wgmma_wait_all();
    add_retired(acc, part);
    issue(t);
  }
  wgmma_wait_all();
  add_retired(acc, part);
}

// An f32 diagonal pair's block does less work per position of N than an
// off-diagonal one (one operand staged, two TF32 products instead of
// three), so the two kinds of pairs may cut N into splits of their own
// lengths, for the blocks of one wave to take about as long.
struct Splits {
  int diag, off;                  // splits of a diagonal and of an off-diagonal pair
  int64_t chunk_diag, chunk_off;  // positions of N per split, multiples of 64
};

// grid (pairs, max(splits), B), Tile<BN>::THREADS threads,
// Tile<BN>::SMEM_BYTES of dynamic shared memory:
// partial[split][b][pair][BN][BN] = F_i[k range] F_j[k range]^T for the
// splits of the pair's kind.
template <typename T, int LOAD, int BN>
__global__ void __launch_bounds__(Tile<BN>::THREADS)
gram_partial_kernel(const T* __restrict__ f, int C, int64_t N, int n_tiles, Splits sp,
                    float* __restrict__ partial) {
  extern __shared__ __align__(1024) uint8_t smem[];
  constexpr bool HALVED_DIAG = sizeof(T) == 4;  // an f32 diagonal tile sums S with G = S + S^T

  int ti, tj;
  tile_pair(blockIdx.x, n_tiles, ti, tj);
  if (static_cast<int>(blockIdx.y) >= (ti == tj ? sp.diag : sp.off)) return;
  const int64_t chunk = ti == tj ? sp.chunk_diag : sp.chunk_off;
  const int64_t k_begin = static_cast<int64_t>(blockIdx.y) * chunk;
  const int64_t k_end = (k_begin + chunk < N) ? k_begin + chunk : N;
  const T* fb = f + static_cast<int64_t>(blockIdx.z) * C * N;
  float acc[BN / 2];
  if (ti == tj)
    tile_partial<T, LOAD, BN, true>(smem, fb, ti, tj, C, N, k_begin, k_end, acc);
  else
    tile_partial<T, LOAD, BN, false>(smem, fb, ti, tj, C, N, k_begin, k_end, acc);

  // accumulator fragment: warp w, lane l holds rows 16w + l/4 (+8) and
  // columns 8j + 2(l%4) (+1) of n8 block j in acc[4j .. 4j+3]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = 16 * warp + lane / 4;
  float* out = partial + ((static_cast<int64_t>(blockIdx.y) * gridDim.z + blockIdx.z) * gridDim.x + blockIdx.x) *
                             (BN * BN);
  if (HALVED_DIAG && ti == tj) {
    // through shared memory (padded rows): out = S + S^T
    float* s = reinterpret_cast<float*>(smem);
    __syncthreads();  // every thread is past its last wgmma and copy
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + 2 * (lane % 4);
#pragma unroll
      for (int e = 0; e < 4; ++e) s[(r + 8 * (e / 2)) * (BN + 1) + c + e % 2] = acc[4 * j + e];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + 2 * (lane % 4);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * j + e] += s[(c + e % 2) * (BN + 1) + r + 8 * (e / 2)];
    }
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * (lane % 4);
    *reinterpret_cast<float2*>(out + r * BN + c) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(out + (r + 8) * BN + c) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

constexpr int RED_THREADS = 256;

// Block of RED_THREADS threads over RED_THREADS / groups consecutive
// elements of the (b, pair) tiles of edge bn: thread group g sums the
// pair's splits g, g + groups, ..., then group 0 adds the group sums in
// order and writes G and its mirror.  A fixed order: two runs give the
// same bits.
__global__ void __launch_bounds__(RED_THREADS)
gram_reduce_kernel(const float* __restrict__ partial, Splits sp, int groups, int B, int pairs, int n_tiles, int C,
                   int bn, float* __restrict__ out) {
  __shared__ float sums[RED_THREADS];
  const int64_t per_split = static_cast<int64_t>(B) * pairs * bn * bn;
  const int elems = RED_THREADS / groups;
  const int e_local = threadIdx.x % elems;
  const int g = threadIdx.x / elems;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * elems + e_local;
  const int e = static_cast<int>(idx % (bn * bn));
  const int64_t rest = idx / (bn * bn);
  const int pair = static_cast<int>(rest % pairs);
  const int b = static_cast<int>(rest / pairs);
  int ti, tj;
  tile_pair(pair, n_tiles, ti, tj);
  const int splits = ti == tj ? sp.diag : sp.off;
  float s = 0.f;
  if (idx < per_split)
    for (int k = g; k < splits; k += groups) s += partial[k * per_split + idx];
  sums[threadIdx.x] = s;
  __syncthreads();
  if (g != 0 || idx >= per_split) return;
  for (int k = 1; k < groups; ++k) s += sums[k * elems + e_local];
  const int gi = ti * bn + e / bn;
  const int gj = tj * bn + e % bn;
  if (gi >= C || gj >= C) return;
  out[(static_cast<int64_t>(b) * C + gi) * C + gj] = s;
  if (ti != tj) out[(static_cast<int64_t>(b) * C + gj) * C + gi] = s;
}

template <typename T, int LOAD, int BN>
cudaError_t launch_partial(const void* f, int B, int C, int64_t N, int n_tiles, int pairs, Splits sp,
                           float* partial, cudaStream_t st) {
  using Cfg = Tile<BN>;
  auto kernel = gram_partial_kernel<T, LOAD, BN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int splits = sp.diag > sp.off ? sp.diag : sp.off;
  kernel<<<dim3(pairs, splits, B), Cfg::THREADS, Cfg::SMEM_BYTES, st>>>(static_cast<const T*>(f), C, N, n_tiles, sp,
                                                                        partial);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_partial(const void* f, bool bf16, bool vec, int B, int C, int64_t N, int n_tiles, int pairs,
                           Splits sp, float* partial, cudaStream_t st) {
  if (bf16)
    return vec ? launch_partial<__nv_bfloat16, LOAD_VEC16, BN>(f, B, C, N, n_tiles, pairs, sp, partial, st)
               : launch_partial<__nv_bfloat16, LOAD_BF16, BN>(f, B, C, N, n_tiles, pairs, sp, partial, st);
  return vec ? launch_partial<float, LOAD_VEC16, BN>(f, B, C, N, n_tiles, pairs, sp, partial, st)
             : launch_partial<float, LOAD_F32, BN>(f, B, C, N, n_tiles, pairs, sp, partial, st);
}

}  // namespace

// f: (B, C, N) contiguous, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1).
// tile: the output tile edge, 64 or 128.
// splits_diag, chunk_diag / splits_off, chunk_off: how a diagonal / an
// off-diagonal tile pair cuts N (chunks of positions, multiples of 64).
// partial: max(splits) * B * pairs * tile * tile f32, pairs = T (T + 1) / 2, T = ceil(C / tile).
// out: (B, C, C) f32.  Returns the cudaError_t of the launches (0 = ok).
extern "C" int gram_forward(const void* f, int is_bf16, int B, int C, int64_t N, int tile, int splits_diag,
                            int64_t chunk_diag, int splits_off, int64_t chunk_off, void* partial, void* out,
                            void* stream) {
  if (tile != 64 && tile != 128) return static_cast<int>(cudaErrorInvalidValue);
  const Splits sp{splits_diag, splits_off, chunk_diag, chunk_off};
  const int n_tiles = (C + tile - 1) / tile;
  const int pairs = n_tiles * (n_tiles + 1) / 2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  const int elt = is_bf16 ? 2 : 4;
  const bool vec = reinterpret_cast<uintptr_t>(f) % 16 == 0 && (N * elt) % 16 == 0;
  const cudaError_t err =
      tile == 64 ? launch_partial<64>(f, is_bf16, vec, B, C, N, n_tiles, pairs, sp, part, st)
                 : launch_partial<128>(f, is_bf16, vec, B, C, N, n_tiles, pairs, sp, part, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  // about 8 to 16 partials summed by each thread, with up to 8 threads per element
  const int splits = splits_diag > splits_off ? splits_diag : splits_off;
  int groups = 1;
  while (groups < 8 && splits >= 16 * groups) groups *= 2;
  const int64_t total = static_cast<int64_t>(B) * pairs * tile * tile;
  const int elems = RED_THREADS / groups;
  const int blocks = static_cast<int>((total + elems - 1) / elems);
  gram_reduce_kernel<<<blocks, RED_THREADS, 0, st>>>(part, sp, groups, B, pairs, n_tiles, C, tile,
                                                      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
