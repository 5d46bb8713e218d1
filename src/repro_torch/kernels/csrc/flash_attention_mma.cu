// K4 in bf16 — flash attention on the tensor cores, hand-written for Hopper
// (sm_90a), with mma.sync.
//
// Replaces repro/kernels/flash_attention.py::flash_attention (the Pallas
// kernel _flash_kernel) for bf16 q (B, H, Tq, hd) and k, v (B, KV, Tk, hd),
// H % KV == 0, hd a multiple of 8 up to 128, every (batch, head, position)
// stride a multiple of 8 elements and 16-byte aligned pointers (the wrapper
// sends every other shape, and f32, to the CUDA-core kernel of
// flash_attention.cu). It computes what that kernel computes, with the same
// semantics: the online softmax per query row (running max m, running sum
// l, f32 accumulator), alpha = exp(m_prev - m_new), p = s > NEG_INF/2 ?
// exp(s - m_new) : 0, out = acc / max(l, 1e-30) in bf16; query head h reads
// kv head h / (H / KV); causal key j is visible to query i when j <= i,
// both from 0, also when Tq != Tk; kv tiles wholly above the block (and, per
// warp, above the warp's rows) are skipped, which changes nothing, since a
// tile whose keys are all masked for a row leaves that row's m, l and acc
// as they were; block_k cuts the kv axis into chunks walked in tiles of 64
// keys, the last one ragged; rows past Tq are not stored, keys past a
// tile's end score NEG_INF and the tile is zero-filled. The query axis is
// tiled by the kernel's own 128 rows, so the reference's Q-chunk changes no
// bit. Numerics: the scores are f32 sums of exact bf16 products, scaled in
// the log2 domain (hd^-0.5 * log2(e), then ex2.approx); p is rounded to bf16
// before p @ v (the Pallas kernel keeps p in f32; the JAX model path's jnp
// attend_flash casts p to the input dtype as here); l sums the f32 p.
//
// Bound. 4 * B * H * Tq * Tk * hd operations (about half for causal)
// against the bytes of q, k, v and o: operations bound both VLM shapes, at
// the data sheet's 989 TFLOP/s of bf16 tensor cores 0.1115 ms for the
// vision encoder's (1, 16, 16, 4641, 80) and 0.1216 ms for qwen2-vl-7b's
// (1, 28, 4, 4096, 128) causal. The CUDA-core kernel could not pass 67
// TFLOP/s of f32 FMA; this one runs both products on the tensor cores.
//
// Design (FlashAttention-2's, on mma.sync.m16n8k16):
//   - a block of four warps owns 128 query rows of one (batch, head); each
//     warp owns two m16 row tiles (32 rows), so every k and v fragment it
//     loads from shared memory feeds two mma; a row's max and sum reduce
//     over the four lanes that share it in the mma accumulator layout
//     (shuffles xor 1 and 2, which leave the same bits in all four);
//   - q is copied to shared memory once and read from there by ldmatrix at
//     each k16 step (held in registers it would not fit beside two row
//     tiles' accumulators at hd = 128); K and V tiles of 64 keys come
//     through a 2-stage ring of 16-byte cp.async copies (zero-filled past a
//     tile's keys or the head dim), the next tile in flight while the
//     current one is computed;
//   - S = q k^T: k read by ldmatrix as the col-major B operand, the head dim
//     in k16 steps (hd = 80: 5 steps, no padding to 128; a head dim that is
//     a multiple of 8 but not of 16 gets one zero-filled 8-column tail);
//   - the online softmax runs on the S accumulator fragments in the log2
//     domain with ex2.approx, the causal and ragged mask skipped on tiles
//     open to all of a warp's rows;
//   - p stays in registers: the S accumulator fragments are exactly the A
//     fragments of p @ v once packed to bf16, and v is read by
//     ldmatrix.trans as the B operand;
//   - shared-memory rows padded by 16 bytes, so ldmatrix is conflict-free.
// Measured on the H100 and not kept: a wgmma version (m64n64k16 for S from
// shared memory, m64nNk16 for p @ v with p in registers, unswizzled
// core-matrix tiles filled by cp.async, with and without overlapping the
// softmax with the previous tile's p @ v) was right at every checked shape
// but slower than this kernel; swizzled tiles, TMA and warp specialisation
// are the open step.
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (repro_torch/kernels/flash_attention.py). The entry point
// launches on the stream it is given, does not synchronise, and returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int MT = 2;         // m16 row tiles per warp
constexpr int BQ = 64 * MT;   // query rows per block (32 per warp)
constexpr int BKV = 64;       // keys per kv tile
constexpr int THREADS = 128;  // four warps
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long qb, qh, qt, kb, kh, kt, vb, vh, vt, ob, oh, ot;
};

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  int H, G, Tq, Tk, hd, causal, block_k;
  float scale;
  Strides st;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x by the MUFU's ex2.approx.ftz (about 2 ulp; subnormal results flush
// to 0, so a masked score's exp2(-1e30 - m) is exactly 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int HDP>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * static_cast<size_t>(BQ + 4 * BKV) * (HDP + 8);
}

// HDP: the head dim rounded up to 16.
template <int HDP>
__global__ void __launch_bounds__(THREADS) flash_mma_kernel(Params p) {
  constexpr int HS = HDP + 8;   // shared row stride (elements)
  constexpr int DK = HDP / 16;  // k16 steps of q k^T
  constexpr int DN = HDP / 8;   // n8 tiles of the output
  constexpr int CH = HDP / 8;   // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][HS]
  bf16* ks = qs + BQ * HS;                       // [2][BKV][HS]
  bf16* vs = ks + 2 * BKV * HS;                  // [2][BKV][HS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H, hk = h / p.G;
  const int row0 = blockIdx.x * BQ;
  const int row_end = min(row0 + BQ, p.Tq);
  const int hd = p.hd;

  const bf16* q = p.q + b * p.st.qb + h * p.st.qh;
  const bf16* k = p.k + b * p.st.kb + hk * p.st.kh;
  const bf16* v = p.v + b * p.st.vb + hk * p.st.vh;
  bf16* o = p.o + b * p.st.ob + h * p.st.oh;

  // rows [base, base + nrows) of src (row stride st) into a tile of `rows`
  // rows, zero past nrows and past hd
  auto load_tile = [&](bf16* dst, const bf16* src, long long st, int base,
                       int nrows, int rows) {
    for (int c = tid; c < rows * CH; c += THREADS) {
      const int r = c / CH, d = (c % CH) * 8;
      const bool ok = r < nrows && d < hd;
      cp_async16(dst + r * HS + d, ok ? src + (base + r) * st + d : src,
                 ok ? 16 : 0);
    }
  };

  // causal: no key past the block's last row is visible to any of its rows
  const int kend = p.causal ? min(p.Tk, row_end) : p.Tk;
  const int wrow = warp * 16 * MT;  // the warp's first row in the block
  const int warp_first = row0 + wrow, warp_last = warp_first + 16 * MT - 1;
  const float sl2 = p.scale * LOG2E;

  // the kv tiles: chunks of block_k keys, each walked in tiles of BKV
  int t0 = 0, c0 = 0;
  auto tile_len = [&](int t, int c) {
    return min(BKV, min(c + p.block_k, p.Tk) - t);
  };
  load_tile(qs, q, p.st.qt, row0, row_end - row0, BQ);
  load_tile(ks, k, p.st.kt, t0, tile_len(t0, c0), BKV);
  load_tile(vs, v, p.st.vt, t0, tile_len(t0, c0), BKV);
  cp_async_commit();

  // row tile i of the warp: rows warp_first + 16 i + g (r = 0), + 8 (r = 1)
  float m[MT][2], l[MT][2], acc[MT][DN][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[i][r] = NEG_INF;
      l[i][r] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < DN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }
  int stage = 0;

  while (t0 < kend) {
    const int n = tile_len(t0, c0);
    int t1 = t0 + BKV, c1 = c0;
    if (t1 >= min(c0 + p.block_k, p.Tk)) {
      c1 = c0 + p.block_k;
      t1 = c1;
    }
    if (t1 < kend) {  // the next tile, in flight during this one
      const int n1 = tile_len(t1, c1);
      load_tile(ks + (stage ^ 1) * BKV * HS, k, p.st.kt, t1, n1, BKV);
      load_tile(vs + (stage ^ 1) * BKV * HS, v, p.st.vt, t1, n1, BKV);
    }
    cp_async_commit();
    cp_async_wait<1>();  // everything but the newest group: this tile
    __syncthreads();
    if (!p.causal || t0 <= warp_last) {
      const bf16* kt = ks + stage * BKV * HS;
      const bf16* vt = vs + stage * BKV * HS;
      // S = q k^T: each k fragment serves the warp's MT row tiles
      float s[MT][8][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][j][e] = 0.f;
#pragma unroll
      for (int d = 0; d < DK; ++d) {
        uint32_t qa[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i)
          ldmatrix_x4(qa[i], qs + (wrow + i * 16 + (lane & 15)) * HS +
                                 d * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          uint32_t r[4];
          ldmatrix_x4(r, kt + (j * 8 + (lane & 7) + ((lane >> 4) << 3)) * HS +
                             d * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            mma_bf16(s[i][j], qa[i], r[0], r[1]);
            mma_bf16(s[i][j + 1], qa[i], r[2], r[3]);
          }
        }
      }

      // online softmax in the log2 domain: the scores are masked raw
      // (NEG_INF), their max is scaled by sl2 = hd^-0.5 log2(e) > 0, and
      // p = 2^(s sl2 - m) by one fma. A tile whose every key is visible to
      // every row of the warp skips the mask.
      const bool open =
          n == BKV && (!p.causal || t0 + BKV - 1 <= warp_first);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int qlo = warp_first + 16 * i + g;
        if (!open) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kj = j * 8 + 2 * tig + (e & 1);
              if (kj >= n || (p.causal && t0 + kj > qlo + (e & 2) * 4))
                s[i][j][e] = NEG_INF;
            }
        }
        float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mx[e >> 1] = fmaxf(mx[e >> 1], s[i][j][e]);
        float alpha[2], mnew[2], rs[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          // a row with no visible key in the tile keeps its m
          mnew[r] = mx[r] > NEG_INF / 2 ? fmaxf(m[i][r], mx[r] * sl2)
                                        : m[i][r];
          alpha[r] = exp2_approx(m[i][r] - mnew[r]);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float sv = s[i][j][e];
            const float pv =
                open || sv > NEG_INF / 2
                    ? exp2_approx(fmaf(sv, sl2, -mnew[e >> 1]))
                    : 0.f;
            s[i][j][e] = pv;
            rs[e >> 1] += pv;
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
          rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
          l[i][r] = l[i][r] * alpha[r] + rs[r];
          m[i][r] = mnew[r];
        }
#pragma unroll
        for (int j = 0; j < DN; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] *= alpha[e >> 1];
      }

      // acc += p (bf16, from the S fragments) @ v; each v fragment serves
      // the warp's MT row tiles
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t a[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          a[i][0] = pack_bf16(s[i][2 * kk][0], s[i][2 * kk][1]);
          a[i][1] = pack_bf16(s[i][2 * kk][2], s[i][2 * kk][3]);
          a[i][2] = pack_bf16(s[i][2 * kk + 1][0], s[i][2 * kk + 1][1]);
          a[i][3] = pack_bf16(s[i][2 * kk + 1][2], s[i][2 * kk + 1][3]);
        }
#pragma unroll
        for (int j = 0; j < DN; j += 2) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, vt + (kk * 16 + (lane & 15)) * HS + j * 8 +
                                   (lane >> 4) * 8);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            mma_bf16(acc[i][j], a[i], r[0], r[1]);
            mma_bf16(acc[i][j + 1], a[i], r[2], r[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
    stage ^= 1;
    t0 = t1;
    c0 = c1;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp_first + 16 * i + g + 8 * r;
      if (row >= row_end) continue;
      const float lv = fmaxf(l[i][r], 1e-30f);
      bf16* orow = o + row * p.st.ot;
#pragma unroll
      for (int j = 0; j < DN; ++j) {
        const int d = j * 8 + 2 * tig;
        if (d < hd)
          *reinterpret_cast<__nv_bfloat162*>(orow + d) =
              __floats2bfloat162_rn(acc[i][j][2 * r] / lv,
                                    acc[i][j][2 * r + 1] / lv);
      }
    }
}

template <int HDP>
cudaError_t launch(const Params& p, int BH, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<HDP>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_mma_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((p.Tq + BQ - 1) / BQ, BH);
  flash_mma_kernel<HDP><<<grid, THREADS, smem, s>>>(p);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

// The same arguments as flash_attention.cu's entry points; bf16 only, and
// the shapes the wrapper's kernel_variant sends here (else
// cudaErrorInvalidValue).
extern "C" int k4_flash_attention_bf16_mma(const void* q, const void* k,
                                           const void* v, void* o, int B,
                                           int H, int KV, int Tq, int Tk,
                                           int hd, const long long* strides,
                                           int causal, int block_k,
                                           float scale, void* stream) {
  if (hd < 8 || hd > 128 || hd % 8 != 0 || KV < 1 || H % KV != 0 ||
      Tq < 1 || Tk < 1 || block_k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 12; ++i)
    if (strides[i] % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<bf16*>(o);
  p.H = H;
  p.G = H / KV;
  p.Tq = Tq;
  p.Tk = Tk;
  p.hd = hd;
  p.causal = causal;
  p.block_k = std::min(block_k, Tk);
  p.scale = scale;
  p.st = Strides{strides[0], strides[1], strides[2],  strides[3],
                 strides[4], strides[5], strides[6],  strides[7],
                 strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int BH = B * H;
  cudaError_t e;
  switch ((hd + 15) / 16) {
    case 1: e = launch<16>(p, BH, s); break;
    case 2: e = launch<32>(p, BH, s); break;
    case 3: e = launch<48>(p, BH, s); break;
    case 4: e = launch<64>(p, BH, s); break;
    case 5: e = launch<80>(p, BH, s); break;
    case 6: e = launch<96>(p, BH, s); break;
    case 7: e = launch<112>(p, BH, s); break;
    default: e = launch<128>(p, BH, s); break;
  }
  return static_cast<int>(e);
}

