// K4's backward in bf16 — the gradients of flash attention on the tensor
// cores, hand-written for Hopper (sm_90a), with mma.sync.
//
// The TPU kernel it completes is repro/kernels/flash_attention.py::
// flash_attention (the Pallas kernel _flash_kernel), which has no backward:
// the JAX package differentiates its jnp twin attend_flash by autodiff. It
// computes what flash_attention_bwd.cu computes, for bf16 q (B, H, Tq, hd),
// k and v (B, KV, Tk, hd), the output's gradient dO and the forward's f32
// row logsumexp lse (B, H, Tq), with hd a multiple of 8 up to 128, every
// (batch, head, position) stride a multiple of 8 elements and 16-byte
// aligned pointers (the wrapper's kernel_variant sends every other call,
// and f32, to flash_attention_bwd.cu): p = exp(s * scale - lse) with
// scale = hd^-0.5; dP = dO v^T; D = rowsum(p dP) in f32, from the f32 p
// and the f32 dP accumulators (not FlashAttention-2's rowsum(dO o): see
// flash_attention_bwd.cu); dv = p^T dO; ds = p (dP - D); dq = scale ds k;
// dk = scale ds^T q; a kv head's dk and dv sum its G query heads; causal
// key j is visible to query i when j <= i, both from 0, also when
// Tq != Tk; rows past Tq and keys past Tk weigh 0 and are never stored.
// Numerics: S and dP are f32 sums of exact bf16 products; p is
// 2^(s scale log2(e) - lse log2(e)) by ex2.approx; p and ds are rounded to
// bf16 as the tensor cores' operands of dv, dk and dq (as the plain bf16
// attention's autograd rounds them), every sum and D stay in f32, and the
// results are rounded to bf16 once.
//
// Bound. Five products of 2 * hd operations per visible (query, key) pair
// (S, dP, dv, dk, dq) against the bytes of q, k, v, dO, lse read once and
// dq, dk, dv written once: operations bound it, at qwen2-0.5b's
// (4, 14, 2, 4096, 64) causal 0.304 ms at the H100 SXM data sheet's 989
// TFLOP/s of bf16 tensor cores. This kernel runs nine products (S and dP
// are recomputed in each of the three sweeps), all on the tensor cores.
//
// Design (two kernels, no atomics, so the bits do not depend on the launch):
//   - mma.sync.m16n8k16, bf16 operands, f32 accumulators; four warps, each
//     owning 16 rows (queries or keys) of a 64-row block; tiles of 64 rows
//     in shared memory padded by 16 bytes, so ldmatrix is conflict-free,
//     filled by 16-byte cp.async (zero past a length or the head dim: a
//     head dim that is a multiple of 8 but not of 16 gets a zero tail);
//   - rows kernel, a block per (batch, head, 64 query rows), q and dO held
//     in shared memory, 64-key tiles of k and v through a 2-stage cp.async
//     ring: a first sweep over the visible key tiles sums p dP per row in
//     registers (then across the 4 lanes that share a row) into D, written
//     to an f32 scratch (B, H, Tq); a second sweep recomputes S and dP,
//     packs ds = p (dP - D) to bf16 straight from the accumulator fragments
//     into the A operand of dq += ds k, with k read by ldmatrix.trans;
//     dq is summed in registers and written once;
//   - dk / dv kernel, a block per (batch, kv head, 64 keys), launched after
//     the rows kernel: k and v held in shared memory; the group's query
//     heads and the 64-row query tiles that can see the block's keys come
//     through a 2-stage cp.async ring (q, dO, lse and D); S^T = k q^T and
//     dP^T = v dO^T put keys on the accumulator rows, so p^T and ds^T,
//     packed to bf16, are the A operands of dv += p^T dO and dk += ds^T q
//     with q and dO read by ldmatrix.trans; 16-query chunks (32 at hd > 64,
//     64 at hd <= 64, so that each k or v fragment serves several of them
//     within the registers); dk and dv are summed in registers and written
//     once;
//   - causal: tiles and chunks that no row of a warp can see are skipped,
//     the mask is skipped on those open to all of them; blocks with the
//     most work launch first (the last query rows, the first keys);
//   - at hd <= 64 the rows kernel's registers are capped at 128, so that
//     four of its blocks share an SM (faster at the training shape).
// Measured on the H100 and not kept (bits equal, times in a scratch build):
// 8 warps a block in either kernel (slower at every timed shape); the D
// sweep as a launch of its own (no faster); the dk / dv kernel's registers
// capped for three blocks an SM (faster at G = 1 and hd 80, slower at the
// training shape's G = 7 and at hd 128); one 16-query chunk a product.
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (repro_torch/kernels/flash_attention.py). The entry point
// launches its two kernels on the stream it is given, does not
// synchronise, and returns cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BT = 64;         // query rows or keys per block and per tile
constexpr int THREADS = 128;   // four warps, 16 rows or keys each
constexpr int GRID_Y_MAX = 65535;
constexpr float LOG2E = 1.4426950408889634f;

// element strides over (batch, head, position); the head dim is contiguous
struct Strides {
  long long b, h, t;
};

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;  // (B, H, Tq), contiguous
  float* delta;      // (B, H, Tq), contiguous: rowsum(p dP)
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int H, KV, G, Tq, Tk, hd, causal;
  float scale;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
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
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
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
// 2^x by the MUFU's ex2.approx.ftz (about 2 ulp)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// rows [base, base + nrows) of src (row stride st) into a BT-row tile of
// row stride HDP + 8, zero past nrows and past hd
template <int HDP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long st, int base, int nrows,
                                          int hd) {
  constexpr int HS = HDP + 8, CH = HDP / 8;
  for (int c = threadIdx.x; c < BT * CH; c += THREADS) {
    const int r = c / CH, d = (c % CH) * 8;
    const bool ok = r < nrows && d < hd;
    cp_async16(dst + r * HS + d, ok ? src + (base + r) * st + d : src,
               ok ? 16 : 0);
  }
}

// BT floats from src into dst, zero past nrows
__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         int nrows) {
  for (int r = threadIdx.x; r < BT; r += THREADS)
    cp_async4(dst + r, r < nrows ? src + r : src, r < nrows ? 4 : 0);
}

// acc[j] (NT n8 tiles) += A B^T over the head dim: A the 16 rows of `a`
// from row a0, B the 8 NT rows of `b` from row b0 (both [row][HDP + 8]);
// each A fragment serves all NT tiles
template <int HDP, int NT>
__device__ __forceinline__ void dot_product(float (&acc)[NT][4],
                                            const bf16* a, int a0,
                                            const bf16* b, int b0, int lane) {
  constexpr int HS = HDP + 8;
#pragma unroll
  for (int d = 0; d < HDP / 16; ++d) {
    uint32_t fa[4];
    ldmatrix_x4(fa, a + (a0 + (lane & 15)) * HS + d * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t r[4];
      ldmatrix_x4(r, b + (b0 + j * 8 + (lane & 7) + ((lane >> 4) << 3)) * HS +
                         d * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(acc[j], fa, r[0], r[1]);
      mma_bf16(acc[j + 1], fa, r[2], r[3]);
    }
  }
}

// the accumulator fragments c (16 rows x 16 KT columns, f32) as the bf16 A
// fragments of the next product, one per 16 columns
template <int KT>
__device__ __forceinline__ void pack_a(uint32_t (&a)[KT][4],
                                       const float (&c)[2 * KT][4]) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// acc[j] (HDP / 8 n8 tiles of the head dim) += A X: A the fragments a of
// 16 rows x 16 KT columns, X the 16 KT rows of `x` from row x0, read by
// ldmatrix.trans
template <int HDP, int KT>
__device__ __forceinline__ void sum_product(float (&acc)[HDP / 8][4],
                                            const uint32_t (&a)[KT][4],
                                            const bf16* x, int x0, int lane) {
  constexpr int HS = HDP + 8;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk)
#pragma unroll
    for (int j = 0; j < HDP / 8; j += 2) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, x + (x0 + kk * 16 + (lane & 15)) * HS + j * 8 +
                               (lane >> 4) * 8);
      mma_bf16(acc[j], a[kk], r[0], r[1]);
      mma_bf16(acc[j + 1], a[kk], r[2], r[3]);
    }
}

// 16 rows x HDP of f32 accumulators times `mul`, as bf16 into rows
// row_lo (e < 2) and row_lo + 8 (e >= 2) of dst, rows below `rows` and
// head dims below hd only
template <int HDP>
__device__ __forceinline__ void store_rows(bf16* dst, long long st,
                                           const float (&acc)[HDP / 8][4],
                                           float mul, int row_lo, int rows,
                                           int hd, int tig) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    if (row >= rows) continue;
    bf16* out = dst + row * st;
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      const int d = j * 8 + 2 * tig;
      if (d < hd)
        *reinterpret_cast<__nv_bfloat162*>(out + d) = __floats2bfloat162_rn(
            acc[j][2 * r] * mul, acc[j][2 * r + 1] * mul);
    }
  }
}

template <int HDP>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * 6 * BT * (HDP + 8) + sizeof(float) * 4 * BT;
}

// D and dq of 64 query rows of one (batch, head) (at hd <= 64 four blocks
// an SM, which caps the registers at 128)
template <int HDP>
__global__ void __launch_bounds__(THREADS, HDP <= 64 ? 4 : 1)
    rows_mma_kernel(Params p) {
  constexpr int HS = HDP + 8, DN = HDP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BT][HS]
  bf16* dos = qs + BT * HS;                      // [BT][HS]
  bf16* ks = dos + BT * HS;                      // [2][BT][HS]
  bf16* vs = ks + 2 * BT * HS;                   // [2][BT][HS]
  float* lse_s = reinterpret_cast<float*>(vs + 2 * BT * HS);  // [BT]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H, hk = h / p.G;
  // the last rows (the most keys under causal) first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BT;
  const int nq = min(BT, p.Tq - q0);
  const bf16* q = p.q + b * p.sq.b + h * p.sq.h;
  const bf16* dO = p.dout + b * p.sdo.b + h * p.sdo.h;
  const bf16* k = p.k + b * p.sk.b + hk * p.sk.h;
  const bf16* v = p.v + b * p.sv.b + hk * p.sv.h;
  const size_t rows = static_cast<size_t>(bh) * p.Tq + q0;

  load_tile<HDP>(qs, q, p.sq.t, q0, nq, p.hd);
  load_tile<HDP>(dos, dO, p.sdo.t, q0, nq, p.hd);
  load_tile<HDP>(ks, k, p.sk.t, 0, min(BT, p.Tk), p.hd);
  load_tile<HDP>(vs, v, p.sv.t, 0, min(BT, p.Tk), p.hd);
  cp_async_commit();
  if (tid < BT) lse_s[tid] = tid < nq ? p.lse[rows + tid] * LOG2E : 0.f;

  // causal: no key past the block's last row is visible to any of its rows
  const int kend = p.causal ? min(p.Tk, q0 + nq) : p.Tk;
  const int nkt = (kend + BT - 1) / BT;
  const int wrow = warp * 16;  // the warp's first row in the block
  const int warp_first = q0 + wrow, warp_last = warp_first + 15;
  const int qlo = warp_first + g;  // rows qlo (e < 2) and qlo + 8 (e >= 2)
  const float sl2 = p.scale * LOG2E;
  float lse2[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f};
  float dq[DN][4];
#pragma unroll
  for (int j = 0; j < DN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  // tiles t < nkt: the D sweep; nkt <= t < 2 nkt: the dq sweep
  int stage = 0;
  for (int t = 0; t < 2 * nkt; ++t) {
    const int k0 = (t % nkt) * BT, nk = min(BT, p.Tk - k0);
    if (t + 1 < 2 * nkt) {  // the next tile, in flight during this one
      const int k1 = ((t + 1) % nkt) * BT, n1 = min(BT, p.Tk - k1);
      load_tile<HDP>(ks + (stage ^ 1) * BT * HS, k, p.sk.t, k1, n1, p.hd);
      load_tile<HDP>(vs + (stage ^ 1) * BT * HS, v, p.sv.t, k1, n1, p.hd);
    }
    cp_async_commit();
    cp_async_wait<1>();  // everything but the newest group: this tile
    __syncthreads();
    if (t == 0) {
      lse2[0] = lse_s[wrow + g];
      lse2[1] = lse_s[wrow + g + 8];
    }
    if (t == nkt) {  // D of the warp's rows: the sum over the row's 4 lanes
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 1);
        dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 2);
        if (tig == 0 && qlo + 8 * r < p.Tq)
          p.delta[rows + wrow + g + 8 * r] = dsum[r];
      }
    }
    if (!p.causal || k0 <= warp_last) {
      const bf16* kt = ks + stage * BT * HS;
      const bf16* vt = vs + stage * BT * HS;
      float s[8][4], dp[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      dot_product<HDP, 8>(s, qs, wrow, kt, 0, lane);
      dot_product<HDP, 8>(dp, dos, wrow, vt, 0, lane);
      // element (j, e): row qlo + 8 (e >> 1), key k0 + 8 j + 2 tig + (e & 1)
      const bool open = nk == BT && (!p.causal || k0 + BT - 1 <= warp_first);
      const bool d_sweep = t < nkt;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + j * 8 + 2 * tig + (e & 1);
          const bool seen =
              open || (kj < p.Tk && (!p.causal || kj <= qlo + 8 * (e >> 1)));
          const float pv =
              seen ? exp2_approx(fmaf(s[j][e], sl2, -lse2[e >> 1])) : 0.f;
          if (d_sweep)
            dsum[e >> 1] = fmaf(pv, dp[j][e], dsum[e >> 1]);
          else
            s[j][e] = pv * (dp[j][e] - dsum[e >> 1]);  // ds
        }
      if (!d_sweep) {
        uint32_t a[4][4];
        pack_a<4>(a, s);
        sum_product<HDP, 4>(dq, a, kt, 0, lane);
      }
    }
    __syncthreads();  // every warp is done with this stage
    stage ^= 1;
  }
  cp_async_wait<0>();
  store_rows<HDP>(p.dq + b * p.sdq.b + h * p.sdq.h, p.sdq.t, dq, p.scale, qlo,
                  p.Tq, p.hd, tig);
}

// dk and dv of 64 keys of one (batch, kv head); reads the rows kernel's D
template <int HDP>
__global__ void __launch_bounds__(THREADS) dkdv_mma_kernel(Params p) {
  constexpr int HS = HDP + 8, DN = HDP / 8;
  constexpr int NC = HDP <= 64 ? 4 : 2;  // 16-query chunks per product
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [BT][HS]
  bf16* vs = ks + BT * HS;                       // [BT][HS]
  bf16* qs = vs + BT * HS;                       // [2][BT][HS]
  bf16* dos = qs + 2 * BT * HS;                  // [2][BT][HS]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * BT * HS);  // [2][BT]
  float* d_s = lse_s + 2 * BT;                                  // [2][BT]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int b = blockIdx.x / p.KV, hk = blockIdx.x % p.KV;
  const int k0 = blockIdx.y * BT, nk = min(BT, p.Tk - k0);
  const bf16* k = p.k + b * p.sk.b + hk * p.sk.h;
  const bf16* v = p.v + b * p.sv.b + hk * p.sv.h;
  // causal: rows before k0 see none of these keys
  const int q_first = p.causal ? k0 : 0;
  const int nqt = q_first < p.Tq ? (p.Tq - q_first + BT - 1) / BT : 0;
  const int n_tiles = p.G * nqt;

  // tile t: query head hk G + t / nqt, rows q_first + (t % nqt) BT
  auto load_q_tile = [&](int t, int st) {
    const int h = hk * p.G + t / nqt, q0 = q_first + (t % nqt) * BT;
    const int nq = min(BT, p.Tq - q0);
    const size_t rows = static_cast<size_t>(b * p.H + h) * p.Tq + q0;
    load_tile<HDP>(qs + st * BT * HS, p.q + b * p.sq.b + h * p.sq.h, p.sq.t,
                   q0, nq, p.hd);
    load_tile<HDP>(dos + st * BT * HS, p.dout + b * p.sdo.b + h * p.sdo.h,
                   p.sdo.t, q0, nq, p.hd);
    load_vec(lse_s + st * BT, p.lse + rows, nq);
    load_vec(d_s + st * BT, p.delta + rows, nq);
  };
  load_tile<HDP>(ks, k, p.sk.t, k0, nk, p.hd);
  load_tile<HDP>(vs, v, p.sv.t, k0, nk, p.hd);
  if (n_tiles > 0) load_q_tile(0, 0);
  cp_async_commit();

  const int kw = warp * 16;  // the warp's first key in the block
  const int kfirst = k0 + kw, klo = kfirst + g;  // keys klo, klo + 8
  const float sl2 = p.scale * LOG2E;
  float dk[DN][4], dv[DN][4];
#pragma unroll
  for (int j = 0; j < DN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  int stage = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = q_first + (t % nqt) * BT;
    if (t + 1 < n_tiles) load_q_tile(t + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* qt = qs + stage * BT * HS;
    const bf16* dot = dos + stage * BT * HS;
    const float* lt = lse_s + stage * BT;
    const float* dt = d_s + stage * BT;
#pragma unroll
    for (int c0 = 0; c0 < BT; c0 += 16 * NC) {
      const int qf = q0 + c0;  // the chunk's first query
      // no key of the warp (none past Tk, under causal none at or before
      // the chunk's last query) is seen by the chunk
      if (kfirst >= p.Tk || qf >= p.Tq ||
          (p.causal && qf + 16 * NC - 1 < kfirst))
        continue;
      float st[2 * NC][4], dpt[2 * NC][4];
#pragma unroll
      for (int j = 0; j < 2 * NC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
      dot_product<HDP, 2 * NC>(st, ks, kw, qt, c0, lane);
      dot_product<HDP, 2 * NC>(dpt, vs, kw, dot, c0, lane);
      // element (j, e): key klo + 8 (e >> 1), query qf + 8 j + 2 tig + (e & 1)
      const bool open = qf + 16 * NC <= p.Tq && kfirst + 16 <= p.Tk &&
                        (!p.causal || qf >= kfirst + 15);
#pragma unroll
      for (int j = 0; j < 2 * NC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = c0 + j * 8 + 2 * tig + (e & 1), qi = q0 + ql;
          const int kj = klo + 8 * (e >> 1);
          const bool seen =
              open || (qi < p.Tq && kj < p.Tk && (!p.causal || kj <= qi));
          const float pv =
              seen ? exp2_approx(fmaf(st[j][e], sl2, -(lt[ql] * LOG2E)))
                   : 0.f;
          st[j][e] = pv;
          dpt[j][e] = pv * (dpt[j][e] - dt[ql]);  // ds
        }
      uint32_t a[NC][4];
      pack_a<NC>(a, st);
      sum_product<HDP, NC>(dv, a, dot, c0, lane);
      pack_a<NC>(a, dpt);
      sum_product<HDP, NC>(dk, a, qt, c0, lane);
    }
    __syncthreads();  // every warp is done with this stage
    stage ^= 1;
  }
  cp_async_wait<0>();
  store_rows<HDP>(p.dk + b * p.sdk.b + hk * p.sdk.h, p.sdk.t, dk, p.scale,
                  klo, p.Tk, p.hd, tig);
  store_rows<HDP>(p.dv + b * p.sdv.b + hk * p.sdv.h, p.sdv.t, dv, 1.f, klo,
                  p.Tk, p.hd, tig);
}

template <int HDP>
cudaError_t launch(const Params& p, int B, cudaStream_t s) {
  // above 48 KB of dynamic shared memory only after this opt-in
  constexpr size_t smem = smem_bytes<HDP>();
  cudaError_t e = cudaFuncSetAttribute(
      rows_mma_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dkdv_mma_kernel<HDP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  rows_mma_kernel<HDP>
      <<<dim3(B * p.H, (p.Tq + BT - 1) / BT), THREADS, smem, s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dkdv_mma_kernel<HDP>
      <<<dim3(B * p.KV, (p.Tk + BT - 1) / BT), THREADS, smem, s>>>(p);
  return cudaGetLastError();
}

Strides strides_at(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

// The same arguments as flash_attention_bwd.cu's entry points; bf16 only,
// and the calls the wrapper's kernel_variant sends here (else
// cudaErrorInvalidValue). strides: (batch, head, position) element strides
// of q, k, v, dO, dq, dk, dv (21 values); lse and delta are contiguous
// (B, H, Tq) f32, delta scratch written here.
extern "C" int k4_flash_attention_bwd_bf16_mma(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv, int B,
    int H, int KV, int Tq, int Tk, int hd, const long long* strides,
    int causal, float scale, void* stream) {
  if (hd < 8 || hd > 128 || hd % 8 != 0 || KV < 1 || H % KV != 0 || B < 1 ||
      Tq < 1 || Tk < 1 || (Tq + BT - 1) / BT > GRID_Y_MAX ||
      (Tk + BT - 1) / BT > GRID_Y_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 21; ++i)
    if (strides[i] % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout) ||
      !aligned16(dq) || !aligned16(dk) || !aligned16(dv))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = lse;
  p.delta = delta;
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.H = H;
  p.KV = KV;
  p.G = H / KV;
  p.Tq = Tq;
  p.Tk = Tk;
  p.hd = hd;
  p.causal = causal;
  p.scale = scale;
  p.sq = strides_at(strides, 0);
  p.sk = strides_at(strides, 1);
  p.sv = strides_at(strides, 2);
  p.sdo = strides_at(strides, 3);
  p.sdq = strides_at(strides, 4);
  p.sdk = strides_at(strides, 5);
  p.sdv = strides_at(strides, 6);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch ((hd + 15) / 16) {
    case 1: e = launch<16>(p, B, s); break;
    case 2: e = launch<32>(p, B, s); break;
    case 3: e = launch<48>(p, B, s); break;
    case 4: e = launch<64>(p, B, s); break;
    case 5: e = launch<80>(p, B, s); break;
    case 6: e = launch<96>(p, B, s); break;
    case 7: e = launch<112>(p, B, s); break;
    default: e = launch<128>(p, B, s); break;
  }
  return static_cast<int>(e);
}
