// K1 in bf16 — the streamed matmul on the tensor cores, hand-written for
// Hopper (sm_90a).
//
// Replaces repro/kernels/streamed_matmul.py::streamed_matmul (the Pallas
// kernel _mm_kernel) for bf16 x (M, K) and w (K, N), row-major: out = x @ w
// with bf16 products summed in f32 and the result rounded to bf16. (K1 in
// f32, K2 and K3 stay on the f32 tile kernel of streamed_matmul.cu: the
// tensor cores have no f32 product that keeps f32's rounding, and K2 / K3
// dequantise to f32, which bf16 operands would round.)
//
// Bound. The port calls K1 for the dense FFN's w_gate, w_up and w_down.
// At decode M is the batch (1..4) and the weight's bytes bound it: qwen2-
// 0.5b's (896, 4864) is 8.7 MB, about 2.6 us at the H100 SXM data sheet's
// 3.35 TB/s. A prefill chunk of 256 rows is still bytes-bound (256 x 896 x
// 4864 x 2 = 2.2 GFLOP, 2.3 us at 989 TFLOP/s of bf16 tensor cores). So
// the kernel has to keep many weight bytes in flight on every SM, which
// the output tiles alone cannot do when N is narrow: (M, 4864) @ (4864,
// 896) has 14 column tiles of 64 for 132 SMs.
//
// Design:
//   - one instruction for every M: mma.sync.m16n8k16 (bf16 operands, f32
//     sums). Block tiles of BM x 64 outputs: BM = 16 with four warps of
//     16 x 16 (M <= 16), else BM = 64 with eight warps of 32 x 16; rows
//     past M are zero-filled in shared memory and not stored;
//   - bf16 tiles in shared memory (x: BM x 64, w: 64 x 64, rows padded by
//     16 bytes so ldmatrix is free of bank conflicts), x read by ldmatrix
//     and w, row-major (K, N), by ldmatrix.trans as the col-major B operand;
//   - a ring of 4 stages filled by 16-byte cp.async copies, zero-filled past
//     every edge (src-size 0); where a row stride or pointer is not 16-byte
//     aligned (K or N not a multiple of 8) the loader falls back to element
//     loads, so any (M, K, N) runs;
//   - a fixed split-K: grid.z = S splits of k_split rows each (a multiple of
//     the 64-row k-tile, the last one ragged), chosen by the wrapper from
//     (K, N) alone (streamed_matmul.py::split_plan), never from M. With
//     S > 1 each split writes its f32 partial tile into a workspace (S, M,
//     N); the last block of an output tile to arrive (a per-tile counter,
//     which that block resets to 0 for the next launch) sums the S partials
//     in split order 0, 1, ..., S-1 and stores bf16. One launch per call.
// Row independence: every output element is the same sequence of k16 steps
// over the same split ranges, each from a zero sum, summed in the same
// order, whatever M, the grid or the tile rows (BM = 16 and BM = 64 differ
// only in how many rows a block holds). So kernel(x)[rows] ==
// kernel(x[rows]) bit for bit, and the wrapper may cut M into slices of at
// most 256 rows, which bounds the workspace.
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (repro_torch/kernels/streamed_matmul.py). The entry point
// launches on the stream it is given, does not synchronise, and returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BN = 64;        // output columns per block
constexpr int BK = 64;        // k-tile
constexpr int STAGES = 4;     // cp.async ring
constexpr int XS = BK + 8;    // row stride (elements) of the x tile
constexpr int WS = BN + 8;    // row stride of the w tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; the bytes past src_bytes are zero-filled.
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

// d += a (16 x 16, row-major fragment) * b (16 x 8, col-major fragment)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// out[row, col], out[row, col + 1] as bf16 where they lie inside (M, N)
__device__ __forceinline__ void store_pair(bf16* out, int M, int N, int row,
                                           int col, float v0, float v1) {
  if (row >= M || col >= N) return;
  bf16* p = out + static_cast<size_t>(row) * N + col;
  if (col + 1 < N && N % 2 == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    p[0] = __float2bfloat16(v0);
    if (col + 1 < N) p[1] = __float2bfloat16(v1);
  }
}

// BM rows x 64 columns per block, warps WM x WN, each warp a (BM / WM) x
// (64 / WN) tile of m16 x n8 fragments.
template <int BM, int WM, int WN>
__global__ void __launch_bounds__(WM * WN * 32)
    mm_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                  bf16* __restrict__ out, float* __restrict__ ws,
                  unsigned* __restrict__ counters, int M, int N, int K,
                  int k_split, bool vec_x, bool vec_w) {
  constexpr int THREADS = WM * WN * 32;
  constexpr int WTM = BM / WM, WTN = BN / WN;
  constexpr int MT = WTM / 16, NT = WTN / 8;
  static_assert(MT >= 1 && NT % 2 == 0, "warp tile of m16 x (2 n8)");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [STAGES][BM][XS]
  bf16* wsm = xs + STAGES * BM * XS;             // [STAGES][BK][WS]
  __shared__ unsigned last_block;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int split = blockIdx.z, S = gridDim.z;
  const int kbeg = split * k_split;
  const int kend = min(K, kbeg + k_split);
  const int ntiles = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;
  const bf16 zero = __float2bfloat16(0.f);

  auto load = [&](int t, int stage) {
    const int k0 = kbeg + t * BK;
    bf16* xd = xs + stage * BM * XS;
    bf16* wd = wsm + stage * BK * WS;
    for (int c = tid; c < BM * (BK / 8); c += THREADS) {
      const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      const int gm = m0 + r, gk = k0 + kc;
      bf16* dst = xd + r * XS + kc;
      if (vec_x) {
        const int n = (gm < M && gk < kend) ? min(8, kend - gk) : 0;
        cp_async16(dst, n ? x + static_cast<size_t>(gm) * K + gk : x, 2 * n);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gm < M && gk + e < kend)
                       ? x[static_cast<size_t>(gm) * K + gk + e]
                       : zero;
      }
    }
    for (int c = tid; c < BK * (BN / 8); c += THREADS) {
      const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
      const int gk = k0 + r, gn = n0 + nc;
      bf16* dst = wd + r * WS + nc;
      if (vec_w) {
        const int n = (gk < kend && gn < N) ? min(8, N - gn) : 0;
        cp_async16(dst, n ? w + static_cast<size_t>(gk) * N + gn : w, 2 * n);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gk < kend && gn + e < N)
                       ? w[static_cast<size_t>(gk) * N + gn + e]
                       : zero;
      }
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) load(s, s);
    cp_async_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<STAGES - 2>();  // tile t has landed
    __syncthreads();              // ... for every thread; stage t-1 is free
    const int tn = t + STAGES - 1;  // into the stage that tile t-1 used
    if (tn < ntiles) load(tn, tn % STAGES);
    cp_async_commit();
    const bf16* xa = xs + (t % STAGES) * BM * XS;
    const bf16* wb = wsm + (t % STAGES) * BK * WS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(a[i], xa + (wm * WTM + i * 16 + (lane & 15)) * XS + kk +
                              (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, wb + (kk + (lane & 15)) * WS + wn * WTN +
                                 j * 8 + (lane >> 4) * 8);
        b[j][0] = r[0];
        b[j][1] = r[1];
        b[j + 1][0] = r[2];
        b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();

  // fragment (i, j, e): row g (+8 for e >= 2), columns 2 * tig, 2 * tig + 1
  const int g = lane >> 2, tig = lane & 3;
  const int rbase = m0 + wm * WTM + g, cbase = n0 + wn * WTN + 2 * tig;
  if (S == 1) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          store_pair(out, M, N, rbase + i * 16 + 8 * h, cbase + j * 8,
                     acc[i][j][2 * h], acc[i][j][2 * h + 1]);
    return;
  }

  // S > 1: this split's partial, then the tile's last block sums them all
  const size_t plane = static_cast<size_t>(M) * N;
  float* part = ws + split * plane;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rbase + i * 16 + 8 * h, col = cbase + j * 8;
        if (row >= M || col >= N) continue;
        float* dst = part + static_cast<size_t>(row) * N + col;
        if (col + 1 < N && N % 2 == 0) {
          *reinterpret_cast<float2*>(dst) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        } else {
          dst[0] = acc[i][j][2 * h];
          if (col + 1 < N) dst[1] = acc[i][j][2 * h + 1];
        }
      }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const unsigned tile = blockIdx.y * gridDim.x + blockIdx.x;
    const unsigned prev = atomicAdd(counters + tile, 1u);
    last_block = prev == static_cast<unsigned>(S - 1);
    if (last_block) counters[tile] = 0u;  // every split has arrived
  }
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  // The whole tile, 4 columns per thread and step, each element summed in
  // split order. The splits' loads are issued 4 at a time ahead of their
  // adds, so the sum waits on the L2 S / 4 times, not S times per element.
  constexpr int CHUNKS = BM * BN / 4 / THREADS;
  const bool vec = N % 4 == 0;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int idx = c * THREADS + tid;
    const int row = m0 + idx / (BN / 4), col = n0 + (idx % (BN / 4)) * 4;
    if (row >= M || col >= N) continue;
    const float* src = ws + static_cast<size_t>(row) * N + col;
    const int nc = min(4, N - col);
    float sum[4], nxt[4][4];
    auto fetch = [&](int s, float (&v)[4]) {
      const float* q = src + s * plane;
      if (vec) {
        const float4 f = __ldcg(reinterpret_cast<const float4*>(q));
        v[0] = f.x;
        v[1] = f.y;
        v[2] = f.z;
        v[3] = f.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = e < nc ? __ldcg(q + e) : 0.f;
      }
    };
    fetch(0, sum);
    int s = 1;
    for (; s + 4 <= S; s += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) fetch(s + u, nxt[u]);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[e] = __fadd_rn(sum[e], nxt[u][e]);
    }
    for (; s < S; ++s) {
      fetch(s, nxt[0]);
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[e] = __fadd_rn(sum[e], nxt[0][e]);
    }
    store_pair(out, M, N, row, col, sum[0], sum[1]);
    store_pair(out, M, N, row, col + 2, sum[2], sum[3]);
  }
}

template <int BM, int WM, int WN>
cudaError_t launch(const bf16* x, const bf16* w, bf16* out, float* ws,
                   unsigned* counters, int M, int N, int K, int k_split,
                   cudaStream_t stream) {
  constexpr size_t smem =
      sizeof(bf16) * STAGES * (static_cast<size_t>(BM) * XS + BK * WS);
  // above 48 KB of dynamic shared memory only after this opt-in, made once
  // per device (a decode step launches K1 72 times from a busy host)
  static std::atomic<unsigned> opted_in{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 32 || !((opted_in.load() >> dev) & 1u)) {
    e = cudaFuncSetAttribute(mm_mma_kernel<BM, WM, WN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    if (dev < 32) opted_in.fetch_or(1u << dev);
  }
  // a 16-byte copy needs an aligned row start: aligned base, stride % 8
  const bool vec_x = reinterpret_cast<uintptr_t>(x) % 16 == 0 && K % 8 == 0;
  const bool vec_w = reinterpret_cast<uintptr_t>(w) % 16 == 0 && N % 8 == 0;
  const int S = K > 0 ? (K + k_split - 1) / k_split : 1;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, S);
  mm_mma_kernel<BM, WM, WN><<<grid, WM * WN * 32, smem, stream>>>(
      x, w, out, ws, counters, M, N, K, k_split, vec_x, vec_w);
  return cudaGetLastError();
}

}  // namespace

// out (M, N) = x (M, K) @ w (K, N), bf16, row-major. k_split: rows of K per
// split (a positive multiple of 64); with ceil(K / k_split) > 1 splits, ws
// holds S * M * N floats and counters one zeroed unsigned per output tile
// (ceil(M / BM) * ceil(N / 64), BM = 16 for M <= 16, else 64), which the
// kernel leaves zeroed. Launches that may run at the same time (on two
// streams) must not share counters or ws; the wrapper keeps one counter
// buffer per (device, stream) and takes ws from the stream-ordered
// caching allocator.
extern "C" int k1_streamed_matmul_bf16(const void* x, const void* w,
                                       void* out, void* ws, void* counters,
                                       int M, int N, int K, int k_split,
                                       void* stream) {
  if (M < 1 || N < 1 || K < 0 || k_split < BK || k_split % BK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (K > k_split && (ws == nullptr || counters == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* ob = static_cast<bf16*>(out);
  float* wsf = static_cast<float*>(ws);
  unsigned* cnt = static_cast<unsigned*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      M <= 16 ? launch<16, 1, 4>(xb, wb, ob, wsf, cnt, M, N, K, k_split, s)
              : launch<64, 2, 4>(xb, wb, ob, wsf, cnt, M, N, K, k_split, s);
  return static_cast<int>(e);
}
