// K1, K2, K3 in f32 — the streamed matmuls for f32 activations, hand-
// written for Hopper (sm_90a). (bf16 x of every format runs on the tensor
// cores: streamed_matmul_mma.cu. The wrapper picks by dtype alone,
// streamed_matmul.py::kernel_variant.)
//
// One tile kernel, three weight formats (the template parameter W):
//   K1 streamed_matmul       replaces repro/kernels/streamed_matmul.py::
//                            _mm_kernel: w (K, N) f32;
//   K2 streamed_matmul_int8  replaces ::_mm_quant_kernel: w (K, N) int8
//                            codes q with f32 scales s (G, 1, N),
//                            w = float(q) * s[k / g];
//   K3 streamed_matmul_int4  replaces ::_mm_int4_kernel: packed (K/2, N)
//                            uint8, two codes per byte (low nibble = even
//                            K row), fp16 scales s and uint8 zero-points z,
//                            both (G, N), w = (float(q) - float(z)) * s.
// Every format computes out = x @ w for x (M, K): x and the dequantised w
// in f32, summed over K in f32 by fmaf, stored as f32. The group of row k
// is k / g with g = ceil(K / G), taken per row (never per
// byte: an odd g puts the two nibbles of one byte in two groups), so
// ragged groups (G * g != K) need no veto. Each weight format
// dequantises while it stores its tile into shared memory, so no
// dequantised weight ever lies in device memory, and the products are
// __fmul_rn, never contracted into the sum's fmaf: the same rounding as
// the plain version's dequantise-then-multiply.
//
// The Pallas kernels carried a sum across a sequential grid axis in VMEM
// scratch; here each thread keeps its sums in registers and walks K in a
// loop inside the block.
//
// Bound. The port calls them for the dense FFN's w_gate, w_up and w_down
// where the model runs in f32. At decode M is the batch (1..4) and they are
// bound by the weight's bytes. At M = 4 on qwen2-0.5b's (896, 4864),
// counting x, w, scales, zeros and out once, over the H100 SXM data
// sheet's 3.35 TB/s:
//   K1 f32   17,432,576 + 92,160 B                       about 5.23 us
//   K2 int8  4,358,144 + 136,192 + 92,160 B              about 1.37 us
//   K3 int4  2,179,072 + 68,096 + 34,048 + 92,160 B      about 0.71 us
// Large prefill chunks lean toward the operations bound.
//
// Design, simple and right first:
//   - shared-memory tiles of x (BM x BK) and of the dequantised w
//     (BK x BN) in f32; each thread owns a TM x TN block of outputs in
//     registers and accumulates with fmaf;
//   - the next K tile is loaded into registers (16-byte vector loads of x;
//     8-byte int8 and 4-byte packed int4 loads of w, with their scales and
//     zeros, where the row stride and the pointers allow; else element by
//     element) while the current one is computed. The quantised formats
//     keep the raw bytes in registers and dequantise at the store, so the
//     loads stay in flight during the compute;
//   - ragged edges are masked in M, N and K: a load past an edge reads 0
//     (codes, scales and zeros alike, so a masked w is exactly 0), and a
//     padded K step adds fmaf(0, 0, acc) == acc exactly; stores past an
//     edge are skipped;
//   - row results do not depend on M: every output element is one thread's
//     fmaf chain over k = 0, 1, ..., K-1 in that order, whatever M, the grid,
//     the tile configuration or the block that holds the row. There is no
//     split-K. So kernel(x)[rows] == kernel(x[rows]) bit for bit.
// Left for a later change (f32 x only; bf16 x has them in
// streamed_matmul_mma.cu): a multi-stage ring, wider loads of the quantised
// bytes, and more bytes in flight at decode: without split-K, N / BN blocks
// is all the parallelism a small M gives, so the (M, 4864) @ (4864, 896)
// down-projection runs on 28 blocks.
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (repro_torch/kernels/streamed_matmul.py). Each entry point
// launches on the stream it is given, does not synchronise, and returns
// cudaGetLastError() after the launch.

#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }

// VEC consecutive elements base[row * ld + col ...] as f32, zero past the
// edges (row >= rows, column >= cols). One 16-byte load when allowed.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ base, int ld,
                                         int row, int col, int rows,
                                         int cols, bool vec_ok,
                                         float (&out)[VEC]) {
  const T* p = base + static_cast<size_t>(row) * ld + col;
  if (row < rows && vec_ok && col + VEC <= cols) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < VEC; ++e) out[e] = to_f32(v[e]);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      out[e] = (row < rows && col + e < cols) ? to_f32(p[e]) : 0.f;
  }
}

// A weight format: one thread's chunk of a w tile is R rows x C columns.
// fetch() loads a chunk's raw bytes into registers (zeros past the edges),
// expand() turns them into the dequantised f32 values.

// K1: bf16 or f32 weights, converted to f32 as they are loaded.
template <typename T>
struct DenseW {
  static constexpr int R = 1, C = 16 / sizeof(T);
  struct Raw {
    float v[C];
  };
  const T* w;

  bool aligned(int N) const {
    return reinterpret_cast<uintptr_t>(w) % 16 == 0 && N % C == 0;
  }
  __device__ __forceinline__ void fetch(int k, int n, int K, int N, bool vec,
                                        Raw& raw) const {
    load_vec<T, C>(w, N, k, n, K, N, vec, raw.v);
  }
  __device__ __forceinline__ void expand(const Raw& raw,
                                         float (&f)[R][C]) const {
#pragma unroll
    for (int e = 0; e < C; ++e) f[0][e] = raw.v[e];
  }
};

// K2: int8 codes with one f32 scale per (group, column).
struct Int8W {
  static constexpr int R = 1, C = 8;
  struct Raw {
    uint2 q;        // 8 int8 codes
    float4 s[2];    // their 8 scales
  };
  const int8_t* q;
  const float* s;  // (G, 1, N)
  int g;           // rows per group

  bool aligned(int N) const {
    return reinterpret_cast<uintptr_t>(q) % 8 == 0 &&
           reinterpret_cast<uintptr_t>(s) % 16 == 0 && N % C == 0;
  }
  __device__ __forceinline__ void fetch(int k, int n, int K, int N, bool vec,
                                        Raw& raw) const {
    if (k < K && vec && n + C <= N) {
      raw.q = *reinterpret_cast<const uint2*>(q + static_cast<size_t>(k) * N
                                              + n);
      const float* sp = s + static_cast<size_t>(k / g) * N + n;
      raw.s[0] = *reinterpret_cast<const float4*>(sp);
      raw.s[1] = *reinterpret_cast<const float4*>(sp + 4);
    } else {
      int8_t* qv = reinterpret_cast<int8_t*>(&raw.q);
      float* sv = reinterpret_cast<float*>(raw.s);
#pragma unroll
      for (int e = 0; e < C; ++e) {
        const bool ok = k < K && n + e < N;
        qv[e] = ok ? q[static_cast<size_t>(k) * N + n + e] : 0;
        sv[e] = ok ? s[static_cast<size_t>(k / g) * N + n + e] : 0.f;
      }
    }
  }
  __device__ __forceinline__ void expand(const Raw& raw,
                                         float (&f)[R][C]) const {
    const int8_t* qv = reinterpret_cast<const int8_t*>(&raw.q);
    const float* sv = reinterpret_cast<const float*>(raw.s);
#pragma unroll
    for (int e = 0; e < C; ++e)
      f[0][e] = __fmul_rn(static_cast<float>(qv[e]), sv[e]);
  }
};

// K3: packed int4 codes, two K rows per byte, with an fp16 scale and a
// uint8 zero-point per (group, column). A chunk is the two rows k, k + 1
// (k even) of 4 columns: one 4-byte load of packed codes, and the scales
// and zeros of each row's own group.
struct Int4W {
  static constexpr int R = 2, C = 4;
  struct Raw {
    uint32_t p;     // 4 packed bytes: rows k (low nibble), k + 1 (high)
    uint2 s[2];     // fp16 scale bits of row k's and row k + 1's group
    uint32_t z[2];  // their zero-points
  };
  const uint8_t* p;   // (K / 2, N)
  const uint16_t* s;  // (G, N) fp16 bit patterns
  const uint8_t* z;   // (G, N)
  int g;

  bool aligned(int N) const {
    return reinterpret_cast<uintptr_t>(p) % 4 == 0 &&
           reinterpret_cast<uintptr_t>(s) % 8 == 0 &&
           reinterpret_cast<uintptr_t>(z) % 4 == 0 && N % C == 0;
  }
  __device__ __forceinline__ void fetch(int k, int n, int K, int N, bool vec,
                                        Raw& raw) const {
    // K is even and k is even, so k < K covers row k + 1 too
    if (k < K && vec && n + C <= N) {
      raw.p = *reinterpret_cast<const uint32_t*>(
          p + static_cast<size_t>(k / 2) * N + n);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const size_t gi = static_cast<size_t>((k + r) / g) * N + n;
        raw.s[r] = *reinterpret_cast<const uint2*>(s + gi);
        raw.z[r] = *reinterpret_cast<const uint32_t*>(z + gi);
      }
    } else {
      uint8_t* pv = reinterpret_cast<uint8_t*>(&raw.p);
      uint16_t* sv = reinterpret_cast<uint16_t*>(raw.s);
      uint8_t* zv = reinterpret_cast<uint8_t*>(raw.z);
#pragma unroll
      for (int e = 0; e < C; ++e) {
        const bool ok = k < K && n + e < N;
        pv[e] = ok ? p[static_cast<size_t>(k / 2) * N + n + e] : 0;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const size_t gi = ok ? static_cast<size_t>((k + r) / g) * N + n + e
                               : 0;
          sv[r * C + e] = ok ? s[gi] : 0;
          zv[r * C + e] = ok ? z[gi] : 0;
        }
      }
    }
  }
  __device__ __forceinline__ void expand(const Raw& raw,
                                         float (&f)[R][C]) const {
    const uint8_t* pv = reinterpret_cast<const uint8_t*>(&raw.p);
    const uint16_t* sv = reinterpret_cast<const uint16_t*>(raw.s);
    const uint8_t* zv = reinterpret_cast<const uint8_t*>(raw.z);
#pragma unroll
    for (int e = 0; e < C; ++e) {
      const float q[R] = {static_cast<float>(pv[e] & 0xF),
                          static_cast<float>(pv[e] >> 4)};
#pragma unroll
      for (int r = 0; r < R; ++r)
        f[r][e] = __fmul_rn(
            __fsub_rn(q[r], static_cast<float>(zv[r * C + e])),
            __half2float(__ushort_as_half(sv[r * C + e])));
    }
  }
};

template <typename T, typename W, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    mm_kernel(const T* __restrict__ x, W w, T* __restrict__ out, int M,
              int N, int K, bool vec_x, bool vec_w) {
  constexpr int VEC = 16 / sizeof(T);  // x elements per 16-byte load
  constexpr int RY = BM / TM;          // thread rows
  constexpr int RX = BN / TN;          // thread columns
  constexpr int NT = RY * RX;
  constexpr int WR = W::R, WC = W::C;  // one w chunk: WR rows x WC columns
  constexpr int LW = BK * BN / (WR * WC) / NT;  // w chunks per thread
  constexpr int LX = BM * BK / VEC / NT;        // x vectors per thread
  static_assert(BN % WC == 0 && BK % WR == 0, "w chunks must tile");
  static_assert(LW * WR * WC * NT == BK * BN, "w tile must split evenly");
  static_assert(LX * VEC * NT == BM * BK, "x tile must split evenly");
  // x tile stored k-major with one column of padding so the transposing
  // store spreads over the banks
  __shared__ float xs[BK][BM + 1];
  __shared__ float ws[BK][BN];

  const int tid = threadIdx.x;
  const int ty = tid / RX;
  const int tx = tid % RX;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  typename W::Raw wr[LW];
  float xr[LX][VEC];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int l = 0; l < LW; ++l) {
      const int v = tid + l * NT;
      const int r = v / (BN / WC) * WR, c = (v % (BN / WC)) * WC;
      w.fetch(k0 + r, n0 + c, K, N, vec_w, wr[l]);
    }
#pragma unroll
    for (int l = 0; l < LX; ++l) {
      const int v = tid + l * NT;
      const int r = v / (BK / VEC), c = (v % (BK / VEC)) * VEC;
      load_vec<T, VEC>(x, K, m0 + r, k0 + c, M, K, vec_x, xr[l]);
    }
  };
  auto store_tile = [&]() {
#pragma unroll
    for (int l = 0; l < LW; ++l) {
      const int v = tid + l * NT;
      const int r = v / (BN / WC) * WR, c = (v % (BN / WC)) * WC;
      float f[WR][WC];
      w.expand(wr[l], f);
#pragma unroll
      for (int rr = 0; rr < WR; ++rr)
#pragma unroll
        for (int e = 0; e < WC; ++e) ws[r + rr][c + e] = f[rr][e];
    }
#pragma unroll
    for (int l = 0; l < LX; ++l) {
      const int v = tid + l * NT;
      const int r = v / (BK / VEC), c = (v % (BK / VEC)) * VEC;
#pragma unroll
      for (int e = 0; e < VEC; ++e) xs[c + e][r] = xr[l][e];
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  load_tile(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    store_tile();
    __syncthreads();
    if (k0 + BK < K) load_tile(k0 + BK);  // in flight during the compute
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + i * RY];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx + j * RX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + i * RY;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * RX;
      if (gn < N) store_as(out + static_cast<size_t>(gm) * N + gn, acc[i][j]);
    }
  }
}

template <typename T, typename W, int BM, int BN, int BK, int TM, int TN>
void launch(const void* x, W w, void* out, int M, int N, int K,
            cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  // a vector load needs an aligned row start: aligned base, stride % VEC
  const bool vec_x = reinterpret_cast<uintptr_t>(x) % 16 == 0 && K % VEC == 0;
  const bool vec_w = w.aligned(N);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const dim3 block((BM / TM) * (BN / TN));
  mm_kernel<T, W, BM, BN, BK, TM, TN><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), w, static_cast<T*>(out), M, N, K, vec_x,
      vec_w);
}

// Small M (decode, short chunks): 16 x 32 output tiles with 128-deep K
// tiles, 256 threads, so a narrow N still spreads over N / 32 blocks.
// Larger M: 64 x 64 tiles, 32-deep K tiles, 256 threads. Both run the same
// per-element fmaf chain, so the choice never changes a result bit.
template <typename T, typename W>
int run(const void* x, W w, void* out, int M, int N, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 16)
    launch<T, W, 16, 32, 128, 2, 1>(x, w, out, M, N, K, s);
  else
    launch<T, W, 64, 64, 32, 4, 4>(x, w, out, M, N, K, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_dense(const void* x, const void* w, void* out, int M, int N, int K,
              void* stream) {
  return run<T>(x, DenseW<T>{static_cast<const T*>(w)}, out, M, N, K,
                stream);
}

template <typename T>
int run_int8(const void* x, const void* q, const void* s, void* out, int M,
             int N, int K, int g, void* stream) {
  return run<T>(x,
                Int8W{static_cast<const int8_t*>(q),
                      static_cast<const float*>(s), g},
                out, M, N, K, stream);
}

template <typename T>
int run_int4(const void* x, const void* p, const void* s, const void* z,
             void* out, int M, int N, int K, int g, void* stream) {
  return run<T>(x,
                Int4W{static_cast<const uint8_t*>(p),
                      static_cast<const uint16_t*>(s),
                      static_cast<const uint8_t*>(z), g},
                out, M, N, K, stream);
}

}  // namespace

extern "C" int k1_streamed_matmul_f32(const void* x, const void* w, void* out,
                                      int M, int N, int K, void* stream) {
  return run_dense<float>(x, w, out, M, N, K, stream);
}

extern "C" int k2_streamed_matmul_int8_f32(const void* x, const void* q,
                                           const void* s, void* out, int M,
                                           int N, int K, int g,
                                           void* stream) {
  return run_int8<float>(x, q, s, out, M, N, K, g, stream);
}

extern "C" int k3_streamed_matmul_int4_f32(const void* x, const void* p,
                                           const void* s, const void* z,
                                           void* out, int M, int N, int K,
                                           int g, void* stream) {
  return run_int4<float>(x, p, s, z, out, M, N, K, g, stream);
}
