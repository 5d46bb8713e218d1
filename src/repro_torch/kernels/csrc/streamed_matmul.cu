// K1 — streamed_matmul, hand-written for Hopper (sm_90a).
//
// Replaces repro/kernels/streamed_matmul.py::_mm_kernel, the Pallas TPU
// kernel behind repro's streamed_matmul. Same function: out = x @ w for
// x (M, K) and w (K, N), both upcast to f32, summed over K in f32, cast to
// the input type (bf16 or f32) on the way out. It is not carried over block
// by block: the TPU kernel carried its sum across a sequential grid axis in
// VMEM scratch; here each thread keeps its sums in registers and walks K in
// a loop inside the block.
//
// Bound. The port calls it for the dense FFN's w_gate, w_up and w_down. At
// decode M is the batch (1..4) and the kernel is bound by the bytes of w:
// one (896, 4864) bf16 matrix of qwen2-0.5b is 8,716,288 B, about 2.6 us at
// the H100 SXM data sheet's 3.35 TB/s. Large prefill chunks lean toward the
// operations bound.
//
// Design, simple and right first:
//   - shared-memory tiles of x (BM x BK) and w (BK x BN), converted to f32
//     as they are stored; each thread owns a TM x TN block of outputs in
//     registers and accumulates with fmaf;
//   - the next K tile is loaded into registers (16-byte vector loads where
//     the row stride and the pointer allow, else element by element) while
//     the current one is computed, so one load latency per tile is hidden;
//   - ragged edges are masked in M, N and K: loads past an edge read 0, and
//     a padded K step adds fmaf(0, 0, acc) == acc exactly; stores past an
//     edge are skipped;
//   - row results do not depend on M: every output element is one thread's
//     fmaf chain over k = 0, 1, ..., K-1 in that order, whatever M, the grid,
//     the tile configuration or the block that holds the row. There is no
//     split-K. So kernel(x)[rows] == kernel(x[rows]) bit for bit.
// Left for a later change: tensor cores (mma.sync / wgmma), TMA loads into a
// multi-stage ring, and more bytes in flight at decode: without split-K,
// N / BN blocks is all the parallelism a small M gives, so the (M, 4864) @
// (4864, 896) down-projection runs on 28 blocks.
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (repro_torch/kernels/streamed_matmul.py). Each entry point
// launches on the stream it is given, does not synchronise, and returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

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

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    mm_kernel(const T* __restrict__ x, const T* __restrict__ w,
              T* __restrict__ out, int M, int N, int K, bool vec_x,
              bool vec_w) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int RY = BM / TM;          // thread rows
  constexpr int RX = BN / TN;          // thread columns
  constexpr int NT = RY * RX;
  constexpr int LW = BK * BN / VEC / NT;  // w vectors per thread per tile
  constexpr int LX = BM * BK / VEC / NT;  // x vectors per thread per tile
  static_assert(LW * VEC * NT == BK * BN, "w tile must split evenly");
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

  float wr[LW][VEC], xr[LX][VEC];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int l = 0; l < LW; ++l) {
      const int v = tid + l * NT;
      const int r = v / (BN / VEC), c = (v % (BN / VEC)) * VEC;
      load_vec<T, VEC>(w, N, k0 + r, n0 + c, K, N, vec_w, wr[l]);
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
      const int r = v / (BN / VEC), c = (v % (BN / VEC)) * VEC;
#pragma unroll
      for (int e = 0; e < VEC; ++e) ws[r][c + e] = wr[l][e];
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

template <typename T, int BM, int BN, int BK, int TM, int TN>
void launch(const void* x, const void* w, void* out, int M, int N, int K,
            cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  // a 16-byte load needs an aligned row start: aligned base, stride % VEC
  const bool vec_x = reinterpret_cast<uintptr_t>(x) % 16 == 0 && K % VEC == 0;
  const bool vec_w = reinterpret_cast<uintptr_t>(w) % 16 == 0 && N % VEC == 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const dim3 block((BM / TM) * (BN / TN));
  mm_kernel<T, BM, BN, BK, TM, TN><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      M, N, K, vec_x, vec_w);
}

// Small M (decode, short chunks): 16 x 32 output tiles with 128-deep K
// tiles, 256 threads, so a narrow N still spreads over N / 32 blocks.
// Larger M: 64 x 64 tiles, 32-deep K tiles, 256 threads. Both run the same
// per-element fmaf chain, so the choice never changes a result bit.
template <typename T>
int run(const void* x, const void* w, void* out, int M, int N, int K,
        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 16)
    launch<T, 16, 32, 128, 2, 1>(x, w, out, M, N, K, s);
  else
    launch<T, 64, 64, 32, 4, 4>(x, w, out, M, N, K, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int k1_streamed_matmul_bf16(const void* x, const void* w,
                                       void* out, int M, int N, int K,
                                       void* stream) {
  return run<__nv_bfloat16>(x, w, out, M, N, K, stream);
}

extern "C" int k1_streamed_matmul_f32(const void* x, const void* w, void* out,
                                      int M, int N, int K, void* stream) {
  return run<float>(x, w, out, M, N, K, stream);
}
