// K4's backward — the gradients of flash attention, hand-written for Hopper
// (sm_90a).
//
// The TPU kernel it completes is repro/kernels/flash_attention.py::
// flash_attention (the Pallas kernel _flash_kernel), which has no backward:
// the JAX package differentiates its jnp twin attend_flash by autodiff.
// For the function K4 computes, o = softmax(q k^T * scale) v per head with
// scale = hd^-0.5, query head h reading kv head h / (H / KV) and, with
// causal, key j visible to query i when j <= i (both from 0, also when
// Tq != Tk), it takes q (B, H, Tq, hd), k and v (B, KV, Tk, hd), the
// output's gradient dO and the forward's f32 row logsumexp lse (B, H, Tq),
// and writes dq, dk and dv in the inputs' type (bf16 or f32). Every sum is
// f32; p is recomputed as exp(s * scale - lse); dp = dO v^T;
// D = rowsum(p dp); dv = p^T dO; ds = p (dp - D); dq = scale ds k;
// dk = scale ds^T q; a kv head's dk and dv sum its G query heads. D is the
// softmax's own row sum, so each row of ds sums to zero up to f32 rounding,
// as the plain attention's autograd gives it. FlashAttention-2's
// rowsum(dO o) equals it only for the exact o: from K4's bf16 output it is
// off by o's rounding, and that error enters every ds of the row with p's
// weight, which puts a bias along the row's mean key into dq (and the mean
// query into dk); measured on the H100, it left bf16 q and k grads of
// qwen2-0.5b several times further from the f32 gradient than the plain
// attention's. Ragged lengths are masked as in the forward: rows past Tq
// and keys past Tk weigh 0 and are never stored. Any hd <= 128 runs.
//
// Bound. Five products of 2 * hd operations per visible (query, key) pair
// (S, dP, dv, dk, dq: 2.5x the forward's two) against the bytes of q, k, v,
// dO, lse read once and dq, dk, dv written once: at qwen2-0.5b's
// (4, 14, 2, 4096, 64) causal about 0.30 TFLOP against 0.1 GB, so
// operations bound it (0.304 ms at the H100 SXM data sheet's 989 TFLOP/s
// of bf16 tensor cores). This first kernel sums in f32 on the CUDA cores
// (67 TFLOP/s on the data sheet), so it cannot come near that bound; what it
// gives is the gradient without the N^2 scores in device memory, which is
// what training at T > 2048 needs.
//
// Design (three passes, no atomics, so the bits do not depend on the launch;
// S and dP are recomputed in each, nine products where five would do):
//   - D: a block per (batch, head, 64 query rows) loops over the 64-key
//     tiles its rows can see, summing p dP per row in registers and then
//     across the 16 threads that share a row, into an f32 scratch
//     (B, H, Tq);
//   - dk / dv: a block per (batch, kv head, 64 keys) holds its k and v tiles
//     and loops over the group's query heads and the 64-row query tiles that
//     can see its keys, recomputing S, p, dP and ds per tile, with dk and dv
//     summed in registers and written once;
//   - dq: a block per (batch, head, 64 query rows) holds its q, dO, lse and D
//     and loops over the 64-key tiles its rows can see, with dq summed in
//     registers and written once;
//   - 256 threads as 16 x 16; every tile sits in shared memory as f32 rows
//     padded by 4 floats. In S = q k^T and dP = dO v^T thread (ty, tx) owns
//     rows ty + 16 r and keys tx + 16 c (r, c < 4) and reads 16-byte vectors
//     along the head dim; in the three sums over rows or keys it owns 4 rows
//     of the result and head dims 64 c + 4 tx .. + 3, reading one 16-byte
//     vector of the right operand per step. Left for a later change: tensor
//     cores (mma.sync / wgmma) and cp.async or TMA loads.
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (repro_torch/kernels/flash_attention.py). The entry points
// launch their three kernels on the stream they are given, do not
// synchronise, and return cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BT = 64;        // rows (queries or keys) per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int PAD = 4;        // keeps rows 16-byte aligned, ldmatrix-free
constexpr int TS = BT + PAD;  // row stride (floats) of the p and ds tiles

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

// element strides over (batch, head, position); the head dim is contiguous
struct Strides {
  long long b, h, t;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;  // (B, H, Tq), contiguous
  float* delta;      // (B, H, Tq), contiguous: rowsum(p dP)
  void* dq;
  void* dk;
  void* dv;
  int H, KV, G, Tq, Tk, hd, hd4, causal;
  float scale;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
};

template <typename T>
__device__ __forceinline__ const T* head_ptr(const void* base,
                                             const Strides& s, int b,
                                             int h) {
  return static_cast<const T*>(base) + b * s.b + h * s.h;
}

// rows [base, base + nrows) of src (row stride st) into a BT-row f32 tile of
// row stride HDP + PAD, zero past nrows and past hd
template <typename T, int HDP>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long st, int base, int nrows,
                                          int hd) {
  constexpr int RS = HDP + PAD;
  for (int idx = threadIdx.x; idx < BT * HDP; idx += THREADS) {
    const int r = idx / HDP, d = idx % HDP;
    dst[r * RS + d] =
        (r < nrows && d < hd) ? to_f32(src[(base + r) * st + d]) : 0.f;
  }
}

// acc[r][c] += sum_d A[ty + 16 r][d] * Bm[tx + 16 c][d] over the tiles'
// first hd4 head dims (zero past hd)
template <int HDP>
__device__ __forceinline__ void dot_rows(float (&acc)[4][4], const float* A,
                                         const float* Bm, int hd4, int ty,
                                         int tx) {
  constexpr int RS = HDP + PAD;
  for (int d = 0; d < hd4; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[r] = *reinterpret_cast<const float4*>(A + (ty + 16 * r) * RS + d);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      b[c] = *reinterpret_cast<const float4*>(Bm + (tx + 16 * c) * RS + d);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float s = acc[r][c];
        s = fmaf(a[r].x, b[c].x, s);
        s = fmaf(a[r].y, b[c].y, s);
        s = fmaf(a[r].z, b[c].z, s);
        s = fmaf(a[r].w, b[c].w, s);
        acc[r][c] = s;
      }
  }
}

// acc[r][c][e] += sum_n L(ty + 16 r, n) * X[n][64 c + 4 tx + e], where
// L(row, n) = Lm[row * lrow + n * lsum]: the thread's 4 result rows and
// head dims 64 c + 4 tx .. + 3
template <int NH>
__device__ __forceinline__ void sum_rows(float (&acc)[4][NH][4],
                                         const float* Lm, int lrow, int lsum,
                                         const float* X, int n_end, int ty,
                                         int tx) {
  constexpr int RS = NH * 64 + PAD;
  for (int n = 0; n < n_end; ++n) {
    float l[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) l[r] = Lm[(ty + 16 * r) * lrow + n * lsum];
#pragma unroll
    for (int c = 0; c < NH; ++c) {
      const float4 x =
          *reinterpret_cast<const float4*>(X + n * RS + c * 64 + tx * 4);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[r][c][0] = fmaf(l[r], x.x, acc[r][c][0]);
        acc[r][c][1] = fmaf(l[r], x.y, acc[r][c][1]);
        acc[r][c][2] = fmaf(l[r], x.z, acc[r][c][2]);
        acc[r][c][3] = fmaf(l[r], x.w, acc[r][c][3]);
      }
    }
  }
}

// p of query qi and key kj from its raw score: exp(s scale - lse), 0 where
// the key is masked or either index is past its length
__device__ __forceinline__ float p_at(const Params& p, float s, float lse,
                                      int qi, int kj) {
  const bool seen = qi < p.Tq && kj < p.Tk && (!p.causal || kj <= qi);
  return seen ? expf(s * p.scale - lse) : 0.f;
}

// p and ds of one (query tile, key tile) pair, into the P and dS tiles (row
// = query, column = key; P may be null when only ds is needed). s holds
// q k^T, dp holds dO v^T; lse_s and d_s the tile's rows' lse and D.
__device__ __forceinline__ void p_and_ds(const Params& p, float (&s)[4][4],
                                         const float (&dp)[4][4],
                                         const float* lse_s, const float* d_s,
                                         int q0, int k0, float* P, float* dS,
                                         int ty, int tx) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty + 16 * r, qi = q0 + i;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = tx + 16 * c;
      const float pv = p_at(p, s[r][c], lse_s[i], qi, k0 + j);
      if (P != nullptr) P[i * TS + j] = pv;
      dS[i * TS + j] = pv * (dp[r][c] - d_s[i]);
    }
  }
}

template <int NH>
constexpr size_t smem_dkdv() {
  return sizeof(float) *
         (4 * BT * (NH * 64 + PAD) + 2 * BT * TS + 2 * BT);
}
template <int NH>
constexpr size_t smem_dq() {
  return sizeof(float) * (4 * BT * (NH * 64 + PAD) + BT * TS + 2 * BT);
}

// dk and dv of 64 keys of one (batch, kv head)
template <typename T, int NH>
__global__ void __launch_bounds__(THREADS) dkdv_kernel(Params p) {
  constexpr int HDP = NH * 64, RS = HDP + PAD;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // [BT][RS]
  float* v_s = k_s + BT * RS;
  float* q_s = v_s + BT * RS;
  float* do_s = q_s + BT * RS;
  float* P = do_s + BT * RS;  // [BT][TS]
  float* dS = P + BT * TS;
  float* lse_s = dS + BT * TS;  // [BT]
  float* d_s = lse_s + BT;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int b = blockIdx.y / p.KV, hk = blockIdx.y % p.KV;
  const int k0 = blockIdx.x * BT, nk = min(BT, p.Tk - k0);
  load_rows<T, HDP>(k_s, head_ptr<T>(p.k, p.sk, b, hk), p.sk.t, k0, nk,
                    p.hd);
  load_rows<T, HDP>(v_s, head_ptr<T>(p.v, p.sv, b, hk), p.sv.t, k0, nk,
                    p.hd);

  float dk[4][NH][4], dv[4][NH][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NH; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[r][c][e] = dv[r][c][e] = 0.f;

  // causal: rows before k0 see none of these keys
  const int q_first = p.causal ? (k0 / BT) * BT : 0;
  for (int g = 0; g < p.G; ++g) {
    const int h = hk * p.G + g;
    const T* q = head_ptr<T>(p.q, p.sq, b, h);
    const T* dO = head_ptr<T>(p.dout, p.sdo, b, h);
    const size_t rows = static_cast<size_t>(b * p.H + h) * p.Tq;
    for (int q0 = q_first; q0 < p.Tq; q0 += BT) {
      const int nq = min(BT, p.Tq - q0);
      __syncthreads();  // the previous tile's readers are done
      load_rows<T, HDP>(q_s, q, p.sq.t, q0, nq, p.hd);
      load_rows<T, HDP>(do_s, dO, p.sdo.t, q0, nq, p.hd);
      if (tid < BT) {
        lse_s[tid] = tid < nq ? p.lse[rows + q0 + tid] : 0.f;
        d_s[tid] = tid < nq ? p.delta[rows + q0 + tid] : 0.f;
      }
      __syncthreads();
      float s[4][4] = {}, dp[4][4] = {};
      dot_rows<HDP>(s, q_s, k_s, p.hd4, ty, tx);
      dot_rows<HDP>(dp, do_s, v_s, p.hd4, ty, tx);
      p_and_ds(p, s, dp, lse_s, d_s, q0, k0, P, dS, ty, tx);
      __syncthreads();
      // dv[j] += sum_i P[i][j] dO[i]; dk[j] += sum_i dS[i][j] q[i]
      sum_rows<NH>(dv, P, 1, TS, do_s, nq, ty, tx);
      sum_rows<NH>(dk, dS, 1, TS, q_s, nq, ty, tx);
    }
  }

  T* dkp = static_cast<T*>(p.dk) + b * p.sdk.b + hk * p.sdk.h;
  T* dvp = static_cast<T*>(p.dv) + b * p.sdv.b + hk * p.sdv.h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = ty + 16 * r;
    if (j >= nk) continue;
#pragma unroll
    for (int c = 0; c < NH; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = c * 64 + tx * 4 + e;
        if (d < p.hd) {
          store_as(dkp + (k0 + j) * p.sdk.t + d, dk[r][c][e] * p.scale);
          store_as(dvp + (k0 + j) * p.sdv.t + d, dv[r][c][e]);
        }
      }
  }
}

// One block per 64 query rows of one (batch, head), looping over the key
// tiles its rows can see. DQ = false: the first pass, D = rowsum(p dP) of
// each row (summed in registers, then across the 16 threads that share a
// row); DQ = true: the last pass, dq = scale sum_j ds k.
template <typename T, int NH, bool DQ>
__global__ void __launch_bounds__(THREADS) rows_kernel(Params p) {
  constexpr int HDP = NH * 64, RS = HDP + PAD;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [BT][RS]
  float* do_s = q_s + BT * RS;
  float* k_s = do_s + BT * RS;
  float* v_s = k_s + BT * RS;
  float* dS = v_s + BT * RS;  // [BT][TS]
  float* lse_s = dS + BT * TS;
  float* d_s = lse_s + BT;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H, hk = h / p.G;
  const int q0 = blockIdx.x * BT, nq = min(BT, p.Tq - q0);
  load_rows<T, HDP>(q_s, head_ptr<T>(p.q, p.sq, b, h), p.sq.t, q0, nq, p.hd);
  load_rows<T, HDP>(do_s, head_ptr<T>(p.dout, p.sdo, b, h), p.sdo.t, q0, nq,
                    p.hd);
  const size_t rows = static_cast<size_t>(bh) * p.Tq;
  if (tid < BT) {
    lse_s[tid] = tid < nq ? p.lse[rows + q0 + tid] : 0.f;
    d_s[tid] = DQ && tid < nq ? p.delta[rows + q0 + tid] : 0.f;
  }
  const T* k = head_ptr<T>(p.k, p.sk, b, hk);
  const T* v = head_ptr<T>(p.v, p.sv, b, hk);

  float dq[4][NH][4], dsum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NH; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[r][c][e] = 0.f;

  // causal: no key past the tile's last row is visible to any of its rows
  const int kend = p.causal ? min(p.Tk, q0 + nq) : p.Tk;
  for (int k0 = 0; k0 < kend; k0 += BT) {
    const int nk = min(BT, p.Tk - k0);
    __syncthreads();  // the previous tile's readers are done
    load_rows<T, HDP>(k_s, k, p.sk.t, k0, nk, p.hd);
    load_rows<T, HDP>(v_s, v, p.sv.t, k0, nk, p.hd);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    dot_rows<HDP>(s, q_s, k_s, p.hd4, ty, tx);
    dot_rows<HDP>(dp, do_s, v_s, p.hd4, ty, tx);
    if (!DQ) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          dsum[r] = fmaf(p_at(p, s[r][c], lse_s[ty + 16 * r],
                              q0 + ty + 16 * r, k0 + tx + 16 * c),
                         dp[r][c], dsum[r]);
      continue;
    }
    p_and_ds(p, s, dp, lse_s, d_s, q0, k0, nullptr, dS, ty, tx);
    __syncthreads();
    // dq[i] += sum_j dS[i][j] k[j]
    sum_rows<NH>(dq, dS, TS, 1, k_s, nk, ty, tx);
  }

  if (!DQ) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], off);
      const int i = ty + 16 * r;
      if (tx == 0 && i < nq) p.delta[rows + q0 + i] = dsum[r];
    }
    return;
  }
  T* dqp = static_cast<T*>(p.dq) + b * p.sdq.b + h * p.sdq.h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty + 16 * r;
    if (i >= nq) continue;
#pragma unroll
    for (int c = 0; c < NH; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = c * 64 + tx * 4 + e;
        if (d < p.hd)
          store_as(dqp + (q0 + i) * p.sdq.t + d, dq[r][c][e] * p.scale);
      }
  }
}

template <typename T, int NH>
cudaError_t launch(const Params& p, int B, cudaStream_t s) {
  // above 48 KB of dynamic shared memory only after this opt-in
  constexpr size_t sm_kv = smem_dkdv<NH>(), sm_q = smem_dq<NH>();
  cudaError_t e = cudaFuncSetAttribute(
      dkdv_kernel<T, NH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sm_kv));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(rows_kernel<T, NH, false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sm_q));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(rows_kernel<T, NH, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sm_q));
  if (e != cudaSuccess) return e;
  const dim3 row_grid((p.Tq + BT - 1) / BT, B * p.H);
  rows_kernel<T, NH, false><<<row_grid, THREADS, sm_q, s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dkdv_kernel<T, NH><<<dim3((p.Tk + BT - 1) / BT, B * p.KV), THREADS, sm_kv,
                       s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  rows_kernel<T, NH, true><<<row_grid, THREADS, sm_q, s>>>(p);
  return cudaGetLastError();
}

Strides strides_at(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

template <typename T>
int run(const void* q, const void* k, const void* v, const void* dout,
        const float* lse, float* delta, void* dq, void* dk, void* dv, int B,
        int H, int KV, int Tq, int Tk, int hd, const long long* strides,
        int causal, float scale, void* stream) {
  if (hd < 1 || hd > 128 || KV < 1 || H % KV != 0 || B < 1 || Tq < 1 ||
      Tk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.H = H;
  p.KV = KV;
  p.G = H / KV;
  p.Tq = Tq;
  p.Tk = Tk;
  p.hd = hd;
  p.hd4 = (hd + 3) & ~3;
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
  const cudaError_t e =
      hd <= 64 ? launch<T, 1>(p, B, s) : launch<T, 2>(p, B, s);
  return static_cast<int>(e);
}

}  // namespace

// strides: (batch, head, position) element strides of q, k, v, dO, dq, dk,
// dv, in that order (21 values); lse and delta are contiguous
// (B, H, Tq) f32, delta scratch written here.
extern "C" int k4_flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int H, int KV, int Tq, int Tk, int hd,
    const long long* strides, int causal, float scale, void* stream) {
  return run<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, dk, dv, B, H,
                            KV, Tq, Tk, hd, strides, causal, scale, stream);
}

extern "C" int k4_flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int H, int KV, int Tq, int Tk, int hd,
    const long long* strides, int causal, float scale, void* stream) {
  return run<float>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, KV, Tq,
                    Tk, hd, strides, causal, scale, stream);
}
