// K4 — flash attention, hand-written for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention.py::flash_attention (the Pallas
// kernel _flash_kernel). For q (B, H, Tq, hd) and k, v (B, KV, Tk, hd),
// H % KV == 0, it computes softmax(q k^T * hd^-0.5) v per head with the
// online softmax, as _flash_kernel does: q, k and v upcast to f32, f32
// scores, a running max m, a running sum l and an f32 accumulator per query
// row, alpha = exp(m_prev - m_new), p = s > NEG_INF/2 ? exp(s - m_new) : 0,
// the f32 sum of p v, and acc / max(l, 1e-30) stored in q's type (bf16 or
// f32). Query head h reads kv head h / (H / KV), so repeated kv heads are
// never materialised. With causal, key j is visible to query i when j <= i,
// both counted from 0 (also when Tq != Tk, as the Pallas kernel counts), and
// a kv tile that lies wholly above the block's last row is skipped: a tile
// whose keys are all masked for a row leaves that row's m, l and acc as
// they were, bit for bit, so the skip changes no result.
//
// The Pallas kernel carried m, l and acc in VMEM scratch across a
// sequential kv grid axis. Here one block owns BQ = 64 query rows of one
// (batch, head), keeps m, l and acc in registers and walks the kv axis in a
// loop; there is no split of the kv axis across blocks. The query axis
// is cut into tiles of BQ rows whatever the reference's Q-chunk: a row's
// arithmetic depends only on the kv tiling, never on the block that holds
// it, so the Q-chunk (block_q in the wrapper, checked there) could change
// no result, and it does not reach the kernel. block_k, the reference's
// KV-chunk, cuts the kv axis into chunks of block_k keys, each walked in
// tiles of BK = 64 keys (the last one ragged); it moves the tile edges and
// so the rounding of the online softmax. Results are bit-equal across B
// and H. Ragged tails are masked: rows past Tq are not stored, keys past
// Tk score NEG_INF and weigh 0, and zero-filled tiles keep 0 * garbage out
// of the sums. Any hd <= 128 runs. Given an lse pointer (training: K4's
// backward, flash_attention_bwd.cu, recomputes p from it), each stored row
// also writes its f32 logsumexp m + log(l) of the scaled scores into lse
// (B, H, Tq); given none, nothing else changes.
//
// Bound. The work is 4 * B * H * Tq * Tk * hd operations (halved for
// causal) against the bytes of q, k, v and o: at the vision encoder's
// (1, 16, 16, 4641, 80) about 110 GFLOP against 48 MB, so operations bound
// it (0.1115 ms at the H100 SXM data sheet's 989 TFLOP/s of bf16 tensor
// cores), and likewise the language model's (1, 28, 4, 4096, 128) causal.
// This first kernel sums in f32 on the CUDA cores (67 TFLOP/s on the data
// sheet), as the Pallas kernel sums in f32, so it cannot come near that
// bound; it keeps the N^2 scores out of device memory, which is what the
// VLM path needs from it.
//
// Design, simple and right first: 256 threads as 16 x 16; thread (ty, tx)
// owns query rows 4ty..4ty+3 of the block, keys 4tx..4tx+3 of the tile for
// the scores and head dims 64h + 4tx..64h + 4tx+3 of the output. The q tile
// (transposed), the k tile (transposed), the v tile and the tile's p
// (transposed) sit in shared memory as f32, so both products read one
// 16-byte vector per operand and step. A row's max and sum over the tile
// are butterfly shuffles across the 16 threads of its half-warp, which
// leave every lane with the same bits. Left for a later change: tensor
// cores (mma.sync / wgmma), TMA loads into a multi-stage ring, one q tile
// shared by a GQA group, and bank-conflict-free transposed stores.
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (repro_torch/kernels/flash_attention.py). The entry points
// launch on the stream they are given, do not synchronise, and return
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per kv tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int PAD = 4;        // keeps rows 16-byte aligned
constexpr int QS = BQ + PAD;  // row stride (floats) of the q and p tiles
constexpr int KS = BK + PAD;  // row stride of the transposed k tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

// Element strides of q, k, v and o over (batch, head, position); the head
// dimension is contiguous.
struct Strides {
  long long qb, qh, qt, kb, kh, kt, vb, vh, vt, ob, oh, ot;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, H, Tq) row logsumexp, or null
  int H, G, Tq, Tk, hd, causal, block_k;
  float scale;
  Strides st;
};

template <int NH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (NH * 64 * QS + NH * 64 * KS +
                          BK * (NH * 64 + PAD) + BK * QS);
}

// NH = head-dim chunks of 64 (hd <= 64 or hd <= 128).
template <typename T, int NH>
__global__ void __launch_bounds__(THREADS) flash_kernel(Params p) {
  constexpr int HDP = NH * 64;
  constexpr int VS = HDP + PAD;
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);  // [HDP][QS]
  float* kT = qT + HDP * QS;                    // [HDP][KS]
  float* vt = kT + HDP * KS;                    // [BK][VS]
  float* pT = vt + BK * VS;                     // [BK][QS]

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H, hk = h / p.G;
  const int row0 = blockIdx.x * BQ;
  const int row_end = min(row0 + BQ, p.Tq);
  const int nrows = row_end - row0, hd = p.hd;

  const T* q = static_cast<const T*>(p.q) + b * p.st.qb + h * p.st.qh;
  const T* k = static_cast<const T*>(p.k) + b * p.st.kb + hk * p.st.kh;
  const T* v = static_cast<const T*>(p.v) + b * p.st.vb + hk * p.st.vh;
  T* o = static_cast<T*>(p.o) + b * p.st.ob + h * p.st.oh;

  for (int idx = tid; idx < BQ * HDP; idx += THREADS) {
    const int r = idx / HDP, d = idx % HDP;
    qT[d * QS + r] =
        (r < nrows && d < hd) ? to_f32(q[(row0 + r) * p.st.qt + d]) : 0.f;
  }

  float m[4], l[4], acc[4][NH][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NH; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  // causal: no key past the block's last row is visible to any of its rows
  const int kend = p.causal ? min(p.Tk, row_end) : p.Tk;
  for (int c0 = 0; c0 < kend; c0 += p.block_k) {
    const int cend = min(c0 + p.block_k, p.Tk);
    for (int t0 = c0; t0 < cend && t0 < kend; t0 += BK) {
      const int n = min(BK, cend - t0);  // keys in this tile
      __syncthreads();  // the previous tile's readers are done
      for (int idx = tid; idx < BK * HDP; idx += THREADS) {
        const int j = idx / HDP, d = idx % HDP;
        const bool in = j < n && d < hd;
        kT[d * KS + j] = in ? to_f32(k[(t0 + j) * p.st.kt + d]) : 0.f;
        vt[j * VS + d] = in ? to_f32(v[(t0 + j) * p.st.vt + d]) : 0.f;
      }
      __syncthreads();

      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < hd; ++d) {
        const float4 a4 = *reinterpret_cast<const float4*>(qT + d * QS + ty * 4);
        const float4 b4 = *reinterpret_cast<const float4*>(kT + d * KS + tx * 4);
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
        const float bk[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qpos = row0 + ty * 4 + i;
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kj = tx * 4 + j;
          float sv = s[i][j] * p.scale;
          if (kj >= n || (p.causal && t0 + kj > qpos)) sv = NEG_INF;
          s[i][j] = sv;
          mx = fmaxf(mx, sv);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[i], mx);
        const float alpha = expf(m[i] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = s[i][j] > NEG_INF / 2 ? expf(s[i][j] - m_new) : 0.f;
          rs += s[i][j];
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          rs += __shfl_xor_sync(0xffffffffu, rs, off);
        l[i] = l[i] * alpha + rs;
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < NH; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float4*>(pT + (tx * 4 + j) * QS + ty * 4) =
            make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      __syncthreads();

      for (int j = 0; j < n; ++j) {
        const float4 a4 = *reinterpret_cast<const float4*>(pT + j * QS + ty * 4);
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int c = 0; c < NH; ++c) {
          const float4 v4 =
              *reinterpret_cast<const float4*>(vt + j * VS + c * 64 + tx * 4);
          const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][c][e] = fmaf(a[i], vv[e], acc[i][c][e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= nrows) continue;
    const float lv = fmaxf(l[i], 1e-30f);
    if (p.lse != nullptr && tx == 0)
      p.lse[static_cast<size_t>(bh) * p.Tq + row0 + r] = m[i] + logf(l[i]);
#pragma unroll
    for (int c = 0; c < NH; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = c * 64 + tx * 4 + e;
        if (d < hd) store_as(o + (row0 + r) * p.st.ot + d, acc[i][c][e] / lv);
      }
  }
}

template <typename T, int NH>
cudaError_t launch(const Params& p, int BH, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<NH>();
  // above 48 KB of dynamic shared memory only after this opt-in
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<T, NH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((p.Tq + BQ - 1) / BQ, BH);
  flash_kernel<T, NH><<<grid, THREADS, smem, s>>>(p);
  return cudaGetLastError();
}

template <typename T>
int run(const void* q, const void* k, const void* v, void* o, float* lse,
        int B, int H, int KV, int Tq, int Tk, int hd,
        const long long* strides, int causal, int block_k, float scale,
        void* stream) {
  if (hd < 1 || hd > 128 || KV < 1 || H % KV != 0 || Tq < 1 || Tk < 1 ||
      block_k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
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
  const cudaError_t e = hd <= 64 ? launch<T, 1>(p, B * H, s)
                                 : launch<T, 2>(p, B * H, s);
  return static_cast<int>(e);
}

}  // namespace

extern "C" int k4_flash_attention_bf16(const void* q, const void* k,
                                       const void* v, void* o, float* lse,
                                       int B, int H, int KV, int Tq, int Tk,
                                       int hd,
                                       const long long* strides, int causal,
                                       int block_k, float scale,
                                       void* stream) {
  return run<__nv_bfloat16>(q, k, v, o, lse, B, H, KV, Tq, Tk, hd, strides,
                            causal, block_k, scale, stream);
}

extern "C" int k4_flash_attention_f32(const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      int B, int H, int KV, int Tq, int Tk,
                                      int hd,
                                      const long long* strides, int causal,
                                      int block_k, float scale,
                                      void* stream) {
  return run<float>(q, k, v, o, lse, B, H, KV, Tq, Tk, hd, strides, causal,
                    block_k, scale, stream);
}
