// K1, K2 and K3 in bf16 — the streamed matmuls on the tensor cores, hand-
// written for Hopper (sm_90a). One kernel, three weight formats (the
// template parameter W):
//   K1 streamed_matmul       replaces repro/kernels/streamed_matmul.py::
//                            streamed_matmul (_mm_kernel): w (K, N) bf16;
//   K2 streamed_matmul_int8  replaces ::streamed_matmul_int8
//                            (_mm_quant_kernel): int8 codes q (K, N), f32
//                            scales s (G, 1, N), w = q * s[k / g];
//   K3 streamed_matmul_int4  replaces ::streamed_matmul_int4
//                            (_mm_int4_kernel): packed (K/2, N) uint8 (low
//                            nibble = even K row), fp16 scales s and uint8
//                            zero-points z, both (G, N), w = (q - z) * s.
// All for bf16 x (M, K), row-major: out = x @ w with f32 sums, rounded to
// bf16. f32 x of every format runs the f32 tile kernel of
// streamed_matmul.cu: the tensor cores have no f32 product that keeps
// f32's rounding. The wrapper picks by dtype alone (kernel_variant).
//
// K2 / K3 stay exact on bf16 operands by scaling per group on the
// accumulator instead of in the tile. The codes q (in [-127, 127]) and
// q - z (in [-15, 15]) are integers that bf16 holds exactly, and a bf16 x
// times such an integer (8 + 7 significant bits) is exact in f32. So
//   out[m, n] = sum_g s[g, n] * (sum_{k in g} x[m, k] * (q[k, n] - z[g, n]))
// runs the inner sums on mma.sync with exact products and f32 sums, and
// rounds only where K1 does (the f32 sums and the bf16 output) plus one
// f32 product and add per group. The group of row k is k / g with
// g = ceil(K / G), so ragged and odd groups and any g >= 1 run.
//
// Bound. The port calls them for the dense FFN's w_gate, w_up and w_down.
// At decode M is the batch (1..4) and the weight's bytes bound it: qwen2-
// 0.5b's (896, 4864) is 8.7 MB in bf16, about 2.6 us at the H100 SXM data
// sheet's 3.35 TB/s; int8 codes and scales 4.5 MB (1.4 us), packed int4
// with scales and zeros 2.3 MB (0.7 us). A prefill chunk of 256 rows is
// still bytes-bound (256 x 896 x 4864 x 2 = 2.2 GFLOP, 2.3 us at 989
// TFLOP/s of bf16 tensor cores). So the kernel has to keep many weight
// bytes in flight on every SM, which the output tiles alone cannot do
// when N is narrow: (M, 4864) @ (4864, 896) has 14 column tiles of 64 for
// 132 SMs.
//
// Design:
//   - one instruction for every M: mma.sync.m16n8k16 (bf16 operands, f32
//     sums). Block tiles of BM x 64 outputs: BM = 16 with four warps of
//     16 x 16 (M <= 16), else BM = 64 with eight warps of 32 x 16 (K1) or
//     four of 64 x 16 (K2 / K3, which convert each code once a block);
//     rows past M are zero-filled in shared memory and not stored;
//   - tiles in shared memory, rows padded by 16 bytes so ldmatrix is free
//     of bank conflicts: x (BM x TK bf16) read by ldmatrix; K1's w (64 x 64
//     bf16, row-major (K, N)) by ldmatrix.trans as the col-major B operand.
//     k-tiles of TK = 64 rows, but 128 for K2 / K3 at BM = 16: their tiles
//     carry fewer bytes a row, and every k-tile costs about a microsecond
//     a block, so at decode the quantised formats take twice the rows a
//     tile (at BM = 64 the 128-row x tile would cost occupancy). x rows past
//     M are zeroed once and never copied;
//   - a ring filled by 16-byte cp.async copies, zero-filled past every
//     edge (src-size 0); where a row stride or pointer is not 16-byte
//     aligned the loader falls back to element loads, so any (M, K, N)
//     runs. K1's stage (4 of them) is the bf16 w tile. K2's and K3's stage
//     (4 and 6 at BM = 16, 4 at BM = 64: as many as fit at g = 1) is the
//     raw codes (TK x 64 int8; TK / 2 x 64 packed bytes) and the scales
//     (and zero-points) of every group the k-tile touches, one row of 64 a
//     group;
//   - K2 / K3 read the raw codes by ldmatrix.trans straight into registers
//     and convert them there into exact bf16 B fragments with full-rate
//     integer and float operations, no conversion instruction: int8 as
//     2^23 + (q + 128) in f32 less 2^23 + 128, int4 as 128 + q in bf16 less
//     128 + z (bf16x2). No scale is applied there, so the fragment is
//     exact. They keep a group partial in f32 fragments beside the output
//     fragments: a k16 step adds into the partial; where a group ends (or
//     the split does) the partial is scaled by its group's f32 scale and
//     added into the output, __fmul_rn then __fadd_rn, never contracted,
//     and cleared. A k-tile inside one group runs its steps unmasked; a
//     k16 step that a group boundary cuts (g not a multiple of 16) runs
//     once per group it touches, each run with the B rows of the other
//     groups masked to zero in the fragment;
//   - a fixed split-K: grid.z = S splits of k_split rows each (a multiple of
//     64 rows, the last one ragged; a 128-row k-tile may end short at a
//     split's end), chosen by the wrapper from
//     (K, N) alone (streamed_matmul.py::split_plan), never from M. With
//     S > 1 each split writes its f32 partial tile (K2 / K3: already
//     scaled; a group cut by a split boundary gives one scaled partial per
//     split) into a workspace (S, M, N); the last block of an output tile
//     to arrive (a per-tile counter, which that block resets to 0 for the
//     next launch) sums the S partials in split order 0, 1, ..., S-1 and
//     stores bf16. One launch per call.
// Row independence: every output element is the same sequence of k16 steps
// (and group flushes) over the same split ranges, each from a zero sum,
// summed in the same order, whatever M, the grid or the tile rows (BM = 16
// and BM = 64 differ only in how many rows a block holds). So
// kernel(x)[rows] == kernel(x[rows]) bit for bit, and the wrapper may cut
// M into slices of at most 256 rows, which bounds the workspace.
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (repro_torch/kernels/streamed_matmul.py). The entry points
// launch on the stream they are given, do not synchronise, and return
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BN = 64;        // output columns per block
constexpr int BK = 64;        // K1's k-tile; every split is a multiple
constexpr int WS = BN + 8;    // row stride (elements) of K1's w tile
constexpr int RS = BN + 16;   // row stride (bytes) of a raw code tile

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

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
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

// Rows r0 .. r0 + nrows - 1 (those at or past rlim read as 0) and columns
// n0 .. n0 + 63 of a row-major (rows, N) array of T into dst, DS bytes a
// row: 16-byte cp.async copies where vec, else element loads.
template <typename T, int THREADS, int DS>
__device__ __forceinline__ void load_rows(unsigned char* dst, const T* src,
                                          int r0, int nrows, int rlim, int n0,
                                          int N, bool vec, int tid) {
  constexpr int PER = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int CH = BN / PER;         // copies per row
  for (int c = tid; c < nrows * CH; c += THREADS) {
    const int r = c / CH, nc = (c % CH) * PER;
    const int gr = r0 + r, gn = n0 + nc;
    T* d = reinterpret_cast<T*>(dst + r * DS) + nc;
    if (vec) {
      const int n = (gr < rlim && gn < N) ? min(PER, N - gn) : 0;
      cp_async16(d, n ? src + static_cast<size_t>(gr) * N + gn : src,
                 n * static_cast<int>(sizeof(T)));
    } else {
#pragma unroll
      for (int e = 0; e < PER; ++e)
        d[e] = (gr < rlim && gn + e < N)
                   ? src[static_cast<size_t>(gr) * N + gn + e]
                   : T(0);
    }
  }
}

// n / d for 0 <= n < 2^32 by a multiply and two shifts (Granlund and
// Montgomery, "Division by invariant integers using multiplication",
// 1994, fig. 4.1): the group of a row, without a division instruction.
struct Div {
  uint32_t m;
  int s1, s2;
  __device__ __forceinline__ int operator()(int n) const {
    const uint32_t u = static_cast<uint32_t>(n), t = __umulhi(m, u);
    return static_cast<int>((t + ((u - t) >> s1)) >> s2);
  }
};
Div make_div(int d) {  // d >= 1
  int l = 0;
  while ((1ull << l) < static_cast<unsigned long long>(d)) ++l;
  const unsigned long long m =
      (1ull << 32) * ((1ull << l) - static_cast<unsigned long long>(d)) / d +
      1;
  return {static_cast<uint32_t>(m), l < 1 ? l : 1, l > 1 ? l - 1 : 0};
}

// A weight format, with its k-tile height TK. load() fills one ring
// stage for the k-tile at k0 (rows past kend zero). The quantised formats
// also give the mma operands: raw() reads a warp's 16 columns of landed
// codes into registers by ldmatrix.trans, RAW_STEPS k16 steps at a time,
// b_frags() turns one step of them into exact bf16 B fragments, a_frags()
// reads the matching x fragments, and scale4() / zpair() read a group's
// scales and zero-points from the stage (slot = group - k0 / g).
//
// Their B operand: ldmatrix.trans over the raw bytes, taken two by two as
// 16-bit elements, gives a thread two adjacent columns, 2 gid and
// 2 gid + 1, of the warp's 16; the even columns form one n8 tile and the
// odd ones another. So the thread's outputs are the four adjacent columns
// 4 tig .. 4 tig + 3: (even c0, odd c0, even c1, odd c1) for row gid,
// (c2, c3) likewise for row gid + 8.

// K1: bf16 weights; the stage is the w tile the mma reads.
struct DenseB {
  static constexpr bool kQuant = false;
  static constexpr int TK = BK;
  static constexpr int kStages = 4;  // ring stages
  const bf16* w;
  int N;
  bool vec;

  __host__ __device__ static constexpr int stage_bytes_most() {
    return static_cast<int>(sizeof(bf16)) * TK * WS;
  }
  __host__ __device__ int stage_bytes() const { return stage_bytes_most(); }
  template <int THREADS>
  __device__ __forceinline__ void load(unsigned char* st, int tid, int k0,
                                       int kend, int n0) const {
    bf16* wd = reinterpret_cast<bf16*>(st);
    const bf16 zero = __float2bfloat16(0.f);
    for (int c = tid; c < TK * (BN / 8); c += THREADS) {
      const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
      const int gk = k0 + r, gn = n0 + nc;
      bf16* dst = wd + r * WS + nc;
      if (vec) {
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
  }
};

// x fragments of one k16 step as ldmatrix gives them (K1, K2); xsr: the x
// tile's row stride in elements
template <int MT>
__device__ __forceinline__ void x_frags(const bf16* xa, int xsr, int row0,
                                        int kk, int lane,
                                        uint32_t (&a)[MT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
    ldmatrix_x4(a[i], xa + (row0 + i * 16 + (lane & 15)) * xsr + kk +
                          (lane >> 4) * 8);
}

// The most groups a k-tile of tk rows can touch at g rows a group.
inline int groups_per_tile(int tk, int g) {
  const int n = (tk - 1) / g + 2;
  return n < tk ? n : tk;
}

// K2: int8 codes (K, N) with one f32 scale per (group, column), in
// k-tiles of TK rows. Stage: the TK x 64 codes (rows RS bytes apart), then
// gpt rows of 64 scales.
template <int TKv>
struct Int8B {
  static constexpr bool kQuant = true;
  static constexpr int TK = TKv;
  static constexpr int kStages = 4;     // all that fit at g = 1, TK = 128
  static constexpr int RAW_STEPS = 2;   // one ldmatrix.x4: 32 rows
  static constexpr int kCodeBytes = TK * RS;
  static constexpr int kGroupBytes = BN * 4;
  const int8_t* q;
  const float* s;  // (G, 1, N)
  int N, g;        // g: rows per group
  Div grp;         // k -> k / g
  int gpt;         // group rows a stage holds (the most a k-tile touches)
  bool vec;

  __host__ __device__ static constexpr int stage_bytes_most() {
    return kCodeBytes + TK * kGroupBytes;
  }
  __host__ __device__ int stage_bytes() const {
    return kCodeBytes + gpt * kGroupBytes;
  }
  template <int THREADS>
  __device__ __forceinline__ void load(unsigned char* st, int tid, int k0,
                                       int kend, int n0) const {
    load_rows<int8_t, THREADS, RS>(st, q, k0, TK, kend, n0, N, vec, tid);
    const int ga = grp(k0), gl = grp(min(k0 + TK, kend) - 1);
    load_rows<float, THREADS, kGroupBytes>(st + kCodeBytes, s, ga,
                                           gl - ga + 1, gl + 1, n0, N, vec,
                                           tid);
  }
  // the codes of k16 steps s0 and s0 + 1 (rows 16 s0 .. + 31)
  __device__ __forceinline__ void raw(const unsigned char* st, int col0,
                                      int lane, int s0,
                                      uint32_t (&r)[4]) const {
    ldmatrix_x4_trans(r, st + (16 * s0 + lane) * RS + col0);
  }
  template <int MT>
  __device__ __forceinline__ void a_frags(const bf16* xa, int xsr, int row0,
                                          int kk, int lane,
                                          uint32_t (&a)[MT][4]) const {
    x_frags<MT>(xa, xsr, row0, kk, lane, a);
  }
  // one register of codes, bytes (k, c0), (k, c1), (k + 1, c0), (k + 1, c1),
  // into bf16 pairs (k, k + 1) of c0 and of c1: each byte, biased to
  // unsigned, goes into the low mantissa of 2^23 and 2^23 + 128 comes off
  // (exact in f32), then the top halves are the exact bf16 values
  __device__ __forceinline__ static void conv(uint32_t r, uint32_t& c0,
                                              uint32_t& c1) {
    const uint32_t u = r ^ 0x80808080u;
    const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440));
    const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441));
    const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442));
    const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443));
    constexpr float kMagic = 8388736.f;  // 2^23 + 128
    c0 = __byte_perm(__float_as_uint(f0 - kMagic),
                     __float_as_uint(f2 - kMagic), 0x7632);
    c1 = __byte_perm(__float_as_uint(f1 - kMagic),
                     __float_as_uint(f3 - kMagic), 0x7632);
  }
  // B fragments of step u of the raw registers: b[0] the even columns' n8
  // tile, b[1] the odd
  __device__ __forceinline__ void b_frags(const uint32_t (&r)[4], int u,
                                          const uint32_t (&)[2],
                                          uint32_t (&b)[2][2]) const {
    conv(r[2 * u], b[0][0], b[1][0]);
    conv(r[2 * u + 1], b[0][1], b[1][1]);
  }
  // the K row that half h of B register j holds, for step rows kb ..
  __device__ __forceinline__ static int row_of(int kb, int tig, int j,
                                               int h) {
    return kb + 2 * tig + 8 * j + h;
  }
  __device__ __forceinline__ void zpair(const unsigned char*, int, int, int,
                                        uint32_t (&)[2]) const {}
  __device__ __forceinline__ float4 scale4(const unsigned char* st, int slot,
                                           int col) const {
    return *reinterpret_cast<const float4*>(
        reinterpret_cast<const float*>(st + kCodeBytes) + slot * BN + col);
  }
};

// K3: packed int4 codes (K/2, N), two K rows a byte (low nibble = even
// row), with an fp16 scale and a uint8 zero-point per (group, column), in
// k-tiles of TK rows. Stage: the TK / 2 x 64 packed bytes (rows RS bytes
// apart), gpt rows of 64 scales, gpt rows of 64 zero-points.
//
// One ldmatrix.trans register holds packed rows 8 s + 2 tig and + 1 of
// columns c0, c1: K rows k, k + 1 (one byte) and k + 2, k + 3 (the next),
// k = 16 s + 4 tig. A nibble under the exponent of 128 in bf16 is 128 + q
// exactly; subtracting 128 + z (bf16x2) leaves q - z. The natural pairs are
// (k, k + 2) and (k + 1, k + 3), so a step's 16 rows enter the mma in that
// order, and x's fragment takes the same order: the mma's k index 2 tig,
// 2 tig + 1 is K row k, k + 2; 2 tig + 8, 2 tig + 9 is k + 1, k + 3.
template <int TKv>
struct Int4B {
  static constexpr bool kQuant = true;
  static constexpr int TK = TKv;
  static constexpr int kStages = TK == 128 ? 6 : 4;
  static constexpr int RAW_STEPS = 4;   // one ldmatrix.x4: 32 packed rows
  static constexpr int kCodeBytes = TK / 2 * RS;
  static constexpr int kGroupBytes = BN * 2 + BN;
  const uint8_t* p;
  const uint16_t* s;  // (G, N) fp16 bit patterns
  const uint8_t* z;   // (G, N)
  int N, g;
  Div grp;
  int gpt;
  bool vec;

  __host__ __device__ static constexpr int stage_bytes_most() {
    return kCodeBytes + TK * kGroupBytes;
  }
  __host__ __device__ int stage_bytes() const {
    return kCodeBytes + gpt * kGroupBytes;
  }
  __device__ __forceinline__ int zeros_at() const {
    return kCodeBytes + gpt * BN * 2;
  }
  template <int THREADS>
  __device__ __forceinline__ void load(unsigned char* st, int tid, int k0,
                                       int kend, int n0) const {
    // k0 and kend are even (K is, and k-tiles start at multiples of 64)
    load_rows<uint8_t, THREADS, RS>(st, p, k0 / 2, TK / 2, kend / 2, n0, N,
                                    vec, tid);
    const int ga = grp(k0), gl = grp(min(k0 + TK, kend) - 1);
    load_rows<uint16_t, THREADS, BN * 2>(st + kCodeBytes, s, ga,
                                         gl - ga + 1, gl + 1, n0, N, vec,
                                         tid);
    load_rows<uint8_t, THREADS, BN>(st + zeros_at(), z, ga, gl - ga + 1,
                                    gl + 1, n0, N, vec, tid);
  }
  // the codes of k16 steps s0 .. s0 + 3 (packed rows 8 s0 .. + 31)
  __device__ __forceinline__ void raw(const unsigned char* st, int col0,
                                      int lane, int s0,
                                      uint32_t (&r)[4]) const {
    ldmatrix_x4_trans(r, st + (8 * s0 + lane) * RS + col0);
  }
  // x rows gid and gid + 8 at K rows kk + 4 tig .. + 3, paired as above
  template <int MT>
  __device__ __forceinline__ void a_frags(const bf16* xa, int xsr, int row0,
                                          int kk, int lane,
                                          uint32_t (&a)[MT][4]) const {
    const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const uint2 v0 = *reinterpret_cast<const uint2*>(
          xa + (row0 + i * 16 + gid) * xsr + kk + 4 * tig);
      const uint2 v1 = *reinterpret_cast<const uint2*>(
          xa + (row0 + i * 16 + gid + 8) * xsr + kk + 4 * tig);
      a[i][0] = __byte_perm(v0.x, v0.y, 0x5410);
      a[i][1] = __byte_perm(v1.x, v1.y, 0x5410);
      a[i][2] = __byte_perm(v0.x, v0.y, 0x7632);
      a[i][3] = __byte_perm(v1.x, v1.y, 0x7632);
    }
  }
  __device__ __forceinline__ static uint32_t sub(uint32_t a, uint32_t b) {
    const __nv_bfloat162 d =
        __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                *reinterpret_cast<const __nv_bfloat162*>(&b));
    return *reinterpret_cast<const uint32_t*>(&d);
  }
  __device__ __forceinline__ void b_frags(const uint32_t (&r)[4], int u,
                                          const uint32_t (&zz)[2],
                                          uint32_t (&b)[2][2]) const {
    constexpr uint32_t kLow = 0x000F000Fu, kMagic = 0x43004300u;  // 128
    const uint32_t v = r[u];
    b[0][0] = sub((v & kLow) | kMagic, zz[0]);          // c0: k, k + 2
    b[0][1] = sub(((v >> 4) & kLow) | kMagic, zz[0]);   // c0: k + 1, k + 3
    b[1][0] = sub(((v >> 8) & kLow) | kMagic, zz[1]);   // c1: k, k + 2
    b[1][1] = sub(((v >> 12) & kLow) | kMagic, zz[1]);  // c1: k + 1, k + 3
  }
  __device__ __forceinline__ static int row_of(int kb, int tig, int j,
                                               int h) {
    return kb + 4 * tig + j + 2 * h;
  }
  // bf16 pairs of 128 + z for the thread's B columns c0, c1 (col0: the
  // warp's first column in the block)
  __device__ __forceinline__ void zpair(const unsigned char* st, int slot,
                                        int col0, int gid,
                                        uint32_t (&zz)[2]) const {
    const uint32_t v = *reinterpret_cast<const uint16_t*>(
        st + zeros_at() + slot * BN + col0 + 2 * gid);
    zz[0] = 0x43004300u | ((v & 0xFFu) * 0x10001u);
    zz[1] = 0x43004300u | ((v >> 8) * 0x10001u);
  }
  __device__ __forceinline__ float4 scale4(const unsigned char* st, int slot,
                                           int col) const {
    const uint2 h = *reinterpret_cast<const uint2*>(
        reinterpret_cast<const __half*>(st + kCodeBytes) + slot * BN + col);
    const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&h.x));
    const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&h.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
};

// BM rows x 64 columns per block, warps WM x WN, each warp a (BM / WM) x
// (64 / WN) tile of m16 x n8 fragments, over k-tiles of W::TK rows.
template <typename W, int BM, int WM, int WN>
__global__ void __launch_bounds__(WM * WN * 32)
    mm_mma_kernel(const bf16* __restrict__ x, W w, bf16* __restrict__ out,
                  float* __restrict__ ws, unsigned* __restrict__ counters,
                  int M, int N, int K, int k_split, bool vec_x) {
  constexpr int THREADS = WM * WN * 32;
  constexpr int STAGES = W::kStages;
  constexpr int TK = W::TK;
  constexpr int XS = TK + 8;  // row stride (elements) of the x tile
  constexpr int WTM = BM / WM, WTN = BN / WN;
  constexpr int MT = WTM / 16, NT = WTN / 8;
  static_assert(MT >= 1 && NT % 2 == 0, "warp tile of m16 x (2 n8)");
  static_assert(!W::kQuant || NT == 2, "a quantised warp tile is 16 wide");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [STAGES][BM][XS]
  unsigned char* ring = smem_raw + sizeof(bf16) * STAGES * BM * XS;
  const int stage_bytes = w.stage_bytes();       // a multiple of 16
  __shared__ unsigned last_block;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int split = blockIdx.z, S = gridDim.z;
  const int kbeg = split * k_split;
  const int kend = min(K, kbeg + k_split);
  const int ntiles = kend > kbeg ? (kend - kbeg + TK - 1) / TK : 0;
  const int xrows = min(BM, M - m0);  // x rows of the block; the rest is 0
  const bf16 zero = __float2bfloat16(0.f);
  // fragment (i, j, e): row gid (+8 for e >= 2); see the formats above
  // for its columns
  const int gid = lane >> 2, tig = lane & 3;

  auto load = [&](int t, int stage) {
    const int k0 = kbeg + t * TK;
    bf16* xd = xs + stage * BM * XS;
    for (int c = tid; c < xrows * (TK / 8); c += THREADS) {
      const int r = c / (TK / 8), kc = (c % (TK / 8)) * 8;
      const int gm = m0 + r, gk = k0 + kc;
      bf16* dst = xd + r * XS + kc;
      if (vec_x) {
        const int n = gk < kend ? min(8, kend - gk) : 0;
        cp_async16(dst, n ? x + static_cast<size_t>(gm) * K + gk : x, 2 * n);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] =
              gk + e < kend ? x[static_cast<size_t>(gm) * K + gk + e] : zero;
      }
    }
    w.template load<THREADS>(ring + stage * stage_bytes, tid, k0, kend, n0);
  };

  float acc[MT][NT][4];
  float part[MT][NT][4];  // K2 / K3: the open group's unscaled sum
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = part[i][j][e] = 0.f;

  // K2 / K3: the partial of the group in slot `slot` of stage st, times
  // its scales, into acc, and cleared
  auto flush = [&](const unsigned char* st, int slot) {
    if constexpr (W::kQuant) {
      const float4 s4 = w.scale4(st, slot, wn * WTN + 4 * tig);
      const float sc[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[i][j][e] = __fadd_rn(
                acc[i][j][e], __fmul_rn(sc[2 * (e & 1) + j], part[i][j][e]));
            part[i][j][e] = 0.f;
          }
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) load(s, s);
    cp_async_commit();
  }
  // x rows past M stay zero in every stage: zeroed once, while the first
  // copies are in flight (the loop's first barrier publishes them), and
  // never copied
  if (xrows < BM) {
    constexpr int CPR = XS / 8;  // 16-byte chunks a row
    const int n = (BM - xrows) * CPR;
    for (int st = 0; st < STAGES; ++st)
      for (int c = tid; c < n; c += THREADS)
        *reinterpret_cast<uint4*>(xs + (st * BM + xrows + c / CPR) * XS +
                                  (c % CPR) * 8) = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<STAGES - 2>();  // tile t has landed
    __syncthreads();              // ... for every thread; stage t-1 is free
    const int tn = t + STAGES - 1;  // into the stage that tile t-1 used
    if (tn < ntiles) load(tn, tn % STAGES);
    cp_async_commit();
    const int k0 = kbeg + t * TK;
    const bf16* xa = xs + (t % STAGES) * BM * XS;
    const unsigned char* st = ring + (t % STAGES) * stage_bytes;
    if constexpr (!W::kQuant) {
      const bf16* wb = reinterpret_cast<const bf16*>(st);
#pragma unroll
      for (int kk = 0; kk < TK; kk += 16) {
        uint32_t a[MT][4], b[NT][2];
        x_frags<MT>(xa, XS, wm * WTM, kk, lane, a);
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
    } else {
      constexpr int RAW_STEPS = W::RAW_STEPS;
      const int g = w.g, col0 = wn * WTN;
      const int kl = min(k0 + TK, kend) - 1;  // the tile's last row
      const int ga = w.grp(k0);               // its first group: slot 0
      uint32_t raw[4];
      if (w.grp(kl) == ga) {
        // the tile lies in one group: no step is cut, no mask
        uint32_t zz[2] = {0u, 0u};
        w.zpair(st, 0, col0, gid, zz);
#pragma unroll
        for (int s = 0; s < TK / 16; ++s) {
          if (k0 + 16 * s > kl) continue;  // past the split's end
          if (s % RAW_STEPS == 0) w.raw(st, col0, lane, s, raw);
          uint32_t a[MT][4], b[2][2];
          w.template a_frags<MT>(xa, XS, wm * WTM, 16 * s, lane, a);
          w.b_frags(raw, s % RAW_STEPS, zz, b);
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < NT; ++j)
              mma_bf16(part[i][j], a[i], b[j][0], b[j][1]);
        }
        // the group ends in this tile, or the split does
        if (static_cast<long long>(ga + 1) * g <= k0 + TK || k0 + TK >= kend)
          flush(st, 0);
      } else {
        // a step a group boundary cuts runs once per group it touches,
        // the B rows of the other groups masked to zero
#pragma unroll
        for (int s = 0; s < TK / 16; ++s) {
          const int kb = k0 + 16 * s;
          if (kb > kl) continue;
          if (s % RAW_STEPS == 0) w.raw(st, col0, lane, s, raw);
          uint32_t a[MT][4];
          w.template a_frags<MT>(xa, XS, wm * WTM, 16 * s, lane, a);
          const int g0 = w.grp(kb), g1 = w.grp(min(kb + 15, kl));
          for (int gi = g0; gi <= g1; ++gi) {
            uint32_t zz[2] = {0u, 0u}, b[2][2];
            w.zpair(st, gi - ga, col0, gid, zz);
            w.b_frags(raw, s % RAW_STEPS, zz, b);
            if (g0 != g1) {
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const uint32_t m =
                    (w.grp(W::row_of(kb, tig, j, 0)) == gi ? 0x0000FFFFu
                                                           : 0u) |
                    (w.grp(W::row_of(kb, tig, j, 1)) == gi ? 0xFFFF0000u
                                                           : 0u);
                b[0][j] &= m;
                b[1][j] &= m;
              }
            }
#pragma unroll
            for (int i = 0; i < MT; ++i)
#pragma unroll
              for (int j = 0; j < NT; ++j)
                mma_bf16(part[i][j], a[i], b[j][0], b[j][1]);
            // group gi ends in this step, or the split does
            if (static_cast<long long>(gi + 1) * g <= kb + 16 ||
                kb + 16 >= kend)
              flush(st, gi - ga);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // the thread's outputs as pairs of adjacent columns: (row, col, v0, v1)
  // with v0 at col and v1 at col + 1, four pairs per m16 tile
  const int rbase = m0 + wm * WTM + gid;
  auto pair = [&](int i, int p, int& row, int& col, float& v0, float& v1) {
    if constexpr (!W::kQuant) {  // p = 2 j + h: columns 8 j + 2 tig, + 1
      const int j = p >> 1, h = p & 1;
      row = rbase + i * 16 + 8 * h;
      col = n0 + wn * WTN + j * 8 + 2 * tig;
      v0 = acc[i][j][2 * h];
      v1 = acc[i][j][2 * h + 1];
    } else {  // p = e: the even and the odd tile, columns 4 tig + 2 (e % 2)
      row = rbase + i * 16 + 8 * (p >> 1);
      col = n0 + wn * WTN + 4 * tig + 2 * (p & 1);
      v0 = acc[i][0][p];
      v1 = acc[i][1][p];
    }
  };
  if (S == 1) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        int row, col;
        float v0, v1;
        pair(i, p, row, col, v0, v1);
        store_pair(out, M, N, row, col, v0, v1);
      }
    return;
  }

  // S > 1: this split's partial, then the tile's last block sums them all
  const size_t plane = static_cast<size_t>(M) * N;
  float* prt = ws + split * plane;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      int row, col;
      float v0, v1;
      pair(i, p, row, col, v0, v1);
      if (row >= M || col >= N) continue;
      float* dst = prt + static_cast<size_t>(row) * N + col;
      if (col + 1 < N && N % 2 == 0) {
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      } else {
        dst[0] = v0;
        if (col + 1 < N) dst[1] = v1;
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

template <typename W, int BM, int WM, int WN>
cudaError_t launch(const bf16* x, W w, bf16* out, float* ws,
                   unsigned* counters, int M, int N, int K, int k_split,
                   cudaStream_t stream) {
  constexpr size_t STAGES = W::kStages;
  constexpr size_t fixed = sizeof(bf16) * STAGES * BM * (W::TK + 8);
  constexpr size_t most = fixed + STAGES * W::stage_bytes_most();
  static_assert(most <= 232448, "a ring that fits shared memory at g = 1");
  const size_t smem = fixed + STAGES * w.stage_bytes();
  // above 48 KB of dynamic shared memory only after this opt-in, made once
  // per device for the largest ring this instantiation can take (a decode
  // step launches the kernel 72 times from a busy host)
  static std::atomic<unsigned> opted_in{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 32 || !((opted_in.load() >> dev) & 1u)) {
    e = cudaFuncSetAttribute(mm_mma_kernel<W, BM, WM, WN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(most));
    if (e != cudaSuccess) return e;
    if (dev < 32) opted_in.fetch_or(1u << dev);
  }
  // a 16-byte copy needs an aligned row start: aligned base, stride % 8
  const bool vec_x = reinterpret_cast<uintptr_t>(x) % 16 == 0 && K % 8 == 0;
  const int S = K > 0 ? (K + k_split - 1) / k_split : 1;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, S);
  mm_mma_kernel<W, BM, WM, WN><<<grid, WM * WN * 32, smem, stream>>>(
      x, w, out, ws, counters, M, N, K, k_split, vec_x);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// w16 runs M <= 16 (decode), w64 larger M: the same weight, in the
// k-tile height each takes.
template <typename W16, typename W64>
int run(const void* x, W16 w16, W64 w64, void* out, void* ws,
        void* counters, int M, int N, int K, int k_split, void* stream) {
  if (M < 1 || N < 1 || K < 0 || k_split < BK || k_split % BK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (K > k_split && (ws == nullptr || counters == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* ob = static_cast<bf16*>(out);
  float* wsf = static_cast<float*>(ws);
  unsigned* cnt = static_cast<unsigned*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // above 16 rows: K1 with two warp rows of 32; K2 / K3 with one warp row
  // of 64, so each warp converts its codes once for all 64 rows
  constexpr int WM = W64::kQuant ? 1 : 2;
  const cudaError_t e =
      M <= 16
          ? launch<W16, 16, 1, 4>(xb, w16, ob, wsf, cnt, M, N, K, k_split, s)
          : launch<W64, 64, WM, 4>(xb, w64, ob, wsf, cnt, M, N, K, k_split,
                                   s);
  return static_cast<int>(e);
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
  const DenseB wf{static_cast<const bf16*>(w), N,
                  aligned16(w) && N % 8 == 0};
  return run(x, wf, wf, out, ws, counters, M, N, K, k_split, stream);
}

// K2: out = x @ (q * s[k / g]) for int8 codes q (K, N) and f32 scales s
// (G, 1, N), g = ceil(K / G) >= 1; ws, counters and k_split as K1's.
extern "C" int k2_streamed_matmul_int8_bf16_mma(
    const void* x, const void* q, const void* s, void* out, void* ws,
    void* counters, int M, int N, int K, int g, int k_split, void* stream) {
  if (g < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* qb = static_cast<const int8_t*>(q);
  const float* sb = static_cast<const float*>(s);
  const bool vec = aligned16(q) && aligned16(s) && N % 16 == 0;
  const Div grp = make_div(g);
  return run(x, Int8B<128>{qb, sb, N, g, grp, groups_per_tile(128, g), vec},
             Int8B<64>{qb, sb, N, g, grp, groups_per_tile(64, g), vec}, out,
             ws, counters, M, N, K, k_split, stream);
}

// K3: out = x @ ((q - z[k / g]) * s[k / g]) for packed int4 codes p
// (K / 2, N), fp16 scales s and uint8 zero-points z (G, N), K even,
// g = ceil(K / G) >= 1; ws, counters and k_split as K1's.
extern "C" int k3_streamed_matmul_int4_bf16_mma(
    const void* x, const void* p, const void* s, const void* z, void* out,
    void* ws, void* counters, int M, int N, int K, int g, int k_split,
    void* stream) {
  if (g < 1 || K % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const uint8_t* pb = static_cast<const uint8_t*>(p);
  const uint16_t* sb = static_cast<const uint16_t*>(s);
  const uint8_t* zb = static_cast<const uint8_t*>(z);
  const bool vec =
      aligned16(p) && aligned16(s) && aligned16(z) && N % 16 == 0;
  const Div grp = make_div(g);
  return run(x,
             Int4B<128>{pb, sb, zb, N, g, grp, groups_per_tile(128, g), vec},
             Int4B<64>{pb, sb, zb, N, g, grp, groups_per_tile(64, g), vec},
             out, ws, counters, M, N, K, k_split, stream);
}
