// Blocked causal GQA attention with a streaming softmax, for sm_90a.
//
// Replaces the Pallas kernel `flash_attention_kernel`
// (src/repro/kernels/flash_attention/kernel.py, body `_kernel`). Computes,
// for q (B,H,S,hd) and k, v (B,Kv,S,hd), query head h reading kv head
// h / (H/Kv):
//   out[i] = sum_j softmax_j(scale * q_i . k_j) v_j
// over the keys j visible to query i: j < S, j <= i when causal, and
// i - j < window when a window is given. Masked scores are -1e30, not
// -inf, and the output divides by max(l, 1e-30), as the TPU kernel does.
// There, a row whose keys in a tile are all masked gets p = exp(0), which
// the correction factor of a later tile with a visible key wipes out; the
// CUDA-core (fp32) body does the same, and the tensor-core (bf16) body
// gives such a row p = 0 until its first visible key, which leaves the
// same result for every row that has one (each row i < S has key i).
//
// Bound: operations. At the TinyLlama prefill (S 2048, hd 64, bf16) the
// four matrix-product flops per visible (query, key) pair and channel
// over the card's 989 TFLOP/s bf16 tensor-core rate take ~3x longer than
// reading q, k, v and writing out once over 3.35 TB/s. Only Hopper's
// warpgroup products (wgmma) reach that rate.
//
// bfloat16 (the main path): both products on the tensor cores, wgmma
// with bf16 operands and fp32 accumulators. A block of 288 threads takes
// 128 queries of one (head, batch): two consumer warpgroups of 64 query
// rows each, and one producer warp.
// * Copies: the producer's lane 0 loads the block's Q tile once, then the
//   K and V tiles (128 keys at head_dim 64, 64 at head_dim 128) by TMA,
//   through 4-d tensor maps (hd, S, heads, B) that the launcher encodes
//   from the tensors' strides, with a 128-byte swizzle, into a ring of
//   three stages guarded by mbarriers: a "full" barrier that the TMA
//   completes with its byte count, an "empty" one on which the 8 consumer
//   warps arrive when their products have read the stage. A head_dim of
//   128 is two 64-column (128-byte) boxes per tile. Rows past S arrive as
//   zeros.
// * head_dim 160 (StableLM-2-12B: 5120 / 32) is 2.5 such chunks. The
//   tensor maps keep the inner dimension at 160 and the box at 64
//   columns, so the third box of each row reads columns 128..191 and the
//   TMA fills 160..191 with zeros. S = Q K^T runs over the 160 real
//   channels (10 k-steps of 16); O += P V runs at N = 192 (a legal wgmma
//   width; the zero columns of V leave columns 160..191 of O at 0), and
//   only columns < 160 are stored. Shared memory then holds the padded
//   rows: Q 48 KB, each K or V stage 24 KB.
// * S = Q K^T: wgmma m64nBKk16, A = Q and B = K, both from shared memory
//   and K-major (the natural layout), one instruction per 16 channels.
// * Softmax on the accumulator fragments: a thread holds two rows of S
//   (r and r + 8 of its warp's 16), in pairs of columns; the row max takes
//   two shuffles within the quad of lanes that holds the row, and the
//   row sum stays a per-thread partial until the end. p = 2^(s c - m c)
//   with c = scale * log2(e): one fma and one MUFU.EX2 a score. Only the
//   tiles that the masks cut (the causal diagonal, the window's edge, the
//   ragged last tile) are masked element by element; tiles that they hide
//   entirely are never loaded (the TPU kernel's skip).
// * O += P V: P goes from the S accumulator to bf16 A fragments in
//   registers (the accumulator's layout is the A operand's, 16 keys at a
//   time), V is the B operand from shared memory, MN-major (the transpose
//   bit), and the fp32 output accumulator stays in registers throughout.
// * Overlap: a warpgroup issues tile t's S = Q K^T and tile t-1's
//   O += P V together, waits for S alone and runs tile t's softmax while
//   the tensor cores finish P V; only then does it correct O by tile t's
//   new maxima. The two consumer warpgroups interleave on top of that.
// * Scheduling: causal query tiles launch heaviest first (reversed
//   blockIdx.x), so the grid's tail is short; GQA is free, as the 8 query
//   heads of a group read their kv head's tiles through L2.
// Shared memory at head_dim 64 is 112 KB (Q 16 KB, three stages of K + V
// at 32 KB), 128 KB at 128, 193 KB at 160 (Q 48 KB, three stages at
// 48 KB); one block an SM.
//
// float32 keeps the CUDA-core body: tensor cores would take fp32 through
// TF32 (~1e-3 relative error), which the fp32 checks against the plain
// version (2e-5) and the card-vs-CPU serve (1e-4) cannot absorb. One block
// of 256 threads per 64-query tile; the query tile (pre-scaled) and each
// 64-key K and V tile sit in shared memory as fp32, four neighbouring
// threads share a query row (16 scores and a quarter of its output
// each), and the products are fmaf on the fp32 cores.
#include <cuda.h>  // CUtensorMap and its enums only: libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, h, s;  // the head_dim stride is 1
};

// ---------------------------------------------------------------------------
// float32: the CUDA-core body
// ---------------------------------------------------------------------------
namespace fp32 {

constexpr int BQ = 64;       // queries per block
constexpr int BK = 64;       // keys per tile
constexpr int THREADS = 256; // 4 threads per query row
constexpr int PS = BK + 4;   // padded row stride of the probability tile

template <int HD>
constexpr int smem_floats() {
  return BQ * (HD + 4) + BK * (HD + 4) + BK * HD + BQ * PS;
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
    flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, Strides sq,
              Strides sk, Strides sv, Strides so, int group, int S,
              float scale, int causal, int window) {
  constexpr int QS = HD + 4;       // padded row stride of the Q and K tiles
  constexpr int NACC = HD / 16;    // float4 output groups per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * QS;
  float* Vs = Ks + BK * QS;
  float* Ps = Vs + BK * HD;

  const int tid = threadIdx.x;
  const int row = tid >> 2;  // query row within the tile
  const int quad = tid & 3;  // this thread's quarter of the row
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / group;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + kvh * sk.h;
  const float* vb = v + b * sv.b + kvh * sv.h;

  for (int idx = tid; idx < BQ * HD; idx += THREADS) {
    const int r = idx / HD, d = idx % HD;
    float x = 0.0f;
    if (q0 + r < S) x = (qb[(long long)(q0 + r) * sq.s + d]) * scale;
    Qs[r * QS + d] = x;
  }

  const int qpos = q0 + row;
  float m_i = NEG_INF, l_i = 0.0f;
  float4 acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int ntiles = (S + BK - 1) / BK;
  const int kt_end = causal ? min(ntiles, q0 / BK + 1) : ntiles;
  const float* qrow = Qs + row * QS;
  float* prow = Ps + row * PS;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    if (window > 0 && k0 + BK - 1 < q0 - (window - 1)) continue;
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = tid; idx < BK * HD; idx += THREADS) {
      const int r = idx / HD, d = idx % HD;
      float kx = 0.0f, vx = 0.0f;
      if (k0 + r < S) {
        kx = (kb[(long long)(k0 + r) * sk.s + d]);
        vx = (vb[(long long)(k0 + r) * sv.s + d]);
      }
      Ks[r * QS + d] = kx;
      Vs[r * HD + d] = vx;
    }
    __syncthreads();

    // scores of keys c = quad + 4 j
    float s[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) s[j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(qrow + d);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float4 kv =
            *reinterpret_cast<const float4*>(Ks + (quad + 4 * j) * QS + d);
        s[j] = fmaf(qv.x, kv.x, s[j]);
        s[j] = fmaf(qv.y, kv.y, s[j]);
        s[j] = fmaf(qv.z, kv.z, s[j]);
        s[j] = fmaf(qv.w, kv.w, s[j]);
      }
    }
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int kpos = k0 + quad + 4 * j;
      bool ok = kpos < S;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && qpos - kpos < window;
      if (!ok) s[j] = NEG_INF;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_i, mx);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float p = expf(s[j] - m_new);
      sum += p;
      prow[quad + 4 * j] = p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float corr = expf(m_i - m_new);
    l_i = l_i * corr + sum;
    m_i = m_new;
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      acc[i].x *= corr;
      acc[i].y *= corr;
      acc[i].z *= corr;
      acc[i].w *= corr;
    }
    __syncwarp();  // the row's probabilities, written by its 4 threads

    // acc[i] holds channels 16 i + 4 quad .. +3
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      const float4 p4 = *reinterpret_cast<const float4*>(prow + c);
      const float pc[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = Vs + (c + cc) * HD + 4 * quad;
#pragma unroll
        for (int i = 0; i < NACC; ++i) {
          const float4 vv = *reinterpret_cast<const float4*>(vrow + 16 * i);
          acc[i].x = fmaf(pc[cc], vv.x, acc[i].x);
          acc[i].y = fmaf(pc[cc], vv.y, acc[i].y);
          acc[i].z = fmaf(pc[cc], vv.z, acc[i].z);
          acc[i].w = fmaf(pc[cc], vv.w, acc[i].w);
        }
      }
    }
  }

  if (qpos < S) {
    const float den = fmaxf(l_i, 1e-30f);
    float* orow = o + b * so.b + h * so.h + (long long)qpos * so.s + 4 * quad;
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      orow[16 * i + 0] = acc[i].x / den;
      orow[16 * i + 1] = acc[i].y / den;
      orow[16 * i + 2] = acc[i].z / den;
      orow[16 * i + 3] = acc[i].w / den;
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Kv, int S, const long long* st, float scale,
           int causal, int window, cudaStream_t stream) {
  auto kernel = flash_fwd<HD>;
  const int smem = smem_floats<HD>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((S + BQ - 1) / BQ), (unsigned)H, (unsigned)B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, H / Kv,
      S, scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace fp32

// ---------------------------------------------------------------------------
// bfloat16: TMA + wgmma
// ---------------------------------------------------------------------------
namespace bf16 {

constexpr int BQ = 128;            // queries per block: two warpgroups
constexpr int CONSUMERS = 256;     // the two consumer warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and the producer warp
constexpr int STAGES = 3;          // K/V ring depth
constexpr int ROW = 128;           // bytes of a swizzled row: 64 bf16

// head_dim rounded up to whole 64-column (128-byte) chunks: the width of
// a tile's rows in shared memory and of the P V product
__host__ __device__ constexpr int padded(int hd) {
  return (hd + 63) / 64 * 64;
}

template <int HD>
struct Tiles {
  static constexpr int BK = HD == 64 ? 128 : 64;  // keys per tile
  static constexpr int HDP = padded(HD);
  static constexpr int CHUNKS = HDP / 64;  // 128-byte column chunks a row
  static constexpr int Q_BYTES = BQ * HDP * 2;
  static constexpr int KV_BYTES = BK * HDP * 2;  // one K or one V tile
  // 1024 bytes of slack to align the swizzled tiles, then the barriers
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * 2 * KV_BYTES + 64;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 4-d tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor for a 128-byte swizzled tile:
// start address, leading and stride byte offsets (16-byte units), and
// the swizzle mode (1 = 128 bytes) in bits 62-63. The tile's 8-row atoms
// are 1024-byte aligned, so the base offset field stays 0.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>  // until at most N committed groups are pending
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keep the compiler from moving accesses to an accumulator across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 64, fp32) = A (64 x 16, shared, K-major) *
// B (64 x 16, shared, K-major)^T (+ D unless scale_d is 0), both
// 128-byte swizzled
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, fp32) = A (64 x 16, shared, K-major) *
// B (128 x 16, shared, K-major)^T (+ D unless scale_d is 0), both
// 128-byte swizzled
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, fp32) += A (64 x 16, bf16 in registers) *
// B (16 x 64, shared, MN-major, 128-byte swizzled)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, fp32) += A (64 x 16, bf16 in registers) *
// B (16 x 128, shared, MN-major, 128-byte swizzled)
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 192, fp32) += A (64 x 16, bf16 in registers) *
// B (16 x 192, shared, MN-major, 128-byte swizzled)
__device__ __forceinline__ void wgmma_rs(float (&d)[96],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

// the running softmax state of the two rows a consumer thread holds
struct Rows {
  int r0, r1;          // query positions: r0 and r0 + 8
  float m0, m1;        // running max of the unscaled scores
  float l0, l1;        // this thread's part of the running sums
};

// S = Q K^T of one tile: HD / 16 wgmma, asynchronous, committed as one
// group; the caller waits. The first product overwrites sc (scale-d 0),
// so no other instruction writes it while products are in flight.
template <int HD, int BK>
__device__ __forceinline__ void issue_qk(float (&sc)[BK / 2], uint32_t qa,
                                         uint32_t ks) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;  // 16 channels in a 128-byte row
    wgmma_ss(sc, gmma_desc(qa + (kk / 4) * BQ * ROW + off, 16, 1024),
             gmma_desc(ks + (kk / 4) * BK * ROW + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// O += P V of one tile, asynchronous, committed as one group; V's 64-
// column chunks lie BK rows of 128 bytes apart (N = the padded head_dim)
template <int HD, int BK>
__device__ __forceinline__ void issue_pv(float (&acc)[padded(HD) / 2],
                                         const uint32_t (&pa)[BK / 16][4],
                                         uint32_t vs) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs(acc, pa[kk], gmma_desc(vs + kk * 16 * ROW, BK * ROW, 1024));
  wgmma_commit();
}

__device__ __forceinline__ float ex2(float x) {  // 2^x, MUFU.EX2
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the softmax of one tile of scores, keys k0.., on the accumulator
// fragments: masks, the new row maxima (of the unscaled scores), P as
// bf16 A fragments (16 keys each), the row sums; returns the two rows'
// correction factors for O. p = 2^(s c - m c) with c = scale * log2(e),
// one fma and one MUFU.EX2 a score.
template <int BK>
__device__ __forceinline__ float2 softmax_tile(float (&sc)[BK / 2],
                                               uint32_t (&pa)[BK / 16][4],
                                               Rows& st, int k0, int q0,
                                               int cq, int S, float scale_log2,
                                               int causal, int window) {
  // accumulator element i: row r0 (i % 4 < 2) or r1, key
  // k0 + 8 (i / 4) + cq + i % 2
  const bool edge = (causal && k0 + BK - 1 > q0) ||
                    (window > 0 && k0 < q0 + BQ - window) || k0 + BK > S;
  if (edge) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int key = k0 + 8 * (i / 4) + cq + (i % 2);
      const int row = (i % 4) < 2 ? st.r0 : st.r1;
      bool ok = key < S;
      if (causal) ok = ok && key <= row;
      if (window > 0) ok = ok && row - key < window;
      if (!ok) sc[i] = NEG_INF;
    }
  }
  float mx[4] = {st.m0, st.m1, NEG_INF, NEG_INF};  // rows r0, r1, twice
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int j = (i % 4) / 2 + 2 * ((i / 4) % 2);
    mx[j] = fmaxf(mx[j], sc[i]);
  }
  float mx0 = fmaxf(mx[0], mx[2]), mx1 = fmaxf(mx[1], mx[3]);
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float2 corr = make_float2(ex2((st.m0 - mx0) * scale_log2),
                                  ex2((st.m1 - mx1) * scale_log2));
  st.m0 = mx0;
  st.m1 = mx1;
  // a row with no visible key yet (max still -1e30) takes bias 0, so its
  // masked scores give p = 0: with the bias -m c the fma's exact product
  // would leave a residual of ~1e22 instead of 0
  const float b0 = mx0 == NEG_INF ? 0.0f : -mx0 * scale_log2;
  const float b1 = mx1 == NEG_INF ? 0.0f : -mx1 * scale_log2;
  float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    float p[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int i = 8 * kk + e;
      p[e] = ex2(fmaf(sc[i], scale_log2, (i % 4) < 2 ? b0 : b1));
      sum[(i % 4) / 2 + 2 * (kk % 2)] += p[e];
    }
    pa[kk][0] = pack_bf16(p[0], p[1]);  // row r0, keys cq, cq + 1
    pa[kk][1] = pack_bf16(p[2], p[3]);  // row r1
    pa[kk][2] = pack_bf16(p[4], p[5]);  // row r0, keys 8 + cq, ..
    pa[kk][3] = pack_bf16(p[6], p[7]);  // row r1
  }
  st.l0 = st.l0 * corr.x + (sum[0] + sum[2]);
  st.l1 = st.l1 * corr.y + (sum[1] + sum[3]);
  return corr;
}

// one step of the consumer's pipeline: tile it's S = Q K^T and tile
// it-1's O += P V (P in `cur`) go to the tensor cores together; tile it's
// softmax (into `nxt`) runs while P V finishes; then O takes tile it's
// correction and tile it-1's stage is released. The caller alternates
// cur and nxt, so no register that a product in flight reads is written.
template <int HD, int BK>
__device__ __forceinline__ void pipeline_step(
    float (&acc)[padded(HD) / 2], float (&sc)[BK / 2],
    const uint32_t (&cur)[BK / 16][4], uint32_t (&nxt)[BK / 16][4], Rows& st, uint32_t qa, uint32_t k_it,
    uint32_t v_prev, uint32_t full_it, int parity, uint32_t empty_prev,
    int k0, int q0, int cq, int S, float scale_log2, int causal, int window) {
  mbar_wait(full_it, parity);
  issue_qk<HD, BK>(sc, qa, k_it);
  issue_pv<HD, BK>(acc, cur, v_prev);
  wgmma_wait<1>();  // S of tile it (the older group)
  fence_regs(sc);
  const float2 corr = softmax_tile<BK>(sc, nxt, st, k0, q0, cq, S,
                                       scale_log2, causal, window);
  wgmma_wait<0>();  // O += P V of tile it - 1
  fence_regs(acc);
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(empty_prev);
#pragma unroll
  for (int i = 0; i < padded(HD) / 2; ++i)
    acc[i] *= (i % 4) < 2 ? corr.x : corr.y;
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              __nv_bfloat16* __restrict__ o, Strides so, int group, int S,
              float scale_log2, int causal, int window) {
  using C = Tiles<HD>;
  constexpr int BK = C::BK;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t kv_s = base + C::Q_BYTES;  // stage s: K, then V
  const uint32_t bars = kv_s + STAGES * 2 * C::KV_BYTES;
  const uint32_t q_full = bars;             // then full[s], empty[s]
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + STAGES + s); };
  auto k_tile = [&](int it) { return kv_s + it % STAGES * 2 * C::KV_BYTES; };

  const int qt = (int)gridDim.x - 1 - (int)blockIdx.x;  // heaviest first
  const int q0 = qt * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / group;
  int kt_hi = (S + BK - 1) / BK;
  if (causal) kt_hi = min(kt_hi, (q0 + BQ - 1) / BK + 1);
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  const int n_tiles = kt_hi - kt_lo;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {  // the producer warp
    if (lane == 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < C::CHUNKS; ++c)
        tma_load(q_s + c * BQ * ROW, &tq, q_full, 64 * c, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(empty(s), (it / STAGES - 1) & 1);
        mbar_expect_tx(full(s), 2 * C::KV_BYTES);
        const int k0 = (kt_lo + it) * BK;
#pragma unroll
        for (int c = 0; c < C::CHUNKS; ++c) {
          tma_load(k_tile(it) + c * BK * ROW, &tk, full(s), 64 * c, k0, kvh,
                   b);
          tma_load(k_tile(it) + C::KV_BYTES + c * BK * ROW, &tv, full(s),
                   64 * c, k0, kvh, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg takes query rows q0 + 64 wg .. + 63; this
  // thread holds rows r0 and r0 + 8 of its warp's 16. Tile it's softmax
  // runs while the tensor cores compute tile it-1's O += P V.
  const int wg = warp / 4;
  const int cq = 2 * (lane % 4);  // first of the thread's column pair
  Rows st;
  st.r0 = q0 + 64 * wg + 16 * (warp % 4) + lane / 4;
  st.r1 = st.r0 + 8;
  st.m0 = st.m1 = NEG_INF;
  st.l0 = st.l1 = 0.0f;
  float acc[C::HDP / 2];  // columns of the padded head_dim
#pragma unroll
  for (int i = 0; i < C::HDP / 2; ++i) acc[i] = 0.0f;
  const uint32_t qa = q_s + 64 * wg * ROW;
  float sc[BK / 2];
  uint32_t pa[BK / 16][4];   // P of the tile whose P V is next
  uint32_t pn[BK / 16][4];   // P of the tile after it

  mbar_wait(q_full, 0);
  mbar_wait(full(0), 0);
  issue_qk<HD, BK>(sc, qa, k_tile(0));
  wgmma_wait<0>();
  fence_regs(sc);
  softmax_tile<BK>(sc, pa, st, kt_lo * BK, q0, cq, S, scale_log2, causal,
                   window);  // O is 0: nothing to correct
  auto step = [&](int it, const uint32_t (&cur)[BK / 16][4],
                  uint32_t (&nxt)[BK / 16][4]) {
    pipeline_step<HD, BK>(acc, sc, cur, nxt, st, qa, k_tile(it),
                          k_tile(it - 1) + C::KV_BYTES, full(it % STAGES),
                          (it / STAGES) & 1, empty((it - 1) % STAGES),
                          (kt_lo + it) * BK, q0, cq, S, scale_log2, causal,
                          window);
  };
  int it = 1;
  for (; it + 1 < n_tiles; it += 2) {
    step(it, pa, pn);
    step(it + 1, pn, pa);
  }
  if (it < n_tiles) {  // an odd number of steps: the last P is in pn
    step(it, pa, pn);
    issue_pv<HD, BK>(acc, pn, k_tile(n_tiles - 1) + C::KV_BYTES);
  } else {
    issue_pv<HD, BK>(acc, pa, k_tile(n_tiles - 1) + C::KV_BYTES);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  float l0 = st.l0, l1 = st.l1;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = o + b * so.b + h * so.h + cq;
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2) {  // the columns < HD only
    const int row = (i % 4) < 2 ? st.r0 : st.r1;
    const float d = (i % 4) < 2 ? d0 : d1;
    if (row < S) {
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row * so.s +
                                         8 * (i / 4)) =
          __floats2bfloat162_rn(acc[i] / d, acc[i + 1] / d);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// tensor map of a (B, heads, S, hd) bf16 tensor with element strides
// (sb, sh, ss) and unit stride on hd, read in boxes of 64 columns x rows
int encode(CUtensorMap* map, const void* ptr, int B, int heads, int S,
           int hd, long long sb, long long sh, long long ss, int rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)S,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
         dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Kv, int S, const long long* st, float scale,
           int causal, int window, cudaStream_t stream) {
  using C = Tiles<HD>;
  CUtensorMap tq, tk, tv;
  int err = encode(&tq, q, B, H, S, HD, st[0], st[1], st[2], BQ);
  if (err == 0) err = encode(&tk, k, B, Kv, S, HD, st[3], st[4], st[5], C::BK);
  if (err == 0) err = encode(&tv, v, B, Kv, S, HD, st[6], st[7], st[8], C::BK);
  if (err != 0) return err;
  auto kernel = flash_fwd<HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((S + BQ - 1) / BQ), (unsigned)H, (unsigned)B);
  kernel<<<grid, THREADS, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o),
      Strides{st[9], st[10], st[11]}, H / Kv, S, scale * 1.4426950408889634f,
      causal, window);
  return (int)cudaGetLastError();
}

}  // namespace bf16

}  // namespace

// q, o: (B,H,S,hd); k, v: (B,Kv,S,hd); each given by its (b, h, s)
// element strides, head_dim contiguous. dtype 0 = float32, 1 = bfloat16
// (all four tensors); for bfloat16 the pointers are 16-byte aligned and
// the strides multiples of 8 elements (TMA's 16 bytes), which the Python
// wrapper checks. window <= 0 means no window. Returns the cudaError_t of
// the launch (0 on success); never synchronises.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int H, int Kv, int S, int hd, long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
    long long vss, long long osb, long long osh, long long oss, float scale,
    int causal, int window, void* stream) {
  if (B < 1 || H < 1 || Kv < 1 || H % Kv != 0 || S < 1 || H > 65535 ||
      B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const long long st[12] = {qsb, qsh, qss, ksb, ksh, kss,
                            vsb, vsh, vss, osb, osh, oss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 64)
    return fp32::launch<64>(q, k, v, o, B, H, Kv, S, st, scale, causal,
                            window, s);
  if (dtype == 0 && hd == 128)
    return fp32::launch<128>(q, k, v, o, B, H, Kv, S, st, scale, causal,
                             window, s);
  if (dtype == 1 && hd == 64)
    return bf16::launch<64>(q, k, v, o, B, H, Kv, S, st, scale, causal,
                            window, s);
  if (dtype == 1 && hd == 128)
    return bf16::launch<128>(q, k, v, o, B, H, Kv, S, st, scale, causal,
                             window, s);
  if (dtype == 0 && hd == 160)
    return fp32::launch<160>(q, k, v, o, B, H, Kv, S, st, scale, causal,
                             window, s);
  if (dtype == 1 && hd == 160)
    return bf16::launch<160>(q, k, v, o, B, H, Kv, S, st, scale, causal,
                             window, s);
  return (int)cudaErrorInvalidValue;
}
