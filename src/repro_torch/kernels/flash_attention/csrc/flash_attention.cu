// Blocked causal GQA attention with a streaming softmax, for sm_90a.
//
// Replaces the Pallas kernel `flash_attention_kernel`
// (src/repro/kernels/flash_attention/kernel.py, body `_kernel`).
// Computes, for q (B,H,S,hd) and k, v (B,Kv,S,hd), query head h reading
// kv head h / (H/Kv):
//   out[i] = sum_j softmax_j(scale * q_i . k_j) v_j
// over the keys j visible to query i: j < S, j <= i when causal, and
// i - j < window when a window is given. Masked scores are -1e30, not
// -inf, and the output divides by max(l, 1e-30), as the TPU kernel does:
// a row whose keys in a tile are all masked gets p = exp(0) there, which
// the correction factor of a later tile with a visible key wipes out.
//
// Design: one block of 256 threads per (64-query tile, head, batch). The
// query tile (pre-scaled, fp32) stays in shared memory; the kernel walks
// the 64-key tiles in order, skipping those that the causal and window
// masks hide entirely (the same skip as the TPU kernel), stages each
// K and V tile in shared memory as fp32 and keeps the running max m,
// denominator l and the fp32 output accumulator per row in registers.
// Four neighbouring threads share a query row: each computes 16 of the
// tile's 64 scores and a quarter of the row's output, so a row's softmax
// needs two shuffles and its probabilities never leave the warp. GQA
// costs nothing: a block reads its kv head's K and V, which are never
// repeated per query head. Shared rows are padded by 4 floats so that the
// 16-byte reads of neighbouring rows fall in different banks.
//
// Bound: operations. At the TinyLlama prefill (S 2048, hd 64, bf16) the
// four matrix-product flops per visible (query, key) pair and channel
// (4 hd per pair) over the card's 989 TFLOP/s tensor-core rate take
// ~3x longer than reading q, k, v and writing out once over 3.35 TB/s.
// This first kernel does its products on the fp32 CUDA cores (67 TFLOP/s
// peak, explicit fmaf), each fed by 16-byte shared-memory reads; moving
// them to the tensor cores (wgmma) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // queries per block
constexpr int BK = 64;       // keys per tile
constexpr int THREADS = 256; // 4 threads per query row
constexpr int PS = BK + 4;   // padded row stride of the probability tile
constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, h, s;  // the head_dim stride is 1
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int HD>
constexpr int smem_floats() {
  return BQ * (HD + 4) + BK * (HD + 4) + BK * HD + BQ * PS;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, Strides sq,
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
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;

  for (int idx = tid; idx < BQ * HD; idx += THREADS) {
    const int r = idx / HD, d = idx % HD;
    float x = 0.0f;
    if (q0 + r < S) x = to_f32(qb[(long long)(q0 + r) * sq.s + d]) * scale;
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
        kx = to_f32(kb[(long long)(k0 + r) * sk.s + d]);
        vx = to_f32(vb[(long long)(k0 + r) * sv.s + d]);
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
    T* orow = o + b * so.b + h * so.h + (long long)qpos * so.s + 4 * quad;
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      store(orow + 16 * i + 0, acc[i].x / den);
      store(orow + 16 * i + 1, acc[i].y / den);
      store(orow + 16 * i + 2, acc[i].z / den);
      store(orow + 16 * i + 3, acc[i].w / den);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Kv, int S, const long long* st, float scale,
           int causal, int window, cudaStream_t stream) {
  auto kernel = flash_fwd<T, HD>;
  const int smem = smem_floats<HD>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((S + BQ - 1) / BQ), (unsigned)H, (unsigned)B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, H / Kv,
      S, scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: (B,H,S,hd); k, v: (B,Kv,S,hd); each given by its (b, h, s)
// element strides, head_dim contiguous. dtype 0 = float32, 1 = bfloat16
// (all four tensors). window <= 0 means no window. Returns the
// cudaError_t of the launch (0 on success); never synchronises.
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
    return launch<float, 64>(q, k, v, o, B, H, Kv, S, st, scale, causal,
                             window, s);
  if (dtype == 0 && hd == 128)
    return launch<float, 128>(q, k, v, o, B, H, Kv, S, st, scale, causal,
                              window, s);
  if (dtype == 1 && hd == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, B, H, Kv, S, st, scale,
                                     causal, window, s);
  if (dtype == 1 && hd == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, B, H, Kv, S, st, scale,
                                      causal, window, s);
  return (int)cudaErrorInvalidValue;
}
