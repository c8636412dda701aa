// The RWKV-6 WKV recurrence from a zero state, for sm_90a.
//
// Replaces the Pallas kernel `rwkv6_scan_kernel`
// (src/repro/kernels/rwkv6_scan/kernel.py, body `_kernel`). For each
// (batch, head), with an fp32 (hd x hd) state S laid out [key i][value j]:
//   y_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j])
//   S[i][j] <- w_t[i] S[i][j] + k_t[i] v_t[j]
// and the final S is written out. The TPU kernel keeps S resident in VMEM
// while time blocks stream through; here it lives in registers.
//
// Design: one block per (head, batch) with hd threads. Thread j owns
// column j of S (hd fp32 registers), so the state never leaves the
// thread and a step needs no synchronisation. Every step reads all of
// r_t, k_t, w_t (and u*k_t) but only v_t[j]: the block stages CH = 8 steps
// of r, u*k, w in shared memory at a time (all threads then read the same
// address: a broadcast), and loads the next chunk into registers while it
// computes the current one, so the loads' latency hides behind 8 steps of
// work. Steps past T are never computed (the TPU kernel pads them with
// w = 1, which leaves S unchanged).
//
// Bound: bytes. At the RWKV-6-3B prefill (B 4, H 40, T 1024, hd 64,
// fp32) the kernel must read r, k, v, w (168 MB) and write y (42 MB) and
// S; ~5 flops per state element a step is 3.4 GFLOP, under the bytes
// time at the card's 67 TFLOP/s fp32 rate. The launch puts B*H = 160
// blocks of 64 threads on 132 SMs: the card is underfilled and each SM
// runs one or two blocks of two warps, so the kernel is bound in practice by the
// latency of its per-step chain, not by either roofline term. Splitting
// the state over more threads per head (or chunked parallel forms) is
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CH = 8;  // steps staged per chunk

struct Strides {
  long long b, h, t;  // the head_dim stride is 1
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int HD>
__global__ void __launch_bounds__(HD)
    rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ w,
                      const float* __restrict__ u, T* __restrict__ y,
                      float* __restrict__ s_out, Strides sr, Strides sk,
                      Strides sv, Strides sw, Strides sy, long long su,
                      int H, int Tn) {
  __shared__ __align__(16) float rs[CH][HD];
  __shared__ __align__(16) float uks[CH][HD];
  __shared__ __align__(16) float ks[CH][HD];
  __shared__ __align__(16) float ws[CH][HD];

  const int j = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;
  const T* rb = r + b * sr.b + h * sr.h + j;
  const T* kb = k + b * sk.b + h * sk.h + j;
  const T* vb = v + b * sv.b + h * sv.h + j;
  const float* wb = w + b * sw.b + h * sw.h + j;
  T* yb = y + b * sy.b + h * sy.h + j;
  const float uj = u[h * su + j];

  float S[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) S[i] = 0.0f;

  float pr[CH], pk[CH], pv[CH], pw[CH];  // the next chunk, in flight
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    pr[c] = pk[c] = pv[c] = 0.0f;
    pw[c] = 1.0f;
    if (c < Tn) {
      pr[c] = to_f32(rb[c * sr.t]);
      pk[c] = to_f32(kb[c * sk.t]);
      pv[c] = to_f32(vb[c * sv.t]);
      pw[c] = wb[c * sw.t];
    }
  }

  for (int t0 = 0; t0 < Tn; t0 += CH) {
    float vc[CH];
    __syncthreads();  // every thread is done with the previous chunk
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      rs[c][j] = pr[c];
      ks[c][j] = pk[c];
      uks[c][j] = uj * pk[c];
      ws[c][j] = pw[c];
      vc[c] = pv[c];
    }
    __syncthreads();
    const int t1 = t0 + CH;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if (t1 + c < Tn) {
        const long long t = t1 + c;
        pr[c] = to_f32(rb[t * sr.t]);
        pk[c] = to_f32(kb[t * sk.t]);
        pv[c] = to_f32(vb[t * sv.t]);
        pw[c] = wb[t * sw.t];
      }
    }
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if (t0 + c < Tn) {
        const float vj = vc[c];
        float y0 = 0.f, y1 = 0.f, y2 = 0.f, y3 = 0.f;
#pragma unroll
        for (int i = 0; i < HD; i += 4) {
          const float4 r4 = *reinterpret_cast<const float4*>(&rs[c][i]);
          const float4 uk4 = *reinterpret_cast<const float4*>(&uks[c][i]);
          const float4 k4 = *reinterpret_cast<const float4*>(&ks[c][i]);
          const float4 w4 = *reinterpret_cast<const float4*>(&ws[c][i]);
          y0 = fmaf(r4.x, fmaf(uk4.x, vj, S[i + 0]), y0);
          y1 = fmaf(r4.y, fmaf(uk4.y, vj, S[i + 1]), y1);
          y2 = fmaf(r4.z, fmaf(uk4.z, vj, S[i + 2]), y2);
          y3 = fmaf(r4.w, fmaf(uk4.w, vj, S[i + 3]), y3);
          S[i + 0] = fmaf(w4.x, S[i + 0], k4.x * vj);
          S[i + 1] = fmaf(w4.y, S[i + 1], k4.y * vj);
          S[i + 2] = fmaf(w4.z, S[i + 2], k4.z * vj);
          S[i + 3] = fmaf(w4.w, S[i + 3], k4.w * vj);
        }
        store(yb + (long long)(t0 + c) * sy.t, (y0 + y1) + (y2 + y3));
      }
    }
  }

  float* sb = s_out + ((long long)b * H + h) * HD * HD + j;
#pragma unroll
  for (int i = 0; i < HD; ++i) sb[i * HD] = S[i];
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, void* y, float* s, int B, int H, int Tn,
           const long long* st, long long su, cudaStream_t stream) {
  rwkv6_scan_kernel<T, HD><<<dim3((unsigned)H, (unsigned)B), HD, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, static_cast<T*>(y), s,
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
      Strides{st[12], st[13], st[14]}, su, H, Tn);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v, y: (B,H,T,hd) of dtype 0 = float32 or 1 = bfloat16; w:
// (B,H,T,hd) float32; each given by its (b, h, t) element strides,
// head_dim contiguous. u: (H,hd) float32, row stride su. s: contiguous
// (B,H,hd,hd) float32, the final state. Returns the cudaError_t of the
// launch (0 on success); never synchronises.
extern "C" int rwkv6_scan_launch(
    const void* r, const void* k, const void* v, const float* w,
    const float* u, void* y, float* s, int dtype, int B, int H, int Tn,
    int hd, long long rsb, long long rsh, long long rst, long long ksb,
    long long ksh, long long kst, long long vsb, long long vsh, long long vst,
    long long wsb, long long wsh, long long wst, long long ysb, long long ysh,
    long long yst, long long su, void* stream) {
  if (B < 1 || H < 1 || Tn < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  const long long st[15] = {rsb, rsh, rst, ksb, ksh, kst, vsb, vsh,
                            vst, wsb, wsh, wst, ysb, ysh, yst};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 32)
    return launch<float, 32>(r, k, v, w, u, y, s, B, H, Tn, st, su, cs);
  if (dtype == 0 && hd == 64)
    return launch<float, 64>(r, k, v, w, u, y, s, B, H, Tn, st, su, cs);
  if (dtype == 1 && hd == 32)
    return launch<__nv_bfloat16, 32>(r, k, v, w, u, y, s, B, H, Tn, st, su,
                                     cs);
  if (dtype == 1 && hd == 64)
    return launch<__nv_bfloat16, 64>(r, k, v, w, u, y, s, B, H, Tn, st, su,
                                     cs);
  return (int)cudaErrorInvalidValue;
}
