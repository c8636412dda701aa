// The RWKV-6 WKV recurrence from a zero state, for sm_90a.
//
// Replaces the Pallas kernel `rwkv6_scan_kernel`
// (src/repro/kernels/rwkv6_scan/kernel.py, body `_kernel`). For each
// (batch, head), with an fp32 (hd x hd) state S laid out [key i][value j]:
//   y_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j])
//   S[i][j] <- w_t[i] S[i][j] + k_t[i] v_t[j]
// and the final S is written out. The TPU kernel keeps S resident in VMEM
// while time blocks stream through; here it lives in registers, spread
// over many threads.
//
// Bound: bytes. At the RWKV-6-3B prefill (B 4, H 40, T 1024, hd 64,
// fp32) the kernel must read r, k, v, w (168 MB) and write y (42 MB) and
// S; ~5 flops per state element a step is 3.4 GFLOP, under the bytes time
// at the card's 67 TFLOP/s fp32 rate. What stands between a kernel and
// that bound is the step-to-step chain of the recurrence: a step needs
// the state of the one before, so the work of a head can only be spread
// across its state, not across time.
//
// Design: the value columns of S are independent (column j needs all of
// r_t, k_t, w_t and u*k_t but only v_t[j]), and so are its key rows
// within a step except for y's sum. So one block of 256 threads takes a
// group of JB = 32 columns of one (batch, head), and the key rows are
// cut in 16 parts of hd/16 rows: half-warp s of warp p holds part 2p + s,
// and its lane c keeps the entries of that part in columns c and c + 16,
// 2 * hd/16 fp32 registers. At the main-path shape that is 2 x 40 x 4 = 320
// blocks of 8 warps (2560 warps, all resident at once on 132 SMs at 3
// blocks an SM), where one block of 2 warps per head gave 320 warps; the
// only chain from step to step is one fmaf per state entry, so the SMs
// issue from many independent chains.
// Every state entry needs its row's r, u*k, k, w each step, read from
// shared memory: the lanes of a half-warp share their rows (one 16-byte
// broadcast read of each vector serves 16 lanes), and each thread applies
// every value it reads to two columns, so those reads stay off the
// critical path. What bounds the kernel then is the fp32 issue of the 4
// operations a state entry a step, and 320 blocks on 132 SMs (3 on some,
// 2 on others).
// y: each thread sums its rows for its two columns, the two half-warps
// of a warp join by one __shfl_xor_sync, and the 8 warps' partial sums go
// to shared memory, to be added in warp order once a chunk.
// Each state entry keeps exactly the update of the one-thread-per-column
// form, fmaf(w, S, k*v) with k*v rounded on its own (built with
// --fmad=false), so the final state is that form's bit for bit; only y's
// order of summation changes.
// Columns are split in groups of 32 and not 16 so that each of r, k, w
// is read by two blocks and not four (the blocks of one head run side by
// side and share those reads in L2).
// Staging: CH = 16 steps of r, k, w and the group's v at a time come into
// one of two shared-memory stages by cp.async, 16 bytes a copy, the next
// chunk in flight while this one computes; no register holds them on the
// way, and u*k is formed once a chunk. So the wrapper asks for 16-byte
// aligned r, k, v, w with strides of 16 bytes. y is written coalesced a
// chunk later. Steps past T are never computed (the TPU kernel pads them
// with w = 1, which leaves S unchanged).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CH = 16;       // steps staged per chunk
constexpr int JB = 32;       // value columns per block, two a lane
constexpr int WARPS = 8;     // warps per block
constexpr int PARTS = 2 * WARPS;  // parts of the key rows: half-warps
constexpr int THREADS = 32 * WARPS;

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

// N = 2 or 4 consecutive values of shared memory, as fp32
template <int N>
__device__ __forceinline__ void load_rows(const float* p, float (&x)[N]) {
  if constexpr (N == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    x[0] = q.x, x[1] = q.y, x[2] = q.z, x[3] = q.w;
  } else {
    const float2 q = *reinterpret_cast<const float2*>(p);
    x[0] = q.x, x[1] = q.y;
  }
}
template <int N>
__device__ __forceinline__ void load_rows(const __nv_bfloat16* p,
                                          float (&x)[N]) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float2 a = __bfloat1622float2(q[i]);
    x[2 * i] = a.x, x[2 * i + 1] = a.y;
  }
}

// one chunk of the inputs as they arrive: CH steps of r, k, w and of the
// group's v
template <typename T, int HD>
struct Stage {
  T r[CH][HD];
  T k[CH][HD];
  float w[CH][HD];
  T v[CH][JB];
};

// 16 bytes global -> shared, asynchronously (cp.async, through L2)
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
               "l"(src)
               : "memory");
}

// the rows of `rows` (x cols values of type E each, a row every `stride`
// elements from src) of the chunk's steps t0.. that exist, in 16-byte
// pieces, spread over the block's threads
template <typename E, int COLS>
__device__ __forceinline__ void copy_rows(E (*dst)[COLS], const E* src,
                                          long long stride, int t0, int Tn) {
  constexpr int PER = 16 / sizeof(E);  // values a piece
  constexpr int PIECES = CH * COLS / PER;
#pragma unroll
  for (int n = 0; n < (PIECES + THREADS - 1) / THREADS; ++n) {
    const int e = threadIdx.x + n * THREADS;
    const int c = e / (COLS / PER), x = e % (COLS / PER) * PER;
    if ((PIECES % THREADS == 0 || e < PIECES) && t0 + c < Tn)
      copy16(&dst[c][x], src + (long long)(t0 + c) * stride + x);
  }
}

template <typename T, int HD>
__device__ __forceinline__ void fetch(Stage<T, HD>& st, const T* rb,
                                      const T* kb, const float* wb,
                                      const T* vb, long long rt, long long kt,
                                      long long wt, long long vt, int t0,
                                      int Tn) {
  copy_rows<T, HD>(st.r, rb, rt, t0, Tn);
  copy_rows<T, HD>(st.k, kb, kt, t0, Tn);
  copy_rows<float, HD>(st.w, wb, wt, t0, Tn);
  copy_rows<T, JB>(st.v, vb, vt, t0, Tn);
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// step c of a chunk: this thread's rows of its two columns, and their
// part of y, joined across the two half-warps
template <typename T, int HD>
__device__ __forceinline__ void step(const Stage<T, HD>& cur,
                                     const float (&uks)[CH][HD],
                                     float (&yp)[CH][WARPS][JB],
                                     float (&S)[HD / PARTS][2], int c, int cp,
                                     int part, int jl) {
  constexpr int RPT = HD / PARTS;
  const float v0 = to_f32(cur.v[c][cp]), v1 = to_f32(cur.v[c][cp + 16]);
  const int at = part * RPT;  // the same for the half-warp
  float r_[RPT], uk_[RPT], k_[RPT], w_[RPT];
  load_rows(&cur.r[c][at], r_);
  load_rows(&uks[c][at], uk_);
  load_rows(&cur.k[c][at], k_);
  load_rows(&cur.w[c][at], w_);
  float y0 = 0.0f, y1 = 0.0f;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    y0 = fmaf(r_[i], fmaf(uk_[i], v0, S[i][0]), y0);
    y1 = fmaf(r_[i], fmaf(uk_[i], v1, S[i][1]), y1);
    S[i][0] = fmaf(w_[i], S[i][0], k_[i] * v0);
    S[i][1] = fmaf(w_[i], S[i][1], k_[i] * v1);
  }
  y0 += __shfl_xor_sync(0xffffffffu, y0, 16);  // the other half-warp
  y1 += __shfl_xor_sync(0xffffffffu, y1, 16);
  yp[c][threadIdx.x / 32][jl] = jl < 16 ? y0 : y1;
}

// 3 blocks an SM (<= 85 registers a thread), so that the main path's 320
// blocks are all resident at once on 132 SMs
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 3)
    rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ w,
                      const float* __restrict__ u, T* __restrict__ y,
                      float* __restrict__ s_out, Strides sr, Strides sk,
                      Strides sv, Strides sw, Strides sy, long long su,
                      int H, int Tn) {
  static_assert(HD % JB == 0 && THREADS % HD == 0, "unsupported head_dim");
  constexpr int RPT = HD / PARTS;       // state rows per thread
  __shared__ __align__(16) Stage<T, HD> stage[2];
  __shared__ __align__(16) float uks[CH][HD];
  __shared__ float yp[CH][WARPS][JB];  // each warp's partial sums of y

  const int tid = threadIdx.x;
  const int jl = tid % 32;  // lane; it stores y's partial sum of column jl
  const int cp = jl % 16;   // its columns cp and cp + 16 of the group
  const int part = 2 * (tid / 32) + jl / 16;  // its key rows' part
  const int j0 = blockIdx.x * JB;
  const int h = blockIdx.y, b = blockIdx.z;
  const T* rb = r + b * sr.b + h * sr.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const float* wb = w + b * sw.b + h * sw.h;
  const T* vb = v + b * sv.b + h * sv.h + j0;
  T* yb = y + b * sy.b + h * sy.h + j0 + jl;
  const int li = tid % HD;  // the key row whose u*k this thread forms
  const float ui = u[h * su + li];

  float S[RPT][2];  // rows part * RPT + i, columns cp and cp + 16
#pragma unroll
  for (int i = 0; i < RPT; ++i) S[i][0] = S[i][1] = 0.0f;

  fetch(stage[0], rb, kb, wb, vb, sr.t, sk.t, sw.t, sv.t, 0, Tn);
  for (int t0 = 0, it = 0; t0 < Tn; t0 += CH, ++it) {
    const Stage<T, HD>& cur = stage[it % 2];
    asm volatile("cp.async.wait_group 0;" ::: "memory");  // this chunk
    __syncthreads();  // its copies are visible; the last chunk is done
    if (t0 + CH < Tn)  // the next chunk flies while this one computes
      fetch(stage[(it + 1) % 2], rb, kb, wb, vb, sr.t, sk.t, sw.t, sv.t,
            t0 + CH, Tn);
    if (t0 > 0) {  // y of the last chunk: the 8 warps' sums, warp order
#pragma unroll
      for (int n = 0; n < CH * JB / THREADS; ++n) {
        const int c = (tid + n * THREADS) / JB;
        float yj = yp[c][0][jl];
#pragma unroll
        for (int q = 1; q < WARPS; ++q) yj += yp[c][q][jl];
        store(yb + (long long)(t0 - CH + c) * sy.t, yj);
      }
    }
#pragma unroll
    for (int n = 0; n < CH * HD / THREADS; ++n) {
      const int c = (tid + n * THREADS) / HD;
      uks[c][li] = ui * to_f32(cur.k[c][li]);
    }
    __syncthreads();
    if (t0 + CH <= Tn) {  // a whole chunk: no step to test
#pragma unroll
      for (int c = 0; c < CH; ++c)
        step<T, HD>(cur, uks, yp, S, c, cp, part, jl);
    } else {
#pragma unroll
      for (int c = 0; c < CH; ++c)
        if (t0 + c < Tn) step<T, HD>(cur, uks, yp, S, c, cp, part, jl);
    }
  }
  __syncthreads();
  const int tl = (Tn - 1) / CH * CH;  // the last chunk's y
#pragma unroll
  for (int n = 0; n < CH * JB / THREADS; ++n) {
    const int c = (tid + n * THREADS) / JB;
    if (tl + c < Tn) {
      float yj = yp[c][0][jl];
#pragma unroll
      for (int q = 1; q < WARPS; ++q) yj += yp[c][q][jl];
      store(yb + (long long)(tl + c) * sy.t, yj);
    }
  }

  float* sb = s_out + ((long long)b * H + h) * HD * HD +
              (long long)(part * RPT) * HD + j0 + cp;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    sb[i * HD] = S[i][0];
    sb[i * HD + 16] = S[i][1];
  }
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, void* y, float* s, int B, int H, int Tn,
           const long long* st, long long su, cudaStream_t stream) {
  const dim3 grid((unsigned)(HD / JB), (unsigned)H, (unsigned)B);
  rwkv6_scan_kernel<T, HD><<<grid, THREADS, 0, stream>>>(
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
  if (B < 1 || H < 1 || Tn < 1 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
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
