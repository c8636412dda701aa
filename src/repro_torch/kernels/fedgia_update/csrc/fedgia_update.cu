// FedGiA's fused client update, eqs (12)-(17) in closed form, for sm_90a.
//
// Replaces the Pallas kernels of src/repro/kernels/fedgia_update/kernel.py:
// `fedgia_update_batched_kernel` (body `_batched_kernel`),
// `fedgia_update_batched_kernel_donated` (same body, inputs aliased onto
// the outputs) and `fedgia_update_kernel` (body `_kernel`, one client).
// All three are this one kernel: the donated form passes input pointers
// as outputs, the single form is the m = 1 launch.
//
// Per element, with inv_m = 1/m and a per-row branch select sel:
//   d = 1/(h*inv_m + sigma),  a = 1 - sigma*d,  b = pi + g
//   ADMM arm (sel): pi' = a^(k0-1)*a*b - g,  x' = xbar - d*a^(k0-1)*b
//   GD arm:         pi' = -g,                 x' = xbar
//   z' = x' + pi'/sigma
//
// Operand forms. The anchor xbar is an (m, n) buffer (row stride n, the
// TPU kernels' form) or one (n,) vector read by every row (row stride 0,
// the round's x̄): a block keeps its float4 slice of it in registers while
// it walks its rows. h is an (m, n) buffer (diag_ema) or one float
// (scalar H = r), read once per block, which also makes d, a and a^(k0-1)
// per-block constants. x' is written only when x_out is not null: the
// round discards it (x̄ is the state's x). sel is the caller's bool
// tensor, one byte a row; sigma is a device pointer, so a launch needs no
// host sync and no side kernel, and a CUDA graph can replay it.
//
// Bound. ~15 flops per element against 12-28 bytes: far below the card's
// ~20 flops a byte, so bytes bound it where the buffers outgrow the 50 MB
// L2. The round's forms move at most 20*m*n bytes under diag_ema (read g,
// pi, h; write pi', z') and 16*m*n under scalar H (read g, pi; write pi',
// z'); the TPU forms 28*m*n (four (m, n) reads, three writes). A GD row
// (not selected) needs neither pi nor h, so only selected rows read them:
// at alpha = 0.5 the round's forms move ~16 and ~14 bytes an element, and
// the bound counts the rows that this call's sel selects. At the
// population size (16384 x 1024), 16 / 20 / 28 bytes an element take
// 80 / 100 / 140 us at 3.35 TB/s, so the design is one pass, each
// element read and written at most once, 16-byte vector accesses with
// neighbouring threads on neighbouring addresses, and a grid of 16 waves
// of the blocks of 256 threads that the SMs hold at once (by the
// occupancy API), whose blocks stride over the rows (at the population
// size a block takes one or two rows; at a million clients ~80, with its
// slice of x̄ kept in registers). At the paper's size (128 x 128, 64 KB
// an operand) the bytes take ~0.1 us, under one launch's fixed cost:
// there the round's launches bound it, which is the CUDA-graph round
// driver's work (core/engine.py), not this kernel's.
//
// Parity: built with --fmad=false and IEEE division (no fast math), and
// a^(k0-1) is computed by square-and-multiply in a fixed order, the same
// order as the plain version in ../ref.py and as JAX's lax.integer_pow;
// the per-block constants of the scalar form are the same operations on
// the same values, so every form is bitwise equal to the plain version.
// Each thread loads all of its inputs before it stores anything, so the
// outputs may alias the inputs element for element (donated form).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWaves = 16;

__device__ __forceinline__ float int_pow(float a, int k) {
  float acc = 1.0f;
  while (k > 0) {
    if (k & 1) acc = acc * a;
    k >>= 1;
    if (k > 0) a = a * a;
  }
  return acc;
}

// d, a^(k0-1)*a and d*a^(k0-1) of one h, in the plain version's order
struct Coef {
  float aka, dak;
};

__device__ __forceinline__ Coef coef(float h, float sigma, float inv_m,
                                     int k) {
  const float d = 1.0f / (h * inv_m + sigma);
  const float a = 1.0f - sigma * d;
  const float ak1 = int_pow(a, k);
  return {ak1 * a, d * ak1};
}

__device__ __forceinline__ void update(float xbar, float g, float pi, Coef c,
                                       float sigma, bool sel, float& x_out,
                                       float& pi_out, float& z_out) {
  float x_new = xbar;
  float pi_new = -g;
  if (sel) {
    const float base = pi + g;
    pi_new = c.aka * base - g;
    x_new = xbar - c.dak * base;
  }
  x_out = x_new;
  pi_out = pi_new;
  z_out = x_new + pi_new / sigma;
}

// No __restrict__: the donated launch passes the same buffers as inputs
// and outputs.
template <bool kRowAnchor, bool kScalarH, bool kWantX>
__global__ void __launch_bounds__(kThreads)
    fedgia_update_kernel(const float4* xbar, const float4* g,
                         const float4* pi, const float* h, float4* x_out,
                         float4* pi_out, float4* z_out, const uint8_t* sel,
                         const float* sigma_ptr, float inv_m, int k,
                         long long m, long long n4) {
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n4) return;
  const float sigma = *sigma_ptr;
  float4 xv;
  if (!kRowAnchor) xv = xbar[col];
  Coef cs;
  if (kScalarH) cs = coef(*h, sigma, inv_m, k);
  const float4* h4 = reinterpret_cast<const float4*>(h);
  for (long long row = blockIdx.y; row < m; row += gridDim.y) {
    const bool s = sel[row] != 0;
    const long long i = row * n4 + col;
    if (kRowAnchor) xv = xbar[i];
    const float4 gv = g[i];
    // the GD arm reads neither pi nor h (the branch is uniform over a row)
    float4 pv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    Coef cx = cs, cy = cs, cz = cs, cw = cs;
    if (s) {
      pv = pi[i];
      if (!kScalarH) {
        const float4 hv = h4[i];
        cx = coef(hv.x, sigma, inv_m, k);
        cy = coef(hv.y, sigma, inv_m, k);
        cz = coef(hv.z, sigma, inv_m, k);
        cw = coef(hv.w, sigma, inv_m, k);
      }
    }
    float4 xo, po, zo;
    update(xv.x, gv.x, pv.x, cx, sigma, s, xo.x, po.x, zo.x);
    update(xv.y, gv.y, pv.y, cy, sigma, s, xo.y, po.y, zo.y);
    update(xv.z, gv.z, pv.z, cz, sigma, s, xo.z, po.z, zo.z);
    update(xv.w, gv.w, pv.w, cw, sigma, s, xo.w, po.w, zo.w);
    if (kWantX) x_out[i] = xo;
    pi_out[i] = po;
    z_out[i] = zo;
  }
}

// One launch: column blocks of `threads` float4 lanes, and kWaves times
// as many row blocks as the SMs hold at once (by the occupancy of this
// instance), or one a row, whichever is fewer; a block's rows are a
// stride loop. Several waves, not one: a selected row reads three
// streams and a GD row one, so blocks of equal row counts take unequal
// times, and a grid of one resident wave waits for its slowest blocks,
// where later waves fill the SMs that finish first.
template <bool kRowAnchor, bool kScalarH, bool kWantX>
cudaError_t launch(int threads, cudaStream_t stream, const float* xbar,
                   const float* g, const float* pi, const float* h,
                   float* x_out, float* pi_out, float* z_out,
                   const uint8_t* sel, const float* sigma, float inv_m, int k,
                   long long m, long long n4) {
  auto kernel = fedgia_update_kernel<kRowAnchor, kScalarH, kWantX>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, 0);
  }
  if (err != cudaSuccess) return err;
  const long long col_blocks = (n4 + threads - 1) / threads;
  long long row_blocks = (long long)kWaves * sms * per_sm / col_blocks;
  if (row_blocks < 1) row_blocks = 1;
  if (row_blocks > m) row_blocks = m;
  if (row_blocks > 65535) row_blocks = 65535;
  const dim3 grid((unsigned)col_blocks, (unsigned)row_blocks);
  kernel<<<grid, threads, 0, stream>>>(
      reinterpret_cast<const float4*>(xbar),
      reinterpret_cast<const float4*>(g), reinterpret_cast<const float4*>(pi),
      h, reinterpret_cast<float4*>(x_out), reinterpret_cast<float4*>(pi_out),
      reinterpret_cast<float4*>(z_out), sel, sigma, inv_m, k, m, n4);
  return cudaGetLastError();
}

}  // namespace

// Row-major (m, n) fp32 buffers g, pi, pi_out, z_out (and x_out unless
// null), n % 128 == 0, 16-byte aligned. xbar: (m, n) with xbar_stride ==
// n, or (n,) with xbar_stride == 0. h: (m, n), or one float when
// h_scalar. sel: (m,) bytes (a bool tensor), 0 = GD arm. sigma: one fp32
// on the device. Returns the cudaError_t of the launch (0 on success);
// never synchronises.
extern "C" int fedgia_update_launch(const float* xbar, long long xbar_stride,
                                    const float* g, const float* pi,
                                    const float* h, int h_scalar,
                                    float* x_out, float* pi_out, float* z_out,
                                    const uint8_t* sel, const float* sigma,
                                    float inv_m, int k0, long long m,
                                    long long n, void* stream) {
  if (m <= 0 || n <= 0 || n % 128 != 0 || k0 < 1 ||
      (xbar_stride != 0 && xbar_stride != n)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n4 = n / 4;  // a multiple of 32
  const int threads = n4 < kThreads ? (int)n4 : kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int k = k0 - 1;
  const bool rows = xbar_stride != 0, scalar = h_scalar != 0;
  const bool want_x = x_out != nullptr;
#define FEDGIA_LAUNCH(R, S, X)                                        \
  launch<R, S, X>(threads, s, xbar, g, pi, h, x_out, pi_out, z_out, sel, \
                  sigma, inv_m, k, m, n4)
  cudaError_t err;
  if (rows) {
    if (scalar) {
      err = want_x ? FEDGIA_LAUNCH(true, true, true)
                   : FEDGIA_LAUNCH(true, true, false);
    } else {
      err = want_x ? FEDGIA_LAUNCH(true, false, true)
                   : FEDGIA_LAUNCH(true, false, false);
    }
  } else {
    if (scalar) {
      err = want_x ? FEDGIA_LAUNCH(false, true, true)
                   : FEDGIA_LAUNCH(false, true, false);
    } else {
      err = want_x ? FEDGIA_LAUNCH(false, false, true)
                   : FEDGIA_LAUNCH(false, false, false);
    }
  }
#undef FEDGIA_LAUNCH
  return (int)err;
}
