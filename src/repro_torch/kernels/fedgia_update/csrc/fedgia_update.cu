// FedGiA's fused client update, eqs (12)-(17) in closed form, for sm_90a.
//
// Replaces the Pallas kernels of src/repro/kernels/fedgia_update/kernel.py:
// `fedgia_update_batched_kernel` (body `_batched_kernel`),
// `fedgia_update_batched_kernel_donated` (same body, inputs aliased onto
// the outputs) and `fedgia_update_kernel` (body `_kernel`, one client).
// All three are this one kernel: the donated form passes the input
// pointers as outputs, the single form is the m = 1 launch.
//
// Per element, with inv_m = 1/m and a per-row branch select sel:
//   d = 1/(h*inv_m + sigma),  a = 1 - sigma*d,  b = pi + g
//   ADMM arm (sel): pi' = a^(k0-1)*a*b - g,  x' = xbar - d*a^(k0-1)*b
//   GD arm:         pi' = -g,                 x' = xbar
//   z' = x' + pi'/sigma
//
// Bound: bytes. Four (m, N) fp32 reads and three writes, 28*m*N bytes of
// HBM traffic for ~15 flops per element (well under one flop per byte),
// so the floor is 28*m*N / 3.35 TB/s on an H100 SXM. The design follows:
// one pass, each element read once and written once, 16-byte vector
// loads and stores (float4) with neighbouring threads on neighbouring
// addresses, no shared memory. Grid (row blocks of N, clients): each
// block reads its own row's sel once; sigma comes from a device pointer
// so a round needs no host sync. Rows beyond gridDim.y are walked by a
// stride loop, so any m launches.
//
// Parity: built with --fmad=false and IEEE division (no fast math), and
// a^(k0-1) is computed by square-and-multiply in a fixed order, the same
// order as the plain version in ../ref.py and as JAX's lax.integer_pow.
// Each thread loads all of its inputs before it stores anything, so the
// outputs may alias the inputs element for element (donated form).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float int_pow(float a, int k) {
  float acc = 1.0f;
  while (k > 0) {
    if (k & 1) acc = acc * a;
    k >>= 1;
    if (k > 0) a = a * a;
  }
  return acc;
}

__device__ __forceinline__ void update(float xbar, float g, float pi, float h,
                                       float sigma, float inv_m, int k,
                                       bool sel, float& x_out, float& pi_out,
                                       float& z_out) {
  float x_new = xbar;
  float pi_new = -g;
  if (sel) {
    const float d = 1.0f / (h * inv_m + sigma);
    const float a = 1.0f - sigma * d;
    const float base = pi + g;
    const float ak1 = int_pow(a, k);
    pi_new = ak1 * a * base - g;
    x_new = xbar - d * ak1 * base;
  }
  x_out = x_new;
  pi_out = pi_new;
  z_out = x_new + pi_new / sigma;
}

// No __restrict__: the donated launch passes the same buffers as inputs
// and outputs.
__global__ void fedgia_update_kernel(const float4* xbar, const float4* g,
                                     const float4* pi, const float4* h,
                                     float4* x_out, float4* pi_out,
                                     float4* z_out, const int32_t* sel,
                                     const float* sigma_ptr, float inv_m,
                                     int k, long long m, long long n4) {
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n4) return;
  const float sigma = *sigma_ptr;
  for (long long row = blockIdx.y; row < m; row += gridDim.y) {
    const bool s = sel[row] != 0;
    const long long i = row * n4 + col;
    const float4 xv = xbar[i];
    const float4 gv = g[i];
    const float4 pv = pi[i];
    const float4 hv = h[i];
    float4 xo, po, zo;
    update(xv.x, gv.x, pv.x, hv.x, sigma, inv_m, k, s, xo.x, po.x, zo.x);
    update(xv.y, gv.y, pv.y, hv.y, sigma, inv_m, k, s, xo.y, po.y, zo.y);
    update(xv.z, gv.z, pv.z, hv.z, sigma, inv_m, k, s, xo.z, po.z, zo.z);
    update(xv.w, gv.w, pv.w, hv.w, sigma, inv_m, k, s, xo.w, po.w, zo.w);
    x_out[i] = xo;
    pi_out[i] = po;
    z_out[i] = zo;
  }
}

}  // namespace

// Row-major (m, n) fp32 buffers, n % 128 == 0, 16-byte aligned; sel (m,)
// int32; sigma one fp32 on the device. Returns the cudaError_t of the
// launch (0 on success); never synchronises.
extern "C" int fedgia_update_launch(const float* xbar, const float* g,
                                    const float* pi, const float* h,
                                    float* x_out, float* pi_out, float* z_out,
                                    const int32_t* sel, const float* sigma,
                                    float inv_m, int k0, long long m,
                                    long long n, void* stream) {
  if (m <= 0 || n <= 0 || n % 128 != 0 || k0 < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n4 = n / 4;  // a multiple of 32
  const int threads = n4 < 256 ? (int)n4 : 256;
  const dim3 grid((unsigned)((n4 + threads - 1) / threads),
                  (unsigned)(m < 65535 ? m : 65535));
  fedgia_update_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(xbar), reinterpret_cast<const float4*>(g),
      reinterpret_cast<const float4*>(pi), reinterpret_cast<const float4*>(h),
      reinterpret_cast<float4*>(x_out), reinterpret_cast<float4*>(pi_out),
      reinterpret_cast<float4*>(z_out), sel, sigma, inv_m, k0 - 1, m, n4);
  return (int)cudaGetLastError();
}
