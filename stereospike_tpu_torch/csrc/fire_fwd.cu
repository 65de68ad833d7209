// Fused T-step integrate-and-fire forward for Hopper (sm_90a).
//
// Replaces the TPU kernel stereospike_tpu/snn/pallas_kernels.py::_fwd_kernel
// (launched by _ms_forward). Over t = 0..T-1, for every element m of M:
//
//     h_t = v + x_t                               (IF)
//     h_t = v + (x_t - (v - v_reset)) * leak      (LIF / PLIF, leak = 1/tau or sigmoid(w))
//     s_t = (h_t - v_th >= 0) ? 1 : 0
//     v   = (1 - s_t) * h_t + s_t * v_reset       (hard reset)
//     v   = h_t - s_t * v_th                      (soft reset; v_reset = 0 is the rest)
//
// (whether the reset is detached matters to the backward only). Each reset
// is a template variant: the default hard reset to 0 runs the operations it
// ran before the rest potential and the soft reset were added.
//
// and writes spikes[T, M] and vT[M] in the I/O type. Arithmetic is fp32
// whatever the I/O type, as on the TPU.
//
// What bounds it: nothing but bytes. Each element does a handful of flops
// per step and moves (2T + 2) values (x and spikes per step, v0 and vT
// once), so the least time is bytes / 3.35 TB/s (H100 SXM HBM3). At the
// flagship StereoSpike's 13 sites at B=1, T=1 that is 188.6 MB, ~56 us.
//
// Design: one thread owns V consecutive elements (V = 16 bytes / sizeof(T):
// 4 floats or 8 bf16) and keeps their membrane in registers across the whole
// loop over T, so v never round-trips device memory and no shared memory is
// used. Loads and stores are single 16-byte vectors, neighbouring threads on
// neighbouring addresses. Elements past the last whole vector, and whole
// arrays whose rows are not 16-byte aligned, take a scalar path.
//
// The arithmetic uses the explicitly rounded intrinsics (__fadd_rn,
// __fmul_rn, __fsub_rn), which nvcc never contracts into an FMA, so the
// kernel rounds exactly where the plain PyTorch version does and agrees
// with it bit for bit at fp32 (the build also passes -fmad=false). A spike
// flipped at the threshold would change the depth map.
//
// leak is read from device memory (for PLIF it is sigmoid(w), computed on
// the device), so no host synchronisation is needed to launch. The kernel
// allocates nothing and runs on the caller's stream.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

template <typename T> struct Io;

template <> struct Io<float> {
  static constexpr int V = 4;
  __device__ static float load(const float* p) { return *p; }
  __device__ static void store(float* p, float v) { *p = v; }
  __device__ static void load_vec(const float* p, float (&out)[V]) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    out[0] = q.x; out[1] = q.y; out[2] = q.z; out[3] = q.w;
  }
  __device__ static void store_vec(float* p, const float (&in)[V]) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
};

template <> struct Io<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ static void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
  __device__ static void load_vec(const __nv_bfloat16* p, float (&out)[V]) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static void store_vec(__nv_bfloat16* p, const float (&in)[V]) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    }
    *reinterpret_cast<uint4*>(p) = q;
  }
};

// RESET: the hard reset to 0 (the default), a hard reset to v_reset != 0,
// a soft reset (the caller passes v_reset = 0, its rest potential)
enum Reset { kHardZero = 0, kHard = 1, kSoft = 2 };

template <bool IS_IF, int RESET>
__device__ __forceinline__ float fire_step(float& v, float x, float leak,
                                           float v_th, float v_reset) {
  const float off = RESET == kHard ? __fsub_rn(v, v_reset) : v;  // v - rest
  const float h = IS_IF ? __fadd_rn(v, x)
                        : __fadd_rn(v, __fmul_rn(__fsub_rn(x, off), leak));
  const float s = (__fsub_rn(h, v_th) >= 0.0f) ? 1.0f : 0.0f;
  v = RESET == kSoft ? __fsub_rn(h, __fmul_rn(s, v_th))
                     : __fadd_rn(__fmul_rn(__fsub_rn(1.0f, s), h), __fmul_rn(s, v_reset));
  return s;
}

// VEC: the host found every row start 16-byte aligned (aligned base
// pointers, and M a multiple of V or T == 1), so elements [0, M / V * V)
// go through 16-byte vectors; the remainder, or everything when !VEC,
// goes through the scalar loop.
template <typename T, bool IS_IF, int RESET, bool VEC>
__global__ void __launch_bounds__(256)
fire_fwd_kernel(const T* __restrict__ x, const T* __restrict__ v0,
                const float* __restrict__ leak_ptr, T* __restrict__ spikes,
                T* __restrict__ vT, int64_t M, int steps, float v_th,
                float v_reset) {
  using io = Io<T>;
  constexpr int V = io::V;
  const float leak = IS_IF ? 0.0f : *leak_ptr;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  const int64_t tid = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t n_vec = VEC ? M / V : 0;

  for (int64_t i = tid; i < n_vec; i += stride) {
    const int64_t base = i * V;
    float v[V], xs[V];
    io::load_vec(v0 + base, v);
    for (int t = 0; t < steps; ++t) {
      const int64_t row = int64_t(t) * M + base;
      io::load_vec(x + row, xs);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        xs[j] = fire_step<IS_IF, RESET>(v[j], xs[j], leak, v_th, v_reset);
      }
      io::store_vec(spikes + row, xs);
    }
    io::store_vec(vT + base, v);
  }

  for (int64_t m = n_vec * V + tid; m < M; m += stride) {
    float v = io::load(v0 + m);
    for (int t = 0; t < steps; ++t) {
      const int64_t idx = int64_t(t) * M + m;
      io::store(spikes + idx,
                fire_step<IS_IF, RESET>(v, io::load(x + idx), leak, v_th, v_reset));
    }
    io::store(vT + m, v);
  }
}

template <typename T, bool IS_IF, int RESET, bool VEC>
void launch(const void* x, const void* v0, const float* leak, void* spikes,
            void* vT, int64_t M, int steps, float v_th, float v_reset,
            cudaStream_t stream) {
  constexpr int threads = 256;
  const int64_t units = VEC ? M / Io<T>::V + M % Io<T>::V : M;
  int64_t blocks = (units + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > 65535 * 16) blocks = 65535 * 16;  // grid-stride covers the rest
  fire_fwd_kernel<T, IS_IF, RESET, VEC><<<dim3(unsigned(blocks)), threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(v0), leak,
      static_cast<T*>(spikes), static_cast<T*>(vT), M, steps, v_th, v_reset);
}

template <typename T, bool IS_IF, int RESET>
void dispatch_vec(const void* x, const void* v0, const float* leak, void* spikes,
                  void* vT, int64_t M, int steps, float v_th, float v_reset, int vec,
                  cudaStream_t stream) {
  if (vec) launch<T, IS_IF, RESET, true>(x, v0, leak, spikes, vT, M, steps, v_th, v_reset,
                                         stream);
  else     launch<T, IS_IF, RESET, false>(x, v0, leak, spikes, vT, M, steps, v_th, v_reset,
                                          stream);
}

template <typename T, bool IS_IF>
void dispatch_reset(const void* x, const void* v0, const float* leak, void* spikes,
                    void* vT, int64_t M, int steps, float v_th, float v_reset, int soft,
                    int vec, cudaStream_t stream) {
  if (soft) {
    dispatch_vec<T, IS_IF, kSoft>(x, v0, leak, spikes, vT, M, steps, v_th, v_reset, vec, stream);
  } else if (v_reset != 0.0f) {
    dispatch_vec<T, IS_IF, kHard>(x, v0, leak, spikes, vT, M, steps, v_th, v_reset, vec, stream);
  } else {
    dispatch_vec<T, IS_IF, kHardZero>(x, v0, leak, spikes, vT, M, steps, v_th, v_reset, vec,
                                      stream);
  }
}

template <typename T>
void dispatch(const void* x, const void* v0, const float* leak, void* spikes,
              void* vT, int64_t M, int steps, float v_th, float v_reset,
              int is_if, int soft, int vec, cudaStream_t stream) {
  if (is_if) {
    dispatch_reset<T, true>(x, v0, leak, spikes, vT, M, steps, v_th, v_reset, soft, vec,
                            stream);
  } else {
    dispatch_reset<T, false>(x, v0, leak, spikes, vT, M, steps, v_th, v_reset, soft, vec,
                             stream);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. soft: 0 = hard reset to v_reset, 1 =
// soft reset (v -= v_th). v_reset is also the LIF/PLIF rest potential: the
// caller passes 0 with a soft reset. Returns cudaGetLastError() after the
// launch (0 = cudaSuccess); a refused launch never runs, so the caller must
// check it.
int stereospike_fire_fwd(const void* x, const void* v0, const void* leak,
                         void* spikes, void* vT, long long M, int steps,
                         float v_th, float v_reset, int dtype, int is_if, int soft,
                         int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lk = static_cast<const float*>(leak);
  if (dtype == 0) {
    dispatch<float>(x, v0, lk, spikes, vT, M, steps, v_th, v_reset, is_if, soft, vec, s);
  } else if (dtype == 1) {
    dispatch<__nv_bfloat16>(x, v0, lk, spikes, vT, M, steps, v_th, v_reset, is_if, soft,
                            vec, s);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

}  // extern "C"
