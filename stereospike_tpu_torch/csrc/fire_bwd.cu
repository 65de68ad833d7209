// Fused T-step integrate-and-fire backward for Hopper (sm_90a).
//
// Replaces the TPU kernel stereospike_tpu/snn/pallas_kernels.py::_bwd_kernel
// (launched by _ms_bwd), the custom-VJP backward of the fused fire whose
// forward is fire_fwd.cu. For every element m of M it first replays the
// forward from (x, v0, leak) in fp32,
//
//     h_t = v_{t-1} + x_t                                   (IF)
//     h_t = v_{t-1} + (x_t - (v_{t-1} - v_reset)) * leak    (LIF / PLIF)
//     s_t = (h_t - v_th >= 0) ? 1 : 0
//     v_t = (1 - s_t) * h_t + s_t * v_reset    (hard reset)
//     v_t = h_t - s_t * v_th                   (soft reset; v_reset = 0 is the rest)
//
// keeping v_{t-1}, then walks t = T-1 .. 0 with gv = gvT (zero when the
// caller has no gradient for vT, gvT == nullptr):
//
//     dh    = gs_t * sg(h_t - v_th) + gv * dv_t/dh_t
//     gx_t  = dh               (IF)   |  dh * leak        (LIF / PLIF)
//     gv    = dh               (IF)   |  dh * (1 - leak)  (LIF / PLIF)
//     gleak += dh * (x_t - (v_{t-1} - v_reset))           (PLIF only)
//
// and writes gx [T, M] and gv0 [M] in the I/O type, and adds the PLIF leak
// gradient into one fp32 scalar. sg is the surrogate derivative: ATan,
// alpha / (2 * (1 + (c * u)^2)) with c = pi/2 * alpha, or Sigmoid,
// alpha * s * (1 - s) with s = 1 / (1 + exp(-alpha * u)).
//
// dv_t/dh_t is (1 - s_t) for the detached hard reset (the default),
// (1 - s_t) + (v_reset - h_t) * sg for an undetached hard reset, 1 for the
// detached soft reset and 1 - v_th * sg for an undetached soft one. The
// default (the detached hard reset to 0) is its own template variant with
// the operations it had before the other modes were added; the others go
// through one GENERAL variant that reads the modes as uniform runtime flags,
// which would otherwise weigh on the default path's register replay.
//
// The replay never inverts the forward algebraically: (h - leak * x) /
// (1 - leak) divides by zero as leak -> 1. v_{t-1} is kept instead: in
// registers for T <= kRegSteps, in a caller-provided fp32 scratch [T, M]
// beyond that. At T = 1 there is nothing to replay (v_{-1} = v0).
//
// What bounds it: bytes. Per element it reads x, v0, gs and gvT and writes
// gx and gv0, (3T + 3) values (x is read twice when T > 1), against a few
// dozen flops, so the least time is bytes / 3.35 TB/s (H100 SXM HBM3). At
// the flagship StereoSpike's 13 sites at B=1, T=1, fp32, that is 283 MB,
// ~84 us; without gvT 236 MB.
//
// Design, as in fire_fwd.cu: one thread owns V consecutive elements (V =
// 16 bytes / sizeof(T): 4 floats or 8 bf16), with single 16-byte loads and
// stores, neighbouring threads on neighbouring addresses, grid-stride over
// M, a scalar path for the tail and for rows that are not 16-byte aligned.
// The PLIF leak gradient is summed per thread in fp32, reduced over the
// block with warp shuffles and shared memory, and added to the output with
// one atomicAdd per block; its order of summation differs from the plain
// version's, so it agrees to a tolerance, not bit for bit.
//
// The arithmetic uses the explicitly rounded intrinsics (__fadd_rn,
// __fmul_rn, __fsub_rn, __fdiv_rn), which nvcc never contracts into an FMA
// (the build also passes -fmad=false), in the order of the plain PyTorch
// version, so gx and gv0 agree with it bit for bit under ATan. Sigmoid goes
// through expf, which matches PyTorch's own sigmoid to an ulp or so.
//
// leak is read from device memory, so no host synchronisation is needed to
// launch. The kernel allocates nothing and runs on the caller's stream.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRegSteps = 8;   // T up to this keeps v_{t-1} in registers

enum Mode { kIF = 0, kLIF = 1, kPLIF = 2 };
enum Path { kOneStep = 0, kRegisters = 1, kScratch = 2 };
enum Surrogate { kATan = 0, kSigmoid = 1 };

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

// N elements starting at p: one 16-byte vector when N == V, else scalars.
template <typename T, int N>
__device__ __forceinline__ void load_n(const T* p, float (&out)[N]) {
  if constexpr (N == Io<T>::V) {
    Io<T>::load_vec(p, out);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = Io<T>::load(p + j);
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_n(T* p, const float (&in)[N]) {
  if constexpr (N == Io<T>::V) {
    Io<T>::store_vec(p, in);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) Io<T>::store(p + j, in[j]);
  }
}

struct Args {
  const void* x;
  const void* v0;
  const float* leak;
  const void* gs;
  const void* gvT;     // nullptr: no gradient for vT, read as zeros
  void* gx;
  void* gv0;
  float* gleak;        // fp32 scalar, accumulated (PLIF only)
  float* scratch;      // fp32 [T, M] of v_{t-1} (kScratch only)
  int64_t M;
  int steps;
  float v_th;
  float v_reset;
  int surrogate;
  float alpha;
  float c_atan;        // pi/2 * alpha, rounded once on the host
  int soft;            // 1: soft reset (v -= v_th), 0: hard reset to v_reset
  int detach;          // 1: the reset takes no gradient (the default)
};

// v - rest: v_reset is the rest potential (0 on the default path and with a
// soft reset)
template <bool GENERAL>
__device__ __forceinline__ float off_rest(float v, const Args& a) {
  return GENERAL ? __fsub_rn(v, a.v_reset) : v;
}

template <int MODE, bool GENERAL>
__device__ __forceinline__ float charge(float v, float x, float leak, const Args& a) {
  return MODE == kIF ? __fadd_rn(v, x)
                     : __fadd_rn(v, __fmul_rn(__fsub_rn(x, off_rest<GENERAL>(v, a)), leak));
}

// the membrane after the fire on the charged potential h
template <bool GENERAL>
__device__ __forceinline__ float reset(float h, const Args& a) {
  const float s = (__fsub_rn(h, a.v_th) >= 0.0f) ? 1.0f : 0.0f;
  if (GENERAL && a.soft) return __fsub_rn(h, __fmul_rn(s, a.v_th));
  return __fadd_rn(__fmul_rn(__fsub_rn(1.0f, s), h), __fmul_rn(s, a.v_reset));
}

__device__ __forceinline__ float surrogate_grad(float u, const Args& a) {
  if (a.surrogate == kATan) {
    const float s = __fmul_rn(a.c_atan, u);
    return __fdiv_rn(a.alpha, __fmul_rn(2.0f, __fadd_rn(1.0f, __fmul_rn(s, s))));
  }
  const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-__fmul_rn(a.alpha, u))));
  return __fmul_rn(__fmul_rn(a.alpha, sig), __fsub_rn(1.0f, sig));
}

// One group of N consecutive elements starting at m0: replay, then walk.
template <typename T, int MODE, int PATH, bool GENERAL, int N>
__device__ __forceinline__ void backward_group(const Args& a, float leak, int64_t m0,
                                               float& gleak_acc) {
  const T* x = static_cast<const T*>(a.x);
  const T* gs = static_cast<const T*>(a.gs);
  T* gx = static_cast<T*>(a.gx);
  const int64_t M = a.M;
  const int steps = PATH == kOneStep ? 1 : a.steps;

  float v[N];
  load_n<T, N>(static_cast<const T*>(a.v0) + m0, v);

  // replay: v_{t-1} for every t, kept in registers or in the scratch
  float vprev[PATH == kRegisters ? kRegSteps : 1][N];
  if constexpr (PATH != kOneStep) {
    float xs[N];
    if constexpr (PATH == kRegisters) {
#pragma unroll
      for (int t = 0; t < kRegSteps; ++t) {
        if (t < steps) {
          load_n<T, N>(x + int64_t(t) * M + m0, xs);
#pragma unroll
          for (int j = 0; j < N; ++j) {
            vprev[t][j] = v[j];
            v[j] = reset<GENERAL>(charge<MODE, GENERAL>(v[j], xs[j], leak, a), a);
          }
        }
      }
    } else {
      for (int t = 0; t < steps; ++t) {
        load_n<T, N>(x + int64_t(t) * M + m0, xs);
#pragma unroll
        for (int j = 0; j < N; ++j) {
          a.scratch[int64_t(t) * M + m0 + j] = v[j];
          v[j] = reset<GENERAL>(charge<MODE, GENERAL>(v[j], xs[j], leak, a), a);
        }
      }
    }
  }

  float gv[N];
  if (a.gvT != nullptr) {
    load_n<T, N>(static_cast<const T*>(a.gvT) + m0, gv);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) gv[j] = 0.0f;
  }

  // one step of the backward walk at t, with v_{t-1} in vp
  auto walk = [&](int t, const float (&vp)[N]) {
    float xs[N], g[N];
    load_n<T, N>(x + int64_t(t) * M + m0, xs);
    load_n<T, N>(gs + int64_t(t) * M + m0, g);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float h = charge<MODE, GENERAL>(vp[j], xs[j], leak, a);
      const float u = __fsub_rn(h, a.v_th);
      const float s = (u >= 0.0f) ? 1.0f : 0.0f;
      const float sg = surrogate_grad(u, a);
      float dvdh = __fsub_rn(1.0f, s);  // dv_t/dh_t
      if (GENERAL) {
        if (a.soft) {
          dvdh = a.detach ? 1.0f : __fsub_rn(1.0f, __fmul_rn(a.v_th, sg));
        } else if (!a.detach) {
          dvdh = __fadd_rn(dvdh, __fmul_rn(__fsub_rn(a.v_reset, h), sg));
        }
      }
      const float dh = __fadd_rn(__fmul_rn(g[j], sg), __fmul_rn(gv[j], dvdh));
      if (MODE == kIF) {
        g[j] = dh;
        gv[j] = dh;
      } else {
        g[j] = __fmul_rn(dh, leak);
        gv[j] = __fmul_rn(dh, __fsub_rn(1.0f, leak));
      }
      if (MODE == kPLIF) {
        gleak_acc = __fadd_rn(gleak_acc,
                              __fmul_rn(dh, __fsub_rn(xs[j], off_rest<GENERAL>(vp[j], a))));
      }
    }
    store_n<T, N>(gx + int64_t(t) * M + m0, g);
  };

  if constexpr (PATH == kOneStep) {
    walk(0, v);
  } else if constexpr (PATH == kRegisters) {
#pragma unroll
    for (int t = kRegSteps - 1; t >= 0; --t) {
      if (t < steps) walk(t, vprev[t]);
    }
  } else {
    for (int t = steps - 1; t >= 0; --t) {
      float vp[N];
#pragma unroll
      for (int j = 0; j < N; ++j) vp[j] = a.scratch[int64_t(t) * M + m0 + j];
      walk(t, vp);
    }
  }
  store_n<T, N>(static_cast<T*>(a.gv0) + m0, gv);
}

// VEC: the host found every row start 16-byte aligned (aligned base
// pointers, and M a multiple of V or T == 1), so elements [0, M / V * V)
// go through 16-byte vectors; the remainder, or everything when !VEC,
// goes through the scalar loop.
template <typename T, int MODE, int PATH, bool GENERAL, bool VEC>
__global__ void __launch_bounds__(kThreads)
fire_bwd_kernel(const Args a) {
  constexpr int V = Io<T>::V;
  const float leak = MODE == kIF ? 0.0f : *a.leak;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  const int64_t tid = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t n_vec = VEC ? a.M / V : 0;
  float gleak_acc = 0.0f;

  for (int64_t i = tid; i < n_vec; i += stride) {
    backward_group<T, MODE, PATH, GENERAL, V>(a, leak, i * V, gleak_acc);
  }
  for (int64_t m = n_vec * V + tid; m < a.M; m += stride) {
    backward_group<T, MODE, PATH, GENERAL, 1>(a, leak, m, gleak_acc);
  }

  if constexpr (MODE == kPLIF) {
    __shared__ float warp_sums[kThreads / 32];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      gleak_acc += __shfl_down_sync(0xffffffffu, gleak_acc, off);
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) warp_sums[warp] = gleak_acc;
    __syncthreads();
    if (warp == 0) {
      float s = lane < kThreads / 32 ? warp_sums[lane] : 0.0f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s += __shfl_down_sync(0xffffffffu, s, off);
      }
      if (lane == 0) atomicAdd(a.gleak, s);
    }
  }
}

template <typename T, int MODE, int PATH, bool GENERAL, bool VEC>
void launch(const Args& a, cudaStream_t stream) {
  const int64_t units = VEC ? a.M / Io<T>::V + a.M % Io<T>::V : a.M;
  int64_t blocks = (units + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > 65535 * 16) blocks = 65535 * 16;  // grid-stride covers the rest
  fire_bwd_kernel<T, MODE, PATH, GENERAL, VEC>
      <<<dim3(unsigned(blocks)), kThreads, 0, stream>>>(a);
}

template <typename T, int MODE, int PATH, bool GENERAL>
void dispatch_vec(const Args& a, int vec, cudaStream_t stream) {
  if (vec) launch<T, MODE, PATH, GENERAL, true>(a, stream);
  else     launch<T, MODE, PATH, GENERAL, false>(a, stream);
}

template <typename T, int MODE, bool GENERAL>
void dispatch_path(const Args& a, int vec, cudaStream_t stream) {
  if (a.steps == 1)              dispatch_vec<T, MODE, kOneStep, GENERAL>(a, vec, stream);
  else if (a.steps <= kRegSteps) dispatch_vec<T, MODE, kRegisters, GENERAL>(a, vec, stream);
  else                           dispatch_vec<T, MODE, kScratch, GENERAL>(a, vec, stream);
}

template <typename T, int MODE>
void dispatch_general(const Args& a, int vec, cudaStream_t stream) {
  // the detached hard reset to 0 takes the default variant
  const bool general = a.soft || !a.detach || a.v_reset != 0.0f;
  if (general) dispatch_path<T, MODE, true>(a, vec, stream);
  else         dispatch_path<T, MODE, false>(a, vec, stream);
}

template <typename T>
int dispatch_mode(const Args& a, int mode, int vec, cudaStream_t stream) {
  switch (mode) {
    case kIF:   dispatch_general<T, kIF>(a, vec, stream); return 0;
    case kLIF:  dispatch_general<T, kLIF>(a, vec, stream); return 0;
    case kPLIF: dispatch_general<T, kPLIF>(a, vec, stream); return 0;
    default:    return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Largest T whose replay stays in registers; a longer T needs `scratch`,
// an fp32 buffer of T * M floats.
int stereospike_fire_bwd_register_steps() { return kRegSteps; }

// dtype: 0 = float32, 1 = bfloat16. mode: 0 = IF, 1 = LIF (leak, no leak
// gradient), 2 = PLIF (leak and its gradient, added into *gleak, which the
// caller zeroes). surrogate: 0 = ATan, 1 = Sigmoid. gvT may be null.
// soft: 1 = soft reset, 0 = hard reset to v_reset, which is also the
// LIF/PLIF rest potential (the caller passes 0 with a soft reset); detach:
// 1 = the reset takes no gradient.
// Returns cudaGetLastError() after the launch (0 = cudaSuccess); a refused
// launch never runs, so the caller must check it.
int stereospike_fire_bwd(const void* x, const void* v0, const void* leak,
                         const void* gs, const void* gvT, void* gx, void* gv0,
                         void* gleak, void* scratch, long long M, int steps,
                         float v_th, float v_reset, int soft, int detach,
                         int surrogate, float alpha, float c_atan,
                         int dtype, int mode, int vec, void* stream) {
  if (steps < 1 || M < 0 || (surrogate != kATan && surrogate != kSigmoid) ||
      (steps > kRegSteps && scratch == nullptr) ||
      (mode != kIF && leak == nullptr) || (mode == kPLIF && gleak == nullptr)) {
    return int(cudaErrorInvalidValue);
  }
  Args a{x, v0, static_cast<const float*>(leak), gs, gvT, gx, gv0,
         static_cast<float*>(gleak), static_cast<float*>(scratch),
         int64_t(M), steps, v_th, v_reset, surrogate, alpha, c_atan, soft, detach};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == 0) {
    err = dispatch_mode<float>(a, mode, vec, s);
  } else if (dtype == 1) {
    err = dispatch_mode<__nv_bfloat16>(a, mode, vec, s);
  } else {
    return int(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return int(cudaGetLastError());
}

}  // extern "C"
