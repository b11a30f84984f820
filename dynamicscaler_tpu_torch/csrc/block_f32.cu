// Kernels 11 and 13 at fp32: the bodies of the whole spatial block and the
// whole spatial transformer, for a model run in float32. The fp32 twins of
// mega.cu::ds_spatial_block / ds_mega_spatial, with the same pointer
// layouts and the weights appended. (Kernels 10 and 12 at fp32, the whole
// temporal block and transformer, are in temporal_f32.cu, on the tensor
// cores.)
//
// Replaces, at fp32 activations, the TPU kernels
//   dynamicscaler_tpu/ops/fused_block.py::_spatial_block_call   (K11)
//   dynamicscaler_tpu/ops/fused_mega.py::_s_mega_call           (K13)
// which compute in x.dtype, so at float32 with no rounding point anywhere:
//   K11 body: h += out1(attnN(qkv)); h += out2(cross(LN2(h) @ Wq2, ctx K|V));
//        h += GEGLU(LN3(h)) @ W2 + b2, with qkv = LN1(x) @ Wqkv and the
//        context K|V projected before the launch (ds_ln_gemm_f32), as the
//        bf16 kernel's are;
//   K13 body: the same from h = proj_in(GN-apply(x)), then y = x + h @ W_out
//        + b_out.
// Everything multiplies and accumulates in fp32 on the CUDA cores (FFMA; TF32
// is not fp32); exponentials with expf, GELU with erff. spatial_f32_kernel,
// the one kernel of this file, is still the first version.
//
// What bounds them on the H100: operations. Per token the body multiplies
// by 16 C^2 weights (kernel 13's adds 2 C^2) beside the N-token attention,
// 2 operations each, against 8 C bytes in and out, hundreds of operations a
// byte at every width, far above the card's 67 TFLOP/s / 3.35 TB/s = 20.
//
// Design (simple and right first): a persistent grid of 256-thread blocks,
// each with a slot of global scratch (cuda_lib.block_f32_scratch: the
// normalised or attention rows [64, C] and the q or GEGLU rows [64, 4C];
// kernel 13 also its residual stream [64, C]), that takes tiles of 64 query
// tokens of one frame sample in turn and runs the whole body on them phase
// after phase, with a barrier between phases: LayerNorm a warp a row; every
// projection as a register-blocked SIMT GEMM of up to 64 rows x 128 weight
// rows a pass (a thread a 4 x 8 block, K in steps of 16 through a double
// buffer in shared memory, the next step's loads in registers while this
// one computes, the GEGLU value and gate rows in one pass); the N-token and
// the cross-attention as a flash tile of 64 queries a head
// (attention_f32.cuh::tile_flash, the tile of ds_flash_attention_f32: an
// online softmax over key tiles of 64 in shared memory, each key segment
// its own softmax, the normalised outputs summed). The scratch stays in L2
// between a block's phases as far as L2 holds it.
// Not done yet (later work): tensor cores through a 3xTF32 split (as
// temporal_f32.cu), tiles resident in shared memory through the block,
// weights shared across a cluster.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_f32.cuh"

namespace {

using namespace attn_f32;

constexpr int RM = 64;    // rows a GEMM pass; the spatial query tile
constexpr int BN = 128;   // weight rows a GEMM pass
constexpr int BK = 16;    // K a step
constexpr int APITCH = RM + 4, BPITCH = BN + 4;
constexpr int GEMM_FLOATS = 2 * BK * (APITCH + BPITCH);
constexpr int SMEM_FLOATS = GEMM_FLOATS > FLASH_FLOATS ? GEMM_FLOATS : FLASH_FLOATS;
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;

enum { EPI_STORE = 0, EPI_RESIDUAL = 1, EPI_GEGLU = 2 };

__device__ __forceinline__ float gelu_erf(float g) {
  return g * 0.5f * (1.0f + erff(g * 0.70710678118654752f));
}

// ---------------------------------------------------------------------------
// GEMM of a tile: Y(r)[n] = epi(sum_k A(r)[k] W[n, k]) for r < rows (<= 64)
// ---------------------------------------------------------------------------
// aload(r, k): the float4 of A's row r at columns k..k+3 (after its
// prologue); yrow(r) / rrow(r): output row r and its residual row. W [N, K]
// row-major (torch Linear layout), bias [N] or null. EPI_GEGLU: value rows
// n and gate rows N/2 + n of W, y = (v + b_v) * gelu(g + b_g), N/2 columns.
template <int EPI, class ALoad, class YRow, class RRow>
__device__ void tile_gemm(float* sm, int rows, int K, const float* __restrict__ W, int N,
                          const float* __restrict__ bias, ALoad aload, YRow yrow, RRow rrow) {
  float (*As)[BK][APITCH] = reinterpret_cast<float (*)[BK][APITCH]>(sm);
  float (*Bs)[BK][BPITCH] = reinterpret_cast<float (*)[BK][BPITCH]>(sm + 2 * BK * APITCH);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lr = tid >> 2, kc = (tid & 3) * 4;
  const int n_out = EPI == EPI_GEGLU ? N / 2 : N;
  constexpr int cols = EPI == EPI_GEGLU ? BN / 2 : BN;
  const int steps = K / BK;
  for (int n0 = 0; n0 < n_out; n0 += cols) {
    const float* brow[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = lr + 64 * i;
      int n;
      bool ok;
      if (EPI == EPI_GEGLU) {
        n = (r < 64 ? n0 + r : N / 2 + n0 + r - 64);
        ok = n0 + (r & 63) < n_out;
      } else {
        n = n0 + r;
        ok = n < N;
      }
      brow[i] = ok ? W + (size_t)n * K + kc : nullptr;
    }
    float4 ra, rb[2];
    auto load = [&](int k0) {
      ra = lr < rows ? aload(lr, k0 + kc) : zero4();
#pragma unroll
      for (int i = 0; i < 2; ++i) rb[i] = brow[i] ? __ldg(reinterpret_cast<const float4*>(brow[i] + k0)) : zero4();
    };
    auto store = [&](int buf) {
      As[buf][kc + 0][lr] = ra.x;
      As[buf][kc + 1][lr] = ra.y;
      As[buf][kc + 2][lr] = ra.z;
      As[buf][kc + 3][lr] = ra.w;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        Bs[buf][kc + 0][lr + 64 * i] = rb[i].x;
        Bs[buf][kc + 1][lr + 64 * i] = rb[i].y;
        Bs[buf][kc + 2][lr + 64 * i] = rb[i].z;
        Bs[buf][kc + 3][lr + 64 * i] = rb[i].w;
      }
    };
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    load(0);
    __syncthreads();  // the shared memory's last readers (a pass, a phase) are done
    store(0);
    __syncthreads();
    for (int st = 0; st < steps; ++st) {
      const int buf = st & 1;
      if (st + 1 < steps) load((st + 1) * BK);
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&As[buf][k][ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][k][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][k][64 + tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      if (st + 1 < steps) {
        store(buf ^ 1);
        __syncthreads();
      }
    }
    // epilogue: rows ty*4 + i, columns n0 + tx*4 + j (half 0) and n0 + 64 + tx*4 + j (half 1)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      if (r >= rows) continue;
      float* y = yrow(r);
      if (EPI == EPI_GEGLU) {
        const int c = n0 + tx * 4;
        if (c >= n_out) continue;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float val = acc[i][j], gate = acc[i][4 + j];
          if (bias) {
            val += __ldg(bias + c + j);
            gate += __ldg(bias + N / 2 + c + j);
          }
          v[j] = val * gelu_erf(gate);
        }
        *reinterpret_cast<float4*>(y + c) = make_float4(v[0], v[1], v[2], v[3]);
        continue;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = n0 + h * 64 + tx * 4;
        if (c >= n_out) continue;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[j] = acc[i][h * 4 + j];
          if (bias) v[j] += __ldg(bias + c + j);
        }
        if (EPI == EPI_RESIDUAL) {
          const float4 res = *reinterpret_cast<const float4*>(rrow(r) + c);
          v[0] += res.x; v[1] += res.y; v[2] += res.z; v[3] += res.w;
        }
        *reinterpret_cast<float4*>(y + c) = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }
  __syncthreads();  // Y is complete for the next phase
}

// A's rows r of a row-major [., lda] buffer from row base.
struct Rows {
  float* base;
  int ld;
  __device__ float* operator()(int r) const { return base + (size_t)r * ld; }
};

struct LoadRows {
  const float* base;
  int ld;
  __device__ float4 operator()(int r, int k) const {
    return *reinterpret_cast<const float4*>(base + (size_t)r * ld + k);
  }
};

// ---------------------------------------------------------------------------
// LayerNorm of rows < rows: a warp a row, flax's fast variance
// ---------------------------------------------------------------------------
__device__ void tile_ln(const float* src, int rows, int C, const float* __restrict__ w, const float* __restrict__ b,
                        float eps, float* dst) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += NT / 32) {
    const float* x = src + (size_t)r * C;
    float s = 0.f, ss = 0.f;
    for (int k = lane * 4; k < C; k += 128) {
      const float4 v = *reinterpret_cast<const float4*>(x + k);
      s += v.x + v.y + v.z + v.w;
      ss += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    }
    const float mu = s / (float)C;
    const float rstd = rsqrtf(fmaxf(0.f, ss / (float)C - mu * mu) + eps);
    float* y = dst + (size_t)r * C;
    for (int k = lane * 4; k < C; k += 128) {
      const float4 v = *reinterpret_cast<const float4*>(x + k);
      const float4 g = __ldg(reinterpret_cast<const float4*>(w + k));
      const float4 c = __ldg(reinterpret_cast<const float4*>(b + k));
      float4 o;
      o.x = __fadd_rn(__fmul_rn(__fsub_rn(v.x, mu), __fmul_rn(rstd, g.x)), c.x);
      o.y = __fadd_rn(__fmul_rn(__fsub_rn(v.y, mu), __fmul_rn(rstd, g.y)), c.y);
      o.z = __fadd_rn(__fmul_rn(__fsub_rn(v.z, mu), __fmul_rn(rstd, g.z)), c.z);
      o.w = __fadd_rn(__fmul_rn(__fsub_rn(v.w, mu), __fmul_rn(rstd, g.w)), c.w);
      *reinterpret_cast<float4*>(y + k) = o;
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// kernels 11 and 13 (the body after the context K|V and q|k|v projections)
// ---------------------------------------------------------------------------

struct SArgs {
  const float* h;    // [T, C] the block's input (K11: x; K13: proj_in's output)
  const float* x;    // K13: [T, C] the outer residual
  const float* qkv;  // [T, 3C] LN1(h) @ Wqkv: q | k | v
  const float* kv[2];  // [clips * len, 2C] K | V per segment (text, image)
  const float *bo1, *ln2_w, *ln2_b, *bo2, *ln3_w, *ln3_b, *b1, *b2, *b_out;
  float* out;
  const float *wo1, *wq2, *wo2, *w1, *w2, *w_out;
  float* scratch;
  long long slot;
  int BF, N, C, frames, len[2], nseg, q_tiles, tiles;
  float scale, eps;
};

template <bool MEGA>
__global__ void __launch_bounds__(NT, 2) spatial_f32_kernel(const SArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int C = a.C, heads = C / D;
  float* nrm = a.scratch + (size_t)blockIdx.x * a.slot;  // [64, C]
  float* big = nrm + (size_t)RM * C;                     // [64, 4C]
  float* rs = big + (size_t)RM * 4 * C;                  // K13: [64, C] the block's stream
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const int bf = tile / a.q_tiles, q0 = (tile % a.q_tiles) * RM;
    const int rows = min(RM, a.N - q0), clip = bf / a.frames;
    const size_t tok0 = (size_t)bf * a.N + q0;
    float* res = MEGA ? rs : a.out + tok0 * C;
    const float* src = a.h + tok0 * C;
    // h += out1(N-token self-attention)
    for (int h = 0; h < heads; ++h) {
      const float* fr = a.qkv + (size_t)bf * a.N * 3 * C + h * D;
      const Seg seg{fr + C, fr + 2 * C, 3 * C, a.N};
      tile_flash(sm, a.qkv + tok0 * 3 * C + h * D, 3 * C, rows, seg, seg, 1, a.scale, nrm + h * D, C);
    }
    tile_gemm<EPI_RESIDUAL>(sm, rows, C, a.wo1, C, a.bo1, LoadRows{nrm, C}, Rows{res, C},
                            Rows{const_cast<float*>(src), C});
    // h += out2(cross-attention of LN2(h) @ Wq2 over the clip's text (+ image) keys)
    tile_ln(res, rows, C, a.ln2_w, a.ln2_b, a.eps, nrm);
    tile_gemm<EPI_STORE>(sm, rows, C, a.wq2, C, nullptr, LoadRows{nrm, C}, Rows{big, C}, Rows{big, C});
    const int last = a.nseg - 1;
    for (int h = 0; h < heads; ++h) {
      const float* t = a.kv[0] + (size_t)clip * a.len[0] * 2 * C + h * D;
      const float* i = a.kv[last] + (size_t)clip * a.len[last] * 2 * C + h * D;
      tile_flash(sm, big + h * D, C, rows, Seg{t, t + C, 2 * C, a.len[0]}, Seg{i, i + C, 2 * C, a.len[last]}, a.nseg,
                 a.scale, nrm + h * D, C);
    }
    tile_gemm<EPI_RESIDUAL>(sm, rows, C, a.wo2, C, a.bo2, LoadRows{nrm, C}, Rows{res, C}, Rows{res, C});
    // h += GEGLU(LN3(h)) @ W2 + b2
    tile_ln(res, rows, C, a.ln3_w, a.ln3_b, a.eps, nrm);
    tile_gemm<EPI_GEGLU>(sm, rows, C, a.w1, 8 * C, a.b1, LoadRows{nrm, C}, Rows{big, 4 * C}, Rows{big, 4 * C});
    tile_gemm<EPI_RESIDUAL>(sm, rows, 4 * C, a.w2, C, a.b2, LoadRows{big, 4 * C}, Rows{res, C}, Rows{res, C});
    if (MEGA)  // y = x + h @ W_out + b_out
      tile_gemm<EPI_RESIDUAL>(sm, rows, C, a.w_out, C, a.b_out, LoadRows{rs, C}, Rows{a.out + tok0 * C, C},
                              Rows{const_cast<float*>(a.x) + tok0 * C, C});
  }
}

// Every kernel of this file may take SMEM_BYTES of dynamic shared memory (once).
cudaError_t prepare() {
  static cudaError_t done = [] {
    cudaError_t e = cudaSuccess;
    const int n = SMEM_BYTES;
    if (e == cudaSuccess) e = cudaFuncSetAttribute(spatial_f32_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, n);
    if (e == cudaSuccess) e = cudaFuncSetAttribute(spatial_f32_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, n);
    return e;
  }();
  return done;
}

template <typename K, typename A>
cudaError_t launch(K kernel, const A& a, int blocks, cudaStream_t stream) {
  const cudaError_t e = prepare();
  if (e != cudaSuccess) return e;
  kernel<<<blocks, NT, SMEM_BYTES, stream>>>(a);
  return cudaGetLastError();
}

const float* f(const void* p) { return static_cast<const float*>(p); }

// The floats of scratch a block needs: [64, C] + [64, 4C] (+ [64, C] for
// kernel 13).
long long slot_floats(int tt, int C, bool mega) { return (long long)tt * C * (mega ? 6 : 5); }

int spatial_run(const void* const* p, bool mega, int BF, int N, int C, int frames, int Lt, int Li, float scale,
                float eps, void* scratch, long long scratch_floats, int slots, void* stream) {
  if (C % 64 || C < 64 || C > 1280 || BF <= 0 || N <= 0 || N % 4 || frames <= 0 || BF % frames || Lt <= 0 ||
      Li < 0 || slots <= 0 || scratch == nullptr || (Li > 0 && p[4] == nullptr) || (mega && p[1] == nullptr))
    return (int)cudaErrorInvalidValue;
  SArgs a{};
  a.h = f(p[0]); a.x = f(p[1]); a.qkv = f(p[2]); a.kv[0] = f(p[3]); a.kv[1] = f(p[4]);
  a.bo1 = f(p[5]); a.ln2_w = f(p[6]); a.ln2_b = f(p[7]); a.bo2 = f(p[8]); a.ln3_w = f(p[9]); a.ln3_b = f(p[10]);
  a.b1 = f(p[11]); a.b2 = f(p[12]); a.b_out = f(p[13]);
  a.out = static_cast<float*>(const_cast<void*>(p[14]));
  a.wo1 = f(p[15]); a.wq2 = f(p[16]); a.wo2 = f(p[17]); a.w1 = f(p[18]); a.w2 = f(p[19]);
  a.w_out = mega ? f(p[20]) : nullptr;
  a.BF = BF; a.N = N; a.C = C; a.frames = frames;
  a.len[0] = Lt; a.len[1] = Li; a.nseg = Li > 0 ? 2 : 1;
  a.scale = scale; a.eps = eps;
  a.q_tiles = (N + RM - 1) / RM;
  const long long tiles = (long long)a.q_tiles * BF;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  a.tiles = (int)tiles;
  a.slot = slot_floats(RM, C, mega);
  const int blocks = (int)(tiles < slots ? tiles : slots);
  if (scratch_floats < a.slot * blocks) return (int)cudaErrorInvalidValue;
  a.scratch = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(mega ? launch(spatial_f32_kernel<true>, a, blocks, s) : launch(spatial_f32_kernel<false>, a, blocks, s));
}

}  // namespace

// p: ds_mega_spatial's 15 pointers (mega.cu), fp32: 0 h [T, C] (K11: x), 1 x
// [T, C] (K13 only), 2 qkv [T, 3C], 3 kv_t [clips * Lt, 2C], 4 kv_i [clips *
// Li, 2C] (or null, Li 0), 5 bo1, 6 ln2_w, 7 ln2_b, 8 bo2, 9 ln3_w, 10 ln3_b,
// 11 b1 [8C], 12 b2, 13 b_out (K13), 14 out [T, C]; then the weights 15 wo1
// [C, C], 16 wq2 [C, C], 17 wo2 [C, C], 18 w1 [8C, C], 19 w2 [C, 4C], 20 w_out
// [C, C] (K13). T = BF * N tokens, samples of N tokens, frames samples a
// clip. scratch: at least slots * 5 (K13: 6) * 64 * C floats.
extern "C" int ds_spatial_block_f32(const void* const* p, int BF, int N, int C, int frames, int Lt, int Li, float scale,
                                    float eps, void* scratch, long long scratch_floats, int slots, void* stream) {
  return spatial_run(p, false, BF, N, C, frames, Lt, Li, scale, eps, scratch, scratch_floats, slots, stream);
}

extern "C" int ds_mega_spatial_f32(const void* const* p, int BF, int N, int C, int frames, int Lt, int Li, float scale,
                                   float eps, void* scratch, long long scratch_floats, int slots, void* stream) {
  return spatial_run(p, true, BF, N, C, frames, Lt, Li, scale, eps, scratch, scratch_floats, slots, stream);
}
