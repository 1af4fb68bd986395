// Causal flash-attention forward for Hopper (sm_90a): bf16 in, bf16 out,
// f32 softmax statistics.
//
// Replaces the TPU kernel upstream JAX's
// jax/experimental/pallas/ops/tpu/flash_attention.py::_flash_attention_impl
// (its pl.pallas_call), which tpu_cluster/workloads/burnin.py:220-227 reaches
// from forward() with attention="flash". It computes the same function, not
// the same blocks: O = softmax(Q K^T * sm_scale + causal mask) V, with the
// [S, S] scores never written to device memory. For training it also
// writes the residual the backward kernels (flash_attn_bwd_dkv.cu,
// flash_attn_bwd_dq.cu) need: where upstream's save_residuals=True returns
// the row max m and denominator l, this kernel stores one f32 per row,
// lse = m + log(l), the natural-log logsumexp of the scaled scores.
//
// Layout: q, k, v and o are [B, S, H, D] with arbitrary batch/seq/head
// strides (in elements) and D contiguous, the layout burnin.forward's
// projections produce, so no transpose copies are made.
//
// Design (simple and right first):
// - One CTA per (64-row query tile, head, batch); 4 warps, each owning 16
//   query rows. A loop inside the CTA walks the KV tiles (64 keys at
//   D = 128, 32 at D = 256) up to the causal diagonal; tiles wholly above
//   it are never loaded, and the tiles it crosses are masked.
// - Q, K and V tiles sit in dynamic shared memory (rows padded by 8 bf16 so
//   ldmatrix is free of bank conflicts): (64 + 2 x keys) x (D + 8) x 2
//   bytes, 52,224 at D = 128 and 67,584 at D = 256, above the 48 KB
//   default, hence cudaFuncSetAttribute before launch.
// - Registers: at D = 256 the f32 O accumulator alone is 128 a thread. With
//   64-key tiles ptxas capped the kernel at 255 registers and spilled
//   about 470 bytes a thread; 32-key tiles halve S and P (16 + 8
//   registers) and compile without spills.
// - Tensor cores through mma.sync.m16n8k16 (bf16 in, f32 accumulate), with
//   fragments loaded by ldmatrix (.trans for V). S = Q K^T stays in
//   registers; the online softmax runs on it in f32 with running max m and
//   denominator l; P is rounded to bf16 and fed straight from registers as
//   the A operand of P V; O accumulates in f32 registers (D/8 x 4 floats a
//   thread) and is divided by l once at the end.
// - cp.async overlaps the next K tile's copy with the softmax and P V, and
//   the next V tile's copy with Q K^T.
//
// What bounds it on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): at the
// serving shape B4 H16 S8192 D256 the causal useful work is 2*B*H*S^2*D =
// 2.20 TFLOP, 2.22 ms at peak, while the bytes (q, k, v read once, o written
// once: 4 x 268 MB = 1.07 GB) take 0.32 ms. It is compute-bound. What this
// design leaves on the table: mma.sync instead of wgmma (Hopper's full rate
// needs warpgroup MMA), per-thread cp.async instead of TMA, no warp
// specialisation, single-buffered K/V tiles, and every warp reading the
// whole K and V tile from shared memory.

#include "flash_common.cuh"

#include <math.h>

namespace {

using namespace flash;

constexpr int kBlockM = 64;   // query rows per CTA
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// kBlockN keys per KV tile.
template <int D, int kBlockN>
__global__ void __launch_bounds__(kThreads)
    flash_attn_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int64_t q_sb,
                          int64_t q_ss, int64_t q_sh, int64_t k_sb,
                          int64_t k_ss, int64_t k_sh, int64_t v_sb,
                          int64_t v_ss, int64_t v_sh, int64_t o_sb,
                          int64_t o_ss, int64_t o_sh, float sm_scale) {
  constexpr int kLd = D + kPad;
  constexpr int kDTiles = D / 8;      // n-tiles of 8 across D (the O tile)
  constexpr int kNTiles = kBlockN / 8;  // n-tiles of 8 across the keys
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kBlockM * kLd;
  __nv_bfloat16* sV = sK + kBlockN * kLd;

  // Longest causal rows first: the last query tiles walk the most KV tiles.
  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // row within the 8-row group of a fragment
  const int t = lane & 3;   // column pair within the fragment

  const __nv_bfloat16* q_base =
      q + b * q_sb + h * q_sh + static_cast<int64_t>(q_tile) * kBlockM * q_ss;
  const __nv_bfloat16* k_base = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* v_base = v + b * v_sb + h * v_sh;

  load_tile<D, kBlockM, kThreads>(sQ, q_base, q_ss);
  load_tile<D, kBlockN, kThreads>(sK, k_base, k_ss);
  cp_async_commit();
  load_tile<D, kBlockN, kThreads>(sV, v_base, v_ss);
  cp_async_commit();

  // ldmatrix addresses (flash_common.cuh): A = Q rows [warp*16, +16);
  // B = K^T (keys are the rows of sK); B = V (transposed load).
  const uint32_t q_addr =
      smem_u32(sQ + warp * 16 * kLd + a_offset(lane, kLd));
  const uint32_t k_addr = smem_u32(sK + b_offset(lane, kLd));
  const uint32_t v_addr = smem_u32(sV + bt_offset(lane, kLd));

  float acc[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }
  // Rows g and g + 8 of this warp's 16: running max and this thread's share
  // of the running denominator (summed over the quad at the end).
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  const int row0 = q_tile * kBlockM + warp * 16 + g;

  // KV tiles up to the causal diagonal of this query tile's last row.
  const int n_kv = (q_tile + 1) * (kBlockM / kBlockN);
  for (int j = 0; j < n_kv; ++j) {
    cp_async_wait<1>();  // K_j (and Q) landed; V_j may still be in flight
    __syncthreads();

    float s[kNTiles][4];
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, q_addr + kk * 16 * 2);
#pragma unroll
      for (int np = 0; np < kNTiles / 2; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, k_addr + (np * 16 * kLd + kk * 16) * 2);
        mma_bf16(s[2 * np], a, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }
    __syncthreads();  // every warp is done reading sK
    if (j + 1 < n_kv) {
      load_tile<D, kBlockN, kThreads>(
          sK, k_base + static_cast<int64_t>(j + 1) * kBlockN * k_ss, k_ss);
    }
    cp_async_commit();

    // Scale, then mask the tiles the diagonal crosses (key > row -> -inf).
    const bool diag = (j + 1) * kBlockN - 1 > q_tile * kBlockM;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * sm_scale;
        if (diag) {
          const int key = j * kBlockN + n * 8 + 2 * t + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          if (key > row) x = -INFINITY;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // Every row has key 0 <= row unmasked in tile 0, so m_new is finite
      // (a row wholly masked in a later tile keeps m and gets P = 0).
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = exp2f((m_run[r] - m_new) * kLog2e);
      m_run[r] = m_new;
    }
    // P = exp(s - m) in f32; the denominator sums the f32 values, P V takes
    // them rounded to bf16 (as burnin._chunked_attention does).
    float psum[2] = {0.f, 0.f};
    uint32_t p[kNTiles / 2][4];
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) {
      const float p0 = exp2f((s[n][0] - m_run[0]) * kLog2e);
      const float p1 = exp2f((s[n][1] - m_run[0]) * kLog2e);
      const float p2 = exp2f((s[n][2] - m_run[1]) * kLog2e);
      const float p3 = exp2f((s[n][3] - m_run[1]) * kLog2e);
      psum[0] += p0 + p1;
      psum[1] += p2 + p3;
      // C fragment of key tile n -> A fragment of the 16-key chunk n / 2.
      p[n / 2][(n & 1) * 2 + 0] = pack_bf16(p0, p1);
      p[n / 2][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + psum[r];
#pragma unroll
    for (int n = 0; n < kDTiles; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    cp_async_wait<1>();  // V_j landed; K_{j+1} may still be in flight
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, v_addr + (kk * 16 * kLd + dp * 16) * 2);
        mma_bf16(acc[2 * dp], p[kk], bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], p[kk], bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done reading sV
    if (j + 1 < n_kv) {
      load_tile<D, kBlockN, kThreads>(
          sV, v_base + static_cast<int64_t>(j + 1) * kBlockN * v_ss, v_ss);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();

  float l_tot[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_tot[r] = l;
  }
  // Row logsumexp of the scaled scores for the backward (natural log: m
  // is in the scores' units, l sums exp(s - m)); one lane per row.
  if (lse != nullptr && t == 0) {
    float* lse_row =
        lse + (static_cast<int64_t>(b) * gridDim.y + h) * gridDim.x * kBlockM;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lse_row[row0 + r * 8] = m_run[r] + logf(l_tot[r]);
    }
  }
  __nv_bfloat16* o_base = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    __nv_bfloat16* o_row = o_base + static_cast<int64_t>(row0 + r * 8) * o_ss;
#pragma unroll
    for (int n = 0; n < kDTiles; ++n) {
      const uint32_t packed = pack_bf16(acc[n][2 * r] / l_tot[r],
                                        acc[n][2 * r + 1] / l_tot[r]);
      *reinterpret_cast<uint32_t*>(o_row + n * 8 + 2 * t) = packed;
    }
  }
}

template <int D, int kBlockN>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int batch, int seq, int heads,
                   const int64_t* st, float sm_scale, cudaStream_t stream) {
  const int smem =
      (kBlockM + 2 * kBlockN) * (D + kPad) * static_cast<int>(sizeof(__nv_bfloat16));
  // Above 48 KB a launch is refused unless the kernel opts in.
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_fwd_kernel<D, kBlockN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(seq / kBlockM, heads, batch);
  flash_attn_fwd_kernel<D, kBlockN><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], sm_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the forward on `stream`; returns the cudaError_t of the launch
// (0 on success). Strides are in elements, per tensor (batch, seq, head);
// the head dimension must be contiguous. seq must be a multiple of 64 and
// head_dim 128 or 256; anything else returns cudaErrorInvalidValue. `lse`
// is null (nothing written) or a contiguous f32 [batch, heads, seq] buffer
// that receives each row's logsumexp of the scaled scores.
int flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                   void* lse, int batch, int seq, int heads, int head_dim,
                   int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
                   int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
                   int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh,
                   float sm_scale, void* stream) {
  if (seq <= 0 || seq % kBlockM != 0 || batch <= 0 || heads <= 0) {
    return cudaErrorInvalidValue;
  }
  const int64_t st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                          v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 128:
      return launch<128, 64>(q, k, v, o, static_cast<float*>(lse), batch,
                             seq, heads, st, sm_scale, s);
    case 256:
      // 32-key tiles: 64 spill at this width (see the note at the top)
      return launch<256, 32>(q, k, v, o, static_cast<float*>(lse), batch,
                             seq, heads, st, sm_scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* flash_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
