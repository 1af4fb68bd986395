// Causal flash-attention backward, dQ, for Hopper (sm_90a): bf16 in, bf16
// out, f32 accumulation.
//
// Replaces the TPU kernel upstream JAX's
// jax/experimental/pallas/ops/tpu/flash_attention.py::_flash_attention_bwd_dq
// (its pl.pallas_call; kernel body _flash_attention_dq_kernel), which the
// VJP of the flash path in tpu_cluster/workloads/burnin.py:220-227 reaches
// when loss_fn/train_step differentiate forward() with attention="flash".
// It computes the same function with upstream's roundings: per (query,
// key) pair, s = q.k * sm_scale in f32, p = exp(s - lse) (upstream:
// exp(s - m) / l; the two differ by f32 rounding only), dp = dO.v in f32,
// ds = p * (dp - di) * sm_scale; then dQ = sum bf16(ds) k over the keys,
// accumulated in f32 and written as bf16. Upstream's second output, dS, is
// written only when there is an attention bias; the burn-in model has
// none, so this kernel does not write it. It is a kernel of its own, as
// upstream's is: dQ needs no atomics across the key tiles, and its result
// is the same on every run.
//
// Layout: q, k, v, dO and dQ are [B, S, H, D] with arbitrary batch/seq/
// head strides (in elements) and D contiguous; lse and di are contiguous
// f32 [B, H, S].
//
// Design (simple and right first), K1's shape:
// - One CTA per (64-row query tile, head, batch); 4 warps, each owning 16
//   query rows. A loop inside the CTA walks the KV tiles (64 keys at
//   D = 128, 32 at D = 256) up to the causal diagonal; the tiles it
//   crosses are masked. The last query tiles, which walk the most KV
//   tiles, are launched first.
// - Registers: the f32 dQ accumulator is D/8 x 4 floats a thread (128 at
//   D = 256, as K1's O), beside S and dP for the KV tile; at D = 256 the
//   32-key tile keeps S and dP to 16 floats each.
// - Per KV tile: dP = dO V^T, S = Q K^T, then P and dS in f32 registers;
//   dS is rounded to bf16 and fed straight from registers as the A operand
//   of dS K (the C -> A fragment identity, flash_common.cuh).
// - Shared memory (rows padded by 8 bf16): Q and dO tiles for the whole
//   loop, one K and one V tile: (2 x 64 + 2 x keys) x (D + 8) x 2 bytes,
//   101,376 at D = 256 and 69,632 at D = 128, hence cudaFuncSetAttribute.
//   cp.async brings the next V tile while S, dS and dS K run, and the next
//   K tile while the next dP runs.
//
// What bounds it on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): at the
// training shape B1 H16 S8192 D256 it does three causal products (Q K^T
// again, dO V^T, dS K), 3 x 2 x B x H x D x S(S+1)/2 = 0.825 TFLOP,
// 0.834 ms at peak, against 0.34 GB of bytes (q, k, v, dO read, dQ written,
// lse and di) in 0.10 ms: it is bound by operations. What this design
// leaves on the table: mma.sync instead of wgmma, cp.async instead of TMA,
// no warp specialisation, single-buffered K and V tiles, and every warp
// reading the whole K and V tile from shared memory.

#include "flash_common.cuh"

#include <math.h>

namespace {

using namespace flash;

constexpr int kBlockM = 64;  // query rows per CTA
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// kBlockN keys per KV tile.
template <int D, int kBlockN>
__global__ void __launch_bounds__(kThreads)
    flash_attn_bwd_dq_kernel(
        const __nv_bfloat16* __restrict__ q,
        const __nv_bfloat16* __restrict__ k,
        const __nv_bfloat16* __restrict__ v,
        const __nv_bfloat16* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ di,
        __nv_bfloat16* __restrict__ dq, int64_t q_sb, int64_t q_ss,
        int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
        int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh,
        int64_t dq_sb, int64_t dq_ss, int64_t dq_sh, float sm_scale) {
  constexpr int kLd = D + kPad;
  constexpr int kDTiles = D / 8;        // n-tiles of 8 across D (the dQ tile)
  constexpr int kNTiles = kBlockN / 8;  // n-tiles of 8 across the keys
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sdO = sQ + kBlockM * kLd;
  __nv_bfloat16* sK = sdO + kBlockM * kLd;
  __nv_bfloat16* sV = sK + kBlockN * kLd;

  // Longest causal rows first: the last query tiles walk the most KV tiles.
  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int seq = gridDim.x * kBlockM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // row within the 8-row group of a fragment
  const int t = lane & 3;   // column pair within the fragment

  const __nv_bfloat16* q_base =
      q + b * q_sb + h * q_sh + static_cast<int64_t>(q_tile) * kBlockM * q_ss;
  const __nv_bfloat16* o_base = dout + b * o_sb + h * o_sh +
                                static_cast<int64_t>(q_tile) * kBlockM * o_ss;
  const __nv_bfloat16* k_base = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* v_base = v + b * v_sb + h * v_sh;

  // Groups in flight at the top of every iteration j: [V_j], [K_j].
  load_tile<D, kBlockM, kThreads>(sQ, q_base, q_ss);
  load_tile<D, kBlockM, kThreads>(sdO, o_base, o_ss);
  load_tile<D, kBlockN, kThreads>(sV, v_base, v_ss);
  cp_async_commit();
  load_tile<D, kBlockN, kThreads>(sK, k_base, k_ss);
  cp_async_commit();

  // A = Q, dO rows [warp*16, +16); B = K^T, V^T (keys are the rows of sK,
  // sV); B = K (transposed load, keys as k) for dS K.
  const uint32_t q_addr =
      smem_u32(sQ + warp * 16 * kLd + a_offset(lane, kLd));
  const uint32_t o_addr =
      smem_u32(sdO + warp * 16 * kLd + a_offset(lane, kLd));
  const uint32_t k_addr = smem_u32(sK + b_offset(lane, kLd));
  const uint32_t v_addr = smem_u32(sV + b_offset(lane, kLd));
  const uint32_t kt_addr = smem_u32(sK + bt_offset(lane, kLd));

  // Rows g and g + 8 of this warp's 16, and their lse and di.
  const int row0 = q_tile * kBlockM + warp * 16 + g;
  const int64_t row_stats = (static_cast<int64_t>(b) * gridDim.y + h) * seq;
  const float lse_r[2] = {lse[row_stats + row0], lse[row_stats + row0 + 8]};
  const float di_r[2] = {di[row_stats + row0], di[row_stats + row0 + 8]};

  float acc[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }

  // KV tiles up to the causal diagonal of this query tile's last row.
  const int n_kv = (q_tile + 1) * (kBlockM / kBlockN);
  for (int j = 0; j < n_kv; ++j) {
    cp_async_wait<1>();  // V_j (and Q, dO) landed; K_j may be in flight
    __syncthreads();

    float dp[kNTiles][4];
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) {
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, o_addr + kk * 16 * 2);
#pragma unroll
      for (int np = 0; np < kNTiles / 2; ++np) {
        uint32_t bv[4];
        ldmatrix_x4(bv, v_addr + (np * 16 * kLd + kk * 16) * 2);
        mma_bf16(dp[2 * np], a, bv[0], bv[1]);
        mma_bf16(dp[2 * np + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done reading sV
    if (j + 1 < n_kv) {
      load_tile<D, kBlockN, kThreads>(
          sV, v_base + static_cast<int64_t>(j + 1) * kBlockN * v_ss, v_ss);
    }
    cp_async_commit();

    cp_async_wait<1>();  // K_j landed; V_{j+1} may be in flight
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

    // P = exp(s * scale - lse), zero where key > row (only the tiles the
    // diagonal crosses have such pairs); dS = P (dP - di) scale, rounded to
    // bf16 into A fragments of 16-key chunks.
    const bool diag = (j + 1) * kBlockN - 1 > q_tile * kBlockM;
    uint32_t ds[kNTiles / 2][4];
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) {
      float d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = expf(s[n][e] * sm_scale - lse_r[r]);
        if (diag && j * kBlockN + n * 8 + 2 * t + (e & 1) > row0 + r * 8) {
          p = 0.f;
        }
        d[e] = p * (dp[n][e] - di_r[r]) * sm_scale;
      }
      ds[n / 2][(n & 1) * 2 + 0] = pack_bf16(d[0], d[1]);
      ds[n / 2][(n & 1) * 2 + 1] = pack_bf16(d[2], d[3]);
    }

    // dQ += dS K_j.
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
#pragma unroll
      for (int dp2 = 0; dp2 < D / 16; ++dp2) {
        uint32_t bk[4];
        ldmatrix_x4_trans(bk, kt_addr + (kk * 16 * kLd + dp2 * 16) * 2);
        mma_bf16(acc[2 * dp2], ds[kk], bk[0], bk[1]);
        mma_bf16(acc[2 * dp2 + 1], ds[kk], bk[2], bk[3]);
      }
    }
    __syncthreads();  // every warp is done reading sK
    if (j + 1 < n_kv) {
      load_tile<D, kBlockN, kThreads>(
          sK, k_base + static_cast<int64_t>(j + 1) * kBlockN * k_ss, k_ss);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();

  __nv_bfloat16* dq_base = dq + b * dq_sb + h * dq_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    __nv_bfloat16* dq_row =
        dq_base + static_cast<int64_t>(row0 + r * 8) * dq_ss;
#pragma unroll
    for (int n = 0; n < kDTiles; ++n) {
      *reinterpret_cast<uint32_t*>(dq_row + n * 8 + 2 * t) =
          pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
    }
  }
}

template <int D, int kBlockN>
cudaError_t launch(const void* const* ptr, int batch, int seq, int heads,
                   const int64_t* st, float sm_scale, cudaStream_t stream) {
  const int smem = (2 * kBlockM + 2 * kBlockN) * (D + kPad) *
                   static_cast<int>(sizeof(__nv_bfloat16));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_bwd_dq_kernel<D, kBlockN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(seq / kBlockM, heads, batch);
  flash_attn_bwd_dq_kernel<D, kBlockN><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(ptr[0]),
      static_cast<const __nv_bfloat16*>(ptr[1]),
      static_cast<const __nv_bfloat16*>(ptr[2]),
      static_cast<const __nv_bfloat16*>(ptr[3]),
      static_cast<const float*>(ptr[4]), static_cast<const float*>(ptr[5]),
      static_cast<__nv_bfloat16*>(const_cast<void*>(ptr[6])), st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      st[12], st[13], st[14], sm_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches dQ on `stream`; returns the cudaError_t of the launch (0 on
// success). Strides are in elements, per tensor (batch, seq, head) in the
// order q, k, v, dO, dQ; the head dimension must be contiguous. lse and di
// are contiguous f32 [batch, heads, seq]. seq must be a multiple of 64 and
// head_dim 128 or 256; anything else returns cudaErrorInvalidValue.
int flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* di,
                      void* dq, int batch, int seq, int heads, int head_dim,
                      int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
                      int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
                      int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh,
                      int64_t dq_sb, int64_t dq_ss, int64_t dq_sh,
                      float sm_scale, void* stream) {
  if (seq <= 0 || seq % kBlockM != 0 || batch <= 0 || heads <= 0) {
    return cudaErrorInvalidValue;
  }
  const void* ptr[7] = {q, k, v, dout, lse, di, dq};
  const int64_t st[15] = {q_sb, q_ss, q_sh, k_sb,  k_ss,  k_sh,  v_sb, v_ss,
                          v_sh, o_sb, o_ss, o_sh, dq_sb, dq_ss, dq_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 128:
      return launch<128, 64>(ptr, batch, seq, heads, st, sm_scale, s);
    case 256:
      return launch<256, 32>(ptr, batch, seq, heads, st, sm_scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* flash_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
