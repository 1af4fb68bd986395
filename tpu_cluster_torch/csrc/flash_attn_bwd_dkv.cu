// Causal flash-attention backward, dK and dV, for Hopper (sm_90a): bf16 in,
// bf16 out, f32 accumulation.
//
// Replaces the TPU kernel upstream JAX's
// jax/experimental/pallas/ops/tpu/flash_attention.py::_flash_attention_bwd_dkv
// (its pl.pallas_call; kernel body _flash_attention_dkv_kernel), which the
// VJP of the flash path in tpu_cluster/workloads/burnin.py:220-227 reaches
// when loss_fn/train_step differentiate forward() with attention="flash".
// It computes the same function with upstream's roundings: per (query,
// key) pair, s = q.k * sm_scale in f32, p = exp(s - lse) (upstream:
// exp(s - m) / l; the two differ by f32 rounding only), dp = dO.v in f32,
// ds = p * (dp - di) * sm_scale; then dV = sum bf16(p) dO and
// dK = sum bf16(ds) q over the queries, accumulated in f32 and written
// as bf16. lse is K1's residual and di = rowsum(o * dO) (f32, computed
// outside, as upstream does in XLA).
//
// Layout: q, k, v, dO, dK and dV are [B, S, H, D] with arbitrary batch/seq/
// head strides (in elements) and D contiguous; lse and di are contiguous
// f32 [B, H, S].
//
// Design (simple and right first):
// - One CTA per (64-key tile, head, batch), 8 warps. A loop inside the CTA
//   walks the 64-query tiles from the causal diagonal to S (query tiles
//   wholly above the diagonal see no key of this tile); only the diagonal
//   tile is masked. CTAs of the first key tiles, which walk the most query
//   tiles, are launched first.
// - Registers: with one warp owning 16 keys x all of D for both dK and dV,
//   the accumulators alone would be 2 x 16 x 256 / 32 = 256 f32 a thread at
//   D = 256, over the 255 cap. So the work is split in two phases per query
//   tile, FlashAttention-2 style:
//   A. S^T = K Q^T and dP^T = V dO^T for the 64 x 64 (key, query) tile,
//      each warp a 16-key x 32-query block, in registers; P^T and dS^T
//      are computed there and stored to shared memory as bf16.
//   B. dV += P^T dO and dK += dS^T Q, each warp owning 16 keys x D/2
//      columns: 2 x 16 x (D/2) / 32 = 128 f32 accumulators a thread at
//      D = 256 (64 at D = 128), plus fragments.
// - Shared memory (rows padded by 8 bf16 so ldmatrix is conflict-free): K
//   and V tiles for the whole loop, Q and dO tiles double-buffered so the
//   next query tile's cp.async copy overlaps this one's products, the bf16
//   P^T and dS^T tiles, and the tile's lse and di: 6 x 64 x (D + 8) x 2 +
//   2 x 64 x 72 x 2 + 4 x 64 x 4 bytes, 222,208 at D = 256 and 123,904 at
//   D = 128, above the 48 KB default, hence cudaFuncSetAttribute.
// - Tensor cores through mma.sync.m16n8k16 (bf16 in, f32 accumulate) with
//   ldmatrix fragment loads (.trans for the Q and dO operands of phase B).
//
// What bounds it on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): at the
// training shape B1 H16 S8192 D256 it does four causal products (Q K^T
// again, dO V^T, P^T dO, dS^T Q), 4 x 2 x B x H x D x S(S+1)/2 = 1.10 TFLOP,
// 1.11 ms at peak, against 0.40 GB of bytes (q, k, v, dO read, dK, dV
// written, lse and di) in 0.12 ms: it is bound by operations. What this
// design leaves on the table: mma.sync instead of wgmma, cp.async instead
// of TMA, no warp specialisation, one CTA an SM (shared memory), and the
// P^T and dS^T round trip through shared memory.

#include "flash_common.cuh"

#include <math.h>

namespace {

using namespace flash;

constexpr int kBlockN = 64;  // keys per CTA
constexpr int kBlockM = 64;  // queries per inner tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kLdP = kBlockM + kPad;  // row stride of the P^T, dS^T tiles

template <int D>
constexpr int smem_bytes() {
  return 6 * 64 * (D + kPad) * 2 + 2 * kBlockN * kLdP * 2 +
         4 * kBlockM * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_attn_bwd_dkv_kernel(
        const __nv_bfloat16* __restrict__ q,
        const __nv_bfloat16* __restrict__ k,
        const __nv_bfloat16* __restrict__ v,
        const __nv_bfloat16* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ di,
        __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
        int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
        int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb,
        int64_t o_ss, int64_t o_sh, int64_t dk_sb, int64_t dk_ss,
        int64_t dk_sh, int64_t dv_sb, int64_t dv_ss, int64_t dv_sh,
        float sm_scale) {
  constexpr int kLd = D + kPad;
  constexpr int kTile = 64 * kLd;      // one 64-row bf16 tile
  constexpr int kHalf = D / 2;         // D columns per warp in phase B
  constexpr int kHTiles = kHalf / 8;   // 8-wide n tiles per warp in phase B
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + kTile;
  __nv_bfloat16* sQ = sV + kTile;       // [2] buffers
  __nv_bfloat16* sdO = sQ + 2 * kTile;  // [2] buffers
  __nv_bfloat16* sPt = sdO + 2 * kTile;
  __nv_bfloat16* sdSt = sPt + kBlockN * kLdP;
  float* sLse = reinterpret_cast<float*>(sdSt + kBlockN * kLdP);  // [2][64]
  float* sDi = sLse + 2 * kBlockM;                                // [2][64]

  const int kv_tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int seq = gridDim.x * kBlockN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // row within the 8-row group of a fragment
  const int t = lane & 3;   // column pair within the fragment
  const int wr = warp & 3;  // this warp's 16-key slab of the tile
  const int wc = warp >> 2; // its query half (phase A) or D half (phase B)

  const __nv_bfloat16* k_base = k + b * k_sb + h * k_sh +
                                static_cast<int64_t>(kv_tile) * kBlockN * k_ss;
  const __nv_bfloat16* v_base = v + b * v_sb + h * v_sh +
                                static_cast<int64_t>(kv_tile) * kBlockN * v_ss;
  const __nv_bfloat16* q_base = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* o_base = dout + b * o_sb + h * o_sh;
  const int64_t row_stats = (static_cast<int64_t>(b) * gridDim.y + h) * seq;
  const float* lse_base = lse + row_stats;
  const float* di_base = di + row_stats;

  // Query tile j into buffer `buf`: Q, dO, and its 64 lse and di values
  // (16 threads x 16 bytes each).
  auto load_query_tile = [&](int j, int buf) {
    load_tile<D, kBlockM, kThreads>(
        sQ + buf * kTile, q_base + static_cast<int64_t>(j) * kBlockM * q_ss,
        q_ss);
    load_tile<D, kBlockM, kThreads>(
        sdO + buf * kTile, o_base + static_cast<int64_t>(j) * kBlockM * o_ss,
        o_ss);
    if (threadIdx.x < 32) {
      const int i = threadIdx.x & 15;
      const float* src = (threadIdx.x < 16 ? lse_base : di_base) +
                         j * kBlockM + i * 4;
      float* dst = (threadIdx.x < 16 ? sLse : sDi) + buf * kBlockM + i * 4;
      cp_async16(smem_u32(dst), src);
    }
  };

  load_tile<D, kBlockN, kThreads>(sK, k_base, k_ss);
  load_tile<D, kBlockN, kThreads>(sV, v_base, v_ss);
  load_query_tile(kv_tile, 0);
  cp_async_commit();

  // Phase A operands: A = K, V rows of this warp's slab; B = Q^T, dO^T
  // (queries are the rows of sQ and sdO). Phase B operands: A = P^T, dS^T
  // rows of the slab; B = dO, Q (transposed loads, queries as k).
  const uint32_t k_addr = smem_u32(sK + wr * 16 * kLd + a_offset(lane, kLd));
  const uint32_t v_addr = smem_u32(sV + wr * 16 * kLd + a_offset(lane, kLd));
  const int qa_off = (wc * 32) * kLd + b_offset(lane, kLd);
  const uint32_t pt_addr =
      smem_u32(sPt + wr * 16 * kLdP + a_offset(lane, kLdP));
  const uint32_t dst_addr =
      smem_u32(sdSt + wr * 16 * kLdP + a_offset(lane, kLdP));
  const int qb_off = wc * kHalf + bt_offset(lane, kLd);

  float dv_acc[kHTiles][4];
  float dk_acc[kHTiles][4];
#pragma unroll
  for (int n = 0; n < kHTiles; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dv_acc[n][e] = dk_acc[n][e] = 0.f;
  }
  // This thread's two keys (rows g and g + 8 of the slab).
  const int key0 = kv_tile * kBlockN + wr * 16 + g;

  const int n_q = seq / kBlockM - kv_tile;
  for (int jj = 0; jj < n_q; ++jj) {
    const int j = kv_tile + jj;  // query tile
    const int buf = jj & 1;
    if (jj + 1 < n_q) load_query_tile(j + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and K, V) landed
    __syncthreads();

    // ---- Phase A: S^T and dP^T for 16 keys x 32 queries.
    const uint32_t q_addr = smem_u32(sQ + buf * kTile + qa_off);
    const uint32_t o_addr = smem_u32(sdO + buf * kTile + qa_off);
    float s[4][4];
    float dp[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ak[4], av[4];
      ldmatrix_x4(ak, k_addr + kk * 16 * 2);
      ldmatrix_x4(av, v_addr + kk * 16 * 2);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bq[4], bo[4];
        ldmatrix_x4(bq, q_addr + (np * 16 * kLd + kk * 16) * 2);
        mma_bf16(s[2 * np], ak, bq[0], bq[1]);
        mma_bf16(s[2 * np + 1], ak, bq[2], bq[3]);
        ldmatrix_x4(bo, o_addr + (np * 16 * kLd + kk * 16) * 2);
        mma_bf16(dp[2 * np], av, bo[0], bo[1]);
        mma_bf16(dp[2 * np + 1], av, bo[2], bo[3]);
      }
    }
    // P^T = exp(s * scale - lse[query]), zero where key > query (only the
    // diagonal tile has such pairs); dS^T = P^T (dP^T - di[query]) scale.
    const float* cLse = sLse + buf * kBlockM;
    const float* cDi = sDi + buf * kBlockM;
    const bool diag = jj == 0;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int col = wc * 32 + n * 8 + 2 * t;  // query within the tile
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = col + (e & 1);
        float pe = expf(s[n][e] * sm_scale - cLse[c]);
        if (diag && key0 + (e >> 1) * 8 > j * kBlockM + c) pe = 0.f;
        p[e] = pe;
        ds[e] = pe * (dp[n][e] - cDi[c]) * sm_scale;
      }
      const int row = wr * 16 + g;
      *reinterpret_cast<uint32_t*>(sPt + row * kLdP + col) =
          pack_bf16(p[0], p[1]);
      *reinterpret_cast<uint32_t*>(sPt + (row + 8) * kLdP + col) =
          pack_bf16(p[2], p[3]);
      *reinterpret_cast<uint32_t*>(sdSt + row * kLdP + col) =
          pack_bf16(ds[0], ds[1]);
      *reinterpret_cast<uint32_t*>(sdSt + (row + 8) * kLdP + col) =
          pack_bf16(ds[2], ds[3]);
    }
    __syncthreads();  // P^T and dS^T complete

    // ---- Phase B: dV += P^T dO, dK += dS^T Q over the 64 queries, for 16
    // keys x D/2 columns.
    const uint32_t ob_addr = smem_u32(sdO + buf * kTile + qb_off);
    const uint32_t qb_addr = smem_u32(sQ + buf * kTile + qb_off);
#pragma unroll
    for (int kk = 0; kk < kBlockM / 16; ++kk) {
      uint32_t ap[4], ads[4];
      ldmatrix_x4(ap, pt_addr + kk * 16 * 2);
      ldmatrix_x4(ads, dst_addr + kk * 16 * 2);
#pragma unroll
      for (int dp2 = 0; dp2 < kHTiles / 2; ++dp2) {
        uint32_t bo[4], bq[4];
        ldmatrix_x4_trans(bo, ob_addr + (kk * 16 * kLd + dp2 * 16) * 2);
        mma_bf16(dv_acc[2 * dp2], ap, bo[0], bo[1]);
        mma_bf16(dv_acc[2 * dp2 + 1], ap, bo[2], bo[3]);
        ldmatrix_x4_trans(bq, qb_addr + (kk * 16 * kLd + dp2 * 16) * 2);
        mma_bf16(dk_acc[2 * dp2], ads, bq[0], bq[1]);
        mma_bf16(dk_acc[2 * dp2 + 1], ads, bq[2], bq[3]);
      }
    }
    __syncthreads();  // this buffer and P^T, dS^T are free again
  }
  cp_async_wait<0>();

  __nv_bfloat16* dk_base = dk + b * dk_sb + h * dk_sh;
  __nv_bfloat16* dv_base = dv + b * dv_sb + h * dv_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t key = key0 + r * 8;
    __nv_bfloat16* dk_row = dk_base + key * dk_ss + wc * kHalf;
    __nv_bfloat16* dv_row = dv_base + key * dv_ss + wc * kHalf;
#pragma unroll
    for (int n = 0; n < kHTiles; ++n) {
      *reinterpret_cast<uint32_t*>(dk_row + n * 8 + 2 * t) =
          pack_bf16(dk_acc[n][2 * r], dk_acc[n][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv_row + n * 8 + 2 * t) =
          pack_bf16(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  }
}

template <int D>
cudaError_t launch(const void* const* ptr, int batch, int seq, int heads,
                   const int64_t* st, float sm_scale, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  static_assert(smem <= 232448, "over the 227 KB a block can use");
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_bwd_dkv_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(seq / kBlockN, heads, batch);
  flash_attn_bwd_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(ptr[0]),
      static_cast<const __nv_bfloat16*>(ptr[1]),
      static_cast<const __nv_bfloat16*>(ptr[2]),
      static_cast<const __nv_bfloat16*>(ptr[3]),
      static_cast<const float*>(ptr[4]), static_cast<const float*>(ptr[5]),
      static_cast<__nv_bfloat16*>(const_cast<void*>(ptr[6])),
      static_cast<__nv_bfloat16*>(const_cast<void*>(ptr[7])), st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      st[12], st[13], st[14], st[15], st[16], st[17], sm_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches dK, dV on `stream`; returns the cudaError_t of the launch (0 on
// success). Strides are in elements, per tensor (batch, seq, head) in the
// order q, k, v, dO, dK, dV; the head dimension must be contiguous. lse and
// di are contiguous f32 [batch, heads, seq]. seq must be a multiple of 64
// and head_dim 128 or 256; anything else returns cudaErrorInvalidValue.
int flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* di,
                       void* dk, void* dv, int batch, int seq, int heads,
                       int head_dim, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                       int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                       int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss,
                       int64_t o_sh, int64_t dk_sb, int64_t dk_ss,
                       int64_t dk_sh, int64_t dv_sb, int64_t dv_ss,
                       int64_t dv_sh, float sm_scale, void* stream) {
  if (seq <= 0 || seq % kBlockN != 0 || batch <= 0 || heads <= 0) {
    return cudaErrorInvalidValue;
  }
  const void* ptr[8] = {q, k, v, dout, lse, di, dk, dv};
  const int64_t st[18] = {q_sb,  q_ss,  q_sh,  k_sb,  k_ss,  k_sh,
                          v_sb,  v_ss,  v_sh,  o_sb,  o_ss,  o_sh,
                          dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 128:
      return launch<128>(ptr, batch, seq, heads, st, sm_scale, s);
    case 256:
      return launch<256>(ptr, batch, seq, heads, st, sm_scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* flash_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
