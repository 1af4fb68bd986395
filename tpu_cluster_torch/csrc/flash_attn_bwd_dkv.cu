// Causal flash-attention backward, dK and dV, for Hopper (sm_90a): bf16 in,
// bf16 out, f32 accumulation; TMA-fed, warp-specialised, wgmma-based.
//
// Replaces the TPU kernel upstream JAX's
// jax/experimental/pallas/ops/tpu/flash_attention.py::_flash_attention_bwd_dkv
// (its pl.pallas_call; kernel body _flash_attention_dkv_kernel), which the
// VJP of the flash path in tpu_cluster/workloads/burnin.py:220-227 reaches
// when loss_fn/train_step differentiate forward() with attention="flash".
// It computes the same function with upstream's roundings: per (query,
// key) pair, s = q.k * sm_scale in f32, p = exp(s - lse) (upstream:
// exp(s - m) / l; the two differ by f32 rounding only), dp = dO.v in f32,
// ds = p * (dp - di) * sm_scale with the f32 p; then dV = sum bf16(p) dO
// and dK = sum bf16(ds) q over the queries, accumulated in f32 and written
// as bf16. lse is K1's residual and di = rowsum(o * dO) (f32, computed
// outside, as upstream does in XLA). Each output tile has one writer (no
// atomics), so two calls on the same inputs give the same bits.
//
// Layout: q, k, v, dO, dK and dV are [B, S, H, D] with arbitrary batch/seq/
// head strides (in elements, multiples of 8) and D contiguous; lse and di
// are contiguous f32 [B, H, S].
//
// What bounds it on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): at the
// training shape B1 H16 S8192 D256 it does four causal products (Q K^T
// again, dO V^T, P^T dO, dS^T Q), 4 x 2 x B x H x D x S(S+1)/2 = 1.10 TFLOP,
// 1.11 ms at peak, against 0.40 GB of bytes (q, k, v, dO read, dK, dV
// written, lse and di) in 0.12 ms: it is bound by operations. The design
// keeps the tensor cores fed the way K1 (flash_attn_fwd.cu) does:
//
// - One CTA per (64-key tile, head, batch), 384 threads in three
//   warpgroups. A loop inside the CTA walks the 64-query tiles from the
//   causal diagonal to S (query tiles wholly above the diagonal see no key
//   of this tile); only the diagonal tile is masked. CTAs of the first key
//   tiles, which walk the most query tiles, are launched first. S is a
//   multiple of 64, so no tile has a ragged edge.
// - Warpgroup 0 is the producer (setmaxnreg to 40): one thread issues every
//   load by TMA through 4-D tensor maps over the strided views (box 64 x 1
//   x 64 x 1, 128-byte swizzle): K and V of the tile once, then Q and dO of
//   each query tile into a ring of two stages, each with a full barrier
//   (TMA bytes) and an empty barrier on which all 256 consumer threads
//   arrive.
// - The two consumer warpgroups (setmaxnreg to 232) split the work, because
//   one warpgroup owning 64 keys x D of both dK and dV would need
//   2 x 64 x 256 / 128 = 256 f32 accumulators a thread at D = 256, over the
//   cap. Warpgroup 1 owns dV: S^T = K Q^T by wgmma m64n64k16 with both
//   operands from shared memory (K-major), the causal mask on the diagonal
//   tile, P^T = exp2(S^T sm_scale log2(e) - lse log2(e)) in f32 registers
//   (lse indexed by column); it hands the f32 P^T to warpgroup 2 through
//   shared memory (16 KB, each thread's 32 values at the same place its
//   peer of warpgroup 2 reads them: both accumulators have one layout),
//   then packs bf16 P^T in place as the register A operand of
//   dV += P^T dO, wgmma m64n{D}k16 with dO as an MN-major B (as V in K1's
//   P V). Warpgroup 2 owns dK: dP^T = V dO^T (SS, m64n64k16), waits on a
//   named barrier for P^T, dS^T = P^T (dP^T - di) sm_scale, and bf16 dS^T
//   in place as the A operand of dK += dS^T Q (Q MN-major). A second named
//   barrier tells warpgroup 1 that the P^T buffer is free again. Each
//   warpgroup does two of the four products: 128 accumulators a thread at
//   D = 256 (64 at D = 128) and 32 of the 64 x 64 tile.
// - lse and di: each consumer thread reads the 16 values of its columns
//   straight from device memory (L2) before the tile's first product, so
//   their latency hides behind it. Unlike the bulk copy or 2-D tensor map
//   that was the first plan, this asks nothing of the alignment of lse and
//   di, so the entry point takes what it took before.
// - Epilogue: dV (warpgroup 1) and dK (warpgroup 2) rounded to bf16 and
//   stored from registers.
//
// Budget: shared memory K + V (64 x D each) + 2 stages x (Q + dO) (64 x D
// each) + P^T 16 KB + barriers: 214,056 bytes at D = 256 (115,752 at
// D = 128) with the 1024 bytes that align the base, so one CTA per SM.
// D = 128 keeps the D = 256 shape (64-key tiles, one product pair per
// warpgroup) at half the accumulators.
//
// What the design still leaves on the table: within a warpgroup the
// products of one query tile do not overlap the next tile's (each waits
// for its wgmma before the exp or dS step), warpgroup 2 idles while
// warpgroup 1 computes P^T, and CTAs are not persistent.

#include "hopper_common.cuh"

#include <math.h>

namespace {

using namespace hopper;

constexpr int kBlockN = 64;  // keys per CTA
constexpr int kBlockM = 64;  // queries per tile of the walk
constexpr int kThreads = 384;  // producer + two consumer warpgroups
constexpr int kConsumerThreads = 256;
constexpr int kStages = 2;
constexpr int kPanel = 64;  // bf16 per 128-byte swizzled row
constexpr int kPanelRowBytes = 128;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;
// Named barriers between the consumers over the P^T buffer.
constexpr int kBarPFull = 1;   // warpgroup 1 wrote P^T
constexpr int kBarPEmpty = 2;  // warpgroup 2 read it

// Dynamic shared memory, in bytes from a 1024-byte-aligned base.
template <int D>
struct Layout {
  static constexpr int kTileBytes = 64 * D * 2;  // K, V, or one Q or dO stage
  static constexpr int kK = 0;
  static constexpr int kV = kK + kTileBytes;
  static constexpr int kQ = kV + kTileBytes;              // + stage
  static constexpr int kdO = kQ + kStages * kTileBytes;   // + stage
  static constexpr int kP = kdO + kStages * kTileBytes;   // f32 P^T
  static constexpr int kPBytes = kBlockN * kBlockM * 4;
  // mbarriers: kv_full, full[kStages], empty[kStages]
  static constexpr int kBars = kP + kPBytes;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages);
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attn_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do,
                              const float* __restrict__ lse,
                              const float* __restrict__ di,
                              __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, int seq,
                              int64_t dk_sb, int64_t dk_ss, int64_t dk_sh,
                              int64_t dv_sb, int64_t dv_ss, int64_t dv_sh,
                              float sm_scale) {
  using L = Layout<D>;
  constexpr int kPanels = D / kPanel;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sK = base + L::kK;
  const uint32_t sV = base + L::kV;
  const uint32_t sQ = base + L::kQ;
  const uint32_t sdO = base + L::kdO;
  float4* sP = reinterpret_cast<float4*>(smem_raw + (base - raw) + L::kP);
  const uint32_t kv_full = base + L::kBars;
  const uint32_t full = kv_full + 8;             // + 8 * stage
  const uint32_t empty = full + 8 * kStages;     // + 8 * stage

  const int kv_tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  // Query tiles from the diagonal (kv_tile) to S.
  const int n_q = seq / kBlockM - kv_tile;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerThreads);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // The roles never reconverge: setmaxnreg needs one branch per role.
  if (threadIdx.x < 128) {
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * L::kTileBytes);
      for (int p = 0; p < kPanels; ++p) {
        tma_load_4d(sK + p * kBlockN * kPanelRowBytes, &tm_k, kv_full,
                    p * kPanel, h, kv_tile * kBlockN, b);
        tma_load_4d(sV + p * kBlockN * kPanelRowBytes, &tm_v, kv_full,
                    p * kPanel, h, kv_tile * kBlockN, b);
      }
      for (int jj = 0; jj < n_q; ++jj) {
        const int s = jj % kStages;
        // the stage's previous tile, jj - kStages, released by every consumer
        if (jj >= kStages) mbar_wait(empty + 8 * s, ((jj / kStages) - 1) & 1);
        const int row = (kv_tile + jj) * kBlockM;
        const uint32_t q_dst = sQ + s * L::kTileBytes;
        const uint32_t do_dst = sdO + s * L::kTileBytes;
        mbar_arrive_expect_tx(full + 8 * s, 2 * L::kTileBytes);
        for (int p = 0; p < kPanels; ++p) {
          tma_load_4d(q_dst + p * kBlockM * kPanelRowBytes, &tm_q,
                      full + 8 * s, p * kPanel, h, row, b);
          tma_load_4d(do_dst + p * kBlockM * kPanelRowBytes, &tm_do,
                      full + 8 * s, p * kPanel, h, row, b);
        }
      }
    }
  } else {
    reg_alloc<kConsumerRegs>();
    // 1: dV, 2: dK. Read from lane 0 so the compiler knows it is
    // warp-uniform (addresses and descriptors in uniform registers).
    const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;  // row within the warp's 8-row group
    const int t = lane & 3;   // column pair within an 8-column tile
    // This thread's accumulator rows are keys key0 and key0 + 8.
    const int key0 = kv_tile * kBlockN + warp * 16 + g;
    const bool dv_group = wg == 1;
    const float* stats =
        (dv_group ? lse : di) + (static_cast<int64_t>(b) * gridDim.y + h) * seq;
    const float scale_log2 = sm_scale * kLog2e;

    float acc[D / 2];  // dV or dK: D/8 tiles of 8 columns x 4
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    // First product: A = K (dV) or V (dK), K-major; B = the query tile's Q
    // (dV) or dO (dK), K-major. Second product: B = dO (dV) or Q (dK),
    // MN-major. A step's descriptor adds its byte offset / 16.
    const uint64_t desc_a = wgmma_desc(dv_group ? sK : sV, 16, 1024);
    const uint64_t desc_b1 = wgmma_desc(dv_group ? sQ : sdO, 16, 1024);
    const uint64_t desc_b2 =
        wgmma_desc(dv_group ? sdO : sQ, kBlockM * kPanelRowBytes, 1024);
    mbar_wait(kv_full, 0);

    for (int jj = 0; jj < n_q; ++jj) {
      const int s = jj % kStages;
      const uint32_t parity = (jj / kStages) & 1;
      const uint64_t stage = (s * L::kTileBytes) >> 4;
      const int q0 = (kv_tile + jj) * kBlockM;  // the tile's first query

      // This thread's columns are queries q0 + 8n + 2t + {0, 1}: their lse
      // in log2 units (dV) or di (dK), loaded before the product.
      float st[16];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = __ldg(stats + q0 + n * 8 + 2 * t + e);
          st[2 * n + e] = dv_group ? x * kLog2e : x;
        }
      }

      // S^T = K Q^T or dP^T = V dO^T, 64 keys x 64 queries: 16 columns of
      // D a step; step kk lies in panel kk / 4 at byte 32 * (kk % 4) of
      // each 128-byte row.
      float x[32];
      mbar_wait(full + 8 * s, parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int col = (kk % 4) * 32;
        wgmma_ss<0>(x, desc_a + (((kk / 4) * kBlockN * kPanelRowBytes + col) >> 4),
                    desc_b1 + stage +
                        (((kk / 4) * kBlockM * kPanelRowBytes + col) >> 4),
                    kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(x);

      if (dv_group) {
        // P^T = exp(s - lse), zero where key > query (only the diagonal
        // tile, jj == 0, has such pairs).
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = exp2f(fmaf(x[4 * n + e], scale_log2, -st[2 * n + (e & 1)]));
            if (jj == 0 && key0 + (e >> 1) * 8 > q0 + n * 8 + 2 * t + (e & 1)) {
              p = 0.f;
            }
            x[4 * n + e] = p;
          }
        }
        if (jj > 0) named_bar_sync(kBarPEmpty, kConsumerThreads);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          sP[n * 128 + tid] =
              make_float4(x[4 * n], x[4 * n + 1], x[4 * n + 2], x[4 * n + 3]);
        }
        named_bar_arrive(kBarPFull, kConsumerThreads);
      } else {
        // dS^T = P^T (dP^T - di) sm_scale, with warpgroup 1's f32 P^T.
        named_bar_sync(kBarPFull, kConsumerThreads);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float4 p = sP[n * 128 + tid];
          x[4 * n + 0] = p.x * (x[4 * n + 0] - st[2 * n]) * sm_scale;
          x[4 * n + 1] = p.y * (x[4 * n + 1] - st[2 * n + 1]) * sm_scale;
          x[4 * n + 2] = p.z * (x[4 * n + 2] - st[2 * n]) * sm_scale;
          x[4 * n + 3] = p.w * (x[4 * n + 3] - st[2 * n + 1]) * sm_scale;
        }
        if (jj + 1 < n_q) named_bar_arrive(kBarPEmpty, kConsumerThreads);
      }

      // bf16 P^T or dS^T: the accumulator of 8-column tiles 2kk and 2kk + 1
      // is the A fragment of k-step kk (16 queries).
      uint32_t a[4][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        a[n / 2][(n & 1) * 2 + 0] = pack_bf16(x[4 * n + 0], x[4 * n + 1]);
        a[n / 2][(n & 1) * 2 + 1] = pack_bf16(x[4 * n + 2], x[4 * n + 3]);
      }

      // dV += P^T dO or dK += dS^T Q: the B tile is [queries][D], D
      // contiguous, an MN-major B; k-step kk starts 16 rows of 128 bytes
      // further into every panel.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockM / 16; ++kk) {
        wgmma_rs<1>(acc, a[kk],
                    desc_b2 + stage + ((kk * 16 * kPanelRowBytes) >> 4), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
      mbar_arrive(empty + 8 * s);  // this thread is done with the stage
    }

    // Keys key0 and key0 + 8 (all < S: S is a multiple of 64).
    __nv_bfloat16* out = dv_group ? dv + b * dv_sb + h * dv_sh
                                  : dk + b * dk_sb + h * dk_sh;
    const int64_t out_ss = dv_group ? dv_ss : dk_ss;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      __nv_bfloat16* row = out + static_cast<int64_t>(key0 + r * 8) * out_ss;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<uint32_t*>(row + n * 8 + 2 * t) =
            pack_bf16(acc[4 * n + 2 * r], acc[4 * n + 2 * r + 1]);
      }
    }
  }
}

template <int D>
cudaError_t launch(const void* const* ptr, int batch, int seq, int heads,
                   const int64_t* st, float sm_scale, cudaStream_t stream) {
  using L = Layout<D>;
  static_assert(L::kAlloc <= 232448, "over the 227 KB a block can use");
  // q, k, v, dO: every box is 64 rows.
  CUtensorMap maps[4];
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err =
        make_map(&maps[i], ptr[i], batch, seq, heads, D, st[3 * i],
                 st[3 * i + 1], st[3 * i + 2], 64);
    if (err != cudaSuccess) return err;
  }
  // Above 48 KB a launch is refused unless the kernel opts in.
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_bwd_dkv_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kAlloc);
  if (err != cudaSuccess) return err;
  const dim3 grid(seq / kBlockN, heads, batch);
  flash_attn_bwd_dkv_kernel<D><<<grid, kThreads, L::kAlloc, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(ptr[4]),
      static_cast<const float*>(ptr[5]),
      static_cast<__nv_bfloat16*>(const_cast<void*>(ptr[6])),
      static_cast<__nv_bfloat16*>(const_cast<void*>(ptr[7])), seq, st[12],
      st[13], st[14], st[15], st[16], st[17], sm_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches dK, dV on `stream`; returns the cudaError_t of the launch (0 on
// success). Strides are in elements, per tensor (batch, seq, head) in the
// order q, k, v, dO, dK, dV; the head dimension must be contiguous, the
// base pointers and strides of q, k, v and dO 16-byte aligned (TMA). lse
// and di are contiguous f32 [batch, heads, seq]. seq must be a multiple of
// 64 and head_dim 128 or 256; anything else returns cudaErrorInvalidValue.
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

// Dynamic shared memory a launch at `head_dim` asks for, in bytes (0 for a
// head_dim the kernel does not take).
int flash_attn_smem_bytes(int head_dim) {
  switch (head_dim) {
    case 128:
      return Layout<128>::kAlloc;
    case 256:
      return Layout<256>::kAlloc;
    default:
      return 0;
  }
}

const char* flash_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
