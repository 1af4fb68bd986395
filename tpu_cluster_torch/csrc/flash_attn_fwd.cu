// Causal flash-attention forward for Hopper (sm_90a): bf16 in, bf16 out,
// f32 softmax statistics; TMA-fed, warp-specialised, wgmma-based.
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
// strides (in elements, multiples of 8) and D contiguous, the layout
// burnin.forward's projections produce, so no transpose copies are made.
//
// What bounds it on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): at the
// serving shape B4 H16 S8192 D256 the causal useful work is 2*B*H*S^2*D =
// 2.20 TFLOP, 2.22 ms at peak, while the bytes (q, k, v read once, o written
// once: 4 x 268 MB = 1.07 GB) take 0.32 ms. It is bound by operations, so
// the design is about keeping the tensor cores fed:
//
// - One CTA per (128-row query tile, head, batch): 384 threads in three
//   warpgroups. The grid runs the longest causal rows first.
// - Warpgroup 0 is the producer. It gives up registers (setmaxnreg to 40),
//   and one thread issues every load by TMA through 4-D tensor maps over
//   the strided views (dims D, H, S, B; box 64 x 1 x rows x 1, 128-byte
//   swizzle): Q once, then K_j and V_j into a ring of two stages. Each
//   stage has a full barrier for K and one for V (TMA bytes), so Q K^T can
//   start before V lands, and an empty barrier on which all 256 consumer
//   threads arrive once they are done with it. A tensor map's S extent is
//   the true S: rows past it load as zeros, which is what lets a 128-row
//   tile serve an S that is 64 mod 128.
// - Warpgroups 1 and 2 are consumers (setmaxnreg to 232), each owning 64
//   query rows. Per KV tile: S = Q K^T by wgmma m64n{kBlockN}k16 with both
//   operands from shared memory (K-major), over D/16 steps; the causal mask
//   only on tiles the diagonal crosses; the online softmax in f32
//   registers (base 2, log2(e) * sm_scale folded into one FMA); P =
//   exp(s - m) packed to bf16 in place as the register A operand of
//   O += P V, wgmma m64n{D}k16 with V as an MN-major B; the f32 row sums
//   taken from the unrounded P. KV tiles wholly above the diagonal are
//   never loaded: producer and consumers derive the same count n_kv.
// - Epilogue: l summed over the quad of threads sharing a row, O times
//   1 / l rounded to bf16 and stored straight from registers to global memory,
//   lse = m ln2 + log l, both for rows < S only.
//
// Budget: kBlockN = 64 keys at D = 256 and 128 at D = 128. Shared memory is
// Q (128 x D) + 2 stages x (K + V) (kBlockN x D each): 192 KB at D = 256,
// 160 KB at D = 128, plus barriers, so one CTA per SM. A consumer thread
// holds D/2 f32 of O (128 at D = 256) and kBlockN/2 of S (32 or 64); the
// producer 40 registers: 128 x 40 + 256 x 232 = 64,512 of the SM's 65,536.
//
// What the design still leaves on the table: the softmax of tile j does
// not overlap the Q K^T of tile j + 1 within a warpgroup, the two consumer
// warpgroups are not ping-pong scheduled against each other, CTAs are not
// persistent (one tile's epilogue does not overlap the next tile's loads),
// no thread block clusters share K/V loads, and O is stored from registers
// rather than through shared memory and a TMA store.

#include "hopper_common.cuh"

#include <cuda_bf16.h>
#include <math.h>

namespace {

using namespace hopper;

constexpr int kBlockM = 128;  // query rows per CTA
constexpr int kRowsPerConsumer = 64;
constexpr int kThreads = 384;  // producer + two consumer warpgroups
constexpr int kConsumerThreads = 256;
constexpr int kStages = 2;
constexpr int kPanel = 64;         // bf16 per 128-byte swizzled row
constexpr int kPanelRowBytes = 128;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Dynamic shared memory, in bytes from a 1024-byte-aligned base.
template <int D, int kBlockN>
struct Layout {
  static constexpr int kQBytes = kBlockM * D * 2;
  static constexpr int kKVBytes = kBlockN * D * 2;  // one K or V stage
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  // mbarriers: q_full, k_full[kStages], v_full[kStages], empty[kStages]
  static constexpr int kBars = kV + kStages * kKVBytes;
  static constexpr int kBytes = kBars + 8 * (1 + 3 * kStages);
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base
};

template <int D, int kBlockN>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attn_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int seq, int64_t o_sb,
                          int64_t o_ss, int64_t o_sh, float scale_log2) {
  using L = Layout<D, kBlockN>;
  constexpr int kPanels = D / kPanel;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base + L::kQ;
  const uint32_t sK = base + L::kK;
  const uint32_t sV = base + L::kV;
  const uint32_t q_full = base + L::kBars;
  const uint32_t k_full = q_full + 8;                // + 8 * stage
  const uint32_t v_full = k_full + 8 * kStages;      // + 8 * stage
  const uint32_t empty = v_full + 8 * kStages;       // + 8 * stage

  // Longest causal rows first: the last query tiles walk the most KV tiles.
  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  // KV tiles up to the diagonal of the tile's last row, and within S.
  const int n_kv = min(((q_tile + 1) * kBlockM + kBlockN - 1) / kBlockN,
                       (seq + kBlockN - 1) / kBlockN);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerThreads);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // The roles never reconverge: setmaxnreg needs one branch per role.
  if (threadIdx.x < 128) {
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(q_full, L::kQBytes);
      for (int p = 0; p < kPanels; ++p) {
        tma_load_4d(sQ + p * kBlockM * kPanelRowBytes, &tm_q, q_full,
                    p * kPanel, h, q_tile * kBlockM, b);
      }
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % kStages;
        // the stage's previous tile, j - kStages, released by every consumer
        if (j >= kStages) mbar_wait(empty + 8 * s, ((j / kStages) - 1) & 1);
        const uint32_t k_dst = sK + s * L::kKVBytes;
        const uint32_t v_dst = sV + s * L::kKVBytes;
        mbar_arrive_expect_tx(k_full + 8 * s, L::kKVBytes);
        for (int p = 0; p < kPanels; ++p) {
          tma_load_4d(k_dst + p * kBlockN * kPanelRowBytes, &tm_k,
                      k_full + 8 * s, p * kPanel, h, j * kBlockN, b);
        }
        mbar_arrive_expect_tx(v_full + 8 * s, L::kKVBytes);
        for (int p = 0; p < kPanels; ++p) {
          tma_load_4d(v_dst + p * kBlockN * kPanelRowBytes, &tm_v,
                      v_full + 8 * s, p * kPanel, h, j * kBlockN, b);
        }
      }
    }
  } else {
    reg_alloc<kConsumerRegs>();
    // Read from lane 0 so the compiler knows it is warp-uniform: the
    // addresses and wgmma descriptors derived from it then live in uniform
    // registers, not in the 232 each consumer thread has.
    const int consumer = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0) - 1;
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;  // row within the warp's 8-row group
    const int t = lane & 3;   // column pair within an 8-column tile
    const int first_row = q_tile * kBlockM + consumer * kRowsPerConsumer;
    const int row0 = first_row + warp * 16 + g;  // and row0 + 8

    float acc[D / 2];  // O: D/8 tiles of 8 columns x 4
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    // Rows row0 and row0 + 8: running max in log2 units of the scaled
    // scores, and this thread's share of the running denominator (summed
    // over the quad at the end).
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};

    // Descriptors of this consumer's 64 rows of Q (K-major), and of the
    // stage-0 K (K-major) and V (MN-major) tiles; a step's descriptor adds
    // its byte offset / 16 to the start-address field.
    const uint64_t desc_q = wgmma_desc(
        sQ + consumer * kRowsPerConsumer * kPanelRowBytes, 16, 1024);
    const uint64_t desc_k = wgmma_desc(sK, 16, 1024);
    const uint64_t desc_v = wgmma_desc(sV, kBlockN * kPanelRowBytes, 1024);
    mbar_wait(q_full, 0);

    for (int j = 0; j < n_kv; ++j) {
      const int s = j % kStages;
      const uint32_t parity = (j / kStages) & 1;
      const uint64_t stage = (s * L::kKVBytes) >> 4;

      // S = Q K^T: both K-major, 16 columns of D a step; step kk lies in
      // panel kk / 4 at byte 32 * (kk % 4) of each 128-byte row.
      float sc[kBlockN / 2];
      mbar_wait(k_full + 8 * s, parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int col = (kk % 4) * 32;
        wgmma_ss<0>(sc,
                    desc_q + (((kk / 4) * kBlockM * kPanelRowBytes + col) >> 4),
                    desc_k + stage +
                        (((kk / 4) * kBlockN * kPanelRowBytes + col) >> 4),
                    kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(sc);

      // Mask the tiles the diagonal crosses (key > row -> -inf; keys past S
      // are past every row < S), then the running max.
      const bool diag = (j + 1) * kBlockN - 1 > first_row;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * n + e];
          if (diag) {
            const int key = j * kBlockN + n * 8 + 2 * t + (e & 1);
            if (key > row0 + (e >> 1) * 8) x = -INFINITY;
          }
          sc[4 * n + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2];
      float m_new[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // Every row (also a zero-filled one past S) has key 0 <= row
        // unmasked in tile 0, so m_new is finite from there on; a row
        // wholly masked in a later tile keeps m and gets P = 0.
        m_new[r] = fmaxf(m_run[r], mx[r] * scale_log2);
        alpha[r] = exp2f(m_run[r] - m_new[r]);
        m_run[r] = m_new[r];
      }
      // P = exp(s - m) in f32; the denominator sums the f32 values, P V
      // takes them rounded to bf16. The accumulator of 8-column tiles 2kk
      // and 2kk + 1 is the A fragment of k-step kk.
      float psum[2] = {0.f, 0.f};
      uint32_t p[kBlockN / 16][4];
#pragma unroll
      for (int n = 0; n < kBlockN / 8; ++n) {
        const float p0 = exp2f(fmaf(sc[4 * n + 0], scale_log2, -m_new[0]));
        const float p1 = exp2f(fmaf(sc[4 * n + 1], scale_log2, -m_new[0]));
        const float p2 = exp2f(fmaf(sc[4 * n + 2], scale_log2, -m_new[1]));
        const float p3 = exp2f(fmaf(sc[4 * n + 3], scale_log2, -m_new[1]));
        psum[0] += p0 + p1;
        psum[1] += p2 + p3;
        p[n / 2][(n & 1) * 2 + 0] = pack_bf16(p0, p1);
        p[n / 2][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + psum[r];
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[4 * n + 0] *= alpha[0];
        acc[4 * n + 1] *= alpha[0];
        acc[4 * n + 2] *= alpha[1];
        acc[4 * n + 3] *= alpha[1];
      }

      // O += P V: V is [keys][D], D contiguous, an MN-major B; k-step kk
      // (16 keys) starts 16 rows of 128 bytes further into every panel.
      mbar_wait(v_full + 8 * s, parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        wgmma_rs<1>(acc, p[kk],
                    desc_v + stage + ((kk * 16 * kPanelRowBytes) >> 4), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
      mbar_arrive(empty + 8 * s);  // this thread is done with the stage
    }

    float l_tot[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      l_tot[r] = l;
    }
    // Row logsumexp of the scaled scores for the backward (natural log; m
    // is in log2 units); one lane per row, rows < S only.
    if (lse != nullptr && t == 0) {
      float* lse_bh = lse + (static_cast<int64_t>(b) * gridDim.y + h) * seq;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + r * 8;
        if (row < seq) lse_bh[row] = m_run[r] * kLn2 + logf(l_tot[r]);
      }
    }
    // One IEEE division a row, then products: O * (1 / l) differs from
    // O / l by at most one f32 rounding, far below O's bf16 rounding.
    __nv_bfloat16* o_bh = o + b * o_sb + h * o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + r * 8;
      if (row >= seq) continue;
      const float inv_l = 1.f / l_tot[r];
      __nv_bfloat16* o_row = o_bh + static_cast<int64_t>(row) * o_ss;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<uint32_t*>(o_row + n * 8 + 2 * t) =
            pack_bf16(acc[4 * n + 2 * r] * inv_l,
                      acc[4 * n + 2 * r + 1] * inv_l);
      }
    }
  }
}

template <int D, int kBlockN>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int batch, int seq, int heads,
                   const int64_t* st, float sm_scale, cudaStream_t stream) {
  using L = Layout<D, kBlockN>;
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err =
        make_map(&maps[i], ptrs[i], batch, seq, heads, D, st[3 * i],
                 st[3 * i + 1], st[3 * i + 2], i == 0 ? kBlockM : kBlockN);
    if (err != cudaSuccess) return err;
  }
  // Above 48 KB a launch is refused unless the kernel opts in.
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_fwd_kernel<D, kBlockN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kAlloc);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kBlockM - 1) / kBlockM, heads, batch);
  flash_attn_fwd_kernel<D, kBlockN><<<grid, kThreads, L::kAlloc, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), lse, seq,
      st[9], st[10], st[11], sm_scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the forward on `stream`; returns the cudaError_t of the launch
// (0 on success). Strides are in elements, per tensor (batch, seq, head);
// the head dimension must be contiguous, the base pointers and strides
// 16-byte aligned (TMA). seq must be a multiple of 64 and head_dim 128 or
// 256; anything else returns cudaErrorInvalidValue. `lse` is null (nothing
// written) or a contiguous f32 [batch, heads, seq] buffer that receives
// each row's logsumexp of the scaled scores.
int flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                   void* lse, int batch, int seq, int heads, int head_dim,
                   int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
                   int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
                   int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh,
                   float sm_scale, void* stream) {
  if (seq <= 0 || seq % 64 != 0 || batch <= 0 || heads <= 0) {
    return cudaErrorInvalidValue;
  }
  const int64_t st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                          v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 128:
      return launch<128, 128>(q, k, v, o, static_cast<float*>(lse), batch,
                              seq, heads, st, sm_scale, s);
    case 256:
      return launch<256, 64>(q, k, v, o, static_cast<float*>(lse), batch,
                             seq, heads, st, sm_scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Dynamic shared memory a launch at `head_dim` asks for, in bytes (0 for a
// head_dim the kernel does not take).
int flash_attn_smem_bytes(int head_dim) {
  switch (head_dim) {
    case 128:
      return Layout<128, 128>::kAlloc;
    case 256:
      return Layout<256, 64>::kAlloc;
    default:
      return 0;
  }
}

const char* flash_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
