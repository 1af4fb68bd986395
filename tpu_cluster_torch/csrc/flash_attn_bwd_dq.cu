// Causal flash-attention backward, dQ, for Hopper (sm_90a): bf16 in, bf16
// out, f32 accumulation; TMA-fed, warp-specialised, wgmma-based; with an
// optional sliding window.
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
// upstream's is: dQ needs no atomics across the key tiles, and two calls
// on the same inputs give the same bits.
//
// Layout: q, k, v, dO and dQ are [B, S, H, D] with arbitrary batch/seq/
// head strides (in elements, multiples of 8) and D contiguous; lse and di
// are contiguous f32 [B, H, S].
//
// What bounds it on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): at the
// training shape B1 H16 S8192 D256 it does three causal products (Q K^T
// again, dO V^T, dS K), 3 x 2 x B x H x D x S(S+1)/2 = 0.825 TFLOP,
// 0.834 ms at peak, against 0.34 GB of bytes (q, k, v, dO read, dQ written,
// lse and di) in 0.10 ms: it is bound by operations. The design is K1's
// (flash_attn_fwd.cu) with one more product:
//
// - One CTA per (128-row query tile, head, batch): 384 threads in three
//   warpgroups. The grid runs the longest causal rows first.
// - Warpgroup 0 is the producer (setmaxnreg to 40): one thread issues every
//   load by TMA through 4-D tensor maps over the strided views (box 64 x 1
//   x rows x 1, 128-byte swizzle): Q and dO of the tile once, each on its
//   own full barrier, then K_j and V_j of each 64-key tile j up to the
//   diagonal. K_j is read twice (in S and in dQ) and V_j once (in dP), so
//   at D = 256 K has a ring of two stages and V one: V_{j+1} loads while
//   tile j's dS and dQ run, K_{j+1} while all of tile j runs. Each slot has
//   a full barrier (TMA bytes) and an empty barrier on which all 256
//   consumer threads arrive. A tensor map's S extent is the true S: rows
//   past it load as zeros, which is what lets a 128-row tile serve an S
//   that is 64 mod 128.
// - Warpgroups 1 and 2 are consumers (setmaxnreg to 232), each owning 64
//   query rows. Per KV tile: S = Q K^T and dP = dO V^T by wgmma m64n64k16
//   with both operands from shared memory (all K-major), committed as two
//   groups so that P = exp2(S sm_scale log2(e) - lse log2(e)) is computed
//   while dP is still running; the causal mask only on tiles the diagonal
//   crosses; dS = P (dP - di) sm_scale in f32 registers, packed to bf16 in
//   place as the register A operand of dQ += dS K, wgmma m64n{D}k16, which
//   reads the same K tile as an MN-major B (as K1 reads V). A consumer
//   skips the products of a tile wholly above its rows' diagonal (the
//   first consumer's last tile) and of a tile whose rows are all past S,
//   but still waits for the slot's loads and releases it, so every empty
//   barrier counts one arrival per consumer thread per tile.
// - lse and di: two rows a thread, read once from device memory.
// - Epilogue: dQ rounded to bf16 and stored from registers, rows < S only.
//
// Budget at D = 256: Q + dO (128 x D each) + 2 stages of K + 1 of V (64 x D
// each) + barriers: 230,464 bytes with the 1024 that align the base, so one
// CTA per SM. A consumer thread holds 128 f32 of dQ and 32 each of S and
// dP. The two alternatives the plan named were measured against this
// design, in turns at the training shape on an H100 (PERF.md), and
// were slower: 32-key tiles with two slots of both K and V (192 KB; their
// S and dP products are SS m64n32k16, which read 3 KB of shared memory
// for 32 K multiply-adds a step, against 4 KB for 64 K at m64n64k16), and
// 64-key tiles with one slot of each (no load overlaps a tile's
// products). D = 128: two slots of both, 132,176 bytes.
//
// What the design still leaves on the table: the dS and dQ of tile j do not
// overlap the S and dP of tile j + 1 within a warpgroup, the consumers are
// not ping-pong scheduled, and CTAs are not persistent.
//
// Window (kWindow, a template flag; window > 0 at the entry point): query i
// sees key j iff 0 <= i - j < window. As in K1, the KV walk starts at the
// first tile the tile's first row reaches; a consumer skips the products of
// a tile wholly before its rows' window (as of one wholly above their
// diagonal), and only tiles the window's edge crosses are masked. The causal
// instantiation compiles to the kernel without the window.

#include "hopper_common.cuh"

#include <math.h>

namespace {

using namespace hopper;

constexpr int kBlockM = 128;  // query rows per CTA
constexpr int kRowsPerConsumer = 64;
constexpr int kBlockN = 64;  // keys per KV tile
constexpr int kKStages = 2;  // slots of K (V: kVStages, by D)
constexpr int kThreads = 384;  // producer + two consumer warpgroups
constexpr int kConsumerThreads = 256;
constexpr int kPanel = 64;  // bf16 per 128-byte swizzled row
constexpr int kPanelRowBytes = 128;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;

// Dynamic shared memory, in bytes from a 1024-byte-aligned base, with
// kVStages slots of V.
template <int D, int kVStages>
struct Layout {
  static constexpr int kQBytes = kBlockM * D * 2;   // Q or dO
  static constexpr int kKVBytes = kBlockN * D * 2;  // one K or V slot
  static constexpr int kQ = 0;
  static constexpr int kdO = kQ + kQBytes;
  static constexpr int kK = kdO + kQBytes;               // + slot
  static constexpr int kV = kK + kKStages * kKVBytes;    // + slot
  // mbarriers: q_full, do_full, k_full[kKStages], k_empty[kKStages],
  // v_full[kVStages], v_empty[kVStages]
  static constexpr int kBars = kV + kVStages * kKVBytes;
  static constexpr int kBytes = kBars + 8 * (2 + 2 * kKStages + 2 * kVStages);
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base
};

template <int D, int kVStages, bool kWindow>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attn_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_do,
                             const float* __restrict__ lse,
                             const float* __restrict__ di,
                             __nv_bfloat16* __restrict__ dq, int seq,
                             int64_t dq_sb, int64_t dq_ss, int64_t dq_sh,
                             float sm_scale, int window) {
  using L = Layout<D, kVStages>;
  constexpr int kPanels = D / kPanel;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base + L::kQ;
  const uint32_t sdO = base + L::kdO;
  const uint32_t sK = base + L::kK;
  const uint32_t sV = base + L::kV;
  const uint32_t q_full = base + L::kBars;
  const uint32_t do_full = q_full + 8;
  const uint32_t k_full = do_full + 8;               // + 8 * slot
  const uint32_t k_empty = k_full + 8 * kKStages;    // + 8 * slot
  const uint32_t v_full = k_empty + 8 * kKStages;    // + 8 * slot
  const uint32_t v_empty = v_full + 8 * kVStages;    // + 8 * slot

  // Longest causal rows first: the last query tiles walk the most KV tiles.
  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  // KV tiles up to the diagonal of the tile's last row, and within S.
  const int n_kv = min(((q_tile + 1) * kBlockM + kBlockN - 1) / kBlockN,
                       seq / kBlockN);
  // With a window, from the tile holding the first key the tile's first
  // row sees; the rings count i = j - j_lo.
  const int j_lo =
      kWindow ? max(q_tile * kBlockM - window + 1, 0) / kBlockN : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(do_full, 1);
    for (int s = 0; s < kKStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, kConsumerThreads);
    }
    for (int s = 0; s < kVStages; ++s) {
      mbar_init(v_full + 8 * s, 1);
      mbar_init(v_empty + 8 * s, kConsumerThreads);
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
      mbar_arrive_expect_tx(do_full, L::kQBytes);
      for (int p = 0; p < kPanels; ++p) {
        tma_load_4d(sdO + p * kBlockM * kPanelRowBytes, &tm_do, do_full,
                    p * kPanel, h, q_tile * kBlockM, b);
      }
      for (int j = j_lo; j < n_kv; ++j) {
        const int i = j - j_lo;
        // Each slot's previous tile released by every consumer.
        const int sk = i % kKStages;
        if (i >= kKStages) {
          mbar_wait(k_empty + 8 * sk, ((i / kKStages) - 1) & 1);
        }
        const uint32_t k_dst = sK + sk * L::kKVBytes;
        mbar_arrive_expect_tx(k_full + 8 * sk, L::kKVBytes);
        for (int p = 0; p < kPanels; ++p) {
          tma_load_4d(k_dst + p * kBlockN * kPanelRowBytes, &tm_k,
                      k_full + 8 * sk, p * kPanel, h, j * kBlockN, b);
        }
        const int sv = i % kVStages;
        if (i >= kVStages) {
          mbar_wait(v_empty + 8 * sv, ((i / kVStages) - 1) & 1);
        }
        const uint32_t v_dst = sV + sv * L::kKVBytes;
        mbar_arrive_expect_tx(v_full + 8 * sv, L::kKVBytes);
        for (int p = 0; p < kPanels; ++p) {
          tma_load_4d(v_dst + p * kBlockN * kPanelRowBytes, &tm_v,
                      v_full + 8 * sv, p * kPanel, h, j * kBlockN, b);
        }
      }
    }
  } else {
    reg_alloc<kConsumerRegs>();
    // Read from lane 0 so the compiler knows it is warp-uniform.
    const int consumer = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0) - 1;
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;  // row within the warp's 8-row group
    const int t = lane & 3;   // column pair within an 8-column tile
    const int first_row = q_tile * kBlockM + consumer * kRowsPerConsumer;
    const int row0 = first_row + warp * 16 + g;  // and row0 + 8
    // S is a multiple of 64: a consumer's rows are all below S or all past.
    const bool active = first_row < seq;
    const float scale_log2 = sm_scale * kLog2e;

    // Rows row0 and row0 + 8: lse in log2 units, and di.
    const int64_t row_stats = (static_cast<int64_t>(b) * gridDim.y + h) * seq;
    float lse_r[2] = {0.f, 0.f};
    float di_r[2] = {0.f, 0.f};
    if (active) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lse_r[r] = lse[row_stats + row0 + 8 * r] * kLog2e;
        di_r[r] = di[row_stats + row0 + 8 * r];
      }
    }

    float acc[D / 2];  // dQ: D/8 tiles of 8 columns x 4
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    // This consumer's 64 rows of Q and dO (K-major A); K and V of slot 0 as
    // K-major B (S, dP) and K as MN-major B (dQ). A step's descriptor adds
    // its byte offset / 16.
    const uint32_t rows = consumer * kRowsPerConsumer * kPanelRowBytes;
    const uint64_t desc_q = wgmma_desc(sQ + rows, 16, 1024);
    const uint64_t desc_do = wgmma_desc(sdO + rows, 16, 1024);
    const uint64_t desc_k = wgmma_desc(sK, 16, 1024);
    const uint64_t desc_v = wgmma_desc(sV, 16, 1024);
    const uint64_t desc_kt = wgmma_desc(sK, kBlockN * kPanelRowBytes, 1024);
    mbar_wait(q_full, 0);
    mbar_wait(do_full, 0);

    for (int j = j_lo; j < n_kv; ++j) {
      const int i = j - j_lo;
      const int sk = i % kKStages;
      const int sv = i % kVStages;
      const uint32_t k_parity = (i / kKStages) & 1;
      const uint32_t v_parity = (i / kVStages) & 1;
      const uint64_t k_slot = (sk * L::kKVBytes) >> 4;
      const uint64_t v_slot = (sv * L::kKVBytes) >> 4;

      if (!active || j * kBlockN > first_row + kRowsPerConsumer - 1 ||
          (kWindow && (j + 1) * kBlockN - 1 + window <= first_row)) {
        // Nothing of this tile reaches this consumer's rows.
        mbar_wait(k_full + 8 * sk, k_parity);
        mbar_wait(v_full + 8 * sv, v_parity);
        mbar_arrive(v_empty + 8 * sv);
        mbar_arrive(k_empty + 8 * sk);
        continue;
      }

      // S = Q K^T, then dP = dO V^T: 16 columns of D a step; step kk lies
      // in panel kk / 4 at byte 32 * (kk % 4) of each 128-byte row.
      float sc[kBlockN / 2];
      float dp[kBlockN / 2];
      mbar_wait(k_full + 8 * sk, k_parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int col = (kk % 4) * 32;
        wgmma_ss<0>(sc,
                    desc_q + (((kk / 4) * kBlockM * kPanelRowBytes + col) >> 4),
                    desc_k + k_slot +
                        (((kk / 4) * kBlockN * kPanelRowBytes + col) >> 4),
                    kk > 0);
      }
      wgmma_commit();
      mbar_wait(v_full + 8 * sv, v_parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int col = (kk % 4) * 32;
        wgmma_ss<0>(dp,
                    desc_do + (((kk / 4) * kBlockM * kPanelRowBytes + col) >> 4),
                    desc_v + v_slot +
                        (((kk / 4) * kBlockN * kPanelRowBytes + col) >> 4),
                    kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // S landed; dP may still run
      fence_operands(sc);

      // P = exp(s - lse), zero where key > row (only tiles the diagonal
      // crosses have such pairs) and, with a window, where key <= row -
      // window (only tiles its edge crosses).
      const bool diag = (j + 1) * kBlockN - 1 > first_row;
      const bool edge =
          kWindow && j * kBlockN + window <= first_row + kRowsPerConsumer - 1;
#pragma unroll
      for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(fmaf(sc[4 * n + e], scale_log2, -lse_r[e >> 1]));
          if (diag && j * kBlockN + n * 8 + 2 * t + (e & 1) >
                          row0 + (e >> 1) * 8) {
            p = 0.f;
          }
          if (kWindow && edge &&
              j * kBlockN + n * 8 + 2 * t + (e & 1) + window <=
                  row0 + (e >> 1) * 8) {
            p = 0.f;
          }
          sc[4 * n + e] = p;
        }
      }
      wgmma_wait<0>();
      fence_operands(dp);
      mbar_arrive(v_empty + 8 * sv);  // this thread is done with V_j

      // dS = P (dP - di) sm_scale, rounded to bf16: the accumulator of
      // 8-column tiles 2kk and 2kk + 1 is the A fragment of k-step kk.
      uint32_t a[kBlockN / 16][4];
#pragma unroll
      for (int n = 0; n < kBlockN / 8; ++n) {
        float d[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          d[e] = sc[4 * n + e] * (dp[4 * n + e] - di_r[e >> 1]) * sm_scale;
        }
        a[n / 2][(n & 1) * 2 + 0] = pack_bf16(d[0], d[1]);
        a[n / 2][(n & 1) * 2 + 1] = pack_bf16(d[2], d[3]);
      }

      // dQ += dS K_j: K is [keys][D], D contiguous, an MN-major B; k-step kk
      // (16 keys) starts 16 rows of 128 bytes further into every panel.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        wgmma_rs<1>(acc, a[kk],
                    desc_kt + k_slot + ((kk * 16 * kPanelRowBytes) >> 4), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
      mbar_arrive(k_empty + 8 * sk);  // this thread is done with K_j
    }

    __nv_bfloat16* dq_bh = dq + b * dq_sb + h * dq_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + r * 8;
      if (row >= seq) continue;
      __nv_bfloat16* dq_row = dq_bh + static_cast<int64_t>(row) * dq_ss;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<uint32_t*>(dq_row + n * 8 + 2 * t) =
            pack_bf16(acc[4 * n + 2 * r], acc[4 * n + 2 * r + 1]);
      }
    }
  }
}

template <int D, int kVStages, bool kWindow>
cudaError_t launch(const void* const* ptr, int batch, int seq, int heads,
                   const int64_t* st, float sm_scale, int window,
                   cudaStream_t stream) {
  using L = Layout<D, kVStages>;
  static_assert(L::kAlloc <= 232448, "over the 227 KB a block can use");
  // q, k, v, dO: Q and dO in 128-row boxes, K and V in 64-row boxes.
  CUtensorMap maps[4];
  for (int i = 0; i < 4; ++i) {
    const bool rows_q = i == 0 || i == 3;
    const cudaError_t err =
        make_map(&maps[i], ptr[i], batch, seq, heads, D, st[3 * i],
                 st[3 * i + 1], st[3 * i + 2], rows_q ? kBlockM : kBlockN);
    if (err != cudaSuccess) return err;
  }
  // Above 48 KB a launch is refused unless the kernel opts in.
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_bwd_dq_kernel<D, kVStages, kWindow>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kAlloc);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kBlockM - 1) / kBlockM, heads, batch);
  flash_attn_bwd_dq_kernel<D, kVStages, kWindow>
      <<<grid, kThreads, L::kAlloc, stream>>>(
          maps[0], maps[1], maps[2], maps[3],
          static_cast<const float*>(ptr[4]), static_cast<const float*>(ptr[5]),
          static_cast<__nv_bfloat16*>(const_cast<void*>(ptr[6])), seq, st[12],
          st[13], st[14], sm_scale, window);
  return cudaGetLastError();
}

template <int D, int kVStages>
cudaError_t launch_any(const void* const* ptr, int batch, int seq, int heads,
                       const int64_t* st, float sm_scale, int window,
                       cudaStream_t stream) {
  if (window > 0) {
    return launch<D, kVStages, true>(ptr, batch, seq, heads, st, sm_scale,
                                     window, stream);
  }
  return launch<D, kVStages, false>(ptr, batch, seq, heads, st, sm_scale, 0,
                                    stream);
}

}  // namespace

extern "C" {

// Launches dQ on `stream`; returns the cudaError_t of the launch (0 on
// success). Strides are in elements, per tensor (batch, seq, head) in the
// order q, k, v, dO, dQ; the head dimension must be contiguous, the base
// pointers and strides of q, k, v and dO 16-byte aligned (TMA). lse and di
// are contiguous f32 [batch, heads, seq]. seq must be a multiple of 64 and
// head_dim 128 or 256; anything else returns cudaErrorInvalidValue.
// `window` 0 is causal attention; window > 0 lets query i see key j iff
// 0 <= i - j < window.
int flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* di,
                      void* dq, int batch, int seq, int heads, int head_dim,
                      int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
                      int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
                      int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh,
                      int64_t dq_sb, int64_t dq_ss, int64_t dq_sh,
                      float sm_scale, void* stream, int window) {
  if (seq <= 0 || seq % kBlockN != 0 || batch <= 0 || heads <= 0 ||
      window < 0) {
    return cudaErrorInvalidValue;
  }
  const void* ptr[7] = {q, k, v, dout, lse, di, dq};
  const int64_t st[15] = {q_sb, q_ss, q_sh, k_sb,  k_ss,  k_sh,  v_sb, v_ss,
                          v_sh, o_sb, o_ss, o_sh, dq_sb, dq_ss, dq_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 128:
      return launch_any<128, 2>(ptr, batch, seq, heads, st, sm_scale, window,
                                s);
    case 256:
      return launch_any<256, 1>(ptr, batch, seq, heads, st, sm_scale, window,
                                s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Dynamic shared memory a launch at `head_dim` asks for, in bytes (0 for a
// head_dim the kernel does not take).
int flash_attn_smem_bytes(int head_dim) {
  switch (head_dim) {
    case 128:
      return Layout<128, 2>::kAlloc;
    case 256:
      return Layout<256, 1>::kAlloc;
    default:
      return 0;
  }
}

const char* flash_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
