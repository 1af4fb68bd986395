// Decode attention for Hopper (sm_90a): one bf16 query row a (slot, head)
// over that slot's cached keys and values, f32 online softmax, f32
// accumulation, bf16 out.
//
// Replaces no TPU kernel. The JAX package's serving engine recomputes the
// whole [slots, seq] buffer each decode iteration and runs the flash
// forward (_flash_attention_impl) over every query row; the port keeps
// each slot's keys and values on the card (workloads/serving.py,
// make_decode) and attends only the row each slot reads, with this kernel
// in K1's place on the decode path. K1 stays for training.
//
// Layout: q and o are contiguous [slots, H, D]; the caches k and v are
// [slots, seq, H, D] with arbitrary slot/seq/head strides (in elements,
// multiples of 8) and D contiguous. lengths is int32 [slots]: slot s
// attends keys 0 .. lengths[s] - 1.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 off the tensor
// cores): a row's work is 4 * D flops a key against 4 * D bytes of K and V,
// one flop a byte, so it is bound by bytes. At the serving cells' shapes
// (4 slots x 32 heads x ~6,000 keys at D = 128; 8 x 16 x ~1,500 at D = 256)
// it reads 0.1-0.4 GB, 30-120 us at the card's bandwidth. The design is
// about keeping that many bytes in flight:
//
// - Split keys (flash decoding): one block of 128 threads per (chunk, head,
//   slot), every chunk the same count of keys (whole tiles), so a long
//   slot takes more blocks than a short one and no block waits on a
//   longer neighbour. The host picks the chunk from the slots' lengths,
//   the heads and the blocks the SMs hold, so that the grid fills the 132
//   SMs several times over (4 x 32 or 8 x 16 (slot, head) pairs alone
//   give 128 blocks); a block past its slot's length exits at once.
// - cp.async (16 bytes a thread, L1 bypassed) into a ring of 4 stages of
//   4096 / D keys of K and of V (16 KB a stage): three tiles in flight
//   while one is consumed; three blocks an SM hold up to ~150 KB of loads
//   in flight. Keys past the length load as zeros and are masked.
// - The products on the CUDA cores in f32: each warp takes a quarter of a
//   tile's keys, each lane D / 32 elements of a row (8 or 16 bytes from
//   shared memory), a butterfly of shuffles sums a score; the online
//   softmax is per warp, in base 2 (sm_scale * log2(e) folded into q), so
//   a warp never waits on another until its chunk ends. P stays in f32.
// - The four warps' (max, sum, O) are merged in shared memory at the end
//   of the chunk and written unnormalised with the chunk's max and sum; a
//   second, short kernel merges the chunks of each (slot, head) by their
//   log-sum-exp and writes O / l in bf16.
//
// What the design leaves on the table: the merge is a second launch (a
// few microseconds); a slot's last chunk is partly empty; nothing is
// shared across heads of one slot (no KV-head grouping: each query head
// reads its own keys).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Shape {
  static constexpr int kKeys = 4096 / D;           // keys a stage: 32 or 16
  static constexpr int kPerWarp = kKeys / kWarps;  // 8 or 4
  static constexpr int kPerLane = D / 32;          // 4 or 8 row elements
  static constexpr int kPieces = D / 8;            // 16-byte pieces a row
  static constexpr int kTile = kKeys * D;          // elements of a K tile
  static constexpr int kSmem = kStages * 2 * kTile * 2;  // 64 KB
  static_assert(kKeys % kWarps == 0, "a warp takes whole keys");
  static_assert(kKeys * kPieces % kThreads == 0, "whole copies a thread");
  static_assert(kWarps * (D + 2) * 4 <= kSmem, "merge scratch fits");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; `bytes` 0 writes zeros and reads
// nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// E consecutive bf16 (8 or 16 bytes, aligned) as f32.
template <int E>
__device__ __forceinline__ void to_float(const __nv_bfloat16* p,
                                         float (&out)[E]) {
  using Vec = typename std::conditional<E == 4, uint2, uint4>::type;
  const Vec raw = *reinterpret_cast<const Vec*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < E / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    decode_attn_split_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const int* __restrict__ lengths,
                             float* __restrict__ o_part,
                             float* __restrict__ ml_part, int heads,
                             int chunk_keys, int64_t k_sb, int64_t k_ss,
                             int64_t k_sh, int64_t v_sb, int64_t v_ss,
                             int64_t v_sh, float scale_log2) {
  using S = Shape<D>;
  constexpr int E = S::kPerLane;
  constexpr int P = S::kPerWarp;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int chunk = blockIdx.x, head = blockIdx.y, slot = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = lengths[slot];
  // a slot's last chunk may be short, and those past it empty
  const int begin = chunk * chunk_keys;
  const int end = min(begin + chunk_keys, len);
  const int64_t part =
      (static_cast<int64_t>(slot) * heads + head) * gridDim.x + chunk;
  if (begin >= end) {
    if (threadIdx.x == 0) {
      ml_part[2 * part] = -INFINITY;
      ml_part[2 * part + 1] = 0.f;
    }
    return;
  }
  const __nv_bfloat16* kb = k + slot * k_sb + head * k_sh;
  const __nv_bfloat16* vb = v + slot * v_sb + head * v_sh;
  const int n_tiles = (end - begin + S::kKeys - 1) / S::kKeys;

  auto load_tile = [&](int t) {
    __nv_bfloat16* ks = smem + (t % kStages) * 2 * S::kTile;
    __nv_bfloat16* vs = ks + S::kTile;
    const int key0 = begin + t * S::kKeys;
#pragma unroll
    for (int j = 0; j < S::kKeys * S::kPieces / kThreads; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int row = i / S::kPieces, col = (i % S::kPieces) * 8;
      const bool in = key0 + row < end;
      const int64_t key = in ? key0 + row : begin;  // a valid address
      cp_async16(smem_u32(ks + row * D + col), kb + key * k_ss + col,
                 in ? 16 : 0);
      cp_async16(smem_u32(vs + row * D + col), vb + key * v_ss + col,
                 in ? 16 : 0);
    }
  };

  float qf[E];
  to_float<E>(q + (static_cast<int64_t>(slot) * heads + head) * D + lane * E,
              qf);
#pragma unroll
  for (int e = 0; e < E; ++e) qf[e] *= scale_log2;
  float m = -INFINITY, l = 0.f, acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_tile(s);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    // tile t has landed for every thread, and every warp is done with the
    // stage the next load overwrites (tile t - 1's)
    __syncthreads();
    if (t + kStages - 1 < n_tiles) load_tile(t + kStages - 1);
    cp_async_commit();

    const __nv_bfloat16* ks = smem + (t % kStages) * 2 * S::kTile;
    const __nv_bfloat16* vs = ks + S::kTile;
    const int row0 = warp * P;
    float sc[P];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      float kf[E];
      to_float<E>(ks + (row0 + i) * D + lane * E, kf);
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) d = fmaf(qf[e], kf[e], d);
      sc[i] = d;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int i = 0; i < P; ++i)
        sc[i] += __shfl_xor_sync(0xffffffffu, sc[i], off);
    }
    const int key0 = begin + t * S::kKeys + row0;
    float mt = -INFINITY;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if (key0 + i >= end) sc[i] = -INFINITY;
      mt = fmaxf(mt, sc[i]);
    }
    if (mt == -INFINITY) continue;  // warp-uniform: no key of this warp
    const float mn = fmaxf(m, mt);
    const float alpha = exp2f(m - mn);  // 0 on the warp's first keys
    l *= alpha;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] *= alpha;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const float p = exp2f(sc[i] - mn);  // 0 for a masked key (zeros in V)
      l += p;
      float vf[E];
      to_float<E>(vs + (row0 + i) * D + lane * E, vf);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = fmaf(p, vf[e], acc[e]);
    }
    m = mn;
  }

  // the ring is free once the (empty) trailing groups are done
  cp_async_wait<0>();
  __syncthreads();
  float* red_o = reinterpret_cast<float*>(smem_raw);  // [kWarps][D]
  float* red_ml = red_o + kWarps * D;                 // [kWarps][2]
#pragma unroll
  for (int e = 0; e < E; ++e) red_o[warp * D + lane * E + e] = acc[e];
  if (lane == 0) {
    red_ml[2 * warp] = m;
    red_ml[2 * warp + 1] = l;
  }
  __syncthreads();
  // the chunk's first key is warp 0's, so the max is finite; a warp that
  // saw no key has m = -inf, weight 0, and zeros
  float mx = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red_ml[2 * w]);
  float wt[kWarps], sum = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    wt[w] = exp2f(red_ml[2 * w] - mx);
    sum = fmaf(wt[w], red_ml[2 * w + 1], sum);
  }
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o = fmaf(wt[w], red_o[w * D + d], o);
    o_part[part * D + d] = o;
  }
  if (threadIdx.x == 0) {
    ml_part[2 * part] = mx;
    ml_part[2 * part + 1] = sum;
  }
}

// One block of D threads per (head, slot): the chunks merged by their
// log-sum-exp, O / l in bf16. A chunk with no key (max -inf) is skipped:
// its O was never written.
template <int D>
__global__ void __launch_bounds__(D)
    decode_attn_merge_kernel(const float* __restrict__ o_part,
                             const float* __restrict__ ml_part,
                             __nv_bfloat16* __restrict__ o, int heads,
                             int n_chunks) {
  const int head = blockIdx.x, slot = blockIdx.y, d = threadIdx.x;
  const int64_t row = static_cast<int64_t>(slot) * heads + head;
  const int64_t base = row * n_chunks;
  float mx = -INFINITY;
  for (int c = 0; c < n_chunks; ++c) mx = fmaxf(mx, ml_part[2 * (base + c)]);
  float sum = 0.f, acc = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const float mc = ml_part[2 * (base + c)];
    if (mc == -INFINITY) continue;
    const float w = exp2f(mc - mx);
    sum = fmaf(w, ml_part[2 * (base + c) + 1], sum);
    acc = fmaf(w, o_part[(base + c) * D + d], acc);
  }
  o[row * D + d] = __float2bfloat16(sum > 0.f ? acc / sum : 0.f);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* o, float* o_part, float* ml_part,
                   int slots, int heads, int n_chunks, int chunk_keys,
                   const int64_t* st, float sm_scale, cudaStream_t stream) {
  using S = Shape<D>;
  // Above 48 KB a launch is refused unless the kernel opts in.
  cudaError_t err = cudaFuncSetAttribute(
      decode_attn_split_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  if (err != cudaSuccess) return err;
  decode_attn_split_kernel<D>
      <<<dim3(n_chunks, heads, slots), kThreads, S::kSmem, stream>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v), lengths, o_part, ml_part,
          heads, chunk_keys, st[0], st[1], st[2], st[3], st[4], st[5],
          sm_scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_attn_merge_kernel<D><<<dim3(heads, slots), D, 0, stream>>>(
      o_part, ml_part, static_cast<__nv_bfloat16*>(o), heads, n_chunks);
  return cudaGetLastError();
}

template <int D>
int blocks_per_sm() {
  using S = Shape<D>;
  if (cudaFuncSetAttribute(decode_attn_split_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           S::kSmem) != cudaSuccess) {
    return 0;
  }
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, decode_attn_split_kernel<D>, kThreads, S::kSmem) !=
      cudaSuccess) {
    return 0;
  }
  return n;
}

}  // namespace

extern "C" {

// Launches the split pass and the merge on `stream`; returns the
// cudaError_t of the launches (0 on success). q and o are contiguous bf16
// [slots, heads, head_dim]; k and v bf16 caches with strides in elements
// (slot, seq, head), head_dim contiguous, base pointers and strides 16-byte
// aligned; lengths int32 [slots], each in [1, n_chunks * chunk_keys];
// o_part f32 [slots, heads, n_chunks, head_dim] and ml_part f32 [slots,
// heads, n_chunks, 2] scratch. chunk_keys, the keys of a chunk, must be a
// positive multiple of decode_attn_tile_keys(head_dim), and head_dim 128
// or 256; anything else returns cudaErrorInvalidValue.
int decode_attn(const void* q, const void* k, const void* v,
                const void* lengths, void* o, void* o_part, void* ml_part,
                int slots, int heads, int head_dim, int n_chunks,
                int chunk_keys, int64_t k_sb, int64_t k_ss, int64_t k_sh,
                int64_t v_sb, int64_t v_ss, int64_t v_sh, float sm_scale,
                void* stream) {
  const int tile = head_dim == 128   ? Shape<128>::kKeys
                   : head_dim == 256 ? Shape<256>::kKeys
                                     : 0;
  if (slots <= 0 || heads <= 0 || n_chunks <= 0 || chunk_keys <= 0 ||
      tile == 0 || chunk_keys % tile != 0) {
    return cudaErrorInvalidValue;
  }
  const int64_t st[6] = {k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  const int* len = static_cast<const int*>(lengths);
  float* op = static_cast<float*>(o_part);
  float* ml = static_cast<float*>(ml_part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 128:
      return launch<128>(q, k, v, len, o, op, ml, slots, heads, n_chunks,
                         chunk_keys, st, sm_scale, s);
    case 256:
      return launch<256>(q, k, v, len, o, op, ml, slots, heads, n_chunks,
                         chunk_keys, st, sm_scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Split-pass blocks one SM holds at `head_dim` (0 for a head_dim the kernel
// does not take, or on an error).
int decode_attn_blocks_per_sm(int head_dim) {
  switch (head_dim) {
    case 128:
      return blocks_per_sm<128>();
    case 256:
      return blocks_per_sm<256>();
    default:
      return 0;
  }
}

// Keys a pipeline stage holds at `head_dim`: a chunk is a multiple of it.
int decode_attn_tile_keys(int head_dim) {
  switch (head_dim) {
    case 128:
      return Shape<128>::kKeys;
    case 256:
      return Shape<256>::kKeys;
    default:
      return 0;
  }
}

// Dynamic shared memory a split-pass launch at `head_dim` asks for.
int decode_attn_smem_bytes(int head_dim) {
  switch (head_dim) {
    case 128:
      return Shape<128>::kSmem;
    case 256:
      return Shape<256>::kSmem;
    default:
      return 0;
  }
}

const char* decode_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
