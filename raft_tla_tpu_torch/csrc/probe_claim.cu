// Claim-insert dedup into the open-addressing visited table (Hopper).
//
// Replaces the reference's Pallas kernel
// raft_tla_tpu/engine/fingerprint.py:probe_claim_insert_pallas, with its
// semantics exactly: lanes resolve in ascending index order, one after
// another.  A live lane hashes its W key words into a home slot (an
// fmix32 chain seeded with HOME_SALT, masked to VCAP-1) and walks the
// quadratic probe sequence pos_k = home + k(k+1)/2 (mod VCAP) until the
// slot holds its key (a duplicate) or is empty (all-ones: the lane
// writes its key there and is fresh), for at most max_rounds steps.  A
// live lane unresolved after max_rounds sets hovf and reports the
// position after its last step; a dead lane reports its home slot.
//
// Design: ONE block of ONE warp walks the lanes in order, so the result
// never depends on scheduling (a first-come atomicCAS claim would).  For
// each lane the 32 threads test 32 consecutive probe positions at once
// against the same table state — a lane writes nothing until it
// resolves, so this equals the one-step-at-a-time walk — and
// __ballot_sync picks the first position that holds the key or is
// empty.  Thread 0 writes the claim; __syncwarp orders it before the
// next lane's loads, which bypass L1 (__ldcg).
//
// Bound on this card: latency.  The walk is a chain of dependent random
// reads into a table of up to hundreds of MiB, one lane after another,
// so it does about one device-memory round trip per live lane and uses
// one SM of 132.  The bytes it must move (keys in, fresh/pos out, one
// table word read per probe) are tiny beside that.  A parallel design
// that keeps the sequential fixpoint (rank-ordered rounds with atomicMin
// claims) is the way past this bound.
//
// Interface: plain C, loaded with ctypes (engine/cuda_ext.py).  Tensors
// are int32-carried u32 words, [W, VCAP] table and [W, M] keys,
// row-major and contiguous.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kHomeSalt = 0x9E3779B9u;
constexpr uint32_t kEmpty = 0xFFFFFFFFu;
constexpr int kMaxWords = 4;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t tri(uint32_t k) {
  return static_cast<uint32_t>((static_cast<uint64_t>(k) * (k + 1)) >> 1);
}

__global__ void __launch_bounds__(32, 1)
probe_claim_kernel(uint32_t* __restrict__ table,
                   const uint32_t* __restrict__ keys,
                   const uint8_t* __restrict__ live,
                   uint8_t* __restrict__ fresh, int32_t* __restrict__ pos,
                   int32_t* __restrict__ hovf, int W, int64_t vcap, int M,
                   int max_rounds) {
  const int lane = threadIdx.x;
  const uint32_t mask = static_cast<uint32_t>(vcap - 1);
  int over = 0;
  for (int m = 0; m < M; ++m) {
    uint32_t key[kMaxWords];
    uint32_t h = kHomeSalt;
    for (int w = 0; w < W; ++w) {
      key[w] = keys[static_cast<int64_t>(w) * M + m];
      h = fmix32(h ^ key[w]);
    }
    const uint32_t home = h & mask;
    if (!live[m]) {
      if (lane == 0) {
        pos[m] = static_cast<int32_t>(home);
        fresh[m] = 0;
      }
      continue;
    }
    uint32_t found = tri(static_cast<uint32_t>(max_rounds));
    int claim = 0, resolved = 0;
    for (int k0 = 0; k0 < max_rounds; k0 += 32) {
      const int k = k0 + lane;
      const uint32_t p = (home + tri(static_cast<uint32_t>(k))) & mask;
      bool is_key = true, is_empty = true;
      if (k < max_rounds) {
        for (int w = 0; w < W; ++w) {
          const uint32_t c = __ldcg(table + static_cast<int64_t>(w) * vcap + p);
          is_key &= c == key[w];
          is_empty &= c == kEmpty;
        }
      }
      const unsigned hit =
          __ballot_sync(0xFFFFFFFFu, k < max_rounds && (is_key || is_empty));
      if (hit) {
        const int first = __ffs(hit) - 1;
        claim = __shfl_sync(0xFFFFFFFFu, static_cast<int>(!is_key), first);
        found = __shfl_sync(0xFFFFFFFFu, p, first);
        resolved = 1;
        break;
      }
    }
    if (!resolved) {
      found = (home + found) & mask;
      over = 1;
    }
    if (lane == 0) {
      if (claim) {
        for (int w = 0; w < W; ++w)
          table[static_cast<int64_t>(w) * vcap + found] = key[w];
        __threadfence_block();
      }
      pos[m] = static_cast<int32_t>(found);
      fresh[m] = static_cast<uint8_t>(claim);
    }
    __syncwarp();
  }
  if (lane == 0) hovf[0] = over;
}

}  // namespace

extern "C" int probe_claim_insert_cuda(void* table, const void* keys,
                                       const void* live, void* fresh,
                                       void* pos, void* hovf, int W,
                                       long long vcap, int M, int max_rounds,
                                       void* stream) {
  if (W < 1 || W > kMaxWords) return static_cast<int>(cudaErrorInvalidValue);
  probe_claim_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(table), static_cast<const uint32_t*>(keys),
      static_cast<const uint8_t*>(live), static_cast<uint8_t*>(fresh),
      static_cast<int32_t*>(pos), static_cast<int32_t*>(hovf), W,
      static_cast<int64_t>(vcap), M, max_rounds);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* probe_claim_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
