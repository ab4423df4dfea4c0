// Claim-insert dedup into the open-addressing visited table (Hopper).
//
// Replaces the reference's Pallas kernel
// raft_tla_tpu/engine/fingerprint.py:probe_claim_insert_pallas, with its
// outputs exactly: the table, fresh, pos and hovf are those of lanes
// resolving in ascending index order, one after another.  A live lane
// hashes its W key words into a home slot (an fmix32 chain seeded with
// HOME_SALT, masked to VCAP-1) and walks the quadratic probe sequence
// pos_k = home + k(k+1)/2 (mod VCAP) until the slot holds its key (a
// duplicate) or is empty (all-ones: the lane writes its key there and is
// fresh), for at most max_rounds probe steps.  A live lane unresolved
// after them sets hovf and reports the position after its last step; a
// dead lane reports its home slot.
//
// Design: every lane walks in parallel, in claim rounds that reach the
// sequential fixpoint.  During the rounds the table is read only (the
// "committed" table).  In round r each live lane i that is not final
// walks its path and, at each slot s:
//   - s empty in the table, owner_{r-1}[s] = j < i: a duplicate at s if
//     key_j = key_i, else s is blocked and the walk goes on;
//   - s empty, no lower owner: i targets s as a claim,
//     atomicMin(owner_r[s], i) — or, for the all-ones key (which equals
//     EMPTY), is a duplicate at s;
//   - s holds key_i: a duplicate at s;
//   - otherwise the walk goes on, for at most max_rounds steps.
// owner_r[s] is the lowest lane that targeted s in round r.  Lane 0 is
// right in round 1, and once lanes 0..i-1 are right so are the owners
// below i, so lane i is right from round i+1 on: within M+1 rounds one
// round changes no lane's result, which is then the sequential outcome,
// and every claimed slot has one claimant.  The commit writes those
// keys.  The lower-owner test comes before the key test: otherwise an
// all-ones key would be a duplicate at a slot a lower lane takes.
//
// No first-come atomicCAS claim: its winner, and so pos and the table,
// would depend on block scheduling.  Here every output is a function of
// the inputs alone; atomicMin's result does not depend on the order.
//
// One cooperative launch, no host sync: a grid-wide barrier ends each
// round, and a device counter of changed lanes decides the next.  Claim
// state is two slot-indexed u64 arrays (round r writes one, reads the
// other), each word ((~epoch) << 32) | lane, so atomicMin prefers the
// newest round, then the lowest lane, and nothing is cleared between
// rounds or launches; the epoch lives on the device.  Lanes that find
// their key (or no empty slot) in round 1 are final; the others restart
// each round at their first empty slot.
//
// Bound on this card: latency.  Each round is a few dependent random
// reads per pending lane (table words, then the owner word), into
// tables of hundreds of MiB, far past the 50 MB L2, plus a grid barrier;
// the kernel's time is about rounds x (barrier + one walk's latency).
// The bytes it must move are small beside that.
//
// Interface: plain C, loaded with ctypes (engine/cuda_ext.py).  Tensors
// are int32-carried u32 words, [W, VCAP] table and [W, M] keys,
// row-major and contiguous; owner is u64 [2, VCAP] and state u32 [4]
// (the last epoch, then three round counters), both kept per (device,
// VCAP) by the wrapper and used on one stream at a time; k0 is
// int32 [M] scratch; out is int32 [3]: hovf, rounds, error (set when
// M+1 rounds end without a fixpoint).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr uint32_t kHomeSalt = 0x9E3779B9u;
constexpr uint32_t kEmpty = 0xFFFFFFFFu;
constexpr int kMaxWords = 4;
constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;
// a lane's result kind, kept in `fresh` during the rounds
constexpr uint8_t kDup = 0, kClaim = 1, kUnresolved = 2;

struct Args {
  uint32_t* table;
  const uint32_t* keys;
  const uint8_t* live;
  uint8_t* fresh;
  int32_t* pos;
  int32_t* out;                  // hovf, rounds, error
  unsigned long long* owner;     // [2, vcap]
  uint32_t* state;               // the last epoch; changed lanes x 3
  int32_t* k0;                   // [M]: first empty step, -1 when final
  int W;
  int64_t vcap;
  int M;
  int max_rounds;
};

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

// One round's walk of lane m from probe step k.  Returns the result
// kind; *slot gets its slot, *stop the step it stopped at, *at_empty
// whether that slot is empty in the committed table.
__device__ uint8_t walk(const Args& a, int m, const uint32_t* key,
                        bool allones, uint32_t home, int k,
                        const unsigned long long* prev, uint32_t prev_hi,
                        uint32_t* slot, int* stop, bool* at_empty) {
  const uint32_t mask = static_cast<uint32_t>(a.vcap - 1);
  for (; k < a.max_rounds; ++k) {
    const uint32_t p = (home + tri(static_cast<uint32_t>(k))) & mask;
    bool is_key = true, empty = true;
    for (int w = 0; w < a.W; ++w) {
      const uint32_t c = a.table[static_cast<int64_t>(w) * a.vcap + p];
      is_key &= c == key[w];
      empty &= c == kEmpty;
    }
    if (empty) {
      if (prev != nullptr) {
        // written by atomics last round: read past L1 (__ldcg)
        const unsigned long long o = __ldcg(prev + p);
        const uint32_t j = static_cast<uint32_t>(o);
        if (static_cast<uint32_t>(o >> 32) == prev_hi &&
            j < static_cast<uint32_t>(m)) {
          bool same = true;
          for (int w = 0; w < a.W; ++w)
            same &= a.keys[static_cast<int64_t>(w) * a.M + j] == key[w];
          if (!same) continue;              // blocked by a lower claim
          *slot = p, *stop = k, *at_empty = true;
          return kDup;
        }
      }
      *slot = p, *stop = k, *at_empty = true;
      return allones ? kDup : kClaim;
    }
    if (is_key) {
      *slot = p, *stop = k, *at_empty = false;
      return kDup;
    }
  }
  *slot = (home + tri(static_cast<uint32_t>(a.max_rounds))) & mask;
  *stop = a.max_rounds, *at_empty = false;
  return kUnresolved;
}

__global__ void __launch_bounds__(kThreads)
probe_claim_rounds(Args a) {
  cg::grid_group grid = cg::this_grid();
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t nthreads = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const uint32_t mask = static_cast<uint32_t>(a.vcap - 1);
  uint32_t* const changed = a.state + 1;   // per round mod 3
  // Epochs must grow through this launch's M+1 rounds at most: if they
  // would pass 2^32, every thread sees it alike and the owners restart.
  uint32_t base = a.state[0];
  if (static_cast<uint64_t>(base) + a.M + 1 > 0xFFFFFFFFull) {
    for (int64_t i = tid; i < 2 * a.vcap; i += nthreads) a.owner[i] = ~0ull;
    base = 0;
  }
  if (tid == 0) {
    changed[0] = changed[1] = changed[2] = 0;
    a.out[0] = 0;
  }
  grid.sync();

  int rounds = 0;
  bool converged = false;
  for (int r = 1; r <= a.M + 1; ++r) {
    const uint32_t ep = base + static_cast<uint32_t>(r);
    unsigned long long* cur = a.owner + static_cast<int64_t>(r & 1) * a.vcap;
    const unsigned long long* prev =
        r == 1 ? nullptr
               : a.owner + static_cast<int64_t>((r - 1) & 1) * a.vcap;
    int moved = 0;
    for (int64_t m = tid; m < a.M; m += nthreads) {
      if (r > 1 && a.k0[m] < 0) continue;   // final (or dead)
      uint32_t key[kMaxWords];
      uint32_t h = kHomeSalt;
      bool allones = true;
      for (int w = 0; w < a.W; ++w) {
        key[w] = a.keys[static_cast<int64_t>(w) * a.M + m];
        h = fmix32(h ^ key[w]);
        allones &= key[w] == kEmpty;
      }
      const uint32_t home = h & mask;
      if (r == 1 && !a.live[m]) {
        a.pos[m] = static_cast<int32_t>(home);
        a.fresh[m] = kDup;
        a.k0[m] = -1;
        continue;
      }
      uint32_t slot;
      int stop;
      bool at_empty;
      const uint8_t kind = walk(a, static_cast<int>(m), key, allones, home,
                                r == 1 ? 0 : a.k0[m], prev, ~(ep - 1u),
                                &slot, &stop, &at_empty);
      if (kind == kClaim)
        atomicMin(cur + slot,
                  (static_cast<unsigned long long>(~ep) << 32) |
                      static_cast<unsigned long long>(m));
      if (r == 1) {
        a.k0[m] = at_empty ? stop : -1;
        moved = 1;
      } else if (kind != a.fresh[m] ||
                 slot != static_cast<uint32_t>(a.pos[m])) {
        moved = 1;
      }
      a.fresh[m] = kind;
      a.pos[m] = static_cast<int32_t>(slot);
    }
    const int n = __syncthreads_count(moved);
    if (threadIdx.x == 0 && n) atomicAdd(changed + r % 3, n);
    // the counter of round r+1 was last read in round r-2
    if (tid == 0) changed[(r + 1) % 3] = 0;
    grid.sync();
    rounds = r;
    if (*reinterpret_cast<volatile uint32_t*>(changed + r % 3) == 0) {
      converged = true;
      break;
    }
  }

  // commit: at the fixpoint every claimed slot has one claimant
  bool over = false;
  for (int64_t m = tid; m < a.M; m += nthreads) {
    const uint8_t kind = a.fresh[m];
    if (kind == kClaim) {
      const uint32_t s = static_cast<uint32_t>(a.pos[m]);
      for (int w = 0; w < a.W; ++w)
        a.table[static_cast<int64_t>(w) * a.vcap + s] =
            a.keys[static_cast<int64_t>(w) * a.M + m];
    }
    over |= kind == kUnresolved;
    a.fresh[m] = kind == kClaim;
  }
  if (over) a.out[0] = 1;
  if (tid == 0) {
    a.state[0] = base + static_cast<uint32_t>(rounds);
    a.out[1] = rounds;
    a.out[2] = converged ? 0 : 1;
  }
}

int grid_limit(int* blocks) {
  static int cached[kMaxDevices];
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < kMaxDevices && cached[dev]) {
    *blocks = cached[dev];
    return 0;
  }
  int coop = 0, sms = 0, per_sm = 0;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                  dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, probe_claim_rounds, kThreads, 0)) != cudaSuccess)
    return static_cast<int>(e);
  if (!coop || per_sm < 1)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  *blocks = sms * per_sm;
  if (dev < kMaxDevices) cached[dev] = *blocks;
  return 0;
}

}  // namespace

extern "C" int probe_claim_insert_cuda(void* table, const void* keys,
                                       const void* live, void* fresh,
                                       void* pos, void* out, void* owner,
                                       void* state, void* k0, int W, long long vcap, int M,
                                       int max_rounds, void* stream) {
  if (W < 1 || W > kMaxWords) return static_cast<int>(cudaErrorInvalidValue);
  int limit = 0;
  if (int rc = grid_limit(&limit)) return rc;
  const int64_t want = (static_cast<int64_t>(M) + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 1 ? 1 : want < limit ? want
                                                                  : limit);
  Args a{static_cast<uint32_t*>(table), static_cast<const uint32_t*>(keys),
         static_cast<const uint8_t*>(live), static_cast<uint8_t*>(fresh),
         static_cast<int32_t*>(pos), static_cast<int32_t*>(out),
         static_cast<unsigned long long*>(owner),
         static_cast<uint32_t*>(state), static_cast<int32_t*>(k0), W, static_cast<int64_t>(vcap), M,
         max_rounds};
  void* args[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(probe_claim_rounds), dim3(blocks),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* probe_claim_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
