// Stencil k-nearest selection for the entity-simulation tick, written by
// hand for Hopper (sm_90a).
//
// Replaces: worldql_server_tpu/ops/knn_pallas.py::knn_select (the Pallas
// kernel at knn_pallas.py:174, body `kernel`/`tile_body`/`_bitonic_kv`).
//
// What it computes. Rows are the tick's sort order (entities sorted by
// spatial-hash key), so the members of one cube form a contiguous run.
// For each row i the candidates are the rows i-(K-1) .. i+(K-1). A
// candidate j is kept when rid[j] == rid[i], peer[j] != peer[i] and
// rid[i] >= 0; its key is the IEEE bits of the f32 squared distance
// dx*dx + dy*dy + dz*dz as an unsigned int, its value the peer id. Every
// other candidate carries (0xFFFFFFFF, -1), so NaN distances (all NaN
// bit patterns but one are below 0xFFFFFFFF) sort after finite ones and
// before invalid slots. Pairs compare lexicographically (key, then value
// as a signed int), and the K smallest values land nearest first in
// out[i*K .. i*K+K-1], -1-padded.
//
// Bound. Per row the kernel must read rid, peer (4 B each) and pos
// (12 B) and write K 4-byte peer ids: 20 + 4K bytes. At N=131,072 and
// K=32 that is ~19.4 MB (~5.8 us at 3.35 TB/s); at N=1,048,576 and K=8
// ~54.5 MB (~16.3 us). The arithmetic these inputs need (8 f32 operations
// per kept candidate, about log2 K compares to place it) is ~1-3 us at
// either shape, so the bytes bound it.
//
// What the first design (one thread per row, an insertion list; kept
// below as knn_insert_kernel) lost time to. Each kept candidate went
// through a fully unrolled KMAX-deep compare-swap chain behind
// `if (!same) continue;`. A warp runs a candidate's chain when any one
// of its 32 lanes keeps it: 54.8 of 62 offsets per warp at K=32, 13.9 of
// 14 at K=8 on the chip check's inputs, ~7 integer instructions a step,
// ~50 M warp instructions at K=32 and ~25 M at K=8. Every step depended
// on the previous one, so the chain had no instruction-level
// parallelism. And each thread wrote its K ids to out + row*K: one warp
// store touched 32 sectors 4 bytes at a time.
//
// Design. What sets the time now is the integer issue of the network:
// compares and selects run on 64 lanes of an SM per clock, and each
// 64-bit compare-exchange takes six of them (PERF.md has the times).
// * One thread per sorted row. A block stages its 128 rows plus the
//   K-1 halo on the left and W-K on the right into shared memory (rid
//   and the peer's low word as int2, pos as float4), each input byte
//   read from device memory about once per block; rows past either
//   array end are staged as rid = -1 so they never match.
// * Each candidate becomes one packed u64, (d2_bits << 32) |
//   (peer ^ 0x80000000): the unsigned 64-bit order is exactly the
//   (key, value-as-signed) order. An invalid slot is the invalid pair
//   packed the same way, 0xFFFFFFFF_7FFFFFFF (not all ones, which would
//   decode to 0x7FFFFFFF), above every kept key: the card's f32
//   arithmetic returns the canonical NaN 0x7FFFFFFF whatever NaN comes
//   in, so no distance has the bits 0xFFFFFFFF.
// * knn_network_kernel<W, FULL> (K <= 32, W = next_pow2(2K-1), W >= 2)
//   is a branch-free selection network. The thread fills W register
//   slots, slot s with candidate i-(K-1)+s; the self slot K-1, the pad
//   slots >= 2K-1 and the dropped candidates hold the invalid key, by
//   select, with no `continue`, so every lane runs the same instruction
//   stream. It sorts both halves ascending with unrolled odd-even merge
//   networks, takes the slot-wise minimum of the first half against the
//   second reversed (the W/2 >= K smallest keys, as a bitonic sequence)
//   and merges that. At K = W/2 (FULL: the server's K=8 and K=32) the
//   last slot of each half is the row itself or past the window, so it
//   is never computed and the networks leave it out. Compare-exchanges a
//   row: 2*186 + 30 + 80 = 482 at K=32, 2*16 + 6 + 12 = 50 at K=8, each
//   stage's exchanges independent of one another.
// * The block's ids are staged in shared memory (128*K words, 16-byte
//   chunks XOR-swizzled so that neither side conflicts on banks) and
//   written as one contiguous slice of `out` with 16-byte stores by
//   consecutive threads; the ragged last block writes what its rows
//   hold, with 4-byte stores for a tail that is not whole chunks.
// * knn_insert_kernel<KMAX> (K > 32) is the first design, kept as the
//   kernel for those K: at W = 128 the network would need 256 registers
//   of keys a thread. Dispatch by K, not a fallback: every K has one
//   kernel.
// * The distance is formed with __fmul_rn/__fadd_rn/__fsub_rn (and the
//   library is built with --fmad=false): a contracted FMA would change
//   the d2 bits and hence the order against the plain version.
// None of the TPU layout carries over: no sublane bitonic network, no
// 128-lane window rounding, no chunked single-program grid.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

constexpr int kBlock = 128;
constexpr unsigned kInvalidKey = 0xFFFFFFFFu;
// the invalid pair (0xFFFFFFFF, -1) packed: -1 ^ 0x80000000 = 0x7FFFFFFF
constexpr u64 kInvalidPacked = 0xFFFFFFFF7FFFFFFFull;
constexpr unsigned kSignFlip = 0x80000000u;
// largest K the network kernel takes (W = 64)
constexpr int kNetworkMaxK = 32;

__host__ __device__ constexpr int log2_of(int w) {
  return w <= 1 ? 0 : 1 + log2_of(w / 2);
}

// a <= b afterwards. The minimum is one 64-bit compare (two ISETP) and
// a 64-bit select (two SEL); the maximum is a ^ b ^ min (two LOP3).
// Written in PTX because the C++ form `lt ? a : b`, `lt ? b : a` (like
// a u64 min and max) compiles to a second compare for the maximum.
__device__ __forceinline__ void cx(u64& a, u64& b) {
  u64 lo, hi;
  asm("{\n\t.reg .pred p;\n\t"
      "setp.lt.u64 p, %2, %3;\n\t"
      "selp.b64 %0, %2, %3, p;\n\t"
      "xor.b64 %1, %2, %3;\n\t"
      "xor.b64 %1, %1, %0;\n\t}"
      : "=l"(lo), "=l"(hi)
      : "l"(a), "l"(b));
  a = lo;
  b = hi;
}

// Batcher's odd-even merge sort, ascending, of the first R of N keys (N
// a power of two); the keys from R on are the invalid key, which stays
// on top, so every comparator that touches them is left out. 19
// compare-exchanges at N=8 (16 at R=7), 191 at N=32 (186 at R=31),
// against 24 and 240 for a bitonic sort. Every loop has a constant trip
// count and every comparator a compile-time guard, so all of them
// unroll, every index is a constant and the keys stay in registers.
// Comparator (e, e+k) of the pass (p, k) is the one Batcher's iterative
// form reaches with i+j = e.
template <int N, int R>
__device__ __forceinline__ void sort_network(u64 (&v)[N]) {
  constexpr int kLog = log2_of(N);
#pragma unroll
  for (int lp = 0; lp < kLog; ++lp) {
#pragma unroll
    for (int q = 0; q < kLog; ++q) {
      const int lk = lp - q;  // k = 2^lk from p = 2^lp down to 1
      if (lk >= 0) {
        const int p = 1 << lp;
        const int k = 1 << lk;
        const int j0 = k % p;
#pragma unroll
        for (int e = 0; e < N; ++e) {
          if (e + k < R && e >= j0 && (e - j0) % (2 * k) < k &&
              e / (2 * p) == (e + k) / (2 * p)) {
            cx(v[e], v[e + k]);
          }
        }
      }
    }
  }
}

// Ascending merge of a bitonic sequence of N keys.
template <int N>
__device__ __forceinline__ void bitonic_merge(u64 (&v)[N]) {
  constexpr int kLog = log2_of(N);
#pragma unroll
  for (int lt = kLog - 1; lt >= 0; --lt) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int j = i ^ (1 << lt);
      if (j > i) cx(v[i], v[j]);
    }
  }
}

// 16-byte chunk c of the staged output lives at chunk swz(c): the XOR
// stays inside c's aligned group of 8 chunks (one 128-byte bank line),
// so a quarter-warp storing chunk q of 8 consecutive rows, or reading 8
// consecutive chunks, touches 8 distinct 16-byte bank groups.
__device__ __forceinline__ int swz(int c) { return c ^ ((c >> 3) & 7); }

__device__ __forceinline__ int swz_word(int w) {
  return (swz(w >> 2) << 2) | (w & 3);
}

__device__ __forceinline__ int packed_id(u64 key) {
  return static_cast<int>(static_cast<unsigned>(key) ^ kSignFlip);
}

template <int W, bool FULL>
__global__ void __launch_bounds__(kBlock)
knn_network_kernel(const int* __restrict__ rid, const int* __restrict__ peer,
                   const float* __restrict__ pos, int n, int k,
                   int* __restrict__ out) {
  constexpr int H = W / 2;
  // FULL (K == W/2): the last slot of each half, H-1 (the row itself)
  // and W-1 (past the window), holds the invalid key at compile time
  constexpr int R = FULL ? H - 1 : H;  // slots of a half that may keep
  constexpr int kSpan = kBlock + W;  // rows tid .. tid+W-1, even
  extern __shared__ __align__(16) unsigned char smem[];
  float4* s_pos = reinterpret_cast<float4*>(smem);
  int2* s_rp = reinterpret_cast<int2*>(s_pos + kSpan);
  int* s_out = reinterpret_cast<int*>(s_rp + kSpan);

  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * kBlock;
  const long long base = row0 - (k - 1);
  for (int t = tid; t < kSpan; t += kBlock) {
    const long long g = base + t;
    int2 rp = make_int2(-1, -1);
    float4 p = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (g >= 0 && g < n) {
      rp = make_int2(rid[g], peer[g] ^ kSignFlip);  // the packed low word
      p = make_float4(pos[3 * g], pos[3 * g + 1], pos[3 * g + 2], 0.0f);
    }
    s_rp[t] = rp;
    s_pos[t] = p;
  }
  __syncthreads();

  const int2 me = s_rp[tid + k - 1];
  const float4 p0 = s_pos[tid + k - 1];
  const bool live = me.x >= 0;
  const int last = FULL ? W - 2 : 2 * k - 2;  // last candidate slot

  auto candidate = [&](int s) -> u64 {
    const int2 q = s_rp[tid + s];
    const float4 pq = s_pos[tid + s];
    const bool keep = live && s <= last && q.x == me.x && q.y != me.y;
    const float dx = __fsub_rn(pq.x, p0.x);
    const float dy = __fsub_rn(pq.y, p0.y);
    const float dz = __fsub_rn(pq.z, p0.z);
    const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                               __fmul_rn(dz, dz));
    const u64 key = (static_cast<u64>(__float_as_uint(d2)) << 32) |
                    static_cast<unsigned>(q.y);
    return keep ? key : kInvalidPacked;
  };

  u64 a[H];
  u64 b[H];
#pragma unroll
  for (int s = 0; s < H; ++s) a[s] = s < R ? candidate(s) : kInvalidPacked;
  sort_network<H, R>(a);
#pragma unroll
  for (int s = 0; s < H; ++s) {
    b[s] = s < R ? candidate(H + s) : kInvalidPacked;
  }
  sort_network<H, R>(b);
  // a ascending against b reversed: the H smallest keys, as a bitonic
  // sequence (a[i] or b[H-1-i] is the invalid key past R: no compare)
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const u64 y = b[H - 1 - i];
    if (i >= R) a[i] = y;
    else if (H - 1 - i < R) a[i] = a[i] < y ? a[i] : y;
  }
  bitonic_merge<H>(a);

  // stage this row's K ids: words tid*K .. tid*K+K-1 of the block slice
  if constexpr (H >= 4) {
    if ((k & 3) == 0) {
      int4* s_out4 = reinterpret_cast<int4*>(s_out);
#pragma unroll
      for (int j = 0; j < H; j += 4) {
        if (j < k) {
          s_out4[swz((tid * k + j) >> 2)] =
              make_int4(packed_id(a[j]), packed_id(a[j + 1]),
                        packed_id(a[j + 2]), packed_id(a[j + 3]));
        }
      }
    }
  }
  if (H < 4 || (k & 3) != 0) {
#pragma unroll
    for (int j = 0; j < H; ++j) {
      if (j < k) s_out[swz_word(tid * k + j)] = packed_id(a[j]);
    }
  }
  __syncthreads();

  // the block's rows are one contiguous slice of out (16-byte aligned:
  // 128*K words per block from a 16-byte aligned base)
  const long long left = n - row0;
  const int rows = left < kBlock ? static_cast<int>(left) : kBlock;
  const int words = rows * k;
  int* dst = out + row0 * k;
  const int chunks = words >> 2;
  const int4* s_out4 = reinterpret_cast<const int4*>(s_out);
  int4* dst4 = reinterpret_cast<int4*>(dst);
  for (int c = tid; c < chunks; c += kBlock) dst4[c] = s_out4[swz(c)];
  for (int w = 4 * chunks + tid; w < words; w += kBlock) {
    dst[w] = s_out[swz_word(w)];
  }
}

template <int KMAX>
__global__ void __launch_bounds__(kBlock)
knn_insert_kernel(const int* __restrict__ rid, const int* __restrict__ peer,
                  const float* __restrict__ pos, int n, int k,
                  int* __restrict__ out) {
  extern __shared__ unsigned char smem[];
  const int halo = k - 1;
  const int span = kBlock + 2 * halo;
  int* s_rid = reinterpret_cast<int*>(smem);
  int* s_peer = s_rid + span;
  float* s_x = reinterpret_cast<float*>(s_peer + span);
  float* s_y = s_x + span;
  float* s_z = s_y + span;

  const long long base = static_cast<long long>(blockIdx.x) * kBlock - halo;
  for (int t = threadIdx.x; t < span; t += kBlock) {
    const long long g = base + t;
    if (g >= 0 && g < n) {
      s_rid[t] = rid[g];
      s_peer[t] = peer[g];
      s_x[t] = pos[3 * g + 0];
      s_y[t] = pos[3 * g + 1];
      s_z[t] = pos[3 * g + 2];
    } else {
      s_rid[t] = -1;
      s_peer[t] = -1;
      s_x[t] = 0.0f;
      s_y[t] = 0.0f;
      s_z[t] = 0.0f;
    }
  }
  __syncthreads();

  const long long row = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (row >= n) return;

  const int self = threadIdx.x + halo;
  const int r0 = s_rid[self];
  const int p0 = s_peer[self];
  const float x0 = s_x[self];
  const float y0 = s_y[self];
  const float z0 = s_z[self];

  unsigned lk[KMAX];
  int lv[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    lk[j] = kInvalidKey;
    lv[j] = -1;
  }

  const int w = 2 * k - 1;
  for (int s = 0; s < w; ++s) {
    const int c = threadIdx.x + s;
    const bool same = (s_rid[c] == r0) && (s_peer[c] != p0) && (r0 >= 0);
    if (!same) continue;  // (0xFFFFFFFF, -1) never displaces a list entry
    const float dx = __fsub_rn(s_x[c], x0);
    const float dy = __fsub_rn(s_y[c], y0);
    const float dz = __fsub_rn(s_z[c], z0);
    const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                               __fmul_rn(dz, dz));
    unsigned ck = __float_as_uint(d2);
    int cv = s_peer[c];
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (ck < lk[j] || (ck == lk[j] && cv < lv[j])) {
        const unsigned tk = lk[j];
        const int tv = lv[j];
        lk[j] = ck;
        lv[j] = cv;
        ck = tk;
        cv = tv;
      }
    }
  }

  int* dst = out + row * k;
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j < k) dst[j] = lv[j];
  }
}

using KernelFn = void (*)(const int*, const int*, const float*, int, int,
                          int*);

// The one kernel that serves K: kind 0 = knn_network_kernel<width,
// full>, kind 1 = knn_insert_kernel<width>; smem = dynamic shared bytes.
struct Choice {
  KernelFn fn;
  int kind;
  int width;
  bool full;
  size_t smem;
};

template <int W>
Choice network(int k) {
  const size_t smem =
      static_cast<size_t>(kBlock + W) * (sizeof(float4) + sizeof(int2)) +
      static_cast<size_t>(kBlock) * k * sizeof(int);
  if (2 * k == W) return {knn_network_kernel<W, true>, 0, W, true, smem};
  return {knn_network_kernel<W, false>, 0, W, false, smem};
}

template <int KMAX>
Choice insertion(int k) {
  return {knn_insert_kernel<KMAX>, 1, KMAX, false,
          static_cast<size_t>(kBlock + 2 * (k - 1)) *
              (2 * sizeof(int) + 3 * sizeof(float))};
}

Choice choose(int k) {
  if (k <= 1) return network<2>(k);
  if (k <= 2) return network<4>(k);
  if (k <= 4) return network<8>(k);
  if (k <= 8) return network<16>(k);
  if (k <= 16) return network<32>(k);
  if (k <= kNetworkMaxK) return network<64>(k);
  if (k <= 64) return insertion<64>(k);
  if (k <= 128) return insertion<128>(k);
  return insertion<256>(k);
}

}  // namespace

// C entry point (loaded with ctypes). Returns a cudaError_t: 0 on a
// successful launch, cudaErrorInvalidValue for a K outside [1, 256],
// cudaErrorMisalignedAddress for an output not 16-byte aligned.
extern "C" int wql_knn_select(const void* rid, const void* peer,
                              const void* pos, int n, int k, void* out,
                              void* stream) {
  if (k < 1 || k > 256 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(out) & 15) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (n == 0) return 0;
  const Choice c = choose(k);
  const int grid = (n + kBlock - 1) / kBlock;
  c.fn<<<grid, kBlock, c.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rid), static_cast<const int*>(peer),
      static_cast<const float*>(pos), n, k, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Which kernel serves K and what it holds on the card: info[0] kind
// (0 network, 1 insertion), info[1] its width (W or KMAX), info[2] 1 for
// the network's FULL form, info[3] registers a thread, info[4] local
// memory bytes a thread, info[5] shared memory bytes a block at this K.
// Returns a cudaError_t.
extern "C" int wql_knn_kernel_info(int k, int* info) {
  if (k < 1 || k > 256) return static_cast<int>(cudaErrorInvalidValue);
  const Choice c = choose(k);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, c.fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = c.kind;
  info[1] = c.width;
  info[2] = c.full;
  info[3] = attr.numRegs;
  info[4] = static_cast<int>(attr.localSizeBytes);
  info[5] = static_cast<int>(attr.sharedSizeBytes + c.smem);
  return 0;
}
