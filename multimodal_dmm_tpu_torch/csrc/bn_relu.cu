// Training-mode BatchNorm followed by ReLU, forward and backward, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves its codecs' BatchNorm
// (multimodal_dmm_tpu/models/nn.py: batchnorm_apply) and the ReLU after it to
// XLA. In the port they ran on cuDNN's BatchNorm, torch.var_mean for the
// running state and F.relu, about 14 launches a site; these four kernels take
// their place in single-rank training on CUDA float32
// (models/nn.py: batchnorm_relu_apply; ops/cuda/bn_relu.py):
//
//   bn_relu_stats_kernel  for each channel c of x (N, C, S), over its R = N S
//     elements: the batch mean and biased variance, saved as mean and
//     inv_std = 1 / sqrt(var + eps), and the running state moved towards
//     them, new = (1 - momentum) old + momentum batch (the variance unbiased,
//     times R / (R - 1)), written to fresh outputs.
//   bn_relu_apply_kernel  y = relu(pre), pre = fmaf(x - mean, a, beta),
//     a = gamma inv_std.
//   bn_relu_grad_sums_kernel  from dy and x: dbeta = sum dy', dgamma =
//     sum dy' xhat, where xhat = (x - mean) inv_std and dy' = dy where
//     pre > 0, else 0. The mask is recomputed from x by the forward's own
//     expression (bn_pre), so it is the forward's bit for bit; y is not kept.
//   bn_relu_grad_apply_kernel  dx = a (dy' - (dbeta + xhat dgamma) / R).
//
// Everything is float32: the statistics by Welford-style partials (each
// thread takes batches of kUnroll values shifted by the batch's first, so a
// constant channel gives a variance of exactly 0, merged by Chan's rule),
// never E[x^2] - E[x]^2.
//
// Layout: x is dense, either with channel-major planes ("NCS": element
// (n, c, s) at (n C + c) S + s, PyTorch's contiguous NCHW and NCW) or
// channels-last ("NSC": at (n S + s) C + c), S the product of the spatial
// sizes; y, dy and dx share x's offsets. The wrapper picks the layout from
// the strides and makes no copy for either.
//
// What bounds it on the H100: device memory. The codecs normalise few
// channels (4 to 32) over 0.4-1.3 M elements each; the least traffic is x
// read and y written forward, dy and x read and dx written backward, 20
// bytes an element, and the two passes each way (statistics, then apply)
// read x (and dy) twice: 32 bytes an element unless L2 still holds them.
// cuDNN's kernels spread this work by channel, so a site with 4 channels
// ran on a few SMs.
//
// Design. The reduction kernels cut every channel's R elements into chunks,
// by a plan made here from (N, C, S), the layout and the card's SM count
// (make_plan), so that about four blocks land on every SM whatever C is:
//   NCS: a grid (C, chunks); a block owns one channel's chunk, its threads
//     walk consecutive elements of the planes (coalesced), one channel each.
//   NSC: a grid (chunks); a block owns a chunk of rows with all C channels,
//     blockDim a multiple of C, so thread t always takes channel t % C and a
//     warp reads consecutive floats.
// Each block reduces its threads' partials by a fixed tree in shared memory
// and writes one partial a channel; then it takes a ticket from an integer
// counter (atomicAdd: one counter a channel for NCS, one for NSC). The
// block that draws the last ticket merges all the chunks' partials in a
// fixed order, writes the channel's results and resets the counter. No
// float atomics: the result is the same bit for bit in every run. The
// counters and the partials live in a workspace that the caller keeps for
// one stream (bn_relu_workspace_bytes; zeroed once when made): launches on
// one stream take it one after another, as the stream orders them, and
// launches on two streams never share one. The apply kernels walk the flat
// tensor with 16-byte loads where every pointer is aligned and the size a
// multiple of 4 (else by floats), from the end back to the start: the
// reduction before them ended there, so their first reads find it in L2.
// Channel indices of flat offsets come from multiply-high divisions by S
// and C.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;    // blocks an SM, so at most 64 registers
constexpr int kUnroll = 8;       // loads in flight a thread and batch
constexpr int kMaxChannels = 1024;
constexpr int kApplyBlocks = 8;  // apply blocks an SM (8 x 256 threads)
// The workspace: kMaxChannels ticket counters, then the chunks' partials
// (a Welford count, mean and sum of squares; the backward's two sums fit).
constexpr long long kTicketBytes = kMaxChannels * sizeof(unsigned int);
constexpr long long kPartialBytes = 3 * sizeof(float);

// n / d for n < 2^31 by a multiply-high (PyTorch's IntDivider).
struct FastDiv {
  uint32_t m, s;
};

FastDiv make_div(uint32_t d) {
  FastDiv f;
  f.s = 0;
  while (f.s < 31 && (1u << f.s) < d) ++f.s;
  const uint64_t one = 1;
  f.m = (uint32_t)(((one << 32) * ((one << f.s) - d)) / d + 1);
  return f;
}

__device__ __forceinline__ uint32_t fdiv(const FastDiv& f, uint32_t n) {
  return (__umulhi(n, f.m) + n) >> f.s;
}

struct Params {
  const float* x;
  const float* dy;
  const float* gamma;
  const float* beta;
  const float* mean;  // saved statistics (apply and backward)
  const float* inv;
  const float* run_mean;
  const float* run_var;
  float* y;  // y, or dx
  float* save_mean;
  float* save_inv;
  float* new_mean;
  float* new_var;
  float* dgamma;
  float* dbeta;
  unsigned int* tickets;
  void* partials;
  int C;
  uint32_t S, rows, numel;  // rows = N S
  int chunks;
  uint32_t chunk_len;  // elements of a channel (NCS) or rows (NSC) a chunk
  float eps, momentum, keep;
  FastDiv div_s, div_c;
};

// The BatchNorm's output before the ReLU, and the ReLU's mask (pre > 0):
// one expression for the forward and the backward.
__device__ __forceinline__ float bn_pre(float x, float mean, float a,
                                        float beta) {
  return fmaf(x - mean, a, beta);
}

__device__ __forceinline__ float bn_scale(float gamma, float inv) {
  return __fmul_rn(gamma, inv);
}

// Welford partial: count, mean, sum of squared deviations.
struct Stat {
  int n;
  float mean, m2;
};

__device__ __forceinline__ void merge(Stat& a, const Stat& b) {
  if (b.n == 0) return;
  if (a.n == 0) {
    a = b;
    return;
  }
  const int n = a.n + b.n;
  const float w = (float)b.n / (float)n;
  const float delta = b.mean - a.mean;
  a.mean = fmaf(delta, w, a.mean);
  a.m2 = a.m2 + b.m2 + delta * delta * ((float)a.n * w);
  a.n = n;
}

__device__ __forceinline__ Stat load_partial(const Stat* p) {
  Stat s;
  s.n = __ldcg(&p->n);
  s.mean = __ldcg(&p->mean);
  s.m2 = __ldcg(&p->m2);
  return s;
}

// The backward's two sums.
struct Sums {
  float dy, dyx;
};

__device__ __forceinline__ void merge(Sums& a, const Sums& b) {
  a.dy += b.dy;
  a.dyx += b.dyx;
}

__device__ __forceinline__ Sums load_partial(const Sums* p) {
  Sums s;
  s.dy = __ldcg(&p->dy);
  s.dyx = __ldcg(&p->dyx);
  return s;
}

// Offset of the q-th element of a block's walk: NCS, element base + q of
// channel c; NSC, flat offset base + q.
template <int kLayout>
__device__ __forceinline__ uint32_t walk_offset(const Params& p,
                                                uint32_t base, uint32_t q,
                                                int c) {
  if (kLayout == 0) {
    const uint32_t i = base + q;
    const uint32_t n = fdiv(p.div_s, i);
    return (n * p.C + c) * p.S + (i - n * p.S);
  }
  return base + q;
}

// The channel of a flat offset.
template <int kLayout>
__device__ __forceinline__ int channel_of(const Params& p, uint32_t o) {
  const uint32_t t = kLayout == 0 ? fdiv(p.div_s, o) : o;
  return (int)(t - fdiv(p.div_c, t) * p.C);
}

// A reduction block's part: its channel c (NSC: thread t's, t % C), the
// walk's base and length, G threads a row of the tree (1 or C), K = T / G.
struct Walk {
  int c, j, G, K;
  uint32_t base, count;
};

template <int kLayout>
__device__ __forceinline__ Walk block_walk(const Params& p) {
  Walk w;
  if (kLayout == 0) {
    w.G = 1;
    w.c = blockIdx.x;
    w.j = blockIdx.y;
    w.base = w.j * p.chunk_len;
    w.count = min(p.chunk_len, p.rows - w.base);
  } else {
    w.G = p.C;
    w.c = threadIdx.x % p.C;
    w.j = blockIdx.x;
    const uint32_t r0 = w.j * p.chunk_len;
    w.base = r0 * p.C;
    w.count = min(p.chunk_len, p.rows - r0) * p.C;
  }
  w.K = blockDim.x / w.G;
  return w;
}

// Fixed-order tree over the K threads of each of the G columns: thread
// g + G k ends with k == 0 holding column g's total in sh[g].
template <class Acc>
__device__ void block_reduce(Acc* sh, const Acc& v, int G, int K) {
  const int t = threadIdx.x, k = t / G;
  sh[t] = v;
  int p2 = 1;
  while (p2 < K) p2 <<= 1;
  for (int s = p2 >> 1; s >= 1; s >>= 1) {
    __syncthreads();
    if (k < s && k + s < K) merge(sh[t], sh[t + s * G]);
  }
  __syncthreads();
}

// After the block's partials are written: whether this block drew the last
// of `expected` tickets (and then reset the counter).
__device__ bool last_block(unsigned int* ticket, unsigned int expected) {
  __shared__ bool is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    is_last = atomicAdd(ticket, 1u) == expected - 1;
    if (is_last) *ticket = 0u;
  }
  __syncthreads();
  if (is_last) __threadfence();
  return is_last;
}

// The block's partials (one a channel) into the scratch, then, in the block
// with the last ticket, every chunk's partials merged in chunk order;
// returns whether this block holds the totals (in sh[g], g < G).
template <int kLayout, class Acc>
__device__ bool reduce_chunks(const Params& p, const Walk& w, Acc* sh,
                              const Acc& mine) {
  Acc* parts = static_cast<Acc*>(p.partials);
  block_reduce(sh, mine, w.G, w.K);
  if ((int)threadIdx.x < w.G) parts[w.j * p.C + w.c] = sh[threadIdx.x];
  if (!last_block(&p.tickets[kLayout == 0 ? w.c : 0], (unsigned)p.chunks))
    return false;
  // Thread (g, k) merges chunks k, k + K, ... in order, kUnroll loads in
  // flight: with hundreds of chunks one at a time it waited on L2 for each.
  Acc acc = {};
  for (int j0 = threadIdx.x / w.G; j0 < p.chunks; j0 += kUnroll * w.K) {
    Acc v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (j0 + u * w.K < p.chunks)
        v[u] = load_partial(&parts[(j0 + u * w.K) * p.C + w.c]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (j0 + u * w.K < p.chunks) merge(acc, v[u]);
  }
  block_reduce(sh, acc, w.G, w.K);
  return true;
}

template <int kLayout>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
bn_relu_stats_kernel(Params p) {
  __shared__ Stat sh[kThreads];
  const Walk w = block_walk<kLayout>(p);
  const uint32_t T = blockDim.x;
  Stat acc = {0, 0.f, 0.f};
  for (uint32_t q0 = threadIdx.x; q0 < w.count; q0 += T * kUnroll) {
    float v[kUnroll];
    int cnt = 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t q = q0 + u * T;
      if (q < w.count) {
        v[u] = p.x[walk_offset<kLayout>(p, w.base, q, w.c)];
        cnt = u + 1;
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (u < cnt) sum += v[u] - v[0];
    const float mb = sum / (float)cnt;
    float m2 = 0.f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (u < cnt) {
        const float d = (v[u] - v[0]) - mb;
        m2 = fmaf(d, d, m2);
      }
    const Stat b = {cnt, v[0] + mb, m2};
    merge(acc, b);
  }
  if (!reduce_chunks<kLayout>(p, w, sh, acc)) return;
  if ((int)threadIdx.x >= w.G) return;
  const int c = w.c;
  const Stat s = sh[threadIdx.x];
  const float var = s.m2 / (float)s.n;
  p.save_mean[c] = s.mean;
  p.save_inv[c] = 1.f / sqrtf(var + p.eps);
  // As models/nn.py's plain path rounds: var * n / max(n - 1, 1), then
  // (1 - momentum) old + momentum new, each product rounded.
  const float unbiased =
      __fdiv_rn(__fmul_rn(var, (float)s.n), (float)max(s.n - 1, 1));
  p.new_mean[c] = __fadd_rn(__fmul_rn(p.keep, p.run_mean[c]),
                            __fmul_rn(p.momentum, s.mean));
  p.new_var[c] = __fadd_rn(__fmul_rn(p.keep, p.run_var[c]),
                           __fmul_rn(p.momentum, unbiased));
}

template <int kLayout>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
bn_relu_grad_sums_kernel(Params p) {
  __shared__ Sums sh[kThreads];
  const Walk w = block_walk<kLayout>(p);
  const uint32_t T = blockDim.x;
  const float m = p.mean[w.c], inv = p.inv[w.c], b = p.beta[w.c];
  const float a = bn_scale(p.gamma[w.c], inv);
  Sums acc = {0.f, 0.f};
  for (uint32_t q0 = threadIdx.x; q0 < w.count; q0 += T * kUnroll) {
    float xv[kUnroll], dv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t q = q0 + u * T;
      if (q < w.count) {
        const uint32_t o = walk_offset<kLayout>(p, w.base, q, w.c);
        xv[u] = p.x[o];
        dv[u] = p.dy[o];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (q0 + u * T < w.count) {
        const float d = bn_pre(xv[u], m, a, b) > 0.f ? dv[u] : 0.f;
        acc.dy += d;
        acc.dyx = fmaf(d, (xv[u] - m) * inv, acc.dyx);
      }
  }
  if (!reduce_chunks<kLayout>(p, w, sh, acc)) return;
  if ((int)threadIdx.x >= w.G) return;
  p.dbeta[w.c] = sh[threadIdx.x].dy;
  p.dgamma[w.c] = sh[threadIdx.x].dyx;
}

template <int kVec>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
};
template <>
struct Vec<1> {
  using T = float;
};

__device__ __forceinline__ float& lane(float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}
__device__ __forceinline__ float& lane(float& v, int) { return v; }

// y = relu(pre). Shared memory: mean, a, beta a channel.
template <int kLayout, int kVec>
__global__ void __launch_bounds__(kThreads)
bn_relu_apply_kernel(Params p) {
  using V = typename Vec<kVec>::T;
  extern __shared__ float smem[];
  float* sm = smem;
  float* sa = smem + p.C;
  float* sb = smem + 2 * p.C;
  for (int c = threadIdx.x; c < p.C; c += blockDim.x) {
    sm[c] = p.mean[c];
    sa[c] = bn_scale(p.gamma[c], p.inv[c]);
    sb[c] = p.beta[c];
  }
  __syncthreads();
  const uint32_t nv = p.numel / kVec;
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t v = blockIdx.x * blockDim.x + threadIdx.x; v < nv;
       v += stride) {
    const uint32_t vi = nv - 1 - v;
    V xv = reinterpret_cast<const V*>(p.x)[vi];
    V yv;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const int c = channel_of<kLayout>(p, vi * kVec + e);
      const float pre = bn_pre(lane(xv, e), sm[c], sa[c], sb[c]);
      lane(yv, e) = pre <= 0.f ? 0.f : pre;  // a NaN passes, as F.relu's
    }
    reinterpret_cast<V*>(p.y)[vi] = yv;
  }
}

// dx. Shared memory: mean, inv, a, beta, dbeta, dgamma a channel.
template <int kLayout, int kVec>
__global__ void __launch_bounds__(kThreads)
bn_relu_grad_apply_kernel(Params p) {
  using V = typename Vec<kVec>::T;
  extern __shared__ float smem[];
  float* sm = smem;
  float* si = smem + p.C;
  float* sa = smem + 2 * p.C;
  float* sb = smem + 3 * p.C;
  float* sdb = smem + 4 * p.C;
  float* sdg = smem + 5 * p.C;
  for (int c = threadIdx.x; c < p.C; c += blockDim.x) {
    sm[c] = p.mean[c];
    si[c] = p.inv[c];
    sa[c] = bn_scale(p.gamma[c], p.inv[c]);
    sb[c] = p.beta[c];
    sdb[c] = p.dbeta[c];
    sdg[c] = p.dgamma[c];
  }
  __syncthreads();
  const float inv_n = 1.f / (float)p.rows;
  const uint32_t nv = p.numel / kVec;
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t v = blockIdx.x * blockDim.x + threadIdx.x; v < nv;
       v += stride) {
    const uint32_t vi = nv - 1 - v;
    V xv = reinterpret_cast<const V*>(p.x)[vi];
    V dv = reinterpret_cast<const V*>(p.dy)[vi];
    V out;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const int c = channel_of<kLayout>(p, vi * kVec + e);
      const float x = lane(xv, e);
      const float d = bn_pre(x, sm[c], sa[c], sb[c]) > 0.f ? lane(dv, e) : 0.f;
      const float xhat = (x - sm[c]) * si[c];
      lane(out, e) = sa[c] * (d - fmaf(xhat, sdg[c], sdb[c]) * inv_n);
    }
    reinterpret_cast<V*>(p.y)[vi] = out;
  }
}

// How the kernels cut x (N, C, S) on a card of `sms` SMs: every channel's
// R = N S elements in `chunks` of `chunk_len` (elements of a channel, or
// rows of C for NSC), enough for kMinBlocks blocks an SM and at least
// kUnroll elements a thread; `threads` a reduction block (a multiple of C
// for NSC); `apply_blocks` for the apply kernels, which move `vec` (4 or 1)
// floats a load; `partials` the chunks' partials (chunks x C).
struct Plan {
  int nsc, chunks, chunk_len, threads, apply_blocks, vec;
  long long partials;
};

long long partial_slots(int sms) {
  const long long target = (long long)sms * kMinBlocks;
  return target * kThreads > target + kMaxChannels ? target * kThreads
                                                   : target + kMaxChannels;
}

cudaError_t make_plan(int N, int C, int S, int nsc, int vec, int sms,
                      Plan* pl) {
  const long long rows = (long long)N * S, numel = rows * C;
  if (N < 1 || C < 1 || C > kMaxChannels || S < 1 || numel >= (1LL << 31) ||
      (nsc && C > kThreads) || sms < 1 || (vec != 1 && vec != 4) ||
      numel % vec)
    return cudaErrorInvalidValue;
  const long long target = (long long)sms * kMinBlocks;
  long long chunks;
  pl->nsc = nsc;
  pl->vec = vec;
  if (nsc) {
    pl->threads = C * (kThreads / C);
    chunks = numel / ((long long)kUnroll * pl->threads);
    if (chunks > target) chunks = target;
  } else {
    pl->threads = kThreads;
    chunks = rows / (kUnroll * kThreads);
    if (chunks > (target + C - 1) / C) chunks = (target + C - 1) / C;
  }
  if (chunks < 1) chunks = 1;
  const long long len = (rows + chunks - 1) / chunks;
  pl->chunk_len = (int)len;
  pl->chunks = (int)((rows + len - 1) / len);
  const long long most = (long long)sms * kApplyBlocks;
  long long blocks = (numel / vec + kThreads - 1) / kThreads;
  if (blocks > most) blocks = most;
  pl->apply_blocks = (int)(blocks < 1 ? 1 : blocks);
  pl->partials = (long long)pl->chunks * C;
  if (pl->chunks > 65535 || pl->partials > partial_slots(sms))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

cudaError_t prepare(Params& p, Plan& pl, int N, int C, int S, int nsc,
                    int vec, int sms, void* work) {
  cudaError_t err = make_plan(N, C, S, nsc, vec, sms, &pl);
  if (err != cudaSuccess) return err;
  p.C = C;
  p.S = (uint32_t)S;
  p.rows = (uint32_t)N * (uint32_t)S;
  p.numel = p.rows * (uint32_t)C;
  p.chunks = pl.chunks;
  p.chunk_len = (uint32_t)pl.chunk_len;
  p.div_s = make_div(p.S);
  p.div_c = make_div((uint32_t)C);
  if (work) {
    p.tickets = static_cast<unsigned int*>(work);
    p.partials = static_cast<char*>(work) + kTicketBytes;
  }
  return cudaSuccess;
}

template <class Kernel>
cudaError_t launch_reduce(Kernel k0, Kernel k1, const Params& p,
                          const Plan& pl, cudaStream_t st) {
  const dim3 grid = pl.nsc ? dim3(pl.chunks) : dim3(p.C, pl.chunks);
  (pl.nsc ? k1 : k0)<<<grid, pl.threads, 0, st>>>(p);
  return cudaGetLastError();
}

template <class Kernel>
cudaError_t launch_apply(Kernel k04, Kernel k01, Kernel k14, Kernel k11,
                         int floats_a_channel, const Params& p,
                         const Plan& pl, cudaStream_t st) {
  const bool vec = pl.vec == 4;
  const Kernel k = pl.nsc ? (vec ? k14 : k11) : (vec ? k04 : k01);
  k<<<pl.apply_blocks, kThreads, floats_a_channel * p.C * sizeof(float),
      st>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry takes x (N, C, S) as NCS (nsc 0) or NSC (nsc 1), plans its
// launch for `sms` SMs and launches on `stream`; the reductions take a
// workspace of bn_relu_workspace_bytes(sms) bytes, zeroed when made and
// used by one stream only. Each returns the launch's CUDA error code
// (cudaErrorInvalidValue for a shape or layout it does not take).

// The workspace's bytes on a card of `sms` SMs: enough for every plan.
long long bn_relu_workspace_bytes(int sms) {
  return kTicketBytes + partial_slots(sms) * kPartialBytes;
}

// The plan for x (N, C, S) on `sms` SMs, for the tests: out = [chunks,
// chunk_len, threads, apply_blocks, partials].
int bn_relu_plan(int N, int C, int S, int nsc, int vec, int sms,
                 long long* out) {
  Plan pl;
  const cudaError_t err = make_plan(N, C, S, nsc, vec, sms, &pl);
  if (err != cudaSuccess) return (int)err;
  out[0] = pl.chunks;
  out[1] = pl.chunk_len;
  out[2] = pl.threads;
  out[3] = pl.apply_blocks;
  out[4] = pl.partials;
  return 0;
}

// The statistics and the new running state.
int bn_relu_stats(const float* x, const float* run_mean,
                  const float* run_var, float* save_mean, float* save_inv,
                  float* new_mean, float* new_var, void* work, int N, int C,
                  int S, int nsc, int sms, float eps, float momentum,
                  float keep, void* stream) {
  Params p = {};
  Plan pl;
  if (!work) return (int)cudaErrorInvalidValue;
  const cudaError_t err = prepare(p, pl, N, C, S, nsc, 1, sms, work);
  if (err != cudaSuccess) return (int)err;
  p.x = x;
  p.run_mean = run_mean;
  p.run_var = run_var;
  p.save_mean = save_mean;
  p.save_inv = save_inv;
  p.new_mean = new_mean;
  p.new_var = new_var;
  p.eps = eps;
  p.momentum = momentum;
  p.keep = keep;
  return (int)launch_reduce(bn_relu_stats_kernel<0>, bn_relu_stats_kernel<1>,
                            p, pl, (cudaStream_t)stream);
}

// y = relu(BatchNorm(x)) from the saved statistics.
int bn_relu_apply(const float* x, const float* gamma, const float* beta,
                  const float* mean, const float* inv, float* y, int N, int C,
                  int S, int nsc, int sms, void* stream) {
  const long long numel = (long long)N * C * S;
  const int vec = numel % 4 == 0 && aligned16(x) && aligned16(y) ? 4 : 1;
  Params p = {};
  Plan pl;
  const cudaError_t err = prepare(p, pl, N, C, S, nsc, vec, sms, nullptr);
  if (err != cudaSuccess) return (int)err;
  p.x = x;
  p.gamma = gamma;
  p.beta = beta;
  p.mean = mean;
  p.inv = inv;
  p.y = y;
  return (int)launch_apply(
      bn_relu_apply_kernel<0, 4>, bn_relu_apply_kernel<0, 1>,
      bn_relu_apply_kernel<1, 4>, bn_relu_apply_kernel<1, 1>, 3, p, pl,
      (cudaStream_t)stream);
}

// dgamma and dbeta.
int bn_relu_grad_sums(const float* dy, const float* x, const float* gamma,
                      const float* beta, const float* mean, const float* inv,
                      float* dgamma, float* dbeta, void* work, int N, int C,
                      int S, int nsc, int sms, void* stream) {
  Params p = {};
  Plan pl;
  if (!work) return (int)cudaErrorInvalidValue;
  const cudaError_t err = prepare(p, pl, N, C, S, nsc, 1, sms, work);
  if (err != cudaSuccess) return (int)err;
  p.dy = dy;
  p.x = x;
  p.gamma = gamma;
  p.beta = beta;
  p.mean = mean;
  p.inv = inv;
  p.dgamma = dgamma;
  p.dbeta = dbeta;
  return (int)launch_reduce(bn_relu_grad_sums_kernel<0>,
                            bn_relu_grad_sums_kernel<1>, p, pl,
                            (cudaStream_t)stream);
}

// dx from dy, x, the saved statistics and the sums.
int bn_relu_grad_apply(const float* dy, const float* x, const float* gamma,
                       const float* beta, const float* mean, const float* inv,
                       const float* dgamma, const float* dbeta, float* dx,
                       int N, int C, int S, int nsc, int sms, void* stream) {
  const long long numel = (long long)N * C * S;
  const int vec = numel % 4 == 0 && aligned16(x) && aligned16(dy) &&
                          aligned16(dx) ? 4 : 1;
  Params p = {};
  Plan pl;
  const cudaError_t err = prepare(p, pl, N, C, S, nsc, vec, sms, nullptr);
  if (err != cudaSuccess) return (int)err;
  p.dy = dy;
  p.x = x;
  p.gamma = gamma;
  p.beta = beta;
  p.mean = mean;
  p.inv = inv;
  p.dgamma = const_cast<float*>(dgamma);  // read only here
  p.dbeta = const_cast<float*>(dbeta);
  p.y = dx;
  return (int)launch_apply(
      bn_relu_grad_apply_kernel<0, 4>, bn_relu_grad_apply_kernel<0, 1>,
      bn_relu_grad_apply_kernel<1, 4>, bn_relu_grad_apply_kernel<1, 1>, 6, p,
      pl, (cudaStream_t)stream);
}

}  // extern "C"
