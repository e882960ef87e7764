// Chain-DP fill and the peak / min-rank ring passes for Hopper (sm_90a),
// called from JAX through the XLA FFI (longqc_tpu/ops/chain_cuda.py).
//
// Semantics are those of the plain lax.scan forms in
// longqc_tpu/ops/chain_ring.py, bit for bit (every value is int32).
//
// Design: one warp per query row, so no state crosses blocks. The anchor
// loop runs inside the warp; each array is read 32 anchors at a time with
// one coalesced load per lane and broadcast by shuffle. The J-deep ring
// lives in shared memory and rotates by moving a head index: the slot of
// age a (1 = newest) is (head + a - 1) mod J, and a push writes one slot.
// Lane l owns the S = J / 32 consecutive ages l*S+1 .. l*S+S, so the
// age-ordered scans are a per-lane prefix plus one warp shuffle scan, the
// reductions are warp reductions, and the max_skip mark words are warp
// OR-reductions. The resumable carry is read once at start and written
// once at end.

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int32_t kNeg = -1000000000;
constexpr int32_t kInf = 0x7FFFFFFF;
constexpr unsigned kFull = 0xFFFFFFFFu;

// int32 arithmetic that wraps like XLA's (signed overflow is undefined
// in C++)
__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t wmul(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) *
                              static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t wabs(int32_t a) {
  return a < 0 ? wsub(0, a) : a;
}

struct OpMax {
  __device__ static int32_t f(int32_t a, int32_t b) { return a > b ? a : b; }
};
struct OpMin {
  __device__ static int32_t f(int32_t a, int32_t b) { return a < b ? a : b; }
};
struct OpAdd {
  __device__ static int32_t f(int32_t a, int32_t b) { return wadd(a, b); }
};

// Inclusive scan over ages of x[S] (lane-major: lane l holds ages
// l*S+1 .. l*S+S), in place.
template <class Op, int S>
__device__ __forceinline__ void age_scan(int32_t (&x)[S], int32_t identity,
                                         int lane) {
#pragma unroll
  for (int s = 1; s < S; ++s) x[s] = Op::f(x[s - 1], x[s]);
  int32_t tot = x[S - 1];
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    int32_t t = __shfl_up_sync(kFull, tot, d);
    if (lane >= d) tot = Op::f(t, tot);
  }
  int32_t excl = __shfl_up_sync(kFull, tot, 1);
  if (lane == 0) excl = identity;
#pragma unroll
  for (int s = 0; s < S; ++s) x[s] = Op::f(excl, x[s]);
}

struct FillArgs {
  const int32_t* axh;   // (Q, A)
  const int32_t* axl;
  const int32_t* aq;
  const int32_t* asp;
  const int32_t* nb;    // (Q,)
  const int32_t* limbs; // (5, Q)
  const int32_t* rbad;  // (Q,)
  const int32_t* cin[7];  // (J, Q) rings: xh, xl, q, span, f, v, p
  const int32_t* cfl;   // (Q,)
  const int32_t* i0;    // scalar
  int32_t* of;          // (Q, A)
  int32_t* op;
  int32_t* ov;
  int32_t* cout[7];     // (J, Q)
  int32_t* ofl;         // (Q,)
  int Q, A, max_dist, bw, max_skip;
};

enum { RXH = 0, RXL, RQ, RS, RF, RV, RP };

template <int J>
__global__ void __launch_bounds__(32) chain_fill_kernel(FillArgs a) {
  constexpr int S = J / 32;
  constexpr int W = J / 32;  // mark words
  __shared__ int32_t ring[7][J];
  const int lane = threadIdx.x;
  const int q = blockIdx.x;
  const int Q = a.Q, A = a.A;

  for (int k = 0; k < 7; ++k)
    for (int j = lane; j < J; j += 32) ring[k][j] = a.cin[k][j * Q + q];
  int head = 0;
  const int32_t n_row = a.nb[q];
  const int32_t l0 = a.limbs[0 * Q + q], l1 = a.limbs[1 * Q + q],
                l2 = a.limbs[2 * Q + q], l3 = a.limbs[3 * Q + q],
                l4 = a.limbs[4 * Q + q];
  // rows with no exact penalty multiplier are host-fallback
  int32_t flag = a.cfl[q] | (a.rbad[q] & (n_row > 0 ? 1 : 0));
  const int32_t i0 = *a.i0;
  const int32_t bw = a.bw, max_dist = a.max_dist;
  const int age0 = lane * S + 1;  // my first age
  __syncwarp();

  const int32_t* rowxh = a.axh + static_cast<size_t>(q) * A;
  const int32_t* rowxl = a.axl + static_cast<size_t>(q) * A;
  const int32_t* rowq = a.aq + static_cast<size_t>(q) * A;
  const int32_t* rows = a.asp + static_cast<size_t>(q) * A;

  for (int base = 0; base < A; base += 32) {
    const int li_l = base + lane;
    const bool in_l = li_l < A;
    const int32_t cxh = in_l ? rowxh[li_l] : 0;
    const int32_t cxl = in_l ? rowxl[li_l] : 0;
    const int32_t cq = in_l ? rowq[li_l] : 0;
    const int32_t cs = in_l ? rows[li_l] : 0;
    int32_t keep_f = 0, keep_p = -1, keep_v = 0;
    const int n_here = min(32, A - base);

    for (int j = 0; j < n_here; ++j) {
      const int32_t i = wadd(i0, base + j);
      const int32_t xh_i = __shfl_sync(kFull, cxh, j);
      const int32_t xl_i = __shfl_sync(kFull, cxl, j);
      const int32_t q_i = __shfl_sync(kFull, cq, j);
      const int32_t s_i = __shfl_sync(kFull, cs, j);
      const bool row_on = i < n_row;

      int32_t sc[S], rp[S], tgt[S];
      bool valid[S], newmax[S];
      bool oldest_ok = false;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int age = age0 + s;
        const int slot = (head + age - 1) & (J - 1);
        const int32_t rxh = ring[RXH][slot], rxl = ring[RXL][slot],
                      rq = ring[RQ][slot], rf = ring[RF][slot];
        rp[s] = ring[RP][slot];
        const bool exists = wsub(i, age) >= 0;
        const int32_t dr = wsub(xl_i, rxl);
        const bool dr_ok = (xh_i == rxh) && dr >= 0 && dr <= max_dist;
        const int32_t dq = wsub(q_i, rq);
        const int32_t dd = wabs(wsub(dr, dq));
        valid[s] = exists && dr_ok && dr != 0 && dq > 0 && dq <= max_dist &&
                   dd <= bw;
        if (age == J) oldest_ok = exists && dr_ok;
        // exact gap penalty: floor(dd * M / 2^64) + (ilog2(dd) >> 1)
        const int32_t ddc = dd < 0 ? 0 : (dd > bw ? bw : dd);
        const int32_t t =
            wadd(wmul(ddc, l3),
                 wadd(wmul(ddc, l2),
                      wadd(wmul(ddc, l1), wmul(ddc, l0) >> 16) >> 16) >>
                     16);
        const int32_t lin = wadd(wmul(ddc, l4), t >> 16);
        const int32_t ex = static_cast<int32_t>(
                               static_cast<uint32_t>(__float_as_int(
                                   static_cast<float>(ddc))) >> 23) - 127;
        const int32_t pen = wadd(lin, (ddc > 0 ? ex : 0) >> 1);
        const int32_t sc0 = min(min(dq, dr), s_i);
        sc[s] = valid[s] ? wadd(wsub(sc0, pen), rf) : kNeg;
        tgt[s] = wsub(i, rp[s]);
      }

      // strict running max in visit (age) order, exclusive prefix
      int32_t inc[S];
#pragma unroll
      for (int s = 0; s < S; ++s) inc[s] = sc[s];
      age_scan<OpMax, S>(inc, kNeg, lane);
      int32_t prev_last = __shfl_up_sync(kFull, inc[S - 1], 1);
      if (lane == 0) prev_last = kNeg;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int32_t before = s == 0 ? prev_last : inc[s - 1];
        const int32_t run_before = max(before, s_i);
        newmax[s] = valid[s] && sc[s] > run_before;
      }

      // marks: bit (t - 1) of the mark words for every ring entry whose
      // stored parent sits t anchors back; lane reads its own ages' bits
      auto marks_from = [&](const bool (&src)[S], bool (&mark)[S]) {
        uint32_t words[W];
#pragma unroll
        for (int w = 0; w < W; ++w) words[w] = 0u;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const bool ok = src[s] && rp[s] > kNeg + J + 1 && tgt[s] >= 1 &&
                          tgt[s] <= J;
          const int t0 = ok ? tgt[s] - 1 : 0;
#pragma unroll
          for (int w = 0; w < W; ++w)
            if (ok && (t0 >> 5) == w) words[w] |= 1u << (t0 & 31);
        }
#pragma unroll
        for (int w = 0; w < W; ++w) words[w] = __reduce_or_sync(kFull, words[w]);
        const int bit0 = age0 - 1;
        uint32_t mine = 0u;
#pragma unroll
        for (int w = 0; w < W; ++w)
          if ((bit0 >> 5) == w) mine = words[w];
#pragma unroll
        for (int s = 0; s < S; ++s)
          mark[s] = ((mine >> ((bit0 + s) & 31)) & 1u) != 0u;
      };

      auto walk_cut = [&](const bool (&mark)[S]) -> int32_t {
        int32_t sum[S];
        bool skipev[S];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          skipev[s] = valid[s] && !newmax[s] && mark[s];
          sum[s] = skipev[s] ? 1 : (newmax[s] ? -1 : 0);
        }
        age_scan<OpAdd, S>(sum, 0, lane);
        int32_t mins[S];
#pragma unroll
        for (int s = 0; s < S; ++s) mins[s] = sum[s];
        age_scan<OpMin, S>(mins, 1 << 30, lane);
        int32_t cut = J + 1;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int32_t walk = wsub(sum[s], min(0, mins[s]));
          if (skipev[s] && walk > a.max_skip) cut = min(cut, age0 + s);
        }
        return __reduce_min_sync(kFull, cut);
      };

      bool mark[S], src1[S];
      marks_from(valid, mark);
      const int32_t cut0 = walk_cut(mark);
#pragma unroll
      for (int s = 0; s < S; ++s) src1[s] = valid[s] && (age0 + s) < cut0;
      marks_from(src1, mark);
      const int32_t cut1 = walk_cut(mark);
      const bool disagree = cut0 != cut1;

      int32_t my_age = 0, my_sc = kNeg;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (newmax[s] && age0 + s <= cut1) {
          my_age = max(my_age, age0 + s);
          my_sc = max(my_sc, sc[s]);
        }
      }
      const int32_t p_age = __reduce_max_sync(kFull, my_age);
      const int32_t best = __reduce_max_sync(kFull, my_sc);
      const bool has_pred = p_age > 0;
      const int32_t f_i = has_pred ? best : s_i;
      const int32_t p_abs = has_pred ? wsub(i, p_age) : kNeg;
      const int32_t v_pred =
          has_pred ? max(ring[RV][(head + p_age - 1) & (J - 1)], kNeg) : kNeg;
      const int32_t v_i = (has_pred && v_pred > f_i) ? v_pred : f_i;
      const bool oldest = __shfl_sync(kFull, oldest_ok ? 1 : 0, 31) != 0;
      const bool trunc = cut1 > J && oldest;
      if (row_on && (disagree || trunc)) flag |= 1;

      // push: every lane has read its slots; one slot is rewritten
      __syncwarp();
      head = (head - 1) & (J - 1);
      const int32_t val = lane == RXH ? xh_i : lane == RXL ? xl_i
                          : lane == RQ ? q_i : lane == RS ? s_i
                          : lane == RF ? f_i : lane == RV ? v_i : p_abs;
      if (lane < 7) ring[lane][head] = val;
      __syncwarp();

      if (lane == j) {
        keep_f = row_on ? f_i : 0;
        keep_p = row_on ? max(p_abs, -1) : -1;
        keep_v = row_on ? v_i : 0;
      }
    }
    if (in_l) {
      const size_t o = static_cast<size_t>(q) * A + li_l;
      a.of[o] = keep_f;
      a.op[o] = keep_p;
      a.ov[o] = keep_v;
    }
  }

  for (int k = 0; k < 7; ++k)
    for (int age = lane + 1; age <= J; age += 32)
      a.cout[k][(age - 1) * Q + q] = ring[k][(head + age - 1) & (J - 1)];
  if (lane == 0) a.ofl[q] = flag;
}

// peak[i] = walk ? peak of the anchor tgt = i - p[i] back : i
template <int J>
__global__ void __launch_bounds__(32) peak_kernel(const int32_t* f,
                                                  const int32_t* v,
                                                  const int32_t* p,
                                                  int32_t* out, int A) {
  __shared__ int32_t ring[J];
  const int lane = threadIdx.x;
  const size_t row = static_cast<size_t>(blockIdx.x) * A;
  for (int j = lane; j < J; j += 32) ring[j] = -1;
  int head = 0;
  __syncwarp();
  for (int base = 0; base < A; base += 32) {
    const int li_l = base + lane;
    const bool in_l = li_l < A;
    const int32_t cf = in_l ? f[row + li_l] : 0;
    const int32_t cv = in_l ? v[row + li_l] : 0;
    const int32_t cp = in_l ? p[row + li_l] : 0;
    int32_t keep = 0;
    const int n_here = min(32, A - base);
    for (int j = 0; j < n_here; ++j) {
      const int32_t i = base + j;
      const int32_t f_i = __shfl_sync(kFull, cf, j);
      const int32_t v_i = __shfl_sync(kFull, cv, j);
      const int32_t p_i = __shfl_sync(kFull, cp, j);
      const int32_t tgt = wsub(i, p_i);
      const bool walk = v_i > f_i && p_i >= 0 && tgt <= J;
      const int32_t sel =
          (tgt >= 1 && tgt <= J) ? ring[(head + tgt - 1) & (J - 1)] : -1;
      const int32_t peak_i = walk ? sel : i;
      __syncwarp();
      head = (head - 1) & (J - 1);
      if (lane == 0) ring[head] = peak_i;
      __syncwarp();
      if (lane == j) keep = peak_i;
    }
    if (in_l) out[row + li_l] = keep;
  }
}

// r[i] = min(own[i], min over ring entries (the J anchors after i) whose
// parent is i of their r), swept from the last anchor back
template <int J>
__global__ void __launch_bounds__(32) minrank_kernel(const int32_t* p,
                                                     const int32_t* own,
                                                     int32_t* out, int A) {
  constexpr int S = J / 32;
  __shared__ int32_t rr[J];
  __shared__ int32_t rp[J];
  const int lane = threadIdx.x;
  const size_t row = static_cast<size_t>(blockIdx.x) * A;
  for (int j = lane; j < J; j += 32) {
    rr[j] = kInf;
    rp[j] = -2;
  }
  int head = 0;
  __syncwarp();
  const int nchunk = (A + 31) / 32;
  for (int c = nchunk - 1; c >= 0; --c) {
    const int base = c * 32;
    const int li_l = base + lane;
    const bool in_l = li_l < A;
    const int32_t cp = in_l ? p[row + li_l] : 0;
    const int32_t co = in_l ? own[row + li_l] : 0;
    int32_t keep = 0;
    const int n_here = min(32, A - base);
    for (int j = n_here - 1; j >= 0; --j) {
      const int32_t i = base + j;
      const int32_t p_i = __shfl_sync(kFull, cp, j);
      const int32_t own_i = __shfl_sync(kFull, co, j);
      int32_t cand = kInf;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int slot = (head + lane * S + s) & (J - 1);
        if (rp[slot] == i) cand = min(cand, rr[slot]);
      }
      cand = __reduce_min_sync(kFull, cand);
      const int32_t r_i = min(own_i, cand);
      __syncwarp();
      head = (head - 1) & (J - 1);
      if (lane == 0) {
        rr[head] = r_i;
        rp[head] = p_i;
      }
      __syncwarp();
      if (lane == j) keep = r_i;
    }
    if (in_l) out[row + li_l] = keep;
  }
}

ffi::Error launch_status() {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess)
    return ffi::Error(ffi::ErrorCode::kInternal, cudaGetErrorString(err));
  return ffi::Error::Success();
}

ffi::Error bad_depth() {
  return ffi::Error(ffi::ErrorCode::kInvalidArgument,
                    "ring depth J must be 64, 128, 256 or 512");
}

using Buf = ffi::Buffer<ffi::S32>;
using Ret = ffi::ResultBuffer<ffi::S32>;

ffi::Error ChainFillImpl(cudaStream_t stream, Buf axh, Buf axl, Buf aq,
                         Buf asp, Buf nb, Buf limbs, Buf rbad, Buf c0,
                         Buf c1, Buf c2, Buf c3, Buf c4, Buf c5, Buf c6,
                         Buf cfl, Buf i0, Ret of, Ret op, Ret ov, Ret o0,
                         Ret o1, Ret o2, Ret o3, Ret o4, Ret o5, Ret o6,
                         Ret ofl, int32_t J, int32_t max_dist, int32_t bw,
                         int32_t max_skip) {
  auto dims = axh.dimensions();
  if (dims.size() != 2)
    return ffi::Error(ffi::ErrorCode::kInvalidArgument,
                      "anchors must be (Q, A)");
  FillArgs a;
  a.Q = static_cast<int>(dims[0]);
  a.A = static_cast<int>(dims[1]);
  a.axh = axh.typed_data();
  a.axl = axl.typed_data();
  a.aq = aq.typed_data();
  a.asp = asp.typed_data();
  a.nb = nb.typed_data();
  a.limbs = limbs.typed_data();
  a.rbad = rbad.typed_data();
  const Buf cin[7] = {c0, c1, c2, c3, c4, c5, c6};
  Ret cout[7] = {o0, o1, o2, o3, o4, o5, o6};
  for (int k = 0; k < 7; ++k) {
    a.cin[k] = cin[k].typed_data();
    a.cout[k] = cout[k]->typed_data();
  }
  a.cfl = cfl.typed_data();
  a.i0 = i0.typed_data();
  a.of = of->typed_data();
  a.op = op->typed_data();
  a.ov = ov->typed_data();
  a.ofl = ofl->typed_data();
  a.max_dist = max_dist;
  a.bw = bw;
  a.max_skip = max_skip;
  if (a.Q == 0) return ffi::Error::Success();
  switch (J) {
    case 64: chain_fill_kernel<64><<<a.Q, 32, 0, stream>>>(a); break;
    case 128: chain_fill_kernel<128><<<a.Q, 32, 0, stream>>>(a); break;
    case 256: chain_fill_kernel<256><<<a.Q, 32, 0, stream>>>(a); break;
    case 512: chain_fill_kernel<512><<<a.Q, 32, 0, stream>>>(a); break;
    default: return bad_depth();
  }
  return launch_status();
}

ffi::Error PeakImpl(cudaStream_t stream, Buf f, Buf v, Buf p, Ret out,
                    int32_t J) {
  auto dims = f.dimensions();
  const int Q = static_cast<int>(dims[0]), A = static_cast<int>(dims[1]);
  if (Q == 0) return ffi::Error::Success();
  const int32_t *fp = f.typed_data(), *vp = v.typed_data(),
                *pp = p.typed_data();
  int32_t* o = out->typed_data();
  switch (J) {
    case 64: peak_kernel<64><<<Q, 32, 0, stream>>>(fp, vp, pp, o, A); break;
    case 128: peak_kernel<128><<<Q, 32, 0, stream>>>(fp, vp, pp, o, A); break;
    case 256: peak_kernel<256><<<Q, 32, 0, stream>>>(fp, vp, pp, o, A); break;
    case 512: peak_kernel<512><<<Q, 32, 0, stream>>>(fp, vp, pp, o, A); break;
    default: return bad_depth();
  }
  return launch_status();
}

ffi::Error MinRankImpl(cudaStream_t stream, Buf p, Buf own, Ret out,
                       int32_t J) {
  auto dims = p.dimensions();
  const int Q = static_cast<int>(dims[0]), A = static_cast<int>(dims[1]);
  if (Q == 0) return ffi::Error::Success();
  const int32_t *pp = p.typed_data(), *op = own.typed_data();
  int32_t* o = out->typed_data();
  switch (J) {
    case 64: minrank_kernel<64><<<Q, 32, 0, stream>>>(pp, op, o, A); break;
    case 128: minrank_kernel<128><<<Q, 32, 0, stream>>>(pp, op, o, A); break;
    case 256: minrank_kernel<256><<<Q, 32, 0, stream>>>(pp, op, o, A); break;
    case 512: minrank_kernel<512><<<Q, 32, 0, stream>>>(pp, op, o, A); break;
    default: return bad_depth();
  }
  return launch_status();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    LongqcChainFill, ChainFillImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<Buf>()  // axh
        .Arg<Buf>()  // axl
        .Arg<Buf>()  // aq
        .Arg<Buf>()  // asp
        .Arg<Buf>()  // nb
        .Arg<Buf>()  // limbs
        .Arg<Buf>()  // rbad
        .Arg<Buf>()  // carry rings x7
        .Arg<Buf>()
        .Arg<Buf>()
        .Arg<Buf>()
        .Arg<Buf>()
        .Arg<Buf>()
        .Arg<Buf>()
        .Arg<Buf>()  // carry flags
        .Arg<Buf>()  // i0
        .Ret<Buf>()  // f
        .Ret<Buf>()  // p
        .Ret<Buf>()  // v
        .Ret<Buf>()  // carry rings x7
        .Ret<Buf>()
        .Ret<Buf>()
        .Ret<Buf>()
        .Ret<Buf>()
        .Ret<Buf>()
        .Ret<Buf>()
        .Ret<Buf>()  // carry flags
        .Attr<int32_t>("J")
        .Attr<int32_t>("max_dist")
        .Attr<int32_t>("bw")
        .Attr<int32_t>("max_skip"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    LongqcPeakPass, PeakImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<Buf>()
        .Arg<Buf>()
        .Arg<Buf>()
        .Ret<Buf>()
        .Attr<int32_t>("J"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    LongqcMinRankPass, MinRankImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<Buf>()
        .Arg<Buf>()
        .Ret<Buf>()
        .Attr<int32_t>("J"));
