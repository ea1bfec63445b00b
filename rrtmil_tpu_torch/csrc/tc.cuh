// Tensor-core (mma.sync bf16 -> fp32) attention core and product: the
// bf16-product path of K1, K2's recompute, K5 and K6; the warp products,
// the online softmax and the tile loads below also build K7's backward
// (region_layer_bwd.cu).  The f32-product path (strict parity) stays on the
// SIMT kernels of common.cuh; the launchers at the end of this file pick
// one by the product dtype.
//
// Why mma.sync and not wgmma / TMA: at K5's and K6's shapes a block does a
// few 64 x 64 tiles, so launch latency and host time set the pace, not the
// tensor-core rate.  K2's four large products run on warpgroup products fed
// by a TMA ring (wgmma.cuh); K1's qkv product is the next candidate.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace rrt {

// ---------------------------------------------------------------------------
// PTX building blocks
// ---------------------------------------------------------------------------
constexpr int TD_MMA = 64;  // depth of one warp product (a 64-wide column chunk)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zero-filled when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 8 consecutive elements (16-byte aligned) times s, rounded to bf16
__device__ __forceinline__ uint4 load8(const float* p, float s) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  return make_uint4(pack_bf16(a.x * s, a.y * s), pack_bf16(a.z * s, a.w * s),
                    pack_bf16(b.x * s, b.y * s), pack_bf16(b.z * s, b.w * s));
}
__device__ __forceinline__ uint4 load8(const bf16* p, float s) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  if (s != 1.f) {
    uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
      w[i] = pack_bf16(__low2float(v) * s, __high2float(v) * s);
    }
  }
  return u;
}

// One 16-byte shared segment of 8 bf16 values from T elements: bf16 goes by
// cp.async (fetch only); float is read into registers by fetch and rounded
// into shared memory by store, so the read can overlap other work.
template <typename T> struct Seg;
template <> struct Seg<bf16> {
  __device__ __forceinline__ void fetch(bf16* dst, const bf16* src, bool ok) {
    cp_async16(dst, src, ok);
  }
  __device__ __forceinline__ void store(bf16*) {}
};
template <> struct Seg<float> {
  uint4 u;
  __device__ __forceinline__ void fetch(bf16*, const float* src, bool ok) {
    u = ok ? load8(src, 1.f) : make_uint4(0, 0, 0, 0);
  }
  __device__ __forceinline__ void store(bf16* dst) { *reinterpret_cast<uint4*>(dst) = u; }
};

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Warp-level 16-row products of the attention cores (fp32 sums in acc[nt]:
// rows g and g + 8 of the warp's 16, columns nt * 8 + cq and + 1, with
// g = lane / 4, cq = 2 (lane % 4)).
// acc (16 x 64) += A (16 x 64, rows of stride lda) B^T, B (64 x 64) stored
// [n][k] with row stride ldb: ks outer, so the sums run in one order.  With
// N2 < 4 only the first 16 N2 columns (acc[0 .. 2 N2 - 1]).
template <int N2 = 4>
__device__ __forceinline__ void mma_abt(float (&acc)[8][4], const bf16* A, int lda,
                                        const bf16* B, int ldb) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < TD_MMA / 16; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, &A[(lane & 15) * lda + ks * 16 + (lane >> 4) * 8]);
#pragma unroll
    for (int n2 = 0; n2 < N2; ++n2) {
      uint32_t b[4];
      ldsm_x4(b, &B[(n2 * 16 + (lane & 7) + (lane >> 4) * 8) * ldb + ks * 16 +
                    ((lane >> 3) & 1) * 8]);
      mma_bf16(acc[2 * n2], a, b[0], b[1]);
      mma_bf16(acc[2 * n2 + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x 64) += P B, P (16 x 64) as A fragments from pack_frags, B (64 x
// 64) stored [k][n] with row stride ldb (read by ldmatrix.trans)
__device__ __forceinline__ void mma_pb(float (&acc)[8][4], const uint32_t (&P)[4][4],
                                       const bf16* B, int ldb) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int d2 = 0; d2 < 4; ++d2) {
      uint32_t b[4];
      ldsm_x4_t(b, &B[(ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldb + d2 * 16 +
                      (lane >> 4) * 8]);
      mma_bf16(acc[2 * d2], P[ks], b[0], b[1]);
      mma_bf16(acc[2 * d2 + 1], P[ks], b[2], b[3]);
    }
}

// a 16 x 64 accumulator rounded to bf16 and repacked in registers as the A
// operand of mma_pb
__device__ __forceinline__ void pack_frags(uint32_t (&P)[4][4], const float (&X)[8][4]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      P[ks][2 * half] = pack_bf16(X[2 * ks + half][0], X[2 * ks + half][1]);
      P[ks][2 * half + 1] = pack_bf16(X[2 * ks + half][2], X[2 * ks + half][3]);
    }
}

// The online row max m and sum l of rows g and g + 8 over one 64-key logit
// tile (masked columns at -inf), the forward core's exact expressions; with
// dA given, also u += sum_j exp(S - m) dA, rescaled with l, so that D =
// rowsum(dA * A) = u / l once every key tile has been seen.
__device__ __forceinline__ void online_softmax(const float (&S)[8][4], float (&m)[2],
                                               float (&l)[2], float (*dA)[4] = nullptr,
                                               float* u = nullptr) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float tmax = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) tmax = fmaxf(tmax, fmaxf(S[nt][2 * hr], S[nt][2 * hr + 1]));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float mnew = fmaxf(m[hr], tmax);
    float tsum = 0.f, tu = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float e0 = expf(S[nt][2 * hr] - mnew), e1 = expf(S[nt][2 * hr + 1] - mnew);
      tsum += e0 + e1;
      if (dA) tu += e0 * dA[nt][2 * hr] + e1 * dA[nt][2 * hr + 1];
    }
    tsum += __shfl_xor_sync(0xffffffffu, tsum, 1);
    tsum += __shfl_xor_sync(0xffffffffu, tsum, 2);
    const float alpha = expf(m[hr] - mnew);
    l[hr] = l[hr] * alpha + tsum;
    if (dA) {
      tu += __shfl_xor_sync(0xffffffffu, tu, 1);
      tu += __shfl_xor_sync(0xffffffffu, tu, 2);
      u[hr] = u[hr] * alpha + tu;
    }
    m[hr] = mnew;
  }
}

__device__ __forceinline__ void zero_acc(float (&X)[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) X[nt][e] = 0.f;
}

// ---------------------------------------------------------------------------
// K6's core (and K1's, K2's recompute's, K5's) with bf16 products, on the
// tensor cores.  The function and its rounding points are attn_kernel's
// (common.cuh), which is what the TPU kernel `_kernel` of
// rrtmil_tpu/ops/pallas/region_attn.py computes.
//
// One block of 4 warps per (region, head, 64-query tile, 64-wide chunk of
// the output columns); each warp owns 16 query rows.  The query tile,
// round(q s) (and round(M_h .) with EPEG: the k-tap pass runs on the CUDA
// cores, ~15 taps a row), sits in shared memory for the whole head width.
// K and V stream through a TST-stage ring of 64-key x 64-wide tiles
// (TST - 1 tiles in flight while one is used): cp.async when the operand is
// bf16, 16-byte loads rounded on their way in when it is f32.  Pass 1: for each key tile, the logits over the whole
// head width (mma m16n8k16, fragments by ldmatrix), then the online row max
// and sum.  Pass 2: the logits again, A = round(exp(L - max) / sum) repacked
// in registers as the A operand of A V (no probability tile in shared
// memory), and V's chunk by ldmatrix.trans.  fp32 sums throughout.  With a
// single key tile (P <= 64) at hd > 64 (brca_r50's CR-MSA), pass 1 is
// dropped (9 ring items at hd = 512, not 17): the max, the sum and the
// probabilities come from the one logit tile in registers, the values the
// two passes give.  A head width that is a multiple of 32 but not of 64
// (--n_heads / --crmsa_heads 16: hd = 32) is held as head_chunks(hd)
// 64-wide chunks whose columns past hd are zero-filled by the loads and
// never stored; zero columns add exact zeros to the logits, so the one
// code path gives every width its own function (at hd = 64 every guard
// holds).
// With EPEG (hd <= 128) the k-tap pass runs a 64-wide chunk at a time
// through the halo buffer.
// ---------------------------------------------------------------------------
constexpr int TQ = 64, TK = 64, TD = 64, TRS = TD + 8;  // ring rows: 144 bytes
constexpr int TST = 4;                                    // ring stages
constexpr int TC_RING = TST * TK * TRS;                   // bf16 elements

inline int attn_tc_smem_bytes(int hd, int kk) {
  const int ring = TC_RING * 2;
  const int halo = kk > 0 ? (TQ + kk - 1) * TD * 2 : 0;
  return TQ * (TD * head_chunks(hd) + 8) * 2 + (ring > halo ? ring : halo);
}

// rows p0 .. p0 + rows - 1 of a token-row operand (width elements from
// base, p outside [0, P) and columns from `valid` on as zeros), times s and
// rounded to bf16, into dst (row stride ld), by a 128-thread block.  bf16
// at s = 1 goes by cp.async (uncommitted: the caller's next commit and wait
// cover it); otherwise 4 loads in flight per thread, rounded in registers.
template <typename TI>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const TI* base, const Opnd& o,
                                          const TokenMap& tm, int r, int p0, int rows,
                                          int width, float s, int valid = 1 << 30) {
  const int segs = width / 8, n = rows * segs;
  if (std::is_same<TI, bf16>::value && s == 1.f) {
    for (int idx = threadIdx.x; idx < n; idx += 128) {
      const int i = idx / segs, sg = idx % segs, p = p0 + i;
      const bool ok = p >= 0 && p < tm.P && sg * 8 < valid;
      cp_async16(&dst[i * ld + sg * 8], ok ? base + row_of(tm, o, r, p) + sg * 8 : base, ok);
    }
    return;
  }
  for (int i0 = 0; i0 < n; i0 += 4 * 128) {
    uint4 val[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = i0 + u * 128 + threadIdx.x, i = idx / segs, sg = idx % segs, p = p0 + i;
      val[u] = (idx < n && p >= 0 && p < tm.P && sg * 8 < valid)
                   ? load8(base + row_of(tm, o, r, p) + sg * 8, s)
                   : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = i0 + u * 128 + threadIdx.x;
      if (idx < n) *reinterpret_cast<uint4*>(&dst[(idx / segs) * ld + (idx % segs) * 8]) = val[u];
    }
  }
}

template <typename TI, typename TO>
__global__ void __launch_bounds__(128)
attn_tc_kernel(Opnd q, Opnd k, Opnd v, Opnd o, int H, int hd, TokenMap tm, float scale,
               const float* __restrict__ pw, int kk, const float* __restrict__ pb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nch = head_chunks(hd), QST = nch * TD + 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [TQ][QST]
  bf16* ring = Qs + TQ * QST;                     // TST x [TK][TRS]
  __shared__ float coef[MAX_KK];

  const int P = tm.P;
  const int r = blockIdx.x / H, h = blockIdx.x % H, hw = fold_of(tm, r) * H + h;
  const int q0 = blockIdx.y * TQ, oc = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const TI* qp = (const TI*)q.p + (long long)h * q.sh;
  const TI* kp = (const TI*)k.p + (long long)h * k.sh;
  const TI* vp = (const TI*)v.p + (long long)h * v.sh + oc * TD;

  // the query tile: round(q s), or round(M_h round(q s)) with EPEG (hd <=
  // 128, a 64-wide chunk at a time through the halo buffer)
  if (kk > 0) {
    const int pad = kk / 2, nh = TQ + kk - 1;
    bf16* Hs = ring;  // [nh][TD]
    for (int t = tid; t < kk; t += blockDim.x)
      coef[t] = round_to<bf16>(pw[hw * kk + t] + (t == pad ? 1.f : 0.f));
    for (int c = 0; c < nch; ++c) {
      const TI* qc = qp + c * TD;
      const int cw = hd - c * TD;  // columns of the chunk that exist
      for (int i0 = 0; i0 < nh * (TD / 8); i0 += 4 * 128) {  // 4 loads in flight
        uint4 val[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int idx = i0 + u * 128 + tid, row = idx / (TD / 8), sg = idx % (TD / 8);
          const int p = q0 - pad + row;
          val[u] = (row < nh && p >= 0 && p < P && sg * 8 < cw)
                       ? load8(qc + row_of(tm, q, r, p) + sg * 8, scale)
                       : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int idx = i0 + u * 128 + tid;
          if (idx < nh * (TD / 8)) *reinterpret_cast<uint4*>(&Hs[idx * 8]) = val[u];
        }
      }
      __syncthreads();
      for (int idx = tid; idx < TQ * TD; idx += blockDim.x) {
        const int i = idx / TD, d = idx % TD;
        float acc = 0.f;
        for (int t = 0; t < kk; ++t)
          acc = fmaf(coef[t], __bfloat162float(Hs[(i + t) * TD + d]), acc);
        Qs[i * QST + c * TD + d] = __float2bfloat16(acc);
      }
      __syncthreads();  // the halo (and the ring after the last chunk) is reused
    }
  } else if (std::is_same<TI, bf16>::value && scale == 1.f) {
    // already rounded (K5's backward hands K6 bf16 at scale 1): by cp.async,
    // in the ring's first group, so item 0's wait covers it
    const int segs = nch * TD / 8;
    for (int idx = tid; idx < TQ * segs; idx += blockDim.x) {
      const int i = idx / segs, sg = idx % segs, p = q0 + i;
      const bool ok = p < P && sg * 8 < hd;
      cp_async16(&Qs[i * QST + sg * 8], ok ? qp + row_of(tm, q, r, p) + sg * 8 : qp, ok);
    }
  } else {
    const int segs = nch * TD / 8;
    for (int i0 = 0; i0 < TQ * segs; i0 += 4 * 128) {  // 4 loads in flight
      uint4 val[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int idx = i0 + u * 128 + tid, i = idx / segs, sg = idx % segs, p = q0 + i;
        val[u] = p < P && sg * 8 < hd ? load8(qp + row_of(tm, q, r, p) + sg * 8, scale)
                                      : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int idx = i0 + u * 128 + tid;
        *reinterpret_cast<uint4*>(&Qs[(idx / segs) * QST + (idx % segs) * 8]) = val[u];
      }
    }
  }

  // the ring's items: pass 1 = (key tile, k chunk) for every chunk; pass 2 =
  // the same, then the key tile's v chunk of this block's output columns.
  // One key tile at hd > 64 (`one`): pass 2 alone, the max and sum taken
  // from the logit tile in registers just before the probabilities.
  const int nkt = (P + TK - 1) / TK;
  const bool one = nkt == 1 && nch > 1;
  const int n1 = one ? 0 : nkt * nch, total = n1 + nkt * (nch + 1);
  Seg<TI> sg[4];
  auto locate = [&](int i, int& kt, int& c, bool& isv) {
    if (i < n1) {
      kt = i / nch; c = i % nch; isv = false;
    } else {
      const int j = i - n1;
      kt = j / (nch + 1); c = j % (nch + 1); isv = c == nch;
    }
  };
  auto fetch = [&](int i) {
    int kt, c; bool isv;
    locate(i, kt, c, isv);
    bf16* T = ring + (i % TST) * TK * TRS;
    const TI* base = isv ? vp : kp + c * TD;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = tid + u * 128, j = idx >> 3, s8 = idx & 7, p = kt * TK + j;
      const bool ok = p < P && (isv ? oc : c) * TD + s8 * 8 < hd;
      const long long row = !ok ? 0 : isv ? row_of(tm, v, r, p) : row_of(tm, k, r, p);
      sg[u].fetch(&T[j * TRS + s8 * 8], base + row + (ok ? s8 * 8 : 0), ok);
    }
  };
  auto store = [&](int i) {
    bf16* T = ring + (i % TST) * TK * TRS;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = tid + u * 128;
      sg[u].store(&T[(idx >> 3) * TRS + (idx & 7) * 8]);
    }
  };

  for (int i = 0; i < TST - 1; ++i) {
    if (i < total) {
      fetch(i);
      store(i);
    }
    cp_async_commit();
  }

  const float bias = (kk > 0 && pb != nullptr) ? pb[hw] : 0.f;
  const int g = lane >> 2, cq = (lane & 3) * 2;
  float S[8][4], O[8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  uint32_t Pa[4][4];
  zero_acc(O);

  for (int i = 0; i < total; ++i) {
    // item i has landed (at most TST - 2 later groups pending), and every
    // warp is done with item i - 1, whose stage item i + TST - 1 reuses
    cp_async_wait<TST - 2>();
    __syncthreads();
    const bool more = i + TST - 1 < total;
    if (more) fetch(i + TST - 1);
    int kt, c; bool isv;
    locate(i, kt, c, isv);
    const bf16* T = ring + (i % TST) * TK * TRS;
    if (!isv) {
      if (c == 0) zero_acc(S);
      mma_abt(S, Qs + warp * 16 * QST + c * TD, QST, T, TRS);
      if (c == nch - 1) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            S[nt][e] = kt * TK + nt * 8 + cq + (e & 1) < P ? S[nt][e] + bias : -INFINITY;
        if (i < n1 || one) online_softmax(S, m, l);  // pass 1: online row max and sum
        if (i >= n1) {  // pass 2: the rounded probabilities as A fragments
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) S[nt][e] = expf(S[nt][e] - m[e >> 1]) / l[e >> 1];
          pack_frags(Pa, S);
        }
      }
    } else {
      mma_pb(O, Pa, T, TRS);
    }
    if (more) store(i + TST - 1);
    cp_async_commit();
  }

  TO* op = (TO*)o.p + (long long)h * o.sh + oc * TD + cq;
  const int p0 = q0 + warp * 16 + g;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int p = p0 + hr * 8;
    if (p >= P) continue;
    TO* orow = op + row_of(tm, o, r, p);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      if (oc * TD + nt * 8 + cq < hd) store2(orow + nt * 8, O[nt][2 * hr], O[nt][2 * hr + 1]);
  }
}

// ---------------------------------------------------------------------------
// The forward product with bf16 products, on the tensor cores:
//   out[M, N] = round(A) round(B) (+ bias) (* rowmask) (+ resid),  as TO.
// 64 x 64 output tile per block of 4 warps (each 32 x 32), k steps of 64
// through a two-stage ring (few steps: K5's small-M products are bound by
// the latency of each step's loads).  A (RowsA) goes by cp.async when it is bf16, or
// is read as f32 and rounded on its way to shared memory (the TPU kernel's
// z = x.astype(mm)); B (Thirds) likewise, read in place through its strides
// (BKC: k is B's contiguous axis, as in a Linear weight; else n is).
// Requires K % 8 == 0, nper % 8 == 0 and 16-byte aligned 8-element
// segments along B's unit-stride axis.  With folds of Mf rows (gridDim.z
// of them), a block's tile lies in fold blockIdx.z and reads that fold's B
// and bias (b.fs, bias.fs elements a fold); Mf = M is one fold.
// ---------------------------------------------------------------------------
constexpr int GM = 64, GN = 64, GK = 64, GKS = GK + 8, GNS = GN + 8;

template <typename TA, typename TB, typename TO, bool BKC>
__global__ void __launch_bounds__(128)
gemm_tc_kernel(RowsA a, Thirds b, TO* __restrict__ out, int ldc, int M, int N, int K,
               Bias3 bias, const uint8_t* __restrict__ rowmask, const TO* __restrict__ resid,
               int ldr, int Mf) {
  __shared__ __align__(16) bf16 As[2][GM * GKS];
  __shared__ __align__(16) bf16 Bs[2][BKC ? GN * GKS : GK * GNS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int f = blockIdx.z, m0 = f * Mf + blockIdx.y * GM, n0 = blockIdx.x * GN;
  M = min(M, f * Mf + Mf);
  bias = bias.fold(f);
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const TA* ap = (const TA*)a.p;
  Seg<TA> sa[4];
  Seg<TB> sb[4];

  // this thread's u-th segments: A row m0 + hi, k segment lo; B (n, k
  // segment) with BKC, or (k, n segment) without, hi = idx >> 3, lo =
  // (idx & 7) * 8.  The part of each address that does not move with k
  // (the row of A, the column of B: runtime divisions) is computed once.
  const TA* arow[4];
  const TB* bcol[4];
  bool aok[4], bok[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int idx = tid + u * 128, hi = idx >> 3, lo = (idx & 7) * 8;
    const int gm = m0 + hi, gn = n0 + (BKC ? hi : lo);
    aok[u] = gm < M;
    arow[u] = ap + (aok[u] ? (long long)(gm / a.P) * a.sr + (long long)(gm % a.P) * a.sp : 0) + lo;
    bok[u] = gn < N;
    const int t = bok[u] ? gn / b.nper : 0, nl = gn - t * b.nper;
    bcol[u] = (const TB*)(t == 0 ? b.p[0] : t == 1 ? b.p[1] : b.p[2]) + f * b.fs +
              (bok[u] ? (long long)(nl / b.ndiv) * b.sn1 + (long long)(nl % b.ndiv) * b.sn0 : 0);
  }
  auto fetch = [&](int k0, int st) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = tid + u * 128, hi = idx >> 3, lo = (idx & 7) * 8;
      const bool ok = aok[u] && k0 + lo < K;
      sa[u].fetch(&As[st][hi * GKS + lo], ok ? arow[u] + k0 : ap, ok);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = tid + u * 128, hi = idx >> 3, lo = (idx & 7) * 8;
      const int gk = k0 + (BKC ? lo : hi);
      const bool ok = bok[u] && gk < K;
      const long long koff = (long long)(gk / b.kdiv) * b.sk1 + (long long)(gk % b.kdiv) * b.sk0;
      sb[u].fetch(&Bs[st][hi * (BKC ? GKS : GNS) + lo], ok ? bcol[u] + koff : bcol[u], ok);
    }
  };
  auto store = [&](int st) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = tid + u * 128, hi = idx >> 3, lo = (idx & 7) * 8;
      sa[u].store(&As[st][hi * GKS + lo]);
      sb[u].store(&Bs[st][hi * (BKC ? GKS : GNS) + lo]);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = (K + GK - 1) / GK;
  fetch(0, 0);
  store(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) fetch((kt + 1) * GK, st ^ 1);
    cp_async_commit();
    const bf16* A_ = As[st];
    const bf16* B_ = Bs[st];
#pragma unroll
    for (int ks = 0; ks < GK / 16; ++ks) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldsm_x4(af[mt], &A_[(wm + mt * 16 + (lane & 15)) * GKS + ks * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int n2 = 0; n2 < 2; ++n2) {
        uint32_t bf[4];
        if (BKC)
          ldsm_x4(bf, &B_[(wn + n2 * 16 + (lane & 7) + (lane >> 4) * 8) * GKS + ks * 16 +
                          ((lane >> 3) & 1) * 8]);
        else
          ldsm_x4_t(bf, &B_[(ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * GNS + wn +
                            n2 * 16 + (lane >> 4) * 8]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * n2], af[mt], bf[0], bf[1]);
          mma_bf16(acc[mt][2 * n2 + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
    if (more) store(st ^ 1);
    cp_async_wait<0>();
    __syncthreads();
  }

  const int g = lane >> 2, cq = (lane & 3) * 2;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int gm = m0 + wm + mt * 16 + g + hr * 8;
      if (gm >= M) continue;
      const float mrow = rowmask ? (rowmask[gm] ? 1.f : 0.f) : 1.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int gn = n0 + wn + nt * 8 + cq;
        if (gn >= N) continue;
        float v0 = acc[mt][nt][2 * hr] + bias.at(gn);
        float v1 = acc[mt][nt][2 * hr + 1] + bias.at(gn + 1);
        if (rowmask) { v0 *= mrow; v1 *= mrow; }
        if (resid) {
          v0 = to_f(resid[(long long)gm * ldr + gn]) + v0;
          v1 = to_f(resid[(long long)gm * ldr + gn + 1]) + v1;
        }
        store2(out + (long long)gm * ldc + gn, v0, v1);
      }
    }
}

// ---------------------------------------------------------------------------
// Launchers: bf16 products (tm = 1) on the tensor cores, f32 products
// (tm = 0) on the SIMT kernels.  The shared-memory opt-in is made once per
// kernel instance and size, not per call.
// ---------------------------------------------------------------------------
template <typename K>
cudaError_t smem_optin(K kernel, int bytes, int& done) {
  if (bytes <= done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done = bytes;
  return err;
}

template <typename TI, typename TM, typename TO>
cudaError_t launch_attention(Opnd q, Opnd k, Opnd v, Opnd o, int R, int H, int hd,
                             TokenMap tm, float scale, const void* pw, int kk, const void* pb,
                             cudaStream_t stream) {
  if (hd <= 0 || hd % 32 != 0 || hd > MAX_HD || kk < 0 || kk > MAX_KK ||
      (kk > 0 && hd > MAX_EPEG_HD) || tm.P <= 0)
    return cudaErrorInvalidValue;
  dim3 grid(R * H, (tm.P + 63) / 64, head_chunks(hd));
  static int done = 0;
  cudaError_t err;
  if (sizeof(TM) == 2) {
    const int smem = attn_tc_smem_bytes(hd, kk);
    if ((err = smem_optin(attn_tc_kernel<TI, TO>, smem, done)) != cudaSuccess) return err;
    attn_tc_kernel<TI, TO><<<grid, 128, smem, stream>>>(q, k, v, o, H, hd, tm, scale,
                                                        (const float*)pw, kk, (const float*)pb);
  } else {
    const int smem = attn_smem_bytes(hd);
    if ((err = smem_optin(attn_kernel<TI, float, TO>, smem, done)) != cudaSuccess) return err;
    attn_kernel<TI, float, TO><<<grid, 256, smem, stream>>>(
        q, k, v, o, H, hd, tm, scale, (const float*)pw, kk, (const float*)pb);
  }
  return cudaGetLastError();
}

// Mf: rows per fold (M for one fold; M a multiple of it)
template <typename TA, typename TB, typename TM, typename TO>
cudaError_t launch_gemm(RowsA a, Thirds b, void* out, int ldc, int M, int N, int K, Bias3 bias,
                        const void* rowmask, const void* resid, int ldr, cudaStream_t stream,
                        int Mf = 0) {
  if (Mf <= 0) Mf = M;
  if (M <= 0 || N <= 0 || K <= 0 || a.P <= 0 || b.nper <= 0 || M % Mf != 0)
    return cudaErrorInvalidValue;
  if (sizeof(TM) == 4)
    return launch_gemm_simt<TA, TB, TO>(a, b, out, ldc, M, N, K, bias, rowmask, resid, ldr,
                                        Mf, stream);
  // 8-element segments along the unit-stride axis stay inside one block
  const bool bkc = b.sk0 == 1;
  if (K % 8 != 0 || b.nper % 8 != 0 || (bkc ? b.kdiv : b.ndiv) % 8 != 0 ||
      (!bkc && b.sn0 != 1))
    return cudaErrorInvalidValue;
  dim3 grid((N + GN - 1) / GN, (Mf + GM - 1) / GM, M / Mf);
  if (bkc)
    gemm_tc_kernel<TA, TB, TO, true><<<grid, 128, 0, stream>>>(
        a, b, (TO*)out, ldc, M, N, K, bias, (const uint8_t*)rowmask, (const TO*)resid, ldr,
        Mf);
  else
    gemm_tc_kernel<TA, TB, TO, false><<<grid, 128, 0, stream>>>(
        a, b, (TO*)out, ldc, M, N, K, bias, (const uint8_t*)rowmask, (const TO*)resid, ldr,
        Mf);
  return cudaGetLastError();
}

}  // namespace rrt
