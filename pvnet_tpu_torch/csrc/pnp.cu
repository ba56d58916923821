// Perspective-n-Point on the card: EPnP (kernel pnp_epnp) and the 4-start
// Levenberg-Marquardt refine (kernel pnp_lm).
//
// Replaces: no TPU kernel. pvnet_tpu/ops/pnp.py leaves PnP to XLA, which
// fuses its batched tensor program; the port's plain version
// (pvnet_tpu_torch/ops/pnp.py: epnp_plain, lm_multi_start_plain) is the
// same program in eager PyTorch, about 8000 launches of tiny kernels and
// 21 host synchronizations a batch of 128 problems (LAPACK error checks,
// small host constants), so that the card idled through PnP's host time.
// Each kernel here computes one of those functions whole, per problem, in
// one launch that allocates nothing and never waits on the host.
//
// pnp_epnp, per problem (ops/pnp.py: epnp): the weighted control points
// (3x3 eigendecomposition), the barycentric coordinates (4x4 LU with
// partial pivoting), M^T M and its 12x12 eigendecomposition, the five
// beta seeds and their damped, accept-gated Gauss-Newton (8 iterations),
// the scale and cheirality fix and Procrustes (so3_project), the
// homography candidate (plane PCA, Hartley-normalised weighted DLT through
// a 9x9 eigendecomposition, K^-1, decomposition), and the argmin of the
// six candidates' weighted reprojection costs (NaN last).
// pnp_lm, per (problem, start) (ops/pnp.py: lm_multi_start_plain,
// lm_refine): the start flipped about the centroid, inverse_rodrigues, a
// fixed number of iterations of the closed-form residuals and Jacobian
// with the depth clamp, J^T J and J^T r, diagonal damping,
// solve_spd_small's modified Cholesky with its scale-relative floor,
// accept or reject with damping x0.33 / x3 in [1e-10, 1e8], rodrigues back
// to [R | t], and the argmin of the four final costs (ties and NaN as
// torch.argmin: the lower start).
//
// The arithmetic is the plain version's in float32, in the same order
// except for the order of sums; eigendecompositions are solve-free cyclic
// Jacobi sweeps (smalllinalg.eigh_small's rotation and sweep counts,
// 6 / 8 / 10 for n <= 4 / 9 / 12, eigenvalues ascending by a stable sort)
// where the plain version calls torch.linalg.eigh, so eigenvectors may
// differ in sign and, inside a degenerate cluster, in order: EPnP seeds
// from every null vector and arbitrates by reprojection cost, so the pose
// depends on neither. -fmad=false (kernel_lib.NVCC_FLAGS) keeps every
// multiply and add rounded on its own, as the plain version rounds.
//
// What bounds it on the H100: neither bytes nor operations at the main
// path's sizes. A batch of 128 problems of 9 points reads ~20 KB and does
// ~64 M float32 operations (tools/bench_torch_pnp.py: pnp_operations):
// ~2 us at the card's 33.5 T/s non-FMA rate, less than a launch. What is
// left is latency: EPnP's 948 Jacobi rotations (12 x 12 and 9 x 9) in a
// chain, each waiting on the last (an atan2, a sine and a cosine, ~0.3 us
// of its ~0.45 us on one warp), and the LM's 16 dependent iterations.
//
// What the design does about it (H100, b = 128, n = 9, warm; the first
// design, a thread per problem and per start, took 1.12 ms and 0.23 ms):
// - EPnP: 16 lanes (half a warp) per problem, 4 problems a block. Lane 0
//   builds M^T M and the DLT's A^T A into shared memory; the 16 lanes run
//   the two large Jacobi sweeps together, lane k rotating row and column
//   k of A and row k of V, with a __syncwarp before and after each
//   rotation's writes (lane 0 writes the 2 x 2 block); lane 0 does the
//   rest (3 x 3 eigendecompositions, the seeds' Gauss-Newton, Procrustes,
//   the costs). Every load of a rotation issues before its stores: with
//   the matrices in one thread's local memory, each load waited on the
//   stores before it (1.12 -> 0.78 ms); the lanes take it to 0.63 ms.
//   Unrolling the pair loops to keep a 12 x 12 matrix in registers was
//   tried and was slower (1.02 ms): 66 inlined rotations with their
//   trigonometry overflow the instruction cache.
// - LM: a warp per problem, 8 lanes per start; each lane sums its points'
//   residuals, J^T J and J^T r, a butterfly of shuffles adds the 8
//   partial sums (identical on every lane, so that every lane takes the
//   same accept), and the 6 x 6 solve and the rest run on all 8 alike;
//   the final argmin over the 4 starts is two more shuffles (0.23 ->
//   0.105 ms).
// - Nothing is unrolled across the sweeps or the 16 iterations, to keep
//   the build short (~16 s); the per-problem functions are
//   __host__ __device__, and with one lane (G = 1) the same arithmetic
//   compiles for the host.
// - Inputs are read where they lie: pts3d and K through a batch stride
//   (0 for one object's keypoints or one K shared by the batch).
#include <math.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define PNP_HD __host__ __device__
#else
#define PNP_HD
#endif

namespace pnp {

constexpr int NMAX = 32;        // points per problem (the wrapper checks)
constexpr float Z_MIN = 1e-5f;  // ops/pnp.py: _Z_MIN

// torch.maximum / torch.clamp(min=) semantics: NaN propagates
PNP_HD inline float tmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}
PNP_HD inline float tmin(float a, float b) {
  return (a != a || a < b) ? a : b;
}

PNP_HD inline void cross3(const float* a, const float* b, float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// C = A @ B for 3x3 row-major matrices
PNP_HD inline void matmul3(const float* A, const float* B, float* C) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[i * 3 + j] = A[i * 3 + 0] * B[0 * 3 + j] + A[i * 3 + 1] * B[1 * 3 + j]
                     + A[i * 3 + 2] * B[2 * 3 + j];
}

// The lanes that share one piece of work: lane `lane` of G adjacent lanes
// of a warp (EPnP's large Jacobi sweeps, an LM start's sums). G = 1 (the
// other pieces of EPnP, and everything on the host) never synchronizes.
struct Lanes {
  int lane, G;
  PNP_HD void sync() const {
#ifdef __CUDA_ARCH__
    if (G > 1) __syncwarp();
#endif
  }
};

// The sum of v over the G lanes (a power of two, adjacent lanes of one
// warp), on every lane: a butterfly of shuffles. One lane: v.
PNP_HD inline float lane_sum(float v, const Lanes& L) {
#ifdef __CUDA_ARCH__
  for (int m = L.G >> 1; m > 0; m >>= 1)
    v = v + __shfl_xor_sync(0xffffffffu, v, m);
#else
  (void)L;
#endif
  return v;
}

// Cyclic Jacobi sweeps on the symmetric N x N row-major A (in place; V is
// set to the accumulated rotations): smalllinalg.eigh_small's rotation
// (theta = atan2(2 apq, aqq - app) / 2), pair order and sweep counts. Lane
// k of the G updates row and column k of A and row k of V; the rotation's
// 2 x 2 block is lane 0's. A and V are in shared memory where G > 1.
template <int N>
PNP_HD void jacobi_sweeps(float* A, float* V, const Lanes& L) {
  for (int k = L.lane; k < N; k += L.G)
    for (int j = 0; j < N; ++j) V[k * N + j] = k == j ? 1.0f : 0.0f;
  const int sweeps = N <= 4 ? 6 : (N <= 9 ? 8 : 10);
#ifdef __CUDACC__
#pragma unroll 1
#endif
  for (int sw = 0; sw < sweeps; ++sw) {
#ifdef __CUDACC__
#pragma unroll 1
#endif
    for (int p = 0; p < N - 1; ++p) {
#ifdef __CUDACC__
#pragma unroll 1
#endif
      for (int q = p + 1; q < N; ++q) {
        L.sync();   // the last rotation's writes are seen
        const float app = A[p * N + p], aqq = A[q * N + q];
        const float apq = A[p * N + q];
        const float theta = 0.5f * atan2f(2.0f * apq, aqq - app);
        const float c = cosf(theta), s = sinf(theta);
        L.sync();   // every lane has read the block before it changes
        // A <- J^T A J, V <- V J with J = I + (c-1)(E_pp + E_qq)
        // + s(E_pq - E_qp): rows and columns p, q of A change (one value
        // for both triangles), columns p, q of V. Each k's loads issue
        // before its stores.
        for (int k = L.lane; k < N; k += L.G) {
          if (k != p && k != q) {
            const float akp = A[k * N + p], akq = A[k * N + q];
            const float np = c * akp - s * akq, nq = s * akp + c * akq;
            A[k * N + p] = np;
            A[p * N + k] = np;
            A[k * N + q] = nq;
            A[q * N + k] = nq;
          }
          const float vp = V[k * N + p], vq = V[k * N + q];
          V[k * N + p] = c * vp - s * vq;
          V[k * N + q] = s * vp + c * vq;
        }
        if (L.lane == 0) {
          const float rpp = c * app - s * apq, rpq = c * apq - s * aqq;
          const float rqp = s * app + c * apq, rqq = s * apq + c * aqq;
          const float npq = s * rpp + c * rpq;
          A[p * N + p] = c * rpp - s * rpq;
          A[q * N + q] = s * rqp + c * rqq;
          A[p * N + q] = npq;
          A[q * N + p] = npq;
        }
      }
    }
  }
  L.sync();
}

// After jacobi_sweeps: lam[i] (i < N) the i-th smallest eigenvalue (a
// stable ascending sort, as torch.sort(stable=True)) and vec[i * N + k]
// (i < K) component k of its eigenvector.
template <int N, int K>
PNP_HD void sorted_eigenpairs(const float* A, const float* V, float* lam,
                              float* vec) {
  int ord[N];
  for (int i = 0; i < N; ++i) ord[i] = i;
  for (int i = 1; i < N; ++i) {
    const int o = ord[i];
    int j = i;
    while (j > 0 && A[ord[j - 1] * (N + 1)] > A[o * (N + 1)]) {
      ord[j] = ord[j - 1];
      --j;
    }
    ord[j] = o;
  }
  for (int i = 0; i < N; ++i) lam[i] = A[ord[i] * (N + 1)];
  for (int i = 0; i < K; ++i)
    for (int k = 0; k < N; ++k) vec[i * N + k] = V[k * N + ord[i]];
}

// smalllinalg.eigh_small of one symmetric N x N matrix by one lane
// (sorted_eigenpairs' lam and vec)
template <int N, int K>
PNP_HD void eigh_jacobi(const float* A_in, float* lam, float* vec) {
  float A[N * N], V[N * N];
  for (int i = 0; i < N; ++i)
    for (int j = 0; j < N; ++j)
      A[i * N + j] = 0.5f * (A_in[i * N + j] + A_in[j * N + i]);
  jacobi_sweeps<N>(A, V, Lanes{0, 1});
  sorted_eigenpairs<N, K>(A, V, lam, vec);
}

// smalllinalg.solve_spd_small / geometry.solve_spd_small: Cholesky with
// the pivot floor eps * max(diag A) + 1e-30, then the two triangular
// solves. A is N x N row-major (its lower triangle is read).
template <int N>
PNP_HD void solve_spd(const float* A, const float* b, float* x, float eps) {
  float dmax = A[0];
  for (int j = 1; j < N; ++j) dmax = tmax(dmax, A[j * N + j]);
  const float floor_ = eps * dmax + 1e-30f;
  float L[N * N];
#ifdef __CUDACC__
#pragma unroll
#endif
  for (int j = 0; j < N; ++j) {
    float s = A[j * N + j];
    for (int k = 0; k < j; ++k) s = s - L[j * N + k] * L[j * N + k];
    const float d = sqrtf(tmax(s, floor_));
    L[j * N + j] = d;
    const float inv_d = 1.0f / d;
    for (int i = j + 1; i < N; ++i) {
      float t = A[i * N + j];
      for (int k = 0; k < j; ++k) t = t - L[i * N + k] * L[j * N + k];
      L[i * N + j] = t * inv_d;
    }
  }
  float y[N];
#ifdef __CUDACC__
#pragma unroll
#endif
  for (int i = 0; i < N; ++i) {
    float s = b[i];
    for (int k = 0; k < i; ++k) s = s - L[i * N + k] * y[k];
    y[i] = s / L[i * N + i];
  }
#ifdef __CUDACC__
#pragma unroll
#endif
  for (int i = N - 1; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < N; ++k) s = s - L[k * N + i] * x[k];
    x[i] = s / L[i * N + i];
  }
}

// smalllinalg.so3_project: the rotation nearest M (3x3 row-major), from
// the eigendecomposition of M^T M, invariant to the eigenvectors' signs.
PNP_HD void so3_project(const float* M, float* R) {
  const float eps = 1e-12f;
  float A[9], V[9], lam[3];
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b)
      A[a * 3 + b] = M[0 * 3 + a] * M[0 * 3 + b] + M[1 * 3 + a] * M[1 * 3 + b]
                     + M[2 * 3 + a] * M[2 * 3 + b];
  eigh_jacobi<3, 3>(A, lam, V);
  float v1[3], v2[3], u1[3], u2[3];
  for (int k = 0; k < 3; ++k) {
    v1[k] = V[3 + k];
    v2[k] = V[6 + k];
  }
  for (int a = 0; a < 3; ++a) {
    u2[a] = M[a * 3 + 0] * v2[0] + M[a * 3 + 1] * v2[1] + M[a * 3 + 2] * v2[2];
    u1[a] = M[a * 3 + 0] * v1[0] + M[a * 3 + 1] * v1[1] + M[a * 3 + 2] * v1[2];
  }
  const float n2 = sqrtf(u2[0] * u2[0] + u2[1] * u2[1] + u2[2] * u2[2] + eps);
  for (int a = 0; a < 3; ++a) u2[a] = u2[a] / n2;
  const float d12 = u1[0] * u2[0] + u1[1] * u2[1] + u1[2] * u2[2];
  for (int a = 0; a < 3; ++a) u1[a] = u1[a] - d12 * u2[a];
  const float n1 = sqrtf(u1[0] * u1[0] + u1[1] * u1[1] + u1[2] * u1[2]);
  // rank-1 guard: a unit vector orthogonal to u2 (the larger of two
  // candidate crosses)
  const float ex[3] = {1.0f, 0.0f, 0.0f}, ey[3] = {0.0f, 1.0f, 0.0f};
  float alt_a[3], alt_b[3], alt[3];
  cross3(u2, ex, alt_a);
  cross3(u2, ey, alt_b);
  const bool use_a = alt_a[0] * alt_a[0] + alt_a[1] * alt_a[1]
                     + alt_a[2] * alt_a[2]
                     > alt_b[0] * alt_b[0] + alt_b[1] * alt_b[1]
                     + alt_b[2] * alt_b[2];
  for (int a = 0; a < 3; ++a) alt[a] = use_a ? alt_a[a] : alt_b[a];
  const float na = sqrtf(alt[0] * alt[0] + alt[1] * alt[1] + alt[2] * alt[2]
                         + eps);
  const float nu = sqrtf(n1 * n1 + eps);
  for (int a = 0; a < 3; ++a)
    u1[a] = n1 > 1e-6f ? u1[a] / nu : alt[a] / na;
  float u0[3], v0[3];
  cross3(u1, u2, u0);
  cross3(v1, v2, v0);
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b)
      R[a * 3 + b] = u2[a] * v2[b] + u1[a] * v1[b] + u0[a] * v0[b];
}

// smalllinalg.inv3x3: adjugate / determinant
PNP_HD void inv3x3(const float* M, float* o) {
  const float a = M[0], b = M[1], c = M[2], d = M[3], e = M[4], f = M[5];
  const float g = M[6], h = M[7], i = M[8];
  const float A = e * i - f * h, B = -(d * i - f * g), C = d * h - e * g;
  const float det = a * A + b * B + c * C;
  const float adj[9] = {A, -(b * i - c * h), b * f - c * e,
                        B, a * i - c * g,    -(a * f - c * d),
                        C, -(a * h - b * g), a * e - b * d};
  for (int k = 0; k < 9; ++k) o[k] = adj[k] / det;
}

// weighted reprojection cost of pose [R | t] (3x4 row-major), as
// geometry.project and epnp's candidate costs
PNP_HD float reprojection_cost(const float* P, const float* X,
                               const float* x, const float* K,
                               const float* w, int n) {
  float cost = 0.0f;
  for (int i = 0; i < n; ++i) {
    float cam[3];
    for (int a = 0; a < 3; ++a)
      cam[a] = X[i * 3 + 0] * P[a * 4 + 0] + X[i * 3 + 1] * P[a * 4 + 1]
               + X[i * 3 + 2] * P[a * 4 + 2] + P[a * 4 + 3];
    float z = cam[2];
    if (fabsf(z) < 1e-5f) z = z < 0.0f ? -1e-5f : 1e-5f;
    const float u = cam[0] * K[0] + cam[1] * K[1] + cam[2] * K[2];
    const float v = cam[0] * K[3] + cam[1] * K[4] + cam[2] * K[5];
    const float ex = u / z - x[i * 2 + 0], ey = v / z - x[i * 2 + 1];
    cost = cost + w[i] * (ex * ex + ey * ey);
  }
  return cost;
}

// the 6 pairs of the 4 control points (ops/pnp.py: _PAIR_A, _PAIR_B)
PNP_HD inline int pair_a(int p) { return p < 3 ? 0 : (p < 5 ? 1 : 2); }
PNP_HD inline int pair_b(int p) {
  return p < 3 ? p + 1 : (p < 5 ? p - 1 : 3);
}

// ops/pnp.py: _betas_gauss_newton for one seed. dV [4][6][3] (basis,
// pair, coordinate), target [6] the squared world distances.
PNP_HD void betas_gauss_newton(const float* dV, const float* target,
                               float* beta) {
  float dc[18], r[6];
  auto residual = [&](const float* bt) {
    for (int p = 0; p < 6; ++p) {
      for (int c = 0; c < 3; ++c)
        dc[p * 3 + c] = bt[0] * dV[(0 * 6 + p) * 3 + c]
                        + bt[1] * dV[(1 * 6 + p) * 3 + c]
                        + bt[2] * dV[(2 * 6 + p) * 3 + c]
                        + bt[3] * dV[(3 * 6 + p) * 3 + c];
      r[p] = dc[p * 3] * dc[p * 3] + dc[p * 3 + 1] * dc[p * 3 + 1]
             + dc[p * 3 + 2] * dc[p * 3 + 2] - target[p];
    }
    float cost = 0.0f;
    for (int p = 0; p < 6; ++p) cost = cost + r[p] * r[p];
    return cost;
  };
  float cost = residual(beta);
  float lam = 1e-6f;
  for (int it = 0; it < 8; ++it) {
    residual(beta);
    float J[24];
    for (int p = 0; p < 6; ++p)
      for (int k = 0; k < 4; ++k)
        J[p * 4 + k] = 2.0f * (dc[p * 3] * dV[(k * 6 + p) * 3]
                               + dc[p * 3 + 1] * dV[(k * 6 + p) * 3 + 1]
                               + dc[p * 3 + 2] * dV[(k * 6 + p) * 3 + 2]);
    float H[16], g[4];
    for (int a = 0; a < 4; ++a) {
      for (int b = a; b < 4; ++b) {
        float s = 0.0f;
        for (int p = 0; p < 6; ++p) s = s + J[p * 4 + a] * J[p * 4 + b];
        H[a * 4 + b] = s;
        H[b * 4 + a] = s;
      }
      float s = 0.0f;
      for (int p = 0; p < 6; ++p) s = s + J[p * 4 + a] * r[p];
      g[a] = s;
    }
    for (int a = 0; a < 4; ++a) {
      const float dH = tmax(H[a * 4 + a], 1e-12f);
      H[a * 4 + a] = H[a * 4 + a] + lam * dH + 1e-12f;
    }
    float step[4], beta_new[4];
    solve_spd<4>(H, g, step, 1e-10f);
    for (int k = 0; k < 4; ++k) beta_new[k] = beta[k] - step[k];
    const float cost_new = residual(beta_new);
    const bool accept = cost_new < cost;   // false for NaN
    if (accept) {
      for (int k = 0; k < 4; ++k) beta[k] = beta_new[k];
      cost = cost_new;
    }
    lam = tmin(tmax(accept ? lam * 0.1f : lam * 100.0f, 1e-12f), 1e12f);
  }
}

// ops/pnp.py: _homography_init for one problem, in two halves around the
// eigendecomposition of the DLT's 9 x 9 A^T A. The first fits the plane
// (its centroid c and basis B, columns e2, e1, e2 x e1), normalises the
// plane and image points (mu_p, s_p, mu_i, s_i) and builds A^T A
// (symmetric, both triangles) in A.
struct Plane {
  float c[3], B[9], mu_p[2], mu_i[2], s_p, s_i;
};

PNP_HD void homography_system(const float* X, const float* x, const float* w,
                              float wsum, int n, Plane& pl, float* A) {
  float* c = pl.c;
  for (int a = 0; a < 3; ++a) {
    float s = 0.0f;
    for (int i = 0; i < n; ++i) s = s + X[i * 3 + a] * w[i];
    c[a] = s / wsum;
  }
  float cov[9], E[9], lam3[3];
  for (int a = 0; a < 3; ++a)
    for (int b = a; b < 3; ++b) {
      float s = 0.0f;
      for (int i = 0; i < n; ++i)
        s = s + (X[i * 3 + a] - c[a]) * w[i] * (X[i * 3 + b] - c[b]);
      cov[a * 3 + b] = s;
      cov[b * 3 + a] = s;
    }
  eigh_jacobi<3, 3>(cov, lam3, E);
  float e3[3];
  cross3(E + 6, E + 3, e3);
  float* B = pl.B;
  for (int r = 0; r < 3; ++r) {
    B[r * 3] = E[6 + r];
    B[r * 3 + 1] = E[3 + r];
    B[r * 3 + 2] = e3[r];
  }
  float uv[NMAX * 2];
  for (int i = 0; i < n; ++i) {
    const float d0 = X[i * 3] - c[0], d1 = X[i * 3 + 1] - c[1];
    const float d2 = X[i * 3 + 2] - c[2];
    uv[i * 2] = d0 * B[0] + d1 * B[3] + d2 * B[6];
    uv[i * 2 + 1] = d0 * B[1] + d1 * B[4] + d2 * B[7];
  }
  // Hartley normalisation: mean, and sqrt(2) over the weighted mean
  // distance
  auto norm_T = [&](const float* p, float* mu, float* s) {
    for (int a = 0; a < 2; ++a) {
      float t = 0.0f;
      for (int i = 0; i < n; ++i) t = t + p[i * 2 + a] * w[i];
      mu[a] = t / wsum;
    }
    float t = 0.0f;
    for (int i = 0; i < n; ++i) {
      const float d0 = p[i * 2] - mu[0], d1 = p[i * 2 + 1] - mu[1];
      t = t + sqrtf(d0 * d0 + d1 * d1 + 1e-12f) * w[i];
    }
    *s = 1.41421354f / (t / wsum + 1e-12f);
  };
  norm_T(uv, pl.mu_p, &pl.s_p);
  norm_T(x, pl.mu_i, &pl.s_i);
  for (int k = 0; k < 81; ++k) A[k] = 0.0f;
  for (int i = 0; i < n; ++i) {
    const float px = (uv[i * 2] - pl.mu_p[0]) * pl.s_p;
    const float py = (uv[i * 2 + 1] - pl.mu_p[1]) * pl.s_p;
    const float u = (x[i * 2] - pl.mu_i[0]) * pl.s_i;
    const float v = (x[i * 2 + 1] - pl.mu_i[1]) * pl.s_i;
    const float sw = sqrtf(w[i]);
    const float ru[9] = {-px * sw, -py * sw, -1.0f * sw, 0.0f * sw, 0.0f * sw,
                         0.0f * sw, u * px * sw, u * py * sw, u * sw};
    const float rv[9] = {0.0f * sw, 0.0f * sw, 0.0f * sw, -px * sw, -py * sw,
                         -1.0f * sw, v * px * sw, v * py * sw, v * sw};
    for (int a = 0; a < 9; ++a)
      for (int b = a; b < 9; ++b)
        A[a * 9 + b] = A[a * 9 + b] + ru[a] * ru[b] + rv[a] * rv[b];
  }
  for (int a = 0; a < 9; ++a)
    for (int b = 0; b < a; ++b) A[a * 9 + b] = A[b * 9 + a];
}

// The second half: the pose P [3][4] from Hn, A^T A's eigenvector of its
// least eigenvalue (row-major 3 x 3).
PNP_HD void homography_pose(const Plane& pl, const float* Hn, const float* K,
                            float* P) {
  // denormalise: p_img = T_i^-1 Hn T_p with T(p) = s (p - mu)
  const float Ti_inv[9] = {1.0f / pl.s_i, 0.0f, pl.mu_i[0], 0.0f,
                           1.0f / pl.s_i, pl.mu_i[1], 0.0f, 0.0f, 1.0f};
  const float Tp[9] = {pl.s_p, 0.0f, -pl.s_p * pl.mu_p[0], 0.0f, pl.s_p,
                       -pl.s_p * pl.mu_p[1], 0.0f, 0.0f, 1.0f};
  float T1[9], H[9], Kinv[9], M[9];
  matmul3(Ti_inv, Hn, T1);
  matmul3(T1, Tp, H);
  inv3x3(K, Kinv);
  matmul3(Kinv, H, M);                      // ~ [r1 r2 | t']
  float lam = 1.0f / (sqrtf(M[0] * M[0] + M[3] * M[3] + M[6] * M[6])
                      + 1e-12f);
  // cheirality: points in front of the camera (z of t' > 0)
  lam = lam * (M[8] < 0.0f ? -1.0f : 1.0f);
  float r1[3], r2[3], r3[3], t_pl[3];
  for (int a = 0; a < 3; ++a) {
    r1[a] = M[a * 3] * lam;
    r2[a] = M[a * 3 + 1] * lam;
    t_pl[a] = M[a * 3 + 2] * lam;
  }
  cross3(r1, r2, r3);
  const float Q[9] = {r1[0], r2[0], r3[0], r1[1], r2[1], r3[1],
                      r1[2], r2[2], r3[2]};
  float Pr[9];
  so3_project(Q, Pr);
  const float* B = pl.B;
  for (int a = 0; a < 3; ++a) {
    float Rc = 0.0f;
    for (int b = 0; b < 3; ++b) {
      // R = Pr @ B^T
      const float r = Pr[a * 3] * B[b * 3] + Pr[a * 3 + 1] * B[b * 3 + 1]
                      + Pr[a * 3 + 2] * B[b * 3 + 2];
      P[a * 4 + b] = r;
      Rc = Rc + r * pl.c[b];
    }
    P[a * 4 + 3] = t_pl[a] - Rc;
  }
}

// EPnP's two large matrices and their rotations, shared by a problem's
// lanes
struct EpnpShared {
  float A12[144], V12[144], A9[81], V9[81];
};

// ops/pnp.py: epnp for one problem. X [n][3], x [n][2], K [3][3], wt [n]
// or null (ones); out [3][4], written by lane 0. Lane 0 builds the
// matrices, the lanes rotate the two large ones together, lane 0 does the
// rest.
PNP_HD void epnp_one(const float* X, const float* x, const float* K,
                     const float* wt, int n, EpnpShared& sh, const Lanes& L,
                     float* out) {
  float w[NMAX], wsum = 0.0f, ctrl[12], alpha[NMAX * 4];
  Plane pl;
  if (L.lane == 0) {
    float wmax = wt ? wt[0] : 1.0f;
    for (int i = 0; i < n; ++i) {
      w[i] = wt ? wt[i] : 1.0f;
      wmax = tmax(wmax, w[i]);
    }
    for (int i = 0; i < n; ++i) w[i] = w[i] / (wmax + 1e-12f);

    // control points: weighted centroid + principal axes
    for (int i = 0; i < n; ++i) wsum = wsum + w[i];
    wsum = wsum + 1e-9f;
    for (int a = 0; a < 3; ++a) {
      float s = 0.0f;
      for (int i = 0; i < n; ++i) s = s + X[i * 3 + a] * w[i];
      ctrl[a] = s / wsum;
    }
    {
      float cov[9], E[9], lam[3];
      for (int a = 0; a < 3; ++a)
        for (int b = a; b < 3; ++b) {
          float s = 0.0f;
          for (int i = 0; i < n; ++i)
            s = s + (X[i * 3 + a] - ctrl[a]) * w[i] * (X[i * 3 + b] - ctrl[b]);
          cov[a * 3 + b] = s / wsum;
          cov[b * 3 + a] = s / wsum;
        }
      eigh_jacobi<3, 3>(cov, lam, E);
      // floor the eigenvalues relative to the cloud's extent, so that planar
      // sets keep a well-conditioned 4th control point
      const float floor_ = 1e-4f * tmax(tmax(lam[0], lam[1]), lam[2]) + 1e-10f;
      for (int j = 0; j < 3; ++j) {
        const float sigma = sqrtf(tmax(lam[j], floor_));
        for (int a = 0; a < 3; ++a)
          ctrl[(j + 1) * 3 + a] = ctrl[a] + E[j * 3 + a] * sigma;
      }
    }

    // barycentric coordinates: C alpha = [X; 1], C = [ctrl^T; 1 1 1 1], by
    // LU with partial pivoting
    {
      float LU[16];
      int perm[4] = {0, 1, 2, 3};
      for (int r = 0; r < 3; ++r)
        for (int j = 0; j < 4; ++j) LU[r * 4 + j] = ctrl[j * 3 + r];
      for (int j = 0; j < 4; ++j) LU[12 + j] = 1.0f;
      for (int k = 0; k < 4; ++k) {
        int piv = k;
        float best = fabsf(LU[k * 4 + k]);
        for (int i = k + 1; i < 4; ++i)
          if (fabsf(LU[i * 4 + k]) > best) {
            best = fabsf(LU[i * 4 + k]);
            piv = i;
          }
        if (piv != k) {
          for (int j = 0; j < 4; ++j) {
            const float t = LU[k * 4 + j];
            LU[k * 4 + j] = LU[piv * 4 + j];
            LU[piv * 4 + j] = t;
          }
          const int t = perm[k];
          perm[k] = perm[piv];
          perm[piv] = t;
        }
        for (int i = k + 1; i < 4; ++i) {
          LU[i * 4 + k] = LU[i * 4 + k] / LU[k * 4 + k];
          for (int j = k + 1; j < 4; ++j)
            LU[i * 4 + j] = LU[i * 4 + j] - LU[i * 4 + k] * LU[k * 4 + j];
        }
      }
      for (int i = 0; i < n; ++i) {
        const float rhs[4] = {X[i * 3], X[i * 3 + 1], X[i * 3 + 2], 1.0f};
        float y[4];
        for (int r = 0; r < 4; ++r) {
          float s = rhs[perm[r]];
          for (int k = 0; k < r; ++k) s = s - LU[r * 4 + k] * y[k];
          y[r] = s;
        }
        for (int r = 3; r >= 0; --r) {
          float s = y[r];
          for (int k = r + 1; k < 4; ++k)
            s = s - LU[r * 4 + k] * alpha[i * 4 + k];
          alpha[i * 4 + r] = s / LU[r * 4 + r];
        }
      }
    }

    // M^T M over the 2n rows [alpha_j * (fx, 0, px - u)] and
    // [alpha_j * (0, fy, py - v)], each times sqrt(w)
    const float fx = K[0], fy = K[4], px = K[2], py = K[5];
    float* A = sh.A12;
    for (int k = 0; k < 144; ++k) A[k] = 0.0f;
    for (int i = 0; i < n; ++i) {
      const float sw = sqrtf(w[i]);
      const float ru[3] = {fx, 0.0f, px - x[i * 2]};
      const float rv[3] = {0.0f, fy, py - x[i * 2 + 1]};
      float mu[12], mv[12];
      for (int j = 0; j < 4; ++j)
        for (int k = 0; k < 3; ++k) {
          mu[j * 3 + k] = alpha[i * 4 + j] * ru[k] * sw;
          mv[j * 3 + k] = alpha[i * 4 + j] * rv[k] * sw;
        }
      for (int a = 0; a < 12; ++a)
        for (int b = a; b < 12; ++b)
          A[a * 12 + b] = A[a * 12 + b] + mu[a] * mu[b] + mv[a] * mv[b];
    }
    for (int a = 0; a < 12; ++a)
      for (int b = 0; b < a; ++b) A[a * 12 + b] = A[b * 12 + a];
    homography_system(X, x, w, wsum, n, pl, sh.A9);
  }
  L.sync();
  jacobi_sweeps<12>(sh.A12, sh.V12, L);
  jacobi_sweeps<9>(sh.A9, sh.V9, L);
  if (L.lane != 0) return;
  float Vn[48];                             // null basis [12][4]
  {
    float lam[12], V4[48];
    sorted_eigenpairs<12, 4>(sh.A12, sh.V12, lam, V4);
    for (int r = 0; r < 12; ++r)
      for (int k = 0; k < 4; ++k) Vn[r * 4 + k] = V4[k * 12 + r];
  }

  // world control-point distances; each basis vector's
  float dist_w[6], target[6], dV[72], b1[4];
  for (int p = 0; p < 6; ++p) {
    const int a = pair_a(p), b = pair_b(p);
    float s = 0.0f;
    for (int c = 0; c < 3; ++c) {
      const float d = ctrl[a * 3 + c] - ctrl[b * 3 + c];
      s = s + d * d;
    }
    dist_w[p] = sqrtf(s + 1e-12f);
    target[p] = dist_w[p] * dist_w[p];
  }
  for (int k = 0; k < 4; ++k) {
    float num = 0.0f, den = 0.0f;
    for (int p = 0; p < 6; ++p) {
      const int a = pair_a(p), b = pair_b(p);
      float s = 0.0f;
      for (int c = 0; c < 3; ++c) {
        const float d = Vn[(a * 3 + c) * 4 + k] - Vn[(b * 3 + c) * 4 + k];
        dV[(k * 6 + p) * 3 + c] = d;
        s = s + d * d;
      }
      const float dv = sqrtf(s + 1e-12f);
      num = num + dv * dist_w[p];
      den = den + dv * dv;
    }
    b1[k] = num / (den + 1e-12f);
  }

  // six candidates: one per beta seed (each null vector alone, and a mixed
  // one), and the homography's; the least weighted reprojection cost wins
  float best_pose[12];
  float best_cost = 0.0f;
  for (int seed = 0; seed < 6; ++seed) {
    float P[12];
    if (seed < 5) {
      float beta[4];
      for (int k = 0; k < 4; ++k)
        beta[k] = seed == 4 ? (k == 0 ? b1[0] : 1e-2f)
                            : (k == seed ? b1[k] : 0.0f);
      betas_gauss_newton(dV, target, beta);
      float cc[12];
      for (int r = 0; r < 12; ++r)
        cc[r] = Vn[r * 4] * beta[0] + Vn[r * 4 + 1] * beta[1]
                + Vn[r * 4 + 2] * beta[2] + Vn[r * 4 + 3] * beta[3];
      // the rigid scale, then cheirality by the weighted mean depth
      float num = 0.0f, den = 0.0f;
      for (int p = 0; p < 6; ++p) {
        const int a = pair_a(p), b = pair_b(p);
        float s = 0.0f;
        for (int c = 0; c < 3; ++c) {
          const float d = cc[a * 3 + c] - cc[b * 3 + c];
          s = s + d * d;
        }
        const float dc = sqrtf(s + 1e-12f);
        num = num + dc * dist_w[p];
        den = den + dc * dc;
      }
      const float scale = num / (den + 1e-12f);
      for (int r = 0; r < 12; ++r) cc[r] = cc[r] * scale;
      float sd = 0.0f;
      for (int i = 0; i < n; ++i)
        sd = sd + (alpha[i * 4] * cc[2] + alpha[i * 4 + 1] * cc[5]
                   + alpha[i * 4 + 2] * cc[8] + alpha[i * 4 + 3] * cc[11])
                  * w[i];
      const float sign = sd < 0.0f ? -1.0f : 1.0f;
      for (int r = 0; r < 12; ++r) cc[r] = cc[r] * sign;
      // Procrustes: world points onto the reconstructed camera points
      float mu_s[3], mu_d[3];
      for (int a = 0; a < 3; ++a) {
        float ss = 0.0f, sd2 = 0.0f;
        for (int i = 0; i < n; ++i) {
          const float pc = alpha[i * 4] * cc[a] + alpha[i * 4 + 1] * cc[3 + a]
                           + alpha[i * 4 + 2] * cc[6 + a]
                           + alpha[i * 4 + 3] * cc[9 + a];
          ss = ss + X[i * 3 + a] * w[i];
          sd2 = sd2 + pc * w[i];
        }
        mu_s[a] = ss / wsum;
        mu_d[a] = sd2 / wsum;
      }
      float Ht[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      for (int i = 0; i < n; ++i) {
        float pc[3];
        for (int a = 0; a < 3; ++a)
          pc[a] = alpha[i * 4] * cc[a] + alpha[i * 4 + 1] * cc[3 + a]
                  + alpha[i * 4 + 2] * cc[6 + a]
                  + alpha[i * 4 + 3] * cc[9 + a];
        // Ht = H^T with H[a][b] = sum (X_a - mu_s_a) w (pc_b - mu_d_b)
        for (int a = 0; a < 3; ++a)
          for (int b = 0; b < 3; ++b)
            Ht[b * 3 + a] = Ht[b * 3 + a]
                            + (X[i * 3 + a] - mu_s[a]) * w[i]
                              * (pc[b] - mu_d[b]);
      }
      float R[9];
      so3_project(Ht, R);
      for (int a = 0; a < 3; ++a) {
        for (int b = 0; b < 3; ++b) P[a * 4 + b] = R[a * 3 + b];
        P[a * 4 + 3] = mu_d[a] - (R[a * 3] * mu_s[0] + R[a * 3 + 1] * mu_s[1]
                                  + R[a * 3 + 2] * mu_s[2]);
      }
    } else {
      float lam9[9], Hn[9];
      sorted_eigenpairs<9, 1>(sh.A9, sh.V9, lam9, Hn);
      homography_pose(pl, Hn, K, P);
    }
    float cost = reprojection_cost(P, X, x, K, w, n);
    if (cost != cost) cost = INFINITY;
    if (seed == 0 || cost < best_cost) {
      best_cost = cost;
      for (int k = 0; k < 12; ++k) best_pose[k] = P[k];
    }
  }
  for (int k = 0; k < 12; ++k) out[k] = best_pose[k];
}

// geometry._rodrigues_coeffs: (theta^2, theta, small, a, b) of
// R = I + a W + b W^2
struct RodCoeffs {
  float theta_sq, theta, a, b;
  bool small;
};

PNP_HD inline RodCoeffs rod_coeffs(const float* w) {
  RodCoeffs k;
  k.theta_sq = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  k.theta = sqrtf(tmax(k.theta_sq, 1e-24f));
  k.small = k.theta_sq < 1e-12f;
  k.a = k.small ? 1.0f - k.theta_sq / 6.0f : sinf(k.theta) / k.theta;
  k.b = k.small ? 0.5f - k.theta_sq / 24.0f
                : (1.0f - cosf(k.theta)) / tmax(k.theta_sq, 1e-24f);
  return k;
}

PNP_HD inline void skew(const float* w, float* W) {
  W[0] = 0.0f;  W[1] = -w[2]; W[2] = w[1];
  W[3] = w[2];  W[4] = 0.0f;  W[5] = -w[0];
  W[6] = -w[1]; W[7] = w[0];  W[8] = 0.0f;
}

// geometry.rodrigues
PNP_HD void rodrigues(const float* w, float* R) {
  const RodCoeffs k = rod_coeffs(w);
  float W[9], W2[9];
  skew(w, W);
  matmul3(W, W, W2);
  for (int i = 0; i < 9; ++i)
    R[i] = ((i % 4 == 0) ? 1.0f : 0.0f) + k.a * W[i] + k.b * W2[i];
}

// geometry.rodrigues and rodrigues_derivative together: R and dR/dw_i
// (dR [3][9])
PNP_HD void rodrigues_with_derivative(const float* w, float* R, float* dR) {
  const RodCoeffs k = rod_coeffs(w);
  float W[9], W2[9];
  skew(w, W);
  matmul3(W, W, W2);
  for (int i = 0; i < 9; ++i)
    R[i] = ((i % 4 == 0) ? 1.0f : 0.0f) + k.a * W[i] + k.b * W2[i];
  const float s = tmax(k.theta_sq, 1e-24f);
  const float sn = sinf(k.theta), cs = cosf(k.theta);
  const float da = k.small ? -1.0f / 6.0f
                           : (k.theta * cs - sn) / (2.0f * k.theta * s);
  const float db = k.small ? -1.0f / 24.0f
                           : sn / (2.0f * k.theta * s) - (1.0f - cs) / (s * s);
  for (int i = 0; i < 3; ++i) {
    float e[3] = {0.0f, 0.0f, 0.0f};
    e[i] = 1.0f;
    float E[9], EW[9], WE[9];
    skew(e, E);
    matmul3(E, W, EW);
    matmul3(W, E, WE);
    const float wi = 2.0f * w[i];
    for (int j = 0; j < 9; ++j)
      dR[i * 9 + j] = k.a * E[j] + k.b * (EW[j] + WE[j])
                      + wi * (da * W[j] + db * W2[j]);
  }
}

// geometry.inverse_rodrigues: Shepperd's quaternion (the best-conditioned
// of four constructions, the first on ties), w >= 0, then angle-axis
PNP_HD void inverse_rodrigues(const float* R, float* aa) {
  const float m00 = R[0], m01 = R[1], m02 = R[2];
  const float m10 = R[3], m11 = R[4], m12 = R[5];
  const float m20 = R[6], m21 = R[7], m22 = R[8];
  const float tr = m00 + m11 + m22;
  const float scores[4] = {tr, m00 - m11 - m22, -m00 + m11 - m22,
                           -m00 - m11 + m22};
  int idx = 0;
  for (int k = 1; k < 4; ++k)
    if (scores[k] > scores[idx]) idx = k;
  float q[4];
  if (idx == 0) {
    const float qw = sqrtf(tmax(1.0f + tr, 1e-12f)) / 2.0f;
    q[0] = qw;
    q[1] = (m21 - m12) / (4.0f * qw);
    q[2] = (m02 - m20) / (4.0f * qw);
    q[3] = (m10 - m01) / (4.0f * qw);
  } else if (idx == 1) {
    const float qx = sqrtf(tmax(1.0f + m00 - m11 - m22, 1e-12f)) / 2.0f;
    q[0] = (m21 - m12) / (4.0f * qx);
    q[1] = qx;
    q[2] = (m01 + m10) / (4.0f * qx);
    q[3] = (m02 + m20) / (4.0f * qx);
  } else if (idx == 2) {
    const float qy = sqrtf(tmax(1.0f - m00 + m11 - m22, 1e-12f)) / 2.0f;
    q[0] = (m02 - m20) / (4.0f * qy);
    q[1] = (m01 + m10) / (4.0f * qy);
    q[2] = qy;
    q[3] = (m12 + m21) / (4.0f * qy);
  } else {
    const float qz = sqrtf(tmax(1.0f - m00 - m11 + m22, 1e-12f)) / 2.0f;
    q[0] = (m10 - m01) / (4.0f * qz);
    q[1] = (m02 + m20) / (4.0f * qz);
    q[2] = (m12 + m21) / (4.0f * qz);
    q[3] = qz;
  }
  const float nq = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2]
                         + q[3] * q[3]);
  for (int k = 0; k < 4; ++k) q[k] = q[k] / nq;
  if (q[0] < 0.0f)
    for (int k = 0; k < 4; ++k) q[k] = q[k] * -1.0f;
  const float qw = tmin(tmax(q[0], -1.0f), 1.0f);
  const float sin_half = sqrtf(q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  const float theta = 2.0f * atan2f(sin_half, qw);
  const float scale = sin_half < 1e-8f ? 2.0f
                                       : theta / tmax(sin_half, 1e-12f);
  for (int k = 0; k < 3; ++k) aa[k] = q[k + 1] * scale;
}

// ops/pnp.py: _residuals' sum of squares at pose6 p (angle-axis, t),
// each lane summing its points
PNP_HD float lm_cost(const float* p, const float* X, const float* x,
                     const float* K, const float* w3, int n,
                     const Lanes& L) {
  float R[9];
  rodrigues(p, R);
  const float fx = K[0], fy = K[4], px = K[2], py = K[5];
  float cost = 0.0f;
  for (int i = L.lane; i < n; i += L.G) {
    float cam[3];
    for (int a = 0; a < 3; ++a)
      cam[a] = X[i * 3] * R[a * 3] + X[i * 3 + 1] * R[a * 3 + 1]
               + X[i * 3 + 2] * R[a * 3 + 2] + p[3 + a];
    const float z = tmax(cam[2], Z_MIN);
    const float dx = fx * cam[0] / z + px - x[i * 2];
    const float dy = fy * cam[1] / z + py - x[i * 2 + 1];
    const float w0 = w3 ? w3[i * 3] : 1.0f, w1 = w3 ? w3[i * 3 + 1] : 0.0f;
    const float w2 = w3 ? w3[i * 3 + 2] : 1.0f;
    const float ru = w0 * dx + w1 * dy, rv = w1 * dx + w2 * dy;
    cost = cost + ru * ru + rv * rv;
  }
  return lane_sum(cost, L);
}

// ops/pnp.py: one start of lm_multi_start_plain: pose0 [3][4] flipped
// (start 0-3) about the centroid of X, then lm_refine. The lanes split the
// points of each sum (the residuals, J^T J, J^T r) and do the rest alike.
// out [3][4]; returns the final cost.
PNP_HD float lm_one(const float* pose0, const float* X, const float* x,
                    const float* K, const float* w3, int n, int start,
                    int iters, const Lanes& L, float* out) {
  const float flips[4][3] = {{1.0f, 1.0f, 1.0f}, {1.0f, -1.0f, -1.0f},
                             {-1.0f, 1.0f, -1.0f}, {-1.0f, -1.0f, 1.0f}};
  float c[3];
  for (int a = 0; a < 3; ++a) {
    float s = 0.0f;
    for (int i = 0; i < n; ++i) s = s + X[i * 3 + a];
    c[a] = s / (float)n;
  }
  float Rs[9], p[6];
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b)
      Rs[a * 3 + b] = pose0[a * 4 + b] * flips[start][b];
  for (int a = 0; a < 3; ++a) {
    const float r0c = pose0[a * 4] * c[0] + pose0[a * 4 + 1] * c[1]
                      + pose0[a * 4 + 2] * c[2];
    const float rsc = Rs[a * 3] * c[0] + Rs[a * 3 + 1] * c[1]
                      + Rs[a * 3 + 2] * c[2];
    p[3 + a] = (pose0[a * 4 + 3] + r0c) - rsc;
  }
  inverse_rodrigues(Rs, p);

  const float fx = K[0], fy = K[4], px = K[2], py = K[5];
  float cost = lm_cost(p, X, x, K, w3, n, L);
  float lam = 1e-3f;
#ifdef __CUDACC__
#pragma unroll 1
#endif
  for (int it = 0; it < iters; ++it) {
    float R[9], dR[27];
    rodrigues_with_derivative(p, R, dR);
    float H[36], g[6];
    for (int k = 0; k < 36; ++k) H[k] = 0.0f;
    for (int k = 0; k < 6; ++k) g[k] = 0.0f;
#ifdef __CUDACC__
#pragma unroll 1
#endif
    for (int i = L.lane; i < n; i += L.G) {
      const float X0 = X[i * 3], X1 = X[i * 3 + 1], X2 = X[i * 3 + 2];
      float cam[3];
      for (int a = 0; a < 3; ++a)
        cam[a] = X0 * R[a * 3] + X1 * R[a * 3 + 1] + X2 * R[a * 3 + 2]
                 + p[3 + a];
      const float zc = cam[2];
      const float z = tmax(zc, Z_MIN);
      const bool active = zc >= Z_MIN;
      const float dx = fx * cam[0] / z + px - x[i * 2];
      const float dy = fy * cam[1] / z + py - x[i * 2 + 1];
      const float w0 = w3 ? w3[i * 3] : 1.0f, w1 = w3 ? w3[i * 3 + 1] : 0.0f;
      const float w2 = w3 ? w3[i * 3 + 2] : 1.0f;
      const float ru = w0 * dx + w1 * dy, rv = w1 * dx + w2 * dy;
      const float zz = z * z;
      float Ju[6], Jv[6];
      for (int j = 0; j < 6; ++j) {
        float dc[3];
        if (j < 3) {
          for (int a = 0; a < 3; ++a)
            dc[a] = X0 * dR[j * 9 + a * 3] + X1 * dR[j * 9 + a * 3 + 1]
                    + X2 * dR[j * 9 + a * 3 + 2];
        } else {
          for (int a = 0; a < 3; ++a) dc[a] = a == j - 3 ? 1.0f : 0.0f;
        }
        const float dz = active ? dc[2] : 0.0f;
        const float dpx = fx * (dc[0] / z - cam[0] * dz / zz);
        const float dpy = fy * (dc[1] / z - cam[1] * dz / zz);
        Ju[j] = w0 * dpx + w1 * dpy;
        Jv[j] = w1 * dpx + w2 * dpy;
      }
      for (int a = 0; a < 6; ++a) {
        for (int b = a; b < 6; ++b)
          H[a * 6 + b] = H[a * 6 + b] + Ju[a] * Ju[b] + Jv[a] * Jv[b];
        g[a] = g[a] + Ju[a] * ru + Jv[a] * rv;
      }
    }
    for (int a = 0; a < 6; ++a) {
      for (int b = a; b < 6; ++b) H[a * 6 + b] = lane_sum(H[a * 6 + b], L);
      g[a] = lane_sum(g[a], L);
    }
    for (int a = 0; a < 6; ++a) {
      for (int b = 0; b < a; ++b) H[a * 6 + b] = H[b * 6 + a];
      const float dH = tmax(H[a * 6 + a], 1e-9f);
      H[a * 6 + a] = H[a * 6 + a] + lam * dH + 1e-12f;
    }
    float step[6], p_new[6];
    solve_spd<6>(H, g, step, 1e-10f);
    for (int k = 0; k < 6; ++k) p_new[k] = p[k] - step[k];
    const float cost_new = lm_cost(p_new, X, x, K, w3, n, L);
    const bool accept = cost_new < cost;
    if (accept) {
      for (int k = 0; k < 6; ++k) p[k] = p_new[k];
      cost = cost_new;
    }
    lam = tmin(tmax(accept ? lam * 0.33f : lam * 3.0f, 1e-10f), 1e8f);
  }
  float R[9];
  rodrigues(p, R);
  for (int a = 0; a < 3; ++a) {
    for (int b = 0; b < 3; ++b) out[a * 4 + b] = R[a * 3 + b];
    out[a * 4 + 3] = p[3 + a];
  }
  return cost;
}

// torch.argmin's order over (cost, start): NaN first, then the least,
// ties to the lower start
PNP_HD inline bool precedes(float c1, int i1, float c2, int i2) {
  const bool n1 = c1 != c1, n2 = c2 != c2;
  if (n1 != n2) return n1;
  if (n1) return i1 < i2;
  return c1 < c2 || (c1 == c2 && i1 < i2);
}

}  // namespace pnp

#ifdef __CUDACC__

namespace {

constexpr int EPNP_LANES = 16;  // lanes a problem (a half warp)
constexpr int EPNP_BLOCK = 64;  // 4 problems a block
constexpr int LM_LANES = 8;     // lanes a start: 4 starts a warp
constexpr int LM_BLOCK = 64;    // 2 problems a block

__global__ void __launch_bounds__(EPNP_BLOCK)
pnp_epnp_kernel(const float* __restrict__ pts3d, int s3,
                const float* __restrict__ pts2d,
                const float* __restrict__ K, int sK,
                const float* __restrict__ weights, float* __restrict__ out,
                int N, int n) {
  __shared__ pnp::EpnpShared sh[EPNP_BLOCK / EPNP_LANES];
  const int slot = threadIdx.x / EPNP_LANES;
  const int t = blockIdx.x * (EPNP_BLOCK / EPNP_LANES) + slot;
  // lanes past the batch solve the last problem again and write nothing,
  // so that every lane of a warp takes part in its synchronizations
  const int i = min(t, N - 1);
  const pnp::Lanes L{(int)threadIdx.x % EPNP_LANES, EPNP_LANES};
  float pose[12];
  pnp::epnp_one(pts3d + (size_t)i * s3, pts2d + (size_t)i * n * 2,
                K + (size_t)i * sK,
                weights ? weights + (size_t)i * n : nullptr, n, sh[slot], L,
                pose);
  if (t < N && L.lane == 0)
    for (int k = 0; k < 12; ++k) out[(size_t)i * 12 + k] = pose[k];
}

__global__ void __launch_bounds__(LM_BLOCK)
pnp_lm_kernel(const float* __restrict__ pose0,
              const float* __restrict__ pts3d, int s3,
              const float* __restrict__ pts2d,
              const float* __restrict__ K, int sK,
              const float* __restrict__ w3, float* __restrict__ out,
              int N, int n, int iters) {
  // a warp per problem: LM_LANES lanes per start, its 4 starts side by side
  const int t = blockIdx.x * (LM_BLOCK / 32) + threadIdx.x / 32;
  const int start = (threadIdx.x % 32) / LM_LANES;
  const pnp::Lanes L{(int)threadIdx.x % LM_LANES, LM_LANES};
  // warps past the batch solve the last problem again and write nothing
  const int i = min(t, N - 1);
  float pose[12];
  const float cost = pnp::lm_one(
      pose0 + (size_t)i * 12, pts3d + (size_t)i * s3,
      pts2d + (size_t)i * n * 2, K + (size_t)i * sK,
      w3 ? w3 + (size_t)i * n * 3 : nullptr, n, start, iters, L, pose);
  // the winner of the problem's 4 starts
  float bc = cost;
  int bi = start;
#pragma unroll
  for (int m = LM_LANES; m < 32; m <<= 1) {
    const float oc = __shfl_xor_sync(0xffffffffu, bc, m);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, m);
    if (pnp::precedes(oc, oi, bc, bi)) {
      bc = oc;
      bi = oi;
    }
  }
  if (t < N && bi == start && L.lane == 0)
    for (int k = 0; k < 12; ++k) out[(size_t)i * 12 + k] = pose[k];
}

}  // namespace

// pts3d [N, n, 3] with batch stride s3 floats (0: one set for the batch),
// pts2d [N, n, 2] contiguous, K [3, 3] with batch stride sK (0 or 9),
// weights [N, n] contiguous or null (ones); out [N, 3, 4].
extern "C" int pvnet_pnp_epnp(const float* pts3d, int s3, const float* pts2d,
                              const float* K, int sK, const float* weights,
                              float* out, int N, int n, cudaStream_t stream) {
  if (N <= 0) return (int)cudaSuccess;
  if (n < 1 || n > pnp::NMAX) return (int)cudaErrorInvalidValue;
  constexpr int per_block = EPNP_BLOCK / EPNP_LANES;
  pnp_epnp_kernel<<<(N + per_block - 1) / per_block, EPNP_BLOCK, 0,
                    stream>>>(pts3d, s3, pts2d, K, sK, weights, out, N, n);
  return (int)cudaGetLastError();
}

// pose0 [N, 3, 4] contiguous, the points and K as pvnet_pnp_epnp, w3
// [N, n, 3] contiguous (wxx, wxy, wyy) or null (identity); out [N, 3, 4].
extern "C" int pvnet_pnp_lm(const float* pose0, const float* pts3d, int s3,
                            const float* pts2d, const float* K, int sK,
                            const float* w3, float* out, int N, int n,
                            int iters, cudaStream_t stream) {
  if (N <= 0) return (int)cudaSuccess;
  if (n < 1 || n > pnp::NMAX || iters < 0)
    return (int)cudaErrorInvalidValue;
  constexpr int per_block = LM_BLOCK / 32;
  pnp_lm_kernel<<<(N + per_block - 1) / per_block, LM_BLOCK, 0, stream>>>(
      pose0, pts3d, s3, pts2d, K, sK, w3, out, N, n, iters);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
