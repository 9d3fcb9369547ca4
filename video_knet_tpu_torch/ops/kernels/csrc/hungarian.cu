// Hungarian (linear sum assignment) for the train step's mask matching, on
// the device, every problem of a step in one launch.
//
// Replaces video_knet_tpu/ops/hungarian.py:hungarian (the reference runs it as
// lax.while_loops on the device, vmapped over all problems of a step; there is
// no Pallas kernel). Algorithm: Jonker-Volgenant shortest augmenting path on an
// [r, c] cost, r <= c, one row added per round, the same steps in the same
// fp32 order as the reference:
//   cur = (cost[i0, j] - u[i0]) - v[j] over unused columns, minv/way update,
//   j1 = argmin(used ? INF : minv) with ties to the lower index,
//   u[p[j]] += delta and v[j] -= delta over used columns (the virtual column c
//   included), minv[j] -= delta over unused ones, then the augment along way.
// Invalid GT rows are all-zero cost rows, so ties are the normal case; the
// first-minimum argmin keeps them identical to jnp.argmin's choice.
//
// Layout: one warp (one block of 32 threads) per problem. The cost matrix, u,
// v, p, minv, way and used live in shared memory; the lanes stride over the
// columns and the argmin is a shuffle reduction on (value, index). The
// augmenting path is walked by lane 0.
//
// What bounds it: neither bytes nor operations. The work is a chain of
// dependent rounds (r rows x up to r rounds, each a c-wide pass and a
// five-step shuffle reduction), so its time is latency: ~r^2 rounds of a few
// hundred cycles. The problems of a step (10 at batch 1) run in parallel on
// separate SMs. Speed is not this kernel's aim; a multi-warp or
// auction-style solve is later work.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr float kInf = 1e9f;  // the reference's _INF

__global__ void __launch_bounds__(32)
hungarian_kernel(const float* __restrict__ cost_all, int* __restrict__ col_of_row_all, int r,
                 int c) {
    extern __shared__ __align__(16) unsigned char smem[];
    float* cost = reinterpret_cast<float*>(smem);   // [r * c]
    float* u = cost + (size_t)r * c;                  // [r]
    float* v = u + r;                                 // [c + 1]
    float* minv = v + (c + 1);                        // [c]
    int* p = reinterpret_cast<int*>(minv + c);        // [c + 1]
    int* way = p + (c + 1);                           // [c]
    unsigned char* used = reinterpret_cast<unsigned char*>(way + c);  // [c + 1]

    const int lane = threadIdx.x;
    const float* src = cost_all + (size_t)blockIdx.x * r * c;
    for (int k = lane; k < r * c; k += 32) cost[k] = src[k];
    for (int k = lane; k < r; k += 32) u[k] = 0.f;
    for (int k = lane; k <= c; k += 32) {
        v[k] = 0.f;
        p[k] = -1;
    }
    __syncwarp();

    for (int i = 0; i < r; ++i) {
        for (int j = lane; j < c; j += 32) {
            minv[j] = kInf;
            way[j] = c;
        }
        for (int j = lane; j <= c; j += 32) used[j] = 0;
        if (lane == 0) p[c] = i;
        __syncwarp();
        int j0 = c;
        for (int round = 0; round <= c && p[j0] != -1; ++round) {
            __syncwarp();
            if (lane == 0) used[j0] = 1;
            __syncwarp();
            const int i0 = p[j0];
            const float ui0 = u[i0];
            const float* row = cost + (size_t)i0 * c;
            float best = INFINITY;
            int best_j = 0x7fffffff;
            for (int j = lane; j < c; j += 32) {
                float m = kInf;
                if (!used[j]) {
                    const float cur = __fsub_rn(__fsub_rn(row[j], ui0), v[j]);
                    if (cur < minv[j]) {
                        minv[j] = cur;
                        way[j] = j0;
                    }
                    m = minv[j];
                }
                if (m < best) {  // j rises within a lane: the first minimum stays
                    best = m;
                    best_j = j;
                }
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
                const float ob = __shfl_xor_sync(0xffffffffu, best, off);
                const int oj = __shfl_xor_sync(0xffffffffu, best_j, off);
                if (ob < best || (ob == best && oj < best_j)) {
                    best = ob;
                    best_j = oj;
                }
            }
            const float delta = best;
            __syncwarp();
            for (int j = lane; j <= c; j += 32) {
                if (used[j]) {
                    u[p[j]] = __fadd_rn(u[p[j]], delta);  // one used column per row
                    v[j] = __fsub_rn(v[j], delta);
                } else if (j < c) {
                    minv[j] = __fsub_rn(minv[j], delta);
                }
            }
            __syncwarp();
            j0 = best_j;
        }
        if (lane == 0) {
            for (int step = 0; step <= c && j0 != c; ++step) {
                const int j1 = way[j0];
                p[j0] = p[j1];
                j0 = j1;
            }
        }
        __syncwarp();
    }
    int* out = col_of_row_all + (size_t)blockIdx.x * r;
    for (int j = lane; j < c; j += 32)
        if (p[j] >= 0) out[p[j]] = j;
}

size_t hungarian_smem(int r, int c) {
    return sizeof(float) * ((size_t)r * c + r + (c + 1) + c) + sizeof(int) * ((c + 1) + c) +
           (c + 1);
}

}  // namespace

extern "C" {

// cost [L, r, c] fp32 (r <= c) -> col_of_row [L, r] int32, on the caller's
// stream; returns a CUDA error code (0 on success)
int vk_hungarian(const float* cost, int* col_of_row, int L, int r, int c, void* stream) {
    if (L <= 0 || r <= 0 || r > c) return (int)cudaErrorInvalidValue;
    const size_t smem = hungarian_smem(r, c);
    cudaError_t err = cudaFuncSetAttribute(
        hungarian_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    // every row is matched, so every output is written: no clearing pass
    hungarian_kernel<<<L, 32, smem, st>>>(cost, col_of_row, r, c);
    return (int)cudaGetLastError();
}

}  // extern "C"
