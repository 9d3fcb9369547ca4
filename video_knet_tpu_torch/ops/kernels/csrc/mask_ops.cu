// Hand-written Hopper (sm_90a) kernels for the two K-Net mask contractions.
// Plain C interface, loaded with ctypes by ops/kernels/build.py. fp32 in,
// fp32 accumulate, fp32 out. Every launch goes on the caller's stream; no
// allocation and no synchronisation here. Each entry point returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
//
// ---------------------------------------------------------------------------
// K1  vk_mask_pool
//   Replaces video_knet_tpu/ops/pallas/mask_ops.py:fused_mask_pool
//   (_mask_pool_kernel / _fused_mask_pool_2d).
//   out[b,n,c] = sum_hw [sigmoid(logit[b,n,hw]) > thr] * feat[b,hw,c]
//
//   Bound on an H100 SXM at the serving shape (N=117, HW=48*156=7488, C=256):
//   the logits (3.5 MB) and features (7.7 MB) are read once, the output
//   (0.12 MB) written once: ~11.3 MB, 3.4 us at 3.35 TB/s. The dense product
//   is 2*N*HW*C = 0.45 GFLOP, 6.7 us at the 67 TFLOP/s fp32 (non-tensor)
//   rate; only the set mask entries add anything, so with about half the
//   mask set the useful work is near the byte bound.
//
//   Design: the [N, C] output is tiny (one 128x256 tile per image), so the
//   reduction axis HW is split across blocks to fill the 132 SMs. Each block
//   owns a [128 x 64] (N x C) tile and one HW chunk; it binarizes a
//   [128 x 32] logit tile into shared memory with the full-precision
//   1/(1+expf(-x)) > thr (no __expf, no fast-math), stages the [32 x 64]
//   feature tile beside it, and accumulates with fp32 FMAs against 0/1
//   (exact adds). Partial sums go to a [splits, B, N, C] scratch buffer and a
//   second kernel adds them in split order: no float atomics, so results are
//   bit-identical run to run. Ragged N / HW / C edges are masked in the
//   kernel. Later work: bf16/tf32 wgmma on the 0/1 operand, TMA staging.
//
// ---------------------------------------------------------------------------
// K2  vk_assemble
//   Replaces video_knet_tpu/ops/pallas/mask_ops.py:fused_assemble_sigmoid
//   (_assemble_kernel / _fused_assemble_2d).
//   out[b,n,hw] = kern[b,n,:] . feat[b,hw,:]   (then sigmoid if asked)
//
//   Bound on an H100 SXM at the serving shape: features 7.7 MB + kernels
//   0.12 MB read, logits 3.5 MB written: ~11.3 MB, 3.4 us at 3.35 TB/s; the
//   product is 2*N*HW*C = 0.45 GFLOP, 6.7 us at 67 TFLOP/s fp32. It is bound
//   by fp32 operations.
//
//   Design: a plain tiled SGEMM, C-major operands ([N,C] x [HW,C]^T): 64x64
//   output tiles (234 blocks at the serving shape, ~2 per SM), K-steps of 16
//   channels staged transposed in shared memory, 4x4 outputs per thread with
//   rows/cols strided by 16 so shared reads are conflict-free and global
//   stores coalesce along HW. The sigmoid epilogue is a runtime flag; the
//   serving path runs with it off (decode upsamples the logits before the
//   sigmoid). Later work: TF32/3xTF32 wgmma with TMA-fed stages.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MP_BN = 128;  // N rows per block
constexpr int MP_BC = 64;   // C cols per block
constexpr int MP_BK = 32;   // HW per shared-memory step
constexpr int MP_THREADS = 256;

__global__ void __launch_bounds__(MP_THREADS)
mask_pool_partial_kernel(const float* __restrict__ logits,  // [B, N, HW]
                         const float* __restrict__ feats,   // [B, HW, C]
                         float* __restrict__ partial,       // [S, B, N, C]
                         int B, int N, int HW, int C, float thr, int chunk) {
    // +1 pad: the binarize stores walk HW, which would hit one bank
    __shared__ float sm_mask[MP_BK][MP_BN + 1];
    __shared__ __align__(16) float sm_feat[MP_BK][MP_BC];

    const int tid = threadIdx.x;
    const int tx = tid % 16;  // 4 contiguous channels each
    const int ty = tid / 16;  // rows ty + 16 * i
    const int c0 = blockIdx.x * MP_BC;
    const int split = blockIdx.y;
    const int n_tiles = (N + MP_BN - 1) / MP_BN;
    const int b = blockIdx.z / n_tiles;
    const int n0 = (blockIdx.z % n_tiles) * MP_BN;
    const int k_begin = split * chunk;
    const int k_end = min(k_begin + chunk, HW);

    const float* lg = logits + (size_t)b * N * HW;
    const float* ft = feats + (size_t)b * HW * C;

    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = k_begin; k0 < k_end; k0 += MP_BK) {
        // binarized logit tile: 128 x 32, consecutive threads along HW
#pragma unroll
        for (int e = 0; e < (MP_BN * MP_BK) / MP_THREADS; ++e) {
            const int idx = e * MP_THREADS + tid;
            const int r = idx / MP_BK;
            const int kk = idx % MP_BK;
            const int n = n0 + r;
            const int k = k0 + kk;
            float m = 0.f;
            if (n < N && k < k_end) {
                const float x = lg[(size_t)n * HW + k];
                m = (1.f / (1.f + expf(-x)) > thr) ? 1.f : 0.f;
            }
            sm_mask[kk][r] = m;
        }
        // feature tile: 32 x 64, consecutive threads along C
#pragma unroll
        for (int e = 0; e < (MP_BK * MP_BC) / MP_THREADS; ++e) {
            const int idx = e * MP_THREADS + tid;
            const int kk = idx / MP_BC;
            const int cc = idx % MP_BC;
            const int k = k0 + kk;
            const int c = c0 + cc;
            sm_feat[kk][cc] = (k < k_end && c < C) ? ft[(size_t)k * C + c] : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < MP_BK; ++kk) {
            const float4 f = *reinterpret_cast<const float4*>(&sm_feat[kk][tx * 4]);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const float m = sm_mask[kk][ty + 16 * i];
                acc[i][0] = fmaf(m, f.x, acc[i][0]);
                acc[i][1] = fmaf(m, f.y, acc[i][1]);
                acc[i][2] = fmaf(m, f.z, acc[i][2]);
                acc[i][3] = fmaf(m, f.w, acc[i][3]);
            }
        }
        __syncthreads();
    }

    float* out = partial + ((size_t)split * B + b) * N * C;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int n = n0 + ty + 16 * i;
        if (n >= N) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int c = c0 + tx * 4 + j;
            if (c < C) out[(size_t)n * C + c] = acc[i][j];
        }
    }
}

// out[i] = sum_s partial[s, i] in split order: deterministic, no atomics
__global__ void mask_pool_reduce_kernel(const float* __restrict__ partial,
                                        float* __restrict__ out, size_t count,
                                        int splits) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= count) return;
    float s = 0.f;
    for (int p = 0; p < splits; ++p) s += partial[(size_t)p * count + i];
    out[i] = s;
}

constexpr int AS_BM = 64;  // N rows per block
constexpr int AS_BN = 64;  // HW cols per block
constexpr int AS_BK = 16;  // channels per shared-memory step
constexpr int AS_THREADS = 256;

__global__ void __launch_bounds__(AS_THREADS)
assemble_kernel(const float* __restrict__ kern,   // [B, N, C]
                const float* __restrict__ feats,  // [B, HW, C]
                float* __restrict__ out,          // [B, N, HW]
                int N, int HW, int C, int apply_sigmoid) {
    // transposed stages (channel-major); +1 pad breaks store bank conflicts
    __shared__ float sm_a[AS_BK][AS_BM + 1];
    __shared__ float sm_b[AS_BK][AS_BN + 1];

    const int tid = threadIdx.x;
    const int tx = tid % 16;  // cols tx + 16 * j
    const int ty = tid / 16;  // rows ty + 16 * i
    const int hw0 = blockIdx.x * AS_BN;
    const int n0 = blockIdx.y * AS_BM;
    const int b = blockIdx.z;

    const float* kb = kern + (size_t)b * N * C;
    const float* fb = feats + (size_t)b * HW * C;

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    // each thread stages 4 channels of one row of each operand tile
    const int lr = tid / 4;        // tile row 0..63
    const int lk = (tid % 4) * 4;  // first channel of the 4

    for (int k0 = 0; k0 < C; k0 += AS_BK) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int c = k0 + lk + e;
            const int n = n0 + lr;
            const int p = hw0 + lr;
            sm_a[lk + e][lr] = (n < N && c < C) ? kb[(size_t)n * C + c] : 0.f;
            sm_b[lk + e][lr] = (p < HW && c < C) ? fb[(size_t)p * C + c] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < AS_BK; ++kk) {
            float a[4], v[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = sm_a[kk][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) v[j] = sm_b[kk][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], v[j], acc[i][j]);
        }
        __syncthreads();
    }

    float* ob = out + (size_t)b * N * HW;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int n = n0 + ty + 16 * i;
        if (n >= N) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int p = hw0 + tx + 16 * j;
            if (p >= HW) continue;
            float v = acc[i][j];
            if (apply_sigmoid) v = 1.f / (1.f + expf(-v));
            ob[(size_t)n * HW + p] = v;
        }
    }
}

}  // namespace

extern "C" {

int vk_mask_pool_block_cols() { return MP_BC; }
int vk_mask_pool_block_rows() { return MP_BN; }
int vk_mask_pool_block_hw() { return MP_BK; }

// partial: [splits, B, N, C] scratch (may alias out when splits == 1)
int vk_mask_pool(const float* logits, const float* feats, float* partial, float* out,
                 int B, int N, int HW, int C, float thr, int splits, int chunk,
                 void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int n_tiles = (N + MP_BN - 1) / MP_BN;
    dim3 grid((C + MP_BC - 1) / MP_BC, splits, B * n_tiles);
    mask_pool_partial_kernel<<<grid, MP_THREADS, 0, st>>>(
        logits, feats, splits == 1 ? out : partial, B, N, HW, C, thr, chunk);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1) return (int)err;
    const size_t count = (size_t)B * N * C;
    const int threads = 256;
    mask_pool_reduce_kernel<<<(unsigned)((count + threads - 1) / threads), threads, 0, st>>>(
        partial, out, count, splits);
    return (int)cudaGetLastError();
}

int vk_assemble(const float* kern, const float* feats, float* out, int B, int N, int HW,
                int C, int apply_sigmoid, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    dim3 grid((HW + AS_BN - 1) / AS_BN, (N + AS_BM - 1) / AS_BM, B);
    assemble_kernel<<<grid, AS_THREADS, 0, st>>>(kern, feats, out, N, HW, C, apply_sigmoid);
    return (int)cudaGetLastError();
}

}  // extern "C"
