// Hand-written Hopper (sm_90a) kernels for the two K-Net mask contractions.
// Plain C interface, loaded with ctypes by ops/kernels/build.py. fp32 in,
// fp32 accumulate, fp32 out. Every launch goes on the caller's stream; no
// allocation and no synchronisation here. Each entry point returns the CUDA
// error of its launches so the wrapper can raise on a refused launch.
//
// ---------------------------------------------------------------------------
// K1  vk_mask_pool
//   Replaces video_knet_tpu/ops/pallas/mask_ops.py:fused_mask_pool
//   (_mask_pool_kernel / _fused_mask_pool_2d).
//   out[b,n,c] = sum_hw [sigmoid(logit[b,n,hw]) > thr] * feat[b,hw,c]
//
//   Bound on an H100 SXM at the serving shape (N=117, HW=48*156=7488, C=256):
//   the logits (3.5 MB) and features (7.7 MB) are read once, the output
//   (0.12 MB) written once: ~11.3 MB, 3.4 us at 3.35 TB/s. It is bound by
//   bytes. The tensor-core work below is 3 planes x 2*128*7488*256 = 1.5
//   GFLOP: 1.5 us at the 989 TFLOP/s bf16 peak, half the byte bound; these
//   small (m64n64k16) wgmmas run below that peak.
//
//   Arithmetic: the 0/1 mask is exact in bf16, and each fp32 feature splits
//   exactly into three bf16 planes, hi = bf16(x), mid = bf16(x - hi),
//   lo = bf16(x - hi - mid) (3 x 8 significand bits cover fp32's 24; bf16
//   has fp32's exponent range). So bf16 wgmma products into fp32 are exact,
//   and only the order of the fp32 sums differs from the plain version (the
//   TPU kernel's jnp.dot(hard, feat, f32) counterpart). The tensor cores'
//   fp32 accumulation may truncate, so each slab's six wgmmas (2 k16 steps x
//   3 planes) go into a zeroed fragment that is then added to the running
//   sum with rounded fp32 adds.
//
//   Three launches, chained by programmatic dependent launch (each starts
//   while the one before runs and waits for it with griddepcontrol.wait):
//   1. binarize: the reference's 1/(1+expf(-x)) > thr (full-precision expf
//      and division, no fast math; it decides the tie at a logit of 0),
//      evaluated only for logits within 1e-3 of logit(thr): outside that
//      band the outcome is already fixed (for thr in [0.01, 0.99] the band's
//      edge moves the sigmoid by >= 9.9e-6, far above expf's 2-ulp error).
//      A warp packs 32 decisions with __ballot_sync into one mask word, so
//      each logit is read and binarized once (3.5 MB in, 0.12 MB of words
//      out), not once by each of the 4 C-tile blocks that share it.
//   2. partial: the [N, C] output is one 128 x 256 tile per image, so HW is
//      split across ~one wave of blocks (4 C-tiles of 64 x 30 HW splits at
//      the serving shape). Each block of 512 threads is warp-specialized:
//      two producer warpgroups keep a 4-stage cp.async ring of [32 x 64]
//      fp32 feature slabs (16-byte copies where rows are aligned, 4-byte
//      zero-filling copies on ragged edges) and their mask words in flight
//      and split each slab into the three planes (64-byte swizzled, K-major);
//      two consumer warpgroups build the A fragments in registers from the
//      mask words and issue m64n64k16 wgmmas on the planes. Named barriers
//      hand two plane buffers back and forth, so the split of slab s+1 runs
//      while the tensor cores work on slab s.
//   3. reduce: adds the 30 partials in split order: no float atomics, so
//      results are bit-identical run to run.
//   C-tile width against the partial sums: C-tiles of 64 give 30 x 117 x
//   256 x 4 B = 3.6 MB of partials (L2-resident); full-width tiles would
//   need ~132 splits and ~16 MB of partials, more than the inputs.
//
// ---------------------------------------------------------------------------
// K2  vk_assemble
//   Replaces video_knet_tpu/ops/pallas/mask_ops.py:fused_assemble_sigmoid
//   (_assemble_kernel / _fused_assemble_2d).
//   out[b,n,hw] = kern[b,n,:] . feat[b,hw,:]   (then sigmoid if asked)
//
//   Bound on an H100 SXM at the serving shape (N=117, HW=7488, C=256):
//   features 7.7 MB + kernels 0.12 MB read, logits 3.5 MB written: ~11.3 MB,
//   3.4 us at 3.35 TB/s. The product is 2*N*HW*C = 0.45 GFLOP; fp32-accurate
//   on the tensor cores as three TF32 products (below) it is 1.35 GFLOP,
//   2.7 us at the 495 TFLOP/s TF32 peak. So it is bound by bytes (the fp32
//   CUDA-core rate, 6.7 us, is not the least time the card needs for it).
//
//   Arithmetic (3xTF32): both operands are arbitrary fp32, so each is split
//   as big = tf32_rna(x), small = tf32_rna(x - big) (cvt.rna.tf32.f32's
//   rounding; the low 13 bits of both are zero, so the tensor cores see them
//   exactly) and the product is big_a*big_b + big_a*small_b + small_a*big_b
//   into fp32.
//   The dropped small*small term and the rounding of small leave ~2^-21 of
//   each |a*b|, the size of an fp32 SGEMM's own summation error at C=256. A
//   single TF32 pass (~2^-11) would flip the sign of logits near 0, which
//   K1 thresholds at the next stage.
//
//   Design: one block per [128 (N) x 64 (HW)] output tile: at the serving
//   shape ceil(7488/64) = 117 HW tiles x 1 N tile (N padded 117 -> 128), one
//   wave on 132 SMs. C runs inside the block in slabs of 32 channels (128
//   bytes of fp32 a row, one 128-byte swizzle span), 8 slabs at C=256, in a
//   fixed order: no split-K, so repeats are bit-identical with no reduce.
//   416 threads, warp-specialized, over a 4-stage shared-memory ring:
//     loader (warp 12): one thread starts two TMA loads a slab, the [128 x
//       32] kernel slab and the [64 x 32] feature slab, onto the stage's
//       mbarrier; TMA zero-fills rows past N or HW and channels past C. A
//       stage is reloaded once the consumers mark it free.
//     splitters (warpgroup 2): once a slab lands, split its features in
//       place into the big plane plus a small plane beside it (4 float4 a
//       thread, its loads in flight together), then mark the stage split.
//     consumers (warpgroups 0, 1: rows 0-63, 64-127) read their A fragments
//       of the kernel slab into registers, split them there, and run 4 k8
//       steps x 3 m64n64k8 TF32 wgmmas (A from registers, B = the feature
//       planes); big*big goes into one accumulator, the two small terms
//       into another (summed apart, they keep their bits through the tensor
//       cores' accumulation: half the error of one accumulator).
//   Stage: 16 KB kernels + 8 KB big + 8 KB small plane, 128 KB for 4. All
//   operand tiles are K-major with the 128-byte swizzle of TMA and wgmma
//   (chunk j of row r at chunk j ^ (r & 7)): conflict-free split and
//   fragment reads. TMA needs 16-byte rows, so C % 4 == 0 and aligned
//   operands; the wrapper pads other shapes with zero channels.
//   Epilogue: the optional sigmoid 1/(1+expf(-v)) (a runtime flag; the
//   serving path runs with it off, decode upsamples the logits first), float2
//   stores along HW.
//   What limits it (PERF.md): a chain inside each block, not L2 or HBM (one
//   block alone takes 92% of the time of 117). Each slab costs ~0.7 us:
//   ~0.42 us of wgmmas at the TF32 peak, then ~0.3 us in which the consumers
//   load and split the next A fragments; ~3.8 us more is fixed (launch,
//   first TMA round trip, epilogue).
// ---------------------------------------------------------------------------

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MP_BN = 128;       // N rows per block
constexpr int MP_BC = 64;        // C cols per block
constexpr int MP_BK = 32;        // HW per ring stage: one mask word, two k16 steps
constexpr int MP_STAGES = 4;     // fp32 ring stages
constexpr int MP_CONSUMERS = 256;  // 2 warpgroups: wgmma, 64 rows x 64 cols each
constexpr int MP_PRODUCERS = 256;  // 2 warpgroups: copies and the split into planes
constexpr int MP_THREADS = MP_CONSUMERS + MP_PRODUCERS;
constexpr int MP_FT_LD = MP_BC + 4;  // fp32 feature row stride (68: conflict-free split reads)
constexpr int MP_FT_STAGE = MP_BK * MP_FT_LD;  // floats
constexpr int MP_PLANE = MP_BC * MP_BK;        // bf16, one plane of one slab
constexpr int MP_PL_TILE = 3 * MP_PLANE;       // bf16, hi / mid / lo planes
// ring (fp32 features + mask words), then 2 buffers of planes + mask words
constexpr int MP_SMEM =
    MP_STAGES * (MP_FT_STAGE * 4 + MP_BN * 4) + 2 * (MP_PL_TILE * 2 + MP_BN * 4);
// named barriers (0 is __syncthreads): producers only; buffer p full / empty
constexpr int MP_BAR_PROD = 1, MP_BAR_FULL = 2, MP_BAR_EMPTY = 4;
constexpr int BZ_THREADS = 256;
constexpr int BZ_ROWS = 4;  // mask rows a warp of the binarize kernel takes

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// 4-byte copy; zero-fills the destination when !ok (src is then not read)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(ok ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// One [64 (C) x 32 (HW)] bf16 plane of a slab, K-major with wgmma's 64-byte
// swizzle: row c holds its 32 HW values in 64 bytes, its 16-byte chunk j
// sits at chunk j ^ ((c >> 1) & 3) (conflict-free stores from the split and
// reads by the tensor cores), and groups of 8 rows are 512 bytes apart in
// the N direction. The descriptor of k16 step ks starts 32 ks bytes into the
// rows.
__device__ __forceinline__ uint64_t wgmma_desc(const uint16_t* plane, int ks) {
    const uint64_t a = static_cast<uint64_t>(__cvta_generic_to_shared(plane)) + ks * 32;
    return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (static_cast<uint64_t>(512 >> 4) << 32) |
           (2ull << 62);
}

__device__ __forceinline__ int plane_word(int c, int k) {  // 4-byte word of (c, k..k+1)
    return c * 16 + (((k / 8) ^ ((c >> 1) & 3)) * 4) + (k % 8) / 2;
}

// d (+)= a * b for one warpgroup: m64n64k16, A (the mask) from registers,
// B (a feature plane) from shared memory, bf16 in, fp32 accumulate.
// scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
        "{%32,%33,%34,%35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// keeps the compiler from touching d while a wgmma that writes it is in flight
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void bar_sync(int id, int count) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
    asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
    return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) -> bf16x2 planes hi, mid, lo with hi + mid + lo == x exactly
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float r0 = x0 - __low2float(h), r1 = x1 - __high2float(h);
    const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
    const __nv_bfloat162 l = __floats2bfloat162_rn(r0 - __low2float(m), r1 - __high2float(m));
    hi = bf16x2_bits(h);
    mid = bf16x2_bits(m);
    lo = bf16x2_bits(l);
}

// bits 0 and 1 of w >> s as a bf16x2 of 0 / 1: one register of an A fragment
__device__ __forceinline__ uint32_t mask_pair(uint32_t w, int s) {
    const uint32_t b = w >> s;
    return ((b & 1u) ? 0x3F80u : 0u) | ((b & 2u) ? 0x3F800000u : 0u);
}

// The reference's decision, for the rare logits in the band where the fast
// comparison does not already fix it. Out of line: the common path stays one
// comparison and the band test.
__device__ __noinline__ bool binarize_exact(float x, float thr) {
    return 1.f / (1.f + expf(-x)) > thr;
}

// logits [B, N, HW] -> mask words [B, ceil(HW/32), n_pad]: bit l of word
// (b, w, n) is [sigmoid(logit[b, n, 32 w + l]) > thr]; rows n >= N and
// positions past HW are 0. A warp takes BZ_ROWS rows n of one word w: lane
// l reads logit 32 w + l of each (128 coalesced bytes a row) and
// __ballot_sync packs the 32 decisions. Grid: (n_pad / rows a block, words, B).
__global__ void __launch_bounds__(BZ_THREADS)
mask_pool_binarize_kernel(const float* __restrict__ logits, uint32_t* __restrict__ bits,
                          int N, int HW, int n_pad, float thr, float band_mid,
                          float band_half) {
    // let the partial kernel launch now: it loads features until it needs the mask
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    const int lane = threadIdx.x % 32;
    const int w = blockIdx.y, b = blockIdx.z;
    const int n_first = (blockIdx.x * (BZ_THREADS / 32) + threadIdx.x / 32) * BZ_ROWS;
    const int k = w * 32 + lane;
    const float band_hi = band_mid + band_half;
    float x[BZ_ROWS];
    bool ok[BZ_ROWS];
#pragma unroll
    for (int i = 0; i < BZ_ROWS; ++i) {
        ok[i] = n_first + i < N && k < HW;
        x[i] = ok[i] ? logits[((size_t)b * N + n_first + i) * HW + k] : 0.f;
    }
    uint32_t* out = bits + ((size_t)b * gridDim.y + w) * n_pad + n_first;
#pragma unroll
    for (int i = 0; i < BZ_ROWS; ++i) {
        bool m = x[i] > band_hi;
        if (fabsf(x[i] - band_mid) <= band_half) m = binarize_exact(x[i], thr);
        const uint32_t word = __ballot_sync(0xFFFFFFFFu, ok[i] && m);
        if (lane == 0) out[i] = word;
    }
}

// fp32 feature stage [32 x 64] -> hi / mid / lo bf16 planes (see
// plane_word): each feature is split once. A warp writes one 16-byte chunk
// of 8 rows of each plane; each thread one (C, HW pair) of it.
__device__ __forceinline__ void mp_split(const float* s_ft, uint16_t* s_pl, int ptid) {
    static_assert(MP_PLANE / 2 % MP_PRODUCERS == 0, "whole pairs a producer");
#pragma unroll
    for (int e = 0; e < MP_PLANE / 2 / MP_PRODUCERS; ++e) {
        const int idx = e * MP_PRODUCERS + ptid;
        const int core = idx / 32, li = idx % 32;
        const int c = (core / (MP_BK / 8)) * 8 + li / 4;
        const int k = (core % (MP_BK / 8)) * 8 + (li % 4) * 2;
        uint32_t h, m, l;
        split3(s_ft[k * MP_FT_LD + c], s_ft[(k + 1) * MP_FT_LD + c], h, m, l);
        uint32_t* d = reinterpret_cast<uint32_t*>(s_pl) + plane_word(c, k);
        d[0] = h;
        d[MP_PLANE / 2] = m;
        d[MP_PLANE] = l;
    }
}

// out tile [128 x 64] of one HW chunk = mask words x features, on the
// tensor cores, with warp specialization:
//   producers (warpgroups 2, 3) keep a 4-stage cp.async ring of [32 x 64]
//     fp32 feature slabs and their 128 mask words in flight, split each slab
//     into the three bf16 planes and copy its mask words into one of two
//     buffers, then mark the buffer full;
//   consumers (warpgroups 0, 1: rows 0-63, 64-127) build A fragments in
//     registers from the mask words, issue 2 k16 steps x 3 planes of
//     m64n64k16 wgmma into a zeroed slab sum, add it to the running fp32
//     sum, and mark the buffer empty.
// So the split of slab s+1 runs while the tensor cores work on slab s.
__global__ void __launch_bounds__(MP_THREADS, 1)
mask_pool_partial_kernel(const uint32_t* __restrict__ bits,  // [B, words, n_pad]
                         const float* __restrict__ feats,     // [B, HW, C]
                         float* __restrict__ partial,         // [S, B, N, C]
                         int B, int N, int HW, int C, int n_pad, int chunk, int vec_ft) {
    extern __shared__ __align__(128) unsigned char mp_smem[];
    float* s_ft = reinterpret_cast<float*>(mp_smem);
    uint32_t* s_mw = reinterpret_cast<uint32_t*>(s_ft + MP_STAGES * MP_FT_STAGE);
    uint16_t* s_pl = reinterpret_cast<uint16_t*>(s_mw + MP_STAGES * MP_BN);
    uint32_t* s_mb = reinterpret_cast<uint32_t*>(s_pl + 2 * MP_PL_TILE);  // [2][128]

    const int tid = threadIdx.x;
    const int c0 = blockIdx.x * MP_BC;
    const int split = blockIdx.y;
    const int n_tiles = n_pad / MP_BN;
    const int b = blockIdx.z / n_tiles;
    const int n0 = (blockIdx.z % n_tiles) * MP_BN;
    const int k_begin = split * chunk;  // a multiple of 32: slab s is mask word k_begin/32 + s
    const int k_end = min(k_begin + chunk, HW);
    const int n_slabs = (k_end - k_begin + MP_BK - 1) / MP_BK;
    constexpr int ALL = MP_THREADS;

    // let the reduce kernel launch now; it waits for this grid to finish
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

    if (tid >= MP_CONSUMERS) {  // ---------------------------------- producers
        const int ptid = tid - MP_CONSUMERS;
        const int words = (HW + 31) / 32;
        const float* ft = feats + (size_t)b * HW * C;
        const uint32_t* bw = bits + ((size_t)b * words + k_begin / MP_BK) * n_pad + n0;
        // 16-byte feature chunks of a slab: chunk ch is row ch / 16, cols
        // 4 (ch % 16) ..; columns past C are never copied but zeroed once
        constexpr int CHUNKS = MP_BK * MP_BC / 4;
        static_assert(CHUNKS % MP_PRODUCERS == 0, "whole chunks a producer");
        for (int ch = ptid; ch < CHUNKS; ch += MP_PRODUCERS) {
            const int r = ch / (MP_BC / 4), j = (ch % (MP_BC / 4)) * 4;
            if (c0 + j >= C)
                for (int s = 0; s < MP_STAGES; ++s)
                    *reinterpret_cast<float4*>(s_ft + s * MP_FT_STAGE + r * MP_FT_LD + j) =
                        make_float4(0.f, 0.f, 0.f, 0.f);
        }
        auto load = [&](int slab_i, bool with_mask) {
            const int slot = slab_i % MP_STAGES;
#pragma unroll
            for (int e = 0; e < CHUNKS / MP_PRODUCERS; ++e) {
                const int ch = e * MP_PRODUCERS + ptid;
                const int r = ch / (MP_BC / 4), j = (ch % (MP_BC / 4)) * 4;
                const int k = k_begin + slab_i * MP_BK + r;
                float* dst = s_ft + slot * MP_FT_STAGE + r * MP_FT_LD + j;
                const float* src = ft + (size_t)k * C + c0 + j;
                if (vec_ft && k < k_end) {
                    if (c0 + j < C) cp_async16(dst, src);
                } else {
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        const bool ok = k < k_end && c0 + j + i < C;
                        cp_async4(dst + i, ok ? src + i : ft, ok);
                    }
                }
            }
            if (with_mask && ptid < MP_BN / 4)
                cp_async16(s_mw + slot * MP_BN + ptid * 4, bw + (size_t)slab_i * n_pad + ptid * 4);
        };
        // features first: they do not wait for the binarize kernel
        for (int s = 0; s < MP_STAGES - 1 && s < n_slabs; ++s) load(s, false);
        asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the mask words are written
        for (int s = 0; s < MP_STAGES - 1; ++s) {
            if (s < n_slabs && ptid < MP_BN / 4)
                cp_async16(s_mw + s * MP_BN + ptid * 4, bw + (size_t)s * n_pad + ptid * 4);
            cp_async_commit();
        }
        for (int s = 0; s < n_slabs; ++s) {
            cp_async_wait<MP_STAGES - 2>();
            bar_sync(MP_BAR_PROD, MP_PRODUCERS);  // slab s landed; slab s-1 is split
            const int p = s % 2;
            if (s >= 2) bar_sync(MP_BAR_EMPTY + p, ALL);  // slab s-2's wgmmas are done
            mp_split(s_ft + (s % MP_STAGES) * MP_FT_STAGE, s_pl + p * MP_PL_TILE, ptid);
            if (ptid < MP_BN) s_mb[p * MP_BN + ptid] = s_mw[(s % MP_STAGES) * MP_BN + ptid];
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // planes -> wgmma
            bar_arrive(MP_BAR_FULL + p, ALL);
            // slot (s-1) % STAGES: slab s-1 was split before the barrier above
            if (s + MP_STAGES - 1 < n_slabs) load(s + MP_STAGES - 1, true);
            cp_async_commit();
        }
        cp_async_wait<0>();
        return;
    }

    // ----------------------------------------------------------------- consumers
    const int lane = tid % 32, warp = tid / 32;
    const int g = lane / 4, t = lane % 4;              // fragment row / column group
    const int row0 = (warp / 4) * 64 + (warp % 4) * 16;  // this warp's 16 rows
    float acc[32], slab[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = slab[i] = 0.f;
    for (int s = 0; s < n_slabs; ++s) {
        const int p = s % 2;
        bar_sync(MP_BAR_FULL + p, ALL);
        const uint32_t w0 = s_mb[p * MP_BN + row0 + g];
        const uint32_t w1 = s_mb[p * MP_BN + row0 + g + 8];
        uint32_t a[2][4];
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
            a[ks][0] = mask_pair(w0, ks * 16 + 2 * t);
            a[ks][1] = mask_pair(w1, ks * 16 + 2 * t);
            a[ks][2] = mask_pair(w0, ks * 16 + 2 * t + 8);
            a[ks][3] = mask_pair(w1, ks * 16 + 2 * t + 8);
        }
        const uint16_t* pl = s_pl + p * MP_PL_TILE;
        fence_regs(slab);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
            for (int q = 0; q < 3; ++q)
                wgmma_m64n64k16(slab, a[ks], wgmma_desc(pl + q * MP_PLANE, ks), ks + q);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_regs(slab);
        if (s + 2 < n_slabs) bar_arrive(MP_BAR_EMPTY + p, ALL);  // the producers refill p
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] += slab[i];
    }

    float* out = partial + ((size_t)split * B + b) * N * C;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int n = n0 + row0 + g + 8 * h;
        if (n >= N) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int c = c0 + j * 8 + 2 * t;
            float* o = out + (size_t)n * C + c;
            if (c + 1 < C && C % 2 == 0) {
                *reinterpret_cast<float2*>(o) =
                    make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
            } else {
                if (c < C) o[0] = acc[4 * j + 2 * h];
                if (c + 1 < C) o[1] = acc[4 * j + 2 * h + 1];
            }
        }
    }
}

// out[i] = sum of partial[s, i] over the splits s in a fixed order: lane
// part (0..3) of the 4 threads of output i adds splits part, part + 4, ...
// in order, then two xor-shuffles add the 4 sums pairwise. Deterministic,
// no atomics; the loads of a thread are issued together.
constexpr int RD_LANES = 4;
__global__ void mask_pool_reduce_kernel(const float* __restrict__ partial,
                                        float* __restrict__ out, size_t count,
                                        int splits) {
    asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the partial sums are written
    const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    const size_t i = t / RD_LANES;
    const int part = (int)(t % RD_LANES);
    float s = 0.f;
    if (i < count) {
        float v[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
            const int p = part + q * RD_LANES;
            v[q] = p < splits ? partial[(size_t)p * count + i] : 0.f;
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) s += v[q];
        for (int p = part + 8 * RD_LANES; p < splits; p += RD_LANES)
            s += partial[(size_t)p * count + i];
    }
    s += __shfl_xor_sync(0xFFFFFFFFu, s, 1);
    s += __shfl_xor_sync(0xFFFFFFFFu, s, 2);
    if (i < count && part == 0) out[i] = s;
}

constexpr int AS_BN = 128;  // N rows per block: two consumer warpgroups of 64
constexpr int AS_BH = 64;   // HW cols per block: wgmma n
constexpr int AS_BK = 32;   // channels per slab: 128 bytes of fp32, 4 k8 steps
constexpr int AS_STAGES = 4;
constexpr int AS_CONSUMERS = 256;  // warpgroups 0, 1
constexpr int AS_SPLITTERS = 128;  // warpgroup 2; warp 12 starts the TMA loads
constexpr int AS_THREADS = AS_CONSUMERS + AS_SPLITTERS + 32;
constexpr int AS_KERN = AS_BN * AS_BK;  // floats: fp32 kernel slab
constexpr int AS_FEAT = AS_BH * AS_BK;  // floats: one feature plane
constexpr int AS_STAGE = AS_KERN + 2 * AS_FEAT;  // kernels, big plane, small plane
constexpr int AS_TX_BYTES = (AS_KERN + AS_FEAT) * 4;  // TMA bytes a stage
// the ring and its mbarriers, + 1 KB to align the ring to the 1024-byte
// period of the 128-byte swizzle
constexpr int AS_SMEM = AS_STAGES * (AS_STAGE * 4 + 8) + 1024;
// named barriers (0 is __syncthreads): stage s split, one for each
// consumer warpgroup (AS_BAR_FULL + 2 s + wg; splitters arrive on both, so
// neither warpgroup waits for the other: ~1 us faster at the serving shape
// than one barrier for both), and stage s free (consumers arrive, the loader
// warp waits)
constexpr int AS_BAR_FULL = 1, AS_BAR_EMPTY = AS_BAR_FULL + 2 * AS_STAGES;
constexpr int AS_FULL_COUNT = AS_SPLITTERS + 128;
constexpr int AS_EMPTY_COUNT = AS_CONSUMERS + 32;
constexpr int AS_SPLIT = AS_FEAT / 4 / AS_SPLITTERS;  // float4 a splitter a slab

// float offset of the 16-byte chunk j of row r in a K-major tile of 32-float
// (128-byte) rows with the 128-byte swizzle of TMA and wgmma
__device__ __forceinline__ int sw128(int r, int j) { return r * AS_BK + ((j ^ (r & 7)) << 2); }

// K-major 128-byte-swizzled tile, rows 128 bytes apart, groups of 8 rows
// 1024 bytes apart; the descriptor of k8 step ks starts 32 ks bytes into the
// rows. The tile must start on a 1024-byte boundary.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(const float* tile, int ks) {
    const uint64_t a = static_cast<uint64_t>(__cvta_generic_to_shared(tile)) + ks * 32;
    return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
           (1ull << 62);
}

// cvt.rna.tf32.f32's rounding (to nearest, ties away from zero, low 13 bits
// cleared) as two integer operations on the bit pattern: cvt runs on the
// conversion unit at a quarter of the integer rate
__device__ __forceinline__ uint32_t tf32_rna(float x) {
    return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the stage's TMA bytes are expected; the one arrival the barrier counts
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                     smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
    asm volatile(
        "{\n.reg .pred done;\nLAB_WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        "@!done bra LAB_WAIT;\n}\n" ::"r"(smem_addr(bar)),
        "r"(parity)
        : "memory");
}

// box (32 channels from c, rows from row, image b) of a [B, rows, C] fp32
// tensor into a 128-byte-swizzled tile; past the tensor's edges TMA writes 0
__device__ __forceinline__ void tma_load(float* dst, const CUtensorMap* map, int c, int row,
                                         int b, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(row), "r"(b), "r"(smem_addr(bar))
        : "memory");
}

// d += a * b for one warpgroup: m64n64k8, A (4 tf32 a thread) from
// registers, B (a feature plane) from shared memory, fp32 accumulate
__device__ __forceinline__ void wgmma_tf32_m64n64k8(float (&d)[32], const uint32_t (&a)[4],
                                                    uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
        "{%32,%33,%34,%35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

// keeps the compiler from reusing A registers a wgmma may still read
__device__ __forceinline__ void fence_regs_u(uint32_t (&a)[4][4]) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

// out tile [128 (N) x 64 (HW)] = kern x feats^T on the tensor cores in
// 3xTF32 (see the note at the top), with warp specialization over a
// 4-stage shared-memory ring; C in slabs of 32 channels, in order.
// tm_kern / tm_feat: TMA maps of kern [B, N, C] and feats [B, HW, C]
// (boxes of 32 channels x 128 / 64 rows, 128-byte swizzle).
__global__ void __launch_bounds__(AS_THREADS, 1)
assemble_kernel(const __grid_constant__ CUtensorMap tm_kern,
                const __grid_constant__ CUtensorMap tm_feat,
                float* __restrict__ out,  // [B, N, HW]
                int N, int HW, int C, int apply_sigmoid) {
    extern __shared__ __align__(128) unsigned char as_smem_raw[];
    // align by an offset from the shared array, so that every access stays a
    // shared-memory one (LDS/STS with 32-bit addresses)
    float* ring = reinterpret_cast<float*>(
        as_smem_raw + ((1024 - (smem_addr(as_smem_raw) & 1023)) & 1023));
    uint64_t* landed = reinterpret_cast<uint64_t*>(ring + AS_STAGES * AS_STAGE);
    const int tid = threadIdx.x;
    const int hw0 = blockIdx.x * AS_BH;
    const int n0 = blockIdx.y * AS_BN;
    const int b = blockIdx.z;
    const int n_slabs = (C + AS_BK - 1) / AS_BK;

    if (tid == 0) {
        for (int i = 0; i < AS_STAGES; ++i)
            asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(landed + i))
                         : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (tid >= AS_CONSUMERS + AS_SPLITTERS) {  // ------------------------ loader
        // one thread keeps the ring full; a stage is refilled once its
        // wgmmas are done
#pragma unroll 1
        for (int s = 0; s < n_slabs; ++s) {
            if (s >= AS_STAGES) bar_sync(AS_BAR_EMPTY + s % AS_STAGES, AS_EMPTY_COUNT);
            if (tid == AS_CONSUMERS + AS_SPLITTERS) {
                float* st = ring + (s % AS_STAGES) * AS_STAGE;
                uint64_t* bar = landed + s % AS_STAGES;
                mbar_expect_tx(bar, AS_TX_BYTES);
                tma_load(st, &tm_kern, s * AS_BK, n0, b, bar);
                tma_load(st + AS_KERN, &tm_feat, s * AS_BK, hw0, b, bar);
            }
        }
    } else if (tid >= AS_CONSUMERS) {  // ------------------------------ splitters
        // slab s landed: split its features, big in place, small beside; a
        // thread's loads are in flight together
        const int stid = tid - AS_CONSUMERS;
#pragma unroll 1
        for (int s = 0; s < n_slabs; ++s) {
            mbar_wait(landed + s % AS_STAGES, (s / AS_STAGES) & 1);
            uint4* v = reinterpret_cast<uint4*>(ring + (s % AS_STAGES) * AS_STAGE + AS_KERN);
            float4 x[AS_SPLIT];
#pragma unroll
            for (int e = 0; e < AS_SPLIT; ++e)
                x[e] = *reinterpret_cast<const float4*>(v + e * AS_SPLITTERS + stid);
#pragma unroll
            for (int e = 0; e < AS_SPLIT; ++e) {
                uint4 hi, lo;
                hi.x = tf32_rna(x[e].x);
                hi.y = tf32_rna(x[e].y);
                hi.z = tf32_rna(x[e].z);
                hi.w = tf32_rna(x[e].w);
                lo.x = tf32_rna(x[e].x - __uint_as_float(hi.x));
                lo.y = tf32_rna(x[e].y - __uint_as_float(hi.y));
                lo.z = tf32_rna(x[e].z - __uint_as_float(hi.z));
                lo.w = tf32_rna(x[e].w - __uint_as_float(hi.w));
                v[e * AS_SPLITTERS + stid] = hi;
                v[AS_FEAT / 4 + e * AS_SPLITTERS + stid] = lo;
            }
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // planes -> wgmma
            bar_arrive(AS_BAR_FULL + 2 * (s % AS_STAGES), AS_FULL_COUNT);
            bar_arrive(AS_BAR_FULL + 2 * (s % AS_STAGES) + 1, AS_FULL_COUNT);
        }
    } else {  // ------------------------------------------------------ consumers
        const int lane = tid % 32, warp = tid / 32;
        const int g = lane / 4, t = lane % 4;              // fragment row / column group
        const int row0 = (warp / 4) * 64 + (warp % 4) * 16;  // this warp's 16 rows
        // big*big into acc, the two small terms into acc2: summed apart, the
        // small terms keep their bits through the tensor cores' accumulation
        float acc[32], acc2[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = acc2[i] = 0.f;
#pragma unroll 1
        for (int s = 0; s < n_slabs; ++s) {
            const float* st = ring + (s % AS_STAGES) * AS_STAGE;
            // the kernels landed (TMA) and the features are split
            mbar_wait(landed + s % AS_STAGES, (s / AS_STAGES) & 1);
            bar_sync(AS_BAR_FULL + 2 * (s % AS_STAGES) + warp / 4, AS_FULL_COUNT);
            // A fragment of k8 step ks: a[q] is row row0 + g + 8 (q & 1),
            // channel 8 ks + t + 4 (q >> 1); split into big and small here
            uint32_t ab[4][4], as[4][4];
#pragma unroll
            for (int ks = 0; ks < 4; ++ks)
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const int r = row0 + g + 8 * (q & 1);
                    const float x = st[sw128(r, 2 * ks + (q >> 1)) + t];
                    ab[ks][q] = tf32_rna(x);
                    as[ks][q] = tf32_rna(x - __uint_as_float(ab[ks][q]));
                }
            const float* big = st + AS_KERN;
            fence_regs(acc);
            fence_regs(acc2);
            asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
            for (int ks = 0; ks < 4; ++ks) {
                wgmma_tf32_m64n64k8(acc, ab[ks], wgmma_desc_sw128(big, ks));
                wgmma_tf32_m64n64k8(acc2, as[ks], wgmma_desc_sw128(big, ks));
                wgmma_tf32_m64n64k8(acc2, ab[ks], wgmma_desc_sw128(big + AS_FEAT, ks));
            }
            asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
            asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
            fence_regs(acc);
            fence_regs(acc2);
            fence_regs_u(ab);
            fence_regs_u(as);
            if (s + AS_STAGES < n_slabs) bar_arrive(AS_BAR_EMPTY + s % AS_STAGES, AS_EMPTY_COUNT);
        }

#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] += acc2[i];
        float* ob = out + (size_t)b * N * HW;
        const bool pairs = HW % 2 == 0;  // float2 stores stay 8-byte aligned
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int n = n0 + row0 + g + 8 * h;
            if (n >= N) continue;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int p = hw0 + j * 8 + 2 * t;
                float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
                if (apply_sigmoid) {
                    v0 = 1.f / (1.f + expf(-v0));
                    v1 = 1.f / (1.f + expf(-v1));
                }
                float* o = ob + (size_t)n * HW + p;
                if (pairs && p + 1 < HW) {
                    *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
                } else {
                    if (p < HW) o[0] = v0;
                    if (p + 1 < HW) o[1] = v1;
                }
            }
        }
    }
}

// cuTensorMapEncodeTiled from the driver, found at run time (the library
// links only the CUDA runtime)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
                cudaSuccess &&
            found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// TMA map of a [B, rows, C] fp32 tensor (C % 4 == 0, 16-byte aligned) with
// boxes of 32 channels x box_rows rows, 128-byte swizzle, zero fill
bool tensor_map(CUtensorMap* map, const float* base, int B, int rows, int C, int box_rows) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return false;
    const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)rows, (cuuint64_t)B};
    const cuuint64_t strides[2] = {(cuuint64_t)C * 4, (cuuint64_t)rows * C * 4};
    const cuuint32_t box[3] = {(cuuint32_t)AS_BK, (cuuint32_t)box_rows, 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base), dims,
                  strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

int vk_mask_pool_block_cols() { return MP_BC; }
int vk_mask_pool_block_rows() { return MP_BN; }
int vk_mask_pool_block_hw() { return MP_BK; }

// blocks of the partial kernel that fit on the card at once, or a negative
// CUDA error
int vk_mask_pool_max_blocks() {
    cudaError_t err = cudaFuncSetAttribute(
        mask_pool_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MP_SMEM);
    int dev = 0, per_sm = 0, sms = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mask_pool_partial_kernel,
                                                            MP_THREADS, MP_SMEM);
    return err == cudaSuccess ? per_sm * sms : -(int)err;
}

// Three launches on the caller's stream, each of the last two with
// programmatic dependent launch (it starts while the one before runs and
// waits for it with griddepcontrol.wait):
//   binarize  logits -> mask words, bits: [B, ceil(HW/32), n_pad] uint32 scratch
//   partial   mask words x features -> partial: [splits, B, N, C] scratch
//             (may alias out when splits == 1)
//   reduce    out = sum of the partials in split order
int vk_mask_pool(const float* logits, const float* feats, void* bits, float* partial, float* out,
                 int B, int N, int HW, int C, float thr, int splits, int chunk,
                 void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaFuncSetAttribute(
        mask_pool_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MP_SMEM);
    if (err != cudaSuccess) return (int)err;
    // the band where the binarize evaluates the reference's formula: 1e-3
    // around logit(thr); for thr outside [0.01, 0.99] it covers every logit
    float band_mid = 0.f, band_half = INFINITY;
    if (thr >= 0.01f && thr <= 0.99f) {
        band_mid = (float)log((double)thr / (1.0 - (double)thr));
        band_half = 1e-3f;
    }
    const int n_tiles = (N + MP_BN - 1) / MP_BN;
    const int n_pad = n_tiles * MP_BN;
    const dim3 bz_grid(n_pad / (BZ_ROWS * BZ_THREADS / 32), (HW + 31) / 32, B);
    mask_pool_binarize_kernel<<<bz_grid, BZ_THREADS, 0, st>>>(
        logits, static_cast<uint32_t*>(bits), N, HW, n_pad, thr, band_mid, band_half);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    cudaLaunchAttribute pdl[1];
    pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    pdl[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((C + MP_BC - 1) / MP_BC, splits, B * n_tiles);
    cfg.blockDim = dim3(MP_THREADS);
    cfg.dynamicSmemBytes = MP_SMEM;
    cfg.stream = st;
    cfg.attrs = pdl;
    cfg.numAttrs = 1;
    const int vec_ft = C % 4 == 0 && reinterpret_cast<uintptr_t>(feats) % 16 == 0;
    err = cudaLaunchKernelEx(&cfg, mask_pool_partial_kernel,
                             static_cast<const uint32_t*>(bits), feats,
                             splits == 1 ? out : partial, B, N, HW, C, n_pad, chunk, vec_ft);
    if (err != cudaSuccess || splits == 1) return (int)err;

    const size_t count = (size_t)B * N * C;
    const int threads = 256;
    cfg.gridDim = dim3((unsigned)((count * RD_LANES + threads - 1) / threads));
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = 0;
    return (int)cudaLaunchKernelEx(&cfg, mask_pool_reduce_kernel, (const float*)partial, out,
                                   count, splits);
}

// kern [B, N, C], feats [B, HW, C] with C % 4 == 0 and 16-byte aligned
// pointers (TMA's row stride; the wrapper pads other shapes)
int vk_assemble(const float* kern, const float* feats, float* out, int B, int N, int HW,
                int C, int apply_sigmoid, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (C % 4 != 0 || reinterpret_cast<uintptr_t>(kern) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(feats) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    CUtensorMap tm_kern, tm_feat;
    if (!tensor_map(&tm_kern, kern, B, N, C, AS_BN) ||
        !tensor_map(&tm_feat, feats, B, HW, C, AS_BH))
        return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        assemble_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, AS_SMEM);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((HW + AS_BH - 1) / AS_BH, (N + AS_BN - 1) / AS_BN, B);
    assemble_kernel<<<grid, AS_THREADS, AS_SMEM, st>>>(tm_kern, tm_feat, out, N, HW, C,
                                                       apply_sigmoid);
    return (int)cudaGetLastError();
}

}  // extern "C"
