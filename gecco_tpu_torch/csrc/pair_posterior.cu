// Kernel J: Forward and Backward of listed pairs in one launch -> Forward
// score, match occupancy, begin and end posteriors.
//
// Replaces gecco_tpu/hmm/kernels.py::_pallas_pair_posterior (the first
// stage of PairDomains).  For each row (sequence, profile) it runs
//
//   pass A: the rescaled Forward of forward_step.cuh over the sequence,
//     recording after each residue the rescaled N, B, J, C, E and the
//     running log scale (kernels.py:1816-1839), and the score
//     log(C * move + 1e-38) + ls after the last residue (an empty sequence
//     scores -1e30);
//   pass B: the rescaled Backward of backward_step.cuh from the last
//     residue down, combining at every residue o the Backward specials
//     with the recorded Forward values of o and o-1 (emit_posterior,
//     kernels.py:1850-1875) into mocc(o), pB(o) and, where asked, pE(o),
//
// and writes score[slot] and post[0] = mocc, post[1] = pB, post[2] = pE as
// [n_out][stride] at the row's output slot (out_row: its index in the
// caller's order), zero from the row's length to the stride.  The six
// Forward trajectories (24 bytes a residue) never leave the chip: the TPU
// kernel kept them in VMEM scratch.
//
// Bound on the H100: the latency of the per-residue chains of both passes
// (~19 + 24 float operations and two emission reads per DP cell); the
// posteriors are 8 or 12 bytes a residue.
//
// Design, widths 128 to 1,024: kernel D's warp body, then kernel E's, in
// the same warp (stream_fwd.cu, stream_bwd.cu): one warp per row, lane l
// holding nodes [l*C, (l+1)*C) in registers, C = ceil(M / 32) for a
// profile of M nodes.  Blocks take runs of rows of ONE profile, one a warp
// (hmm.kernels.pair_blocks); the block stages the profile's 8 transition
// and 21 emission-odds rows once, lane-interleaved, and one warp computes
// the Backward delete chain's basis U into a 30th row; at C <= 8 a lane
// keeps its transitions, nm and U in registers.  Pass A is
// warp_forward_traj (forward_step.cuh): lane i mod 32 keeps residue i's N,
// B, J, C, E and log scale, and once every 32 residues the warp stores 32
// consecutive floats of each trajectory into the row's slice of a scratch
// tensor in device memory ([6][n_out][stride], that no other warp
// touches), which the L2 cache holds between the passes.  A __syncwarp
// orders those stores before pass B reads them.  Pass B is
// warp_posterior_row (backward_step.cuh): lane o mod 32 keeps residue o's
// Backward specials, and once every 32 residues each lane runs
// emit_posterior for its own residue, so that the trajectory reads at o
// and o-1 and the mocc, pB, pE stores are 32 consecutive floats a warp.
// No barrier in either residue loop.  (A slice of shared memory a warp
// would hold 12 KB at 512 residues and 96 KB at 4,096: it would set the
// warps a block from the launch's longest row, and J could no longer take
// every row that kernel D takes.)
//
// Design, widths 2,048 and 4,096 (3 of 2,766 Pfam-sized profiles): one
// block per row, CHUNK nodes a thread, the block-level forward_step and
// Backward (two barriers a residue each); transitions, the node mask, U
// and the trajectories in shared memory, thread 0 recording them and
// emitting each residue's posterior, so that a launch needs (10 * width +
// 1 + 6 * stride) * 4 bytes of dynamic shared memory a block, which the
// wrapper holds under the 227 KB a block may opt into.  The TPU kernel's
// (St, 8) grid of C gathered profile rows has no counterpart.
#include <type_traits>

#include "backward_step.cuh"

using namespace gecco;

namespace {

constexpr int N_TRAJ = 6;  // fN, fB, fJ, fC, flog, fE
// warps a block (hmm.stream.DOMAIN_BLOCK_ROWS) and the blocks an SM the
// registers must leave room for: kernel E's (stream_bwd.cu), the larger of
// the two bodies
template <int C>
constexpr int J_WARPS = C <= 8 ? 4 : 8;
template <int C>
constexpr int J_MIN_BLOCKS = C <= 4 ? 4 : C <= 8 ? 3 : C <= 16 ? 2 : 1;
// rows of the staged table: 8 transitions, 21 emission odds (nm is the
// last), U
constexpr int J_SLOTS = N_TRANS + K_ALPHA + 1;

// What a block's warps need to run its run of rows.
struct Rows {
    RowArgs a;
    const int32_t* out_row;
    const float* smem;  // the staged table, J_SLOTS rows of 32 * C nodes
    int first, count, n_out, n_post;
    float* traj;        // scratch [N_TRAJ][n_out][stride]
    float* score;
    float* post;
};

// The block's rows, C nodes a lane, warp w taking rows w, w + warps, ...
// The block runs the body of C = ceil(M / 32) (C0 up to CMAX).
template <int C0, int CMAX>
__device__ __forceinline__ void posterior_rows(int c, const Rows& t) {
    if constexpr (C0 < CMAX) {
        if (c > C0) {
            posterior_rows<C0 + 1, CMAX>(c, t);
            return;
        }
    }
    constexpr int C = C0;
    constexpr int W = 32 * C;
    const int lane = threadIdx.x & 31;
    const float* esm = t.smem + N_TRANS * W + lane;
    constexpr bool REG = C <= 8;
    using Trans = std::conditional_t<REG, RegTrans<C>, SmemTrans<C>>;
    const Trans tr(t.smem + lane);
    const LaneRows<C, 2, REG> nu(t.smem + (N_TRANS + K_ALPHA - 1) * W + lane);  // nm, U
    const ChainScan chain = chain_scan<C>(tr);
    const ChainScan right = chain_scan_right<C>(tr);
    const int stride = t.a.stride;
    const size_t rows = static_cast<size_t>(t.n_out) * stride;  // one trajectory

    for (int r = threadIdx.x >> 5; r < t.count; r += blockDim.x >> 5) {
        const int row = t.first + r;
        const int s = t.a.seq[row];
        const int8_t* xs = t.a.xs + t.a.offsets[s];
        const int L = t.a.lens[s];
        const float loop = t.a.loops[s];
        const float move = t.a.moves[s];
        const int slot = t.out_row[row];
        const size_t at = static_cast<size_t>(slot) * stride;
        float* fN = t.traj + at;  // trajectory q at fN + q * rows
        const float score =
            warp_forward_traj<C, N_TRAJ>(xs, L, loop, move, esm, tr, chain, fN, rows);
        if (lane == 0) t.score[slot] = score;
        __syncwarp();  // pass A's trajectory stores before pass B reads them
        const ForwardTraj f{fN, fN + rows, fN + 2 * rows, fN + 3 * rows, fN + 5 * rows,
                            fN + 4 * rows};
        float* mocc = t.post + at;
        warp_posterior_row<C>(xs, L, loop, move, score, esm, tr, nu, right, f, mocc,
                              mocc + rows, t.n_post > 2 ? mocc + 2 * rows : nullptr, stride);
    }
}

// One block per run of rows of one profile (`blocks`: first row, row
// count) in a width class of 32 * CMAX nodes.
template <int CMAX>
__global__ void __launch_bounds__(32 * J_WARPS<CMAX>, J_MIN_BLOCKS<CMAX>)
pair_posterior_kernel(RowArgs a, const int32_t* __restrict__ blocks,
                      const int32_t* __restrict__ out_row, int n_out, int n_post, float* traj,
                      float* __restrict__ score, float* __restrict__ post) {
    // the narrowest class holds every model length up to its width, the
    // others those above half their width
    constexpr int CMIN = CMAX <= 4 ? 1 : CMAX / 2 + 1;
    constexpr int WARPS = J_WARPS<CMAX>;
    extern __shared__ float smem[];  // [J_SLOTS][W], lane-interleaved

    const int first = blocks[2 * blockIdx.x];
    const int count = blocks[2 * blockIdx.x + 1];
    const int p = a.prof[first];
    const int c = min(max((a.model_len[p] + 31) / 32, CMIN), CMAX);
    const int W = 32 * c;
    stage_interleaved(smem, a.trans, a.e_odds, static_cast<size_t>(a.P) * a.Mp,
                      static_cast<size_t>(p) * a.Mp, a.model_len[p], c, 32 * WARPS);
    __syncthreads();
    if (threadIdx.x < 32)
        warp_delete_basis(smem, smem + (N_TRANS + K_ALPHA - 1) * W, smem + (J_SLOTS - 1) * W, c);
    __syncthreads();

    const Rows t{a, out_row, smem, first, count, n_out, n_post, traj, score, post};
    posterior_rows<CMIN, CMAX>(c, t);
}

template <int THREADS, int CHUNK>
__global__ void __launch_bounds__(THREADS)
pair_posterior_kernel_wide(RowArgs a, const int32_t* __restrict__ out_row, int n_out,
                           int n_post, float* __restrict__ score_out, float* __restrict__ post) {
    constexpr int WIDTH = THREADS * CHUNK;
    extern __shared__ float smem[];  // trans [8][W], nm [W], U [W + 1], traj [6][stride]
    __shared__ ForwardScratch<THREADS> fsh;
    __shared__ BackwardScratch<THREADS> bsh;
    float* tsm = smem;
    float* nm = smem + N_TRANS * WIDTH;
    float* U = nm + WIDTH;
    float* traj = U + WIDTH + 1;
    float* fN = traj;
    float* fB = traj + a.stride;
    float* fJ = traj + 2 * a.stride;
    float* fC = traj + 3 * a.stride;
    float* fE = traj + 4 * a.stride;
    float* flog = traj + 5 * a.stride;

    const int r = blockIdx.x;
    const Row row = load_row(a, r);
    stage_planes<THREADS, WIDTH>(tsm, a.trans, N_TRANS, row);
    stage_planes<THREADS, WIDTH>(nm, a.e_odds + 20 * row.plane, 1, row);
    __syncthreads();

    // pass A: Forward, the trajectories into shared memory
    float score = NEG;
    {
        float Mv[CHUNK], Iv[CHUNK], Dv[CHUNK];
#pragma unroll
        for (int j = 0; j < CHUNK; ++j) Mv[j] = Iv[j] = Dv[j] = 0.0f;
        float N = 1.0f, B = row.move, J = 0.0f, C = 0.0f, E = 0.0f;
        double ls = 0.0;  // in double, as warp_forward_traj's
        for (int i = 0; i < row.L; ++i) {
            const float* e = emission_row(a.e_odds, row, i);
            ls += logf(forward_step<THREADS, CHUNK>(Mv, Iv, Dv, N, B, J, C, e, tsm, row.M,
                                                    row.loop, row.move, fsh, E));
            if (threadIdx.x == 0) {
                fN[i] = N;
                fB[i] = B;
                fJ[i] = J;
                fC[i] = C;
                fE[i] = E;
                flog[i] = static_cast<float>(ls);
            }
        }
        if (row.L > 0) score = static_cast<float>(logf(C * row.move + 1e-38f) + ls);
    }
    const int slot = out_row[r];
    if (threadIdx.x == 0) score_out[slot] = score;

    // pass B: Backward, the posteriors out
    const size_t rows = static_cast<size_t>(n_out) * a.stride;
    float* mocc = post + static_cast<size_t>(slot) * a.stride;
    float* pb = mocc + rows;
    float* pe = n_post > 2 ? mocc + 2 * rows : nullptr;
    const ForwardTraj f{fN, fB, fJ, fC, fE, flog};
    Backward<THREADS, CHUNK> bw{tsm, nm, U, bsh};
    bw.init(row.move);
    if (row.L > 0) {
        if (threadIdx.x == 0)
            emit_posterior(f, row.L - 1, row.loop, score, 0.0f, 0.0f, 0.0f, row.move, 0.0f, mocc,
                           pb, pe);
        for (int o = row.L - 2; o >= 0; --o) {
            const float bB =
                bw.step(emission_row(a.e_odds, row, o + 1), row.M, row.loop, row.move);
            if (threadIdx.x == 0)
                emit_posterior(f, o, row.loop, score, bw.bN, bB, bw.bJ, bw.bC, bw.ls, mocc, pb,
                               pe);
        }
    }
    for (int q = 0; q < n_post; ++q) {
        for (int o = row.L + threadIdx.x; o < a.stride; o += THREADS) mocc[q * rows + o] = 0.0f;
    }
}

struct Out {
    const int32_t* out_row;
    int n_out, n_post;
    float* traj;
    float* score;
    float* post;
};

template <int C>
cudaError_t launch_warps(const RowArgs& a, const int32_t* blocks, int n_blocks, const Out& o,
                         cudaStream_t st) {
    const size_t smem = sizeof(float) * J_SLOTS * 32 * C;
    cudaError_t err = allow_smem(pair_posterior_kernel<C>, smem);
    if (err != cudaSuccess) return err;
    pair_posterior_kernel<C><<<n_blocks, 32 * J_WARPS<C>, smem, st>>>(
        a, blocks, o.out_row, o.n_out, o.n_post, o.traj, o.score, o.post);
    return cudaGetLastError();
}

template <int THREADS, int CHUNK>
cudaError_t launch_wide(const RowArgs& a, const Out& o, cudaStream_t st) {
    const size_t smem = sizeof(float) * ((N_TRANS + 2) * THREADS * CHUNK + 1 +
                                         N_TRAJ * static_cast<size_t>(a.stride));
    cudaError_t err = allow_smem(pair_posterior_kernel_wide<THREADS, CHUNK>, smem);
    if (err != cudaSuccess) return err;
    pair_posterior_kernel_wide<THREADS, CHUNK><<<a.n_rows, THREADS, smem, st>>>(
        a, o.out_row, o.n_out, o.n_post, o.score, o.post);
    return cudaGetLastError();
}

}  // namespace

// Rows r < n_rows: sequence seq[r] against profile prof[r], every sequence
// of at most `stride` residues, written at output row out_row[r] of score
// [n_out] and post [n_post][n_out][stride] (mocc, pB and, with n_post = 3,
// pE); traj [6][n_out][stride] is scratch.  Widths 128 to 1,024 take every
// row of one width class, cut by `blocks` [n_blocks][2] int32 (first row,
// row count) into runs of one profile (hmm.kernels.pair_blocks); widths
// 2,048 and 4,096 ignore it and take one block a row, every profile of
// model length <= width, and leave traj alone.  Returns a CUDA error code.
extern "C" int gecco_pair_posterior(const void* xs, const void* offsets, const void* lens,
                                    const void* loops, const void* moves, const void* seq,
                                    const void* prof, int n_rows, const void* e_odds,
                                    const void* trans, const void* model_len, int P, int Mp,
                                    int width, int stride, const void* blocks, int n_blocks,
                                    const void* out_row, int n_out, int n_post, void* traj,
                                    void* score, void* post, void* stream) {
    if (n_rows <= 0) return 0;
    if (n_post != 2 && n_post != 3) return static_cast<int>(cudaErrorInvalidValue);
    const RowArgs a = make_row_args(xs, offsets, lens, loops, moves, seq, prof, n_rows, e_odds,
                                    trans, model_len, P, Mp, stride);
    const Out o{static_cast<const int32_t*>(out_row), n_out, n_post, static_cast<float*>(traj),
                static_cast<float*>(score), static_cast<float*>(post)};
    const int32_t* runs = static_cast<const int32_t*>(blocks);
    if (width <= 1024 && (runs == nullptr || n_blocks <= 0 || traj == nullptr))
        return cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    switch (width) {
        case 128: err = launch_warps<4>(a, runs, n_blocks, o, st); break;
        case 256: err = launch_warps<8>(a, runs, n_blocks, o, st); break;
        case 512: err = launch_warps<16>(a, runs, n_blocks, o, st); break;
        case 1024: err = launch_warps<32>(a, runs, n_blocks, o, st); break;
        case 2048: err = launch_wide<256, 8>(a, o, st); break;
        case 4096: err = launch_wide<256, 16>(a, o, st); break;
        default: err = cudaErrorInvalidValue;
    }
    return static_cast<int>(err);
}
