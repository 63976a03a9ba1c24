// Kernel E: posterior Backward -> match occupancy and begin posterior.
//
// Replaces gecco_tpu/hmm/stream.py::_stream_bwd.  For each row it runs
// the Backward recurrence of backward_step.cuh from the initial row at
// o = L-1 down to o = 0 and, at every residue, combines the Backward
// specials of o with kernel D's Forward trajectories of o and o-1
// (traj [5][n_out][stride]: N, B, J, C, log scale; N=1, J=C=0 and log
// scale 0 before the first residue) and the Forward score `total`:
//
//   ppX = fX(o-1) * loop * bX(o) * exp(fls(o-1) + bls(o) - total), X = N, J, C,
//   mocc(o) = clip(1 - ppN - ppJ - ppC, 0, 1),
//   pB(o) = fB(o) * bB(o) * exp(fls(o) + bls(o) - total),
//
// written to post[0][slot][o] and post[1][slot][o], zero from L to stride;
// traj and score are read, and post written, at the row's output slot
// (out_row: the row's index in the caller's order).  The JAX kernel reads
// o-1 from shifted copies of the trajectories; here the lane that writes
// reads it directly.
//
// Bound on the H100: the latency of the per-residue chain (a DP cell is
// ~24 float operations and one emission read); the trajectories and
// posteriors are 28 bytes a residue.
//
// Design, widths 128 to 1,024 (kernel F's, align_bwd.cu, without the
// planes): one warp per row, lane l holding nodes [l*C, (l+1)*C) of bM
// and bI in registers, C = ceil(M / 32) for a profile of M nodes.  Blocks
// take runs of rows of ONE profile, one a warp (hmm.kernels.pair_blocks);
// the block stages the profile's 8 transition and 21 emission-odds rows
// once, lane-interleaved, and one warp computes the delete chain's basis U
// into a 30th row; at C <= 8 a lane keeps its transitions, nm and U in
// registers.  A row is warp_posterior_row (backward_step.cuh, shared
// with kernel J).  Per residue: the residue from ResidueStreamRev, the
// next step's emissions read one step ahead, warp_backward_step, no
// barrier.
// The posterior is off that chain: lane o mod 32 keeps residue o's bN, bB,
// bJ, bC and log scale, and once every 32 residues each lane runs
// emit_posterior for its own residue, so that D's trajectories at o and
// o-1 are read, and mocc and pB stored, as 32 consecutive floats a warp.
//
// Design, widths 2,048 and 4,096 (3 of 2,766 Pfam-sized profiles): one
// block per row, CHUNK nodes a thread, the block-level Backward (two
// barriers a residue), thread 0 emitting each residue's posterior.  The
// TPU kernel's reversed block maps, its `binit` and `ekeep` scratch
// carries have no counterpart: the warp or block walks its own row from
// the end.
#include <type_traits>

#include "backward_step.cuh"

using namespace gecco;

namespace {

// warps a block and the blocks an SM the registers must leave room for:
// kernel F's (align_bwd.cu), whose warp body this is
template <int C>
constexpr int E_WARPS = C <= 8 ? 4 : 8;
template <int C>
constexpr int E_MIN_BLOCKS = C <= 4 ? 4 : C <= 8 ? 3 : C <= 16 ? 2 : 1;
// rows of the staged table: 8 transitions, 21 emission odds (nm is the
// last), U
constexpr int E_SLOTS = N_TRANS + K_ALPHA + 1;

// What a block's warps need to run its run of rows.
struct Rows {
    RowArgs a;
    const int32_t* out_row;
    const float* smem;  // the staged table, E_SLOTS rows of 32 * C nodes
    int first, count, n_out;
    const float* traj;
    const float* score;
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
    const ChainScan right = chain_scan_right<C>(tr);
    const int stride = t.a.stride;
    const size_t rows = static_cast<size_t>(t.n_out) * stride;  // one trajectory

    for (int r = threadIdx.x >> 5; r < t.count; r += blockDim.x >> 5) {
        const int row = t.first + r;
        const int s = t.a.seq[row];
        const int slot = t.out_row[row];
        const size_t at = static_cast<size_t>(slot) * stride;
        const float* fN = t.traj + at;
        const ForwardTraj f{fN, fN + rows, fN + 2 * rows, fN + 3 * rows, nullptr, fN + 4 * rows};
        warp_posterior_row<C>(t.a.xs + t.a.offsets[s], t.a.lens[s], t.a.loops[s], t.a.moves[s],
                              t.score[slot], esm, tr, nu, right, f, t.post + at,
                              t.post + rows + at, nullptr, stride);
    }
}

// One block per run of rows of one profile (`blocks`: first row, row
// count) in a width class of 32 * CMAX nodes.
template <int CMAX>
__global__ void __launch_bounds__(32 * E_WARPS<CMAX>, E_MIN_BLOCKS<CMAX>)
posterior_bwd_kernel(RowArgs a, const int32_t* __restrict__ blocks,
                     const int32_t* __restrict__ out_row, int n_out,
                     const float* __restrict__ traj, const float* __restrict__ score,
                     float* __restrict__ post) {
    // the narrowest class holds every model length up to its width, the
    // others those above half their width
    constexpr int CMIN = CMAX <= 4 ? 1 : CMAX / 2 + 1;
    constexpr int WARPS = E_WARPS<CMAX>;
    extern __shared__ float smem[];  // [E_SLOTS][W], lane-interleaved

    const int first = blocks[2 * blockIdx.x];
    const int count = blocks[2 * blockIdx.x + 1];
    const int p = a.prof[first];
    const int c = min(max((a.model_len[p] + 31) / 32, CMIN), CMAX);
    const int W = 32 * c;
    stage_interleaved(smem, a.trans, a.e_odds, static_cast<size_t>(a.P) * a.Mp,
                      static_cast<size_t>(p) * a.Mp, a.model_len[p], c, 32 * WARPS);
    __syncthreads();
    if (threadIdx.x < 32)
        warp_delete_basis(smem, smem + (N_TRANS + K_ALPHA - 1) * W, smem + (E_SLOTS - 1) * W, c);
    __syncthreads();

    const Rows t{a, out_row, smem, first, count, n_out, traj, score, post};
    posterior_rows<CMIN, CMAX>(c, t);
}

template <int THREADS, int CHUNK>
__global__ void __launch_bounds__(THREADS)
posterior_bwd_kernel_wide(RowArgs a, const int32_t* __restrict__ out_row, int n_out,
                          const float* __restrict__ traj, const float* __restrict__ score,
                          float* __restrict__ post) {
    constexpr int WIDTH = THREADS * CHUNK;
    extern __shared__ float smem[];  // trans [8][W], nm [W], U [W + 1]
    __shared__ BackwardScratch<THREADS> sh;
    float* tsm = smem;
    float* nm = smem + N_TRANS * WIDTH;
    float* U = nm + WIDTH;

    const int r = blockIdx.x;
    const Row row = load_row(a, r);
    stage_planes<THREADS, WIDTH>(tsm, a.trans, N_TRANS, row);
    stage_planes<THREADS, WIDTH>(nm, a.e_odds + 20 * row.plane, 1, row);
    __syncthreads();

    const int slot = out_row[r];
    const size_t rows = static_cast<size_t>(n_out) * a.stride;
    const size_t at = static_cast<size_t>(slot) * a.stride;
    const float* fN = traj + at;
    const ForwardTraj f{fN, fN + rows, fN + 2 * rows, fN + 3 * rows, nullptr, fN + 4 * rows};
    float* mocc = post + at;
    float* pb = post + rows + at;
    const float total = score[slot];
    const float loop = row.loop;

    Backward<THREADS, CHUNK> bw{tsm, nm, U, sh};
    bw.init(row.move);
    if (row.L > 0) {
        if (threadIdx.x == 0)
            emit_posterior(f, row.L - 1, loop, total, 0.0f, 0.0f, 0.0f, row.move, 0.0f, mocc, pb,
                           nullptr);
        for (int o = row.L - 2; o >= 0; --o) {
            const float bB = bw.step(emission_row(a.e_odds, row, o + 1), row.M, loop, row.move);
            if (threadIdx.x == 0)
                emit_posterior(f, o, loop, total, bw.bN, bB, bw.bJ, bw.bC, bw.ls, mocc, pb,
                               nullptr);
        }
    }
    for (int o = row.L + threadIdx.x; o < a.stride; o += THREADS) {
        mocc[o] = 0.0f;
        pb[o] = 0.0f;
    }
}

struct Out {
    const int32_t* out_row;
    int n_out;
    const float* traj;
    const float* score;
    float* post;
};

template <int C>
cudaError_t launch_warps(const RowArgs& a, const int32_t* blocks, int n_blocks, const Out& o,
                         cudaStream_t st) {
    const size_t smem = sizeof(float) * E_SLOTS * 32 * C;
    cudaError_t err = allow_smem(posterior_bwd_kernel<C>, smem);
    if (err != cudaSuccess) return err;
    posterior_bwd_kernel<C><<<n_blocks, 32 * E_WARPS<C>, smem, st>>>(
        a, blocks, o.out_row, o.n_out, o.traj, o.score, o.post);
    return cudaGetLastError();
}

template <int THREADS, int CHUNK>
cudaError_t launch_wide(const RowArgs& a, const Out& o, cudaStream_t st) {
    const size_t smem = sizeof(float) * ((N_TRANS + 2) * THREADS * CHUNK + 1);
    cudaError_t err = allow_smem(posterior_bwd_kernel_wide<THREADS, CHUNK>, smem);
    if (err != cudaSuccess) return err;
    posterior_bwd_kernel_wide<THREADS, CHUNK><<<a.n_rows, THREADS, smem, st>>>(
        a, o.out_row, o.n_out, o.traj, o.score, o.post);
    return cudaGetLastError();
}

}  // namespace

// Rows as gecco_posterior_fwd's, cut into blocks as its are, with its traj
// [5][n_out][stride] and score [n_out]: reads them, and writes post
// [2][n_out][stride] (mocc, pB), at output row out_row[r].  Returns a
// CUDA error code.
extern "C" int gecco_posterior_bwd(const void* xs, const void* offsets, const void* lens,
                                   const void* loops, const void* moves, const void* seq,
                                   const void* prof, int n_rows, const void* e_odds,
                                   const void* trans, const void* model_len, int P, int Mp,
                                   int width, int stride, const void* blocks, int n_blocks,
                                   const void* out_row, int n_out, const void* traj,
                                   const void* score, void* post, void* stream) {
    if (n_rows <= 0) return 0;
    const RowArgs a = make_row_args(xs, offsets, lens, loops, moves, seq, prof, n_rows, e_odds,
                                    trans, model_len, P, Mp, stride);
    const Out o{static_cast<const int32_t*>(out_row), n_out, static_cast<const float*>(traj),
                static_cast<const float*>(score), static_cast<float*>(post)};
    const int32_t* runs = static_cast<const int32_t*>(blocks);
    if (width <= 1024 && (runs == nullptr || n_blocks <= 0)) return cudaErrorInvalidValue;
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
