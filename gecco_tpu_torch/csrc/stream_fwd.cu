// Kernel D: posterior Forward with the special-state trajectories.
//
// Replaces gecco_tpu/hmm/stream.py::_stream_fwd (the first pass of
// StreamDomains' posterior decoding).  It is kernel C's Forward
// (forward_step.cuh, rescaled every residue) plus, after each residue i,
// the rescaled N, B, J, C and the running log scale written to
// traj[0..4][slot][i], and the final score log(C * move + 1e-38) + ls
// written to score[slot], where slot is the row's output index (out_row).
// Trajectories are zero from the row's length to the launch's stride; an
// empty sequence scores -1e30.
//
// Bound on the H100: the latency of the per-residue chain (a DP cell is
// ~19 float operations); the trajectories are 20 bytes a residue.
//
// Design, widths 128 to 1,024 (kernel C's, forward.cu): one warp per row,
// lane l holding nodes [l*C, (l+1)*C) of M, I and D in registers, C =
// ceil(M / 32) for a profile of M nodes (each block runs the body of its
// profile's C; the class sets the registers).  The host orders the rows
// by width class and profile and hands each block a run of rows of ONE
// profile (hmm.kernels.pair_blocks), at most as many as it has warps (4 at
// C <= 8, else 8), so that a launch of few rows a profile runs every row
// side by side; the block stages that profile's 8 transition and 21
// emission-odds rows once, lane-interleaved, and warp w takes its row w.
// (Blocks of 16 rows that the warps take in turn, as kernel C's, took up
// to 3x as long on an H100 where a profile has many rows:
// tools/torch_domain_kernels.py.)  At C <= 8 a lane
// keeps its transitions in registers (RegTrans).  Per residue: the residue
// from ResidueStream, the next residue's emissions read one step ahead,
// warp_forward_step (one shuffle for the stay, a five-step shuffle scan for
// the delete chain with ChainScan's slopes, E one warp sum), no barrier.
// Lane i mod 32 keeps residue i's N, B, J, C and log scale, and the warp
// stores 32 consecutive floats of each trajectory once every 32 residues
// (and the rest after the last one).  Each row is written in place at its
// output slot: the host permutes only the row indices, never the outputs.
//
// Design, widths 2,048 and 4,096 (3 of 2,766 Pfam-sized profiles): one
// block per row, CHUNK nodes a thread, the block-level forward_step (two
// barriers a residue), transitions staged in shared memory, emission rows
// read by residue index.  The TPU kernel's L-chunk grid and its VMEM
// carries have no counterpart: the residue loop runs inside the warp or
// block.
#include <type_traits>

#include "forward_step.cuh"

using namespace gecco;

namespace {

// warps a block and the blocks an SM the registers must leave room for,
// as kernel C's (forward.cu) at the same C
template <int C>
constexpr int D_WARPS = C <= 8 ? 4 : 8;
template <int C>
constexpr int D_MIN_BLOCKS = C <= 4 ? 6 : C <= 8 ? 4 : C <= 16 ? 2 : 1;

// What a block's warps need to run its run of rows.
struct Rows {
    RowArgs a;
    const int32_t* out_row;
    const float* smem;  // the staged tables, 32 * C nodes a row
    int first, count, n_out;
    float* traj;
    float* score;
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
    using Trans = std::conditional_t<(C <= 8), RegTrans<C>, SmemTrans<C>>;
    const Trans tr(t.smem + lane);
    const ChainScan chain = chain_scan<C>(tr);
    const int stride = t.a.stride;
    const size_t rows = static_cast<size_t>(t.n_out) * stride;  // one trajectory

    for (int r = threadIdx.x >> 5; r < t.count; r += blockDim.x >> 5) {
        const int row = t.first + r;
        const int s = t.a.seq[row];
        const int L = t.a.lens[s];
        const int slot = t.out_row[row];
        float* out = t.traj + static_cast<size_t>(slot) * stride;  // trajectory q at q * rows
        const float score = warp_forward_traj<C, 5>(t.a.xs + t.a.offsets[s], L, t.a.loops[s],
                                                    t.a.moves[s], esm, tr, chain, out, rows);
        for (int i = L + lane; i < stride; i += 32) {
#pragma unroll
            for (int q = 0; q < 5; ++q) out[q * rows + i] = 0.0f;
        }
        if (lane == 0) t.score[slot] = score;
    }
}

// One block per run of rows of one profile (`blocks`: first row, row
// count) in a width class of 32 * CMAX nodes.
template <int CMAX>
__global__ void __launch_bounds__(32 * D_WARPS<CMAX>, D_MIN_BLOCKS<CMAX>)
posterior_fwd_kernel(RowArgs a, const int32_t* __restrict__ blocks,
                     const int32_t* __restrict__ out_row, int n_out, float* __restrict__ traj,
                     float* __restrict__ score) {
    // the narrowest class holds every model length up to its width, the
    // others those above half their width
    constexpr int CMIN = CMAX <= 4 ? 1 : CMAX / 2 + 1;
    constexpr int WARPS = D_WARPS<CMAX>;
    extern __shared__ float smem[];  // [8][W] transitions, [21][W] emission odds

    const int first = blocks[2 * blockIdx.x];
    const int count = blocks[2 * blockIdx.x + 1];
    const int p = a.prof[first];
    const int c = min(max((a.model_len[p] + 31) / 32, CMIN), CMAX);
    stage_interleaved(smem, a.trans, a.e_odds, static_cast<size_t>(a.P) * a.Mp,
                      static_cast<size_t>(p) * a.Mp, a.model_len[p], c, 32 * WARPS);
    __syncthreads();

    const Rows t{a, out_row, smem, first, count, n_out, traj, score};
    posterior_rows<CMIN, CMAX>(c, t);
}

template <int THREADS, int CHUNK>
__global__ void __launch_bounds__(THREADS)
posterior_fwd_kernel_wide(RowArgs a, const int32_t* __restrict__ out_row, int n_out,
                          float* __restrict__ traj, float* __restrict__ score_out) {
    constexpr int WIDTH = THREADS * CHUNK;
    extern __shared__ float tsm[];  // [8][WIDTH] transition probabilities
    __shared__ ForwardScratch<THREADS> sh;

    const int r = blockIdx.x;
    const Row row = load_row(a, r);
    stage_planes<THREADS, WIDTH>(tsm, a.trans, N_TRANS, row);
    __syncthreads();

    const int slot = out_row[r];
    const size_t rows = static_cast<size_t>(n_out) * a.stride;
    float* out = traj + static_cast<size_t>(slot) * a.stride;  // slot q at out + q * rows
    float Mv[CHUNK], Iv[CHUNK], Dv[CHUNK];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) Mv[j] = Iv[j] = Dv[j] = 0.0f;
    float N = 1.0f, B = row.move, J = 0.0f, C = 0.0f;
    double ls = 0.0;  // in double, as warp_forward_traj's
    float score = NEG;

    for (int i = 0; i < row.L; ++i) {
        const float* e = emission_row(a.e_odds, row, i);
        ls += logf(forward_step<THREADS, CHUNK>(Mv, Iv, Dv, N, B, J, C, e, tsm, row.M,
                                                row.loop, row.move, sh));
        if (threadIdx.x == 0) {
            out[i] = N;
            out[rows + i] = B;
            out[2 * rows + i] = J;
            out[3 * rows + i] = C;
            out[4 * rows + i] = static_cast<float>(ls);
        }
        if (i == row.L - 1) score = static_cast<float>(logf(C * row.move + 1e-38f) + ls);
    }
    for (int i = row.L + threadIdx.x; i < a.stride; i += THREADS) {
#pragma unroll
        for (int q = 0; q < 5; ++q) out[q * rows + i] = 0.0f;
    }
    if (threadIdx.x == 0) score_out[slot] = score;
}

struct Out {
    const int32_t* out_row;
    int n_out;
    float* traj;
    float* score;
};

template <int C>
cudaError_t launch_warps(const RowArgs& a, const int32_t* blocks, int n_blocks, const Out& o,
                         cudaStream_t st) {
    const size_t smem = sizeof(float) * (N_TRANS + K_ALPHA) * 32 * C;
    cudaError_t err = allow_smem(posterior_fwd_kernel<C>, smem);
    if (err != cudaSuccess) return err;
    posterior_fwd_kernel<C><<<n_blocks, 32 * D_WARPS<C>, smem, st>>>(
        a, blocks, o.out_row, o.n_out, o.traj, o.score);
    return cudaGetLastError();
}

template <int THREADS, int CHUNK>
cudaError_t launch_wide(const RowArgs& a, const Out& o, cudaStream_t st) {
    const size_t smem = sizeof(float) * N_TRANS * THREADS * CHUNK;
    cudaError_t err = allow_smem(posterior_fwd_kernel_wide<THREADS, CHUNK>, smem);
    if (err != cudaSuccess) return err;
    posterior_fwd_kernel_wide<THREADS, CHUNK><<<a.n_rows, THREADS, smem, st>>>(
        a, o.out_row, o.n_out, o.traj, o.score);
    return cudaGetLastError();
}

}  // namespace

// Rows r < n_rows: sequence seq[r] against profile prof[r], written at
// output row out_row[r] of traj [5][n_out][stride] and score [n_out].
// Widths 128 to 1,024 take every row of one width class, cut by `blocks`
// [n_blocks][2] int32 (first row, row count) into runs of one profile
// (hmm.kernels.pair_blocks); widths 2,048 and 4,096 ignore it and take
// one block a row, every profile of model length <= width.  Returns a
// CUDA error code.
extern "C" int gecco_posterior_fwd(const void* xs, const void* offsets, const void* lens,
                                   const void* loops, const void* moves, const void* seq,
                                   const void* prof, int n_rows, const void* e_odds,
                                   const void* trans, const void* model_len, int P, int Mp,
                                   int width, int stride, const void* blocks, int n_blocks,
                                   const void* out_row, int n_out, void* traj, void* score,
                                   void* stream) {
    if (n_rows <= 0) return 0;
    const RowArgs a = make_row_args(xs, offsets, lens, loops, moves, seq, prof, n_rows, e_odds,
                                    trans, model_len, P, Mp, stride);
    const Out o{static_cast<const int32_t*>(out_row), n_out, static_cast<float*>(traj),
                static_cast<float*>(score)};
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
