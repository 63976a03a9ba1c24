// Kernel B: Viterbi (max-plus, log space) scores of listed pairs.
//
// Replaces gecco_tpu/hmm/kernels.py::_pallas_pair_fwd_ilp in its log-space
// Viterbi form (the F2 gate of SearchPipeline.search), and
// _pallas_pair_fwd where F2 took it for profiles of 2048 nodes or more.
// For each (sequence, profile) pair it runs the Plan7 M/I/D max-plus
// recurrence of kernels.py:1397-1427:
//
//   M_k = e_k(x_i) + max(max(M_{k-1} + tmm, I_{k-1} + tim, D_{k-1} + tdm)_{k-1},
//                         B + bm_k)
//   I_k = max(M_k + tmi_k, I_k + tii_k)                  (previous row)
//   D_j = S_{j-1} + max_{i<j} (M_i + log tmd_i - S_i),    S = prefix sum of log tdd
//   E = max_k M_k, J/C/N/B as HMMER's multihit length model,
//
// and returns C + move in nats.  Slots 5 and 6 of the transition tensor
// hold log tmd - S and S_{j-1} (gecco_tpu_torch.hmm.bank).
//
// With per-row windows (`starts`, `ends`, 0-based half-open; null for the
// whole sequence) it also replaces _pallas_pair_fwd's Viterbi over a
// residue window (`ranges`): the recurrence starts afresh at `start`, ends
// at `end`, under the WHOLE sequence's loop and move.  An empty window
// scores -inf, as the TPU kernel's probability-space log(0 + 1e-38) does
// where 1e-38, a subnormal, is flushed.
//
// Bound on the H100: operations and shared-memory reads.  ~15 float
// operations a DP cell (11 for the M/I/D updates, 3 for the delete chain,
// 1 for E) against the float32 peak, and with the transitions in shared
// memory nine shared reads a cell (eight transitions and the emission),
// which at 32 floats a clock an SM cap it near 3.6 cells a clock an SM.
// A pair is one serial dependency chain over its residues, so the card
// needs many pairs in flight.
//
// Design, widths 128 to 1,024: one warp scores one pair, lane l holding
// the nodes [l*C, (l+1)*C) of M, I and D in registers (C = width / 32).
// The host orders the rows by width class and profile and hands each block
// a run of at most a few rows of ONE profile (`blocks`: first row and row
// count); the block stages that profile's 8 log-transition rows and 21
// log-odds rows once, lane-interleaved (node l*C + j at j*32 + l) so that
// a warp's reads fall in 32 banks, and its warps take the rows in turn
// (a shared counter).  At C <= 8 (widths 128 and 256) each lane also keeps
// its nodes' transitions in registers, which leaves one shared read a cell.
// Per residue: one __shfl_up_sync hands the last node's stay to lane l+1;
// the lane rewrites its nodes from the top down; the delete chain's
// exclusive prefix maximum is a five-step shuffle scan of the lanes'
// maxima; E is one redux maximum; every lane updates J, C, N and B
// itself.  No barrier runs inside the residue loop.  The next residue's
// emissions are read from shared memory one step ahead, and the warp
// reads its residues as aligned words, every lane the same address
// (ResidueStream).  (A block per pair would need two __syncthreads a
// residue to hand nodes across warps and combine their maxima, and would
// stage its profile's transitions once per pair.)
//
// Design, widths 2,048 and 4,096: one block per pair (rows in the host's
// order), each thread owning CHUNK consecutive nodes, two barriers a
// residue.  64 or 128 nodes a lane of M, I and D would not stay in
// registers, and these classes hold 3 of 2,766 Pfam-sized profiles.
//
// Both designs keep the order of operations of the plain version
// (gecco_tpu_torch.hmm.kernels.viterbi_pairs_plain); max-plus is exact, so
// the scores equal it bit for bit.  Nodes at or past the model length
// hold NEG and never feed a real node.
#include "common.cuh"

using namespace gecco;

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;

// warps a block: 4 where a lane's nodes and transitions take many
// registers in few nodes (C <= 8), 8 where the staged tables (116 bytes a
// node) leave room for few blocks an SM
template <int C>
constexpr int VIT_WARPS = C <= 8 ? 4 : 8;

template <int C>
__global__ void __launch_bounds__(32 * VIT_WARPS<C>)
viterbi_kernel(const int8_t* __restrict__ xs, const int64_t* __restrict__ offsets,
               const int32_t* __restrict__ lens, const float* __restrict__ loops,
               const float* __restrict__ moves, const int32_t* __restrict__ pair_seq,
               const int32_t* __restrict__ pair_prof, const float* __restrict__ e_log,
               const float* __restrict__ trans_log, const int32_t* __restrict__ model_len,
               int P, int Mp, const int32_t* __restrict__ blocks,
               const int32_t* __restrict__ starts, const int32_t* __restrict__ ends,
               float* __restrict__ out) {
    constexpr int W = 32 * C;
    constexpr bool TREG = C <= 8;
    // [8][W] log transitions, then [21][W] log-odds; lane-interleaved
    extern __shared__ float smem[];
    __shared__ int next_row;

    const int first = blocks[2 * blockIdx.x];
    const int count = blocks[2 * blockIdx.x + 1];
    const int p = pair_prof[first];
    const int M = model_len[p];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const size_t plane = static_cast<size_t>(P) * Mp;
    const size_t prow = static_cast<size_t>(p) * Mp;

    for (int idx = threadIdx.x; idx < (8 + K_ALPHA) * W; idx += 32 * VIT_WARPS<C>) {
        const int slot = idx / W;
        const int k = idx - slot * W;
        const int owner = k / C;
        const float* src = slot < 8 ? trans_log + slot * plane : e_log + (slot - 8) * plane;
        smem[slot * W + (k - owner * C) * 32 + owner] = k < M ? src[prow + k] : NEG;
    }
    if (threadIdx.x == 0) next_row = VIT_WARPS<C>;
    __syncthreads();

    const float* tsm = smem + lane;
    const float* esm = smem + 8 * W + lane;
    float treg[8][TREG ? C : 1];
    if constexpr (TREG) {
#pragma unroll
        for (int slot = 0; slot < 8; ++slot)
#pragma unroll
            for (int j = 0; j < C; ++j) treg[slot][j] = tsm[slot * W + j * 32];
    }
// transition `slot` of this lane's node j
#define TR(slot, j) (TREG ? treg[slot][TREG ? (j) : 0] : tsm[(slot) * W + (j) * 32])

    const bool windowed = starts != nullptr;
    const int nvalid = M - lane * C;  // this lane's nodes j < nvalid are real
    int r = warp;
    while (r < count) {
        const int pair = first + r;
        const int s = pair_seq[pair];
        const int start = windowed ? starts[pair] : 0;
        const int L = windowed ? ends[pair] - start : lens[s];
        const float loop = loops[s];
        const float move = moves[s];

        float Mv[C], Iv[C], Dv[C], e[C];
#pragma unroll
        for (int j = 0; j < C; ++j) Mv[j] = Iv[j] = Dv[j] = NEG;
        float N = 0.0f, B = move, J = NEG, Cs = NEG;
        ResidueStream x(xs + offsets[s] + start, L);
        {
            const int x0 = L > 0 ? x.next() : 0;
#pragma unroll
            for (int j = 0; j < C; ++j) e[j] = esm[x0 * W + j * 32];
        }
        for (int i = 0; i < L; ++i) {
            // the next residue's emissions, one step ahead
            const int xn = i + 1 < L ? x.next() : 0;
            float en[C];
#pragma unroll
            for (int j = 0; j < C; ++j) en[j] = esm[xn * W + j * 32];
            float prev = __shfl_up_sync(
                FULL_MASK,
                fmaxf(fmaxf(Mv[C - 1] + TR(0, C - 1), Iv[C - 1] + TR(1, C - 1)),
                      Dv[C - 1] + TR(2, C - 1)),
                1);
            if (lane == 0) prev = NEG;
            // descending, so node j-1 still holds the previous row
#pragma unroll
            for (int j = C - 1; j >= 0; --j) {
                const int q = j > 0 ? j - 1 : 0;
                const float tmm = TR(0, q), tim = TR(1, q), tdm = TR(2, q);
                const float tmi = TR(3, j), tii = TR(4, j), bm = TR(7, j);
                const float stay =
                    j > 0 ? fmaxf(fmaxf(Mv[q] + tmm, Iv[q] + tim), Dv[q] + tdm) : prev;
                if (j < nvalid) {
                    const float mn = e[j] + fmaxf(stay, B + bm);
                    Iv[j] = fmaxf(Mv[j] + tmi, Iv[j] + tii);
                    Mv[j] = mn;
                } else {
                    Mv[j] = NEG;
                    Iv[j] = NEG;
                }
            }
            // delete chain: exclusive prefix max of M + (log tmd - S); E = max M
            // (two running maxima each: max is exact in any order)
            float emax[2] = {NEG, NEG}, incl[2] = {NEG, NEG};
#pragma unroll
            for (int j = 0; j < C; ++j) {
                emax[j & 1] = fmaxf(emax[j & 1], Mv[j]);
                incl[j & 1] = fmaxf(incl[j & 1], Mv[j] + TR(5, j));
            }
            float run = fmaxf(incl[0], incl[1]);
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const float y = __shfl_up_sync(FULL_MASK, run, o);
                if (lane >= o) run = fmaxf(run, y);
            }
            run = __shfl_up_sync(FULL_MASK, run, 1);
            if (lane == 0) run = NEG;
#pragma unroll
            for (int j = 0; j < C; ++j) {
                const float Sm1 = TR(6, j), tmdS = TR(5, j);
                Dv[j] = j < nvalid ? Sm1 + run : NEG;
                run = fmaxf(run, Mv[j] + tmdS);
            }
            const float Elm = warp_max_redux(fmaxf(emax[0], emax[1])) + LOG_HALF;
            J = fmaxf(J + loop, Elm);
            Cs = fmaxf(Cs + loop, Elm);
            N = N + loop;
            B = fmaxf(N, J) + move;
#pragma unroll
            for (int j = 0; j < C; ++j) e[j] = en[j];
        }
        if (lane == 0) out[pair] = windowed && L == 0 ? -INFINITY : Cs + move;
        int taken = 0;
        if (lane == 0) taken = atomicAdd(&next_row, 1);
        r = __shfl_sync(FULL_MASK, taken, 0);
    }
#undef TR
}

template <int THREADS, int CHUNK>
__global__ void __launch_bounds__(THREADS)
viterbi_kernel_wide(const int8_t* __restrict__ xs, const int64_t* __restrict__ offsets,
                    const int32_t* __restrict__ lens, const float* __restrict__ loops,
                    const float* __restrict__ moves, const int32_t* __restrict__ pair_seq,
                    const int32_t* __restrict__ pair_prof, const float* __restrict__ e_log,
                    const float* __restrict__ trans_log, const int32_t* __restrict__ model_len,
                    int P, int Mp, const int32_t* __restrict__ starts,
                    const int32_t* __restrict__ ends, float* __restrict__ out) {
    constexpr int WIDTH = THREADS * CHUNK;
    constexpr int WARPS = THREADS / 32;
    extern __shared__ float tsm[];  // [8][WIDTH] log transitions
    __shared__ float sh_stay[THREADS];
    __shared__ float sh_scan[WARPS];
    __shared__ float sh_emax[WARPS];

    const int pair = blockIdx.x;
    const int s = pair_seq[pair];
    const int p = pair_prof[pair];
    const int M = model_len[p];
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const size_t plane = static_cast<size_t>(P) * Mp;
    const size_t row = static_cast<size_t>(p) * Mp;

    for (int idx = tid; idx < 8 * WIDTH; idx += THREADS) {
        const int slot = idx / WIDTH;
        const int k = idx - slot * WIDTH;
        tsm[idx] = k < M ? trans_log[slot * plane + row + k] : NEG;
    }
    __syncthreads();
    const float* tmm = tsm;
    const float* tim = tsm + WIDTH;
    const float* tdm = tsm + 2 * WIDTH;
    const float* tmi = tsm + 3 * WIDTH;
    const float* tii = tsm + 4 * WIDTH;
    const float* tmdS = tsm + 5 * WIDTH;
    const float* Sm1 = tsm + 6 * WIDTH;
    const float* bm = tsm + 7 * WIDTH;

    const bool windowed = starts != nullptr;
    const int start = windowed ? starts[pair] : 0;
    const int L = windowed ? ends[pair] - start : lens[s];
    const int8_t* x = xs + offsets[s] + start;
    const float loop = loops[s];
    const float move = moves[s];
    const int base = tid * CHUNK;

    float Mv[CHUNK], Iv[CHUNK], Dv[CHUNK];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) Mv[j] = Iv[j] = Dv[j] = NEG;
    float N = 0.0f, B = move, J = NEG, C = NEG;

    for (int i = 0; i < L; ++i) {
        const float* e = e_log + static_cast<size_t>(x[i]) * plane + row;
        {
            const int k = base + CHUNK - 1;
            sh_stay[tid] = fmaxf(fmaxf(Mv[CHUNK - 1] + tmm[k], Iv[CHUNK - 1] + tim[k]),
                                 Dv[CHUNK - 1] + tdm[k]);
        }
        __syncthreads();
        const float prev = tid > 0 ? sh_stay[tid - 1] : NEG;
        // descending, so node j-1 still holds the previous row
#pragma unroll
        for (int j = CHUNK - 1; j >= 0; --j) {
            const int k = base + j;
            const int q = j > 0 ? j - 1 : 0;  // node k-1 of this chunk
            const float stay =
                j > 0 ? fmaxf(fmaxf(Mv[q] + tmm[base + q], Iv[q] + tim[base + q]),
                              Dv[q] + tdm[base + q])
                      : prev;
            if (k < M) {
                const float mn = __ldg(e + k) + fmaxf(stay, B + bm[k]);
                Iv[j] = fmaxf(Mv[j] + tmi[k], Iv[j] + tii[k]);
                Mv[j] = mn;
            } else {
                Mv[j] = NEG;
                Iv[j] = NEG;
            }
        }
        // delete chain: exclusive prefix max of M + (log tmd - S)
        float emax = NEG;
        float incl = NEG;
#pragma unroll
        for (int j = 0; j < CHUNK; ++j) {
            emax = fmaxf(emax, Mv[j]);
            incl = fmaxf(incl, Mv[j] + tmdS[base + j]);
        }
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const float y = __shfl_up_sync(FULL_MASK, incl, o);
            if (lane >= o) incl = fmaxf(incl, y);
        }
        float run = __shfl_up_sync(FULL_MASK, incl, 1);
        if (lane == 0) run = NEG;
        emax = warp_max(emax);
        if (lane == 31) sh_scan[warp] = incl;
        if (lane == 0) sh_emax[warp] = emax;
        __syncthreads();
        float E = NEG;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
            if (w < warp) run = fmaxf(run, sh_scan[w]);
            E = fmaxf(E, sh_emax[w]);
        }
#pragma unroll
        for (int j = 0; j < CHUNK; ++j) {
            const int k = base + j;
            Dv[j] = k < M ? Sm1[k] + run : NEG;
            run = fmaxf(run, Mv[j] + tmdS[k]);
        }
        const float Elm = E + LOG_HALF;
        J = fmaxf(J + loop, Elm);
        C = fmaxf(C + loop, Elm);
        N = N + loop;
        B = fmaxf(N, J) + move;
    }
    if (tid == 0) out[pair] = windowed && L == 0 ? -INFINITY : C + move;
}

struct Args {
    const int8_t* xs;
    const int64_t* offsets;
    const int32_t* lens;
    const float* loops;
    const float* moves;
    const int32_t* pair_seq;
    const int32_t* pair_prof;
    const float* e_log;
    const float* trans_log;
    const int32_t* model_len;
    int P, Mp;
    const int32_t* starts;
    const int32_t* ends;
    float* out;
};

template <int C>
cudaError_t launch_warps(const Args& a, const int32_t* blocks, int n_blocks, cudaStream_t st) {
    const size_t smem = sizeof(float) * (8 + K_ALPHA) * 32 * C;
    cudaError_t err = allow_smem(viterbi_kernel<C>, smem);
    if (err != cudaSuccess) return err;
    viterbi_kernel<C><<<n_blocks, 32 * VIT_WARPS<C>, smem, st>>>(
        a.xs, a.offsets, a.lens, a.loops, a.moves, a.pair_seq, a.pair_prof, a.e_log, a.trans_log,
        a.model_len, a.P, a.Mp, blocks, a.starts, a.ends, a.out);
    return cudaGetLastError();
}

template <int THREADS, int CHUNK>
cudaError_t launch_wide(const Args& a, int n_pairs, cudaStream_t st) {
    const size_t smem = sizeof(float) * 8 * THREADS * CHUNK;
    cudaError_t err = allow_smem(viterbi_kernel_wide<THREADS, CHUNK>, smem);
    if (err != cudaSuccess) return err;
    viterbi_kernel_wide<THREADS, CHUNK><<<n_pairs, THREADS, smem, st>>>(
        a.xs, a.offsets, a.lens, a.loops, a.moves, a.pair_seq, a.pair_prof, a.e_log, a.trans_log,
        a.model_len, a.P, a.Mp, a.starts, a.ends, a.out);
    return cudaGetLastError();
}

}  // namespace

// Scores n_pairs (pair_seq[r], pair_prof[r]) pairs whose profiles all have
// model length <= width (128, 256, ..., 4096); starts/ends [n_pairs] int32
// are the rows' residue windows (0 <= start <= end <= length), or both null
// for whole sequences.  blocks [n_blocks][2] int32 (first row, row count)
// cut the rows into runs of one profile each, one block a run; widths 2048
// and 4096 ignore it and take one block a row.  Writes out[r]; returns a
// CUDA error code.
extern "C" int gecco_viterbi_pairs(const void* xs, const void* offsets, const void* lens,
                                   const void* loops, const void* moves, const void* pair_seq,
                                   const void* pair_prof, int n_pairs, const void* e_log,
                                   const void* trans_log, const void* model_len, int P, int Mp,
                                   int width, const void* blocks, int n_blocks,
                                   const void* starts, const void* ends, void* out,
                                   void* stream) {
    if (n_pairs <= 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const Args a{static_cast<const int8_t*>(xs), static_cast<const int64_t*>(offsets),
                 static_cast<const int32_t*>(lens), static_cast<const float*>(loops),
                 static_cast<const float*>(moves), static_cast<const int32_t*>(pair_seq),
                 static_cast<const int32_t*>(pair_prof), static_cast<const float*>(e_log),
                 static_cast<const float*>(trans_log), static_cast<const int32_t*>(model_len),
                 P, Mp, static_cast<const int32_t*>(starts), static_cast<const int32_t*>(ends),
                 static_cast<float*>(out)};
    const int32_t* runs = static_cast<const int32_t*>(blocks);
    if (width <= 1024 && (runs == nullptr || n_blocks <= 0)) return cudaErrorInvalidValue;
    cudaError_t err;
    switch (width) {
        case 128: err = launch_warps<4>(a, runs, n_blocks, st); break;
        case 256: err = launch_warps<8>(a, runs, n_blocks, st); break;
        case 512: err = launch_warps<16>(a, runs, n_blocks, st); break;
        case 1024: err = launch_warps<32>(a, runs, n_blocks, st); break;
        case 2048: err = launch_wide<256, 8>(a, n_pairs, st); break;
        case 4096: err = launch_wide<256, 16>(a, n_pairs, st); break;
        default: err = cudaErrorInvalidValue;
    }
    return static_cast<int>(err);
}
