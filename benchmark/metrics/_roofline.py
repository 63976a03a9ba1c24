"""Work and peak arithmetic of kernel A, the SSV filter (``csrc/ssv.cu``).

The filter scores every (protein, profile) pair: a cell is one residue
against one node, ``M_k = max(M_{k-1}, entry) + e_k(x_i)`` and a running
maximum for the exit, so ``OPS_PER_CELL`` = 3 (add, max, max), counted from
the inputs alone (the port's ``chip_smoke.py`` counts 4: it also subtracts
the loop score per cell, which another design folds away).

The peak is an upper bound on the rate at which an NVIDIA H100 SXM can do
the add and the max of a cell at any width the filter's tolerance admits
(HMMER scores SSV in saturating 8-bit lanes; 16 and 32 bits are as exact).
An SM issues at most 128 thread instructions a clock (four warp schedulers,
32 threads a clock each).  The most add and max operations one of them
does is 4: DPX's ``__viaddmax_s16x2`` (sm_90), the add and the max of two
16-bit cells.  sm_90 has no fused add and max on 8-bit lanes (the DPX
instructions take 16-bit pairs and 32-bit words), and the tensor cores do
no max.  So: 132 SMs x 128 x 4 x 1.98 GHz = 133.8 T operations a second,
the same figure as the card's fastest documented rate outside the tensor
cores (FP16 and BF16, non-tensor: 133.8 TFLOPS, a fused multiply-add
counted as two).  No design of the filter can read over 100%.
Bytes: each residue once (1 B), each node's 20 match scores once at 8 bits,
each pair's float32 score written once; HBM3 at 3.35 TB/s.
Source: NVIDIA H100 Tensor Core GPU Architecture whitepaper (132 SMs,
1,980 MHz boost, the SM's four partitions each with a 32 thread/clk warp
scheduler and dispatch unit, DPX, the non-tensor FP16 peak), the CUDA Math
API's DPX intrinsics, and the H100 data sheet (HBM rate); the limit of
the card that ran is printed beside every reading.
"""

from typing import Iterable

SMS, ISSUE_PER_CLOCK, BOOST_HZ, OPS_PER_INSTRUCTION = 132, 128, 1.98e9, 4
PEAK_OPS = SMS * ISSUE_PER_CLOCK * BOOST_HZ * OPS_PER_INSTRUCTION
PEAK_BYTES = 3.35e12
OPS_PER_CELL = 3
PEAK_SOURCE = ("H100 SXM: 132 SMs x 128 thread instructions a clock x 1.98 GHz x 4 ops "
               "(DPX viaddmax_s16x2: add and max of two 16-bit cells) = %.4g ops/s; "
               "HBM3 3.35 TB/s" % PEAK_OPS)
#: the port's node-width classes (``hmm/bank.py::width_class``): one launch of
#: kernel A each
MIN_WIDTH = 128


def width_class(M: int) -> int:
    return max(MIN_WIDTH, 1 << max(0, int(M) - 1).bit_length())


def classes(lengths: Iterable[int]) -> int:
    return len({width_class(M) for M in lengths})


def ssv_bound_s(residues: Iterable[int], lengths: Iterable[int]) -> float:
    """The least time of the filter over every pair of these proteins and
    profiles: the larger of its operations and its bytes over the peaks."""
    residues, lengths = list(residues), list(lengths)
    cells = float(sum(residues)) * float(sum(lengths))
    nbytes = float(sum(residues)) + 20.0 * float(sum(lengths)) + 4.0 * len(residues) * len(lengths)
    return max(cells * OPS_PER_CELL / PEAK_OPS, nbytes / PEAK_BYTES)
