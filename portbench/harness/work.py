"""The yardstick's arithmetic: the card's peaks, the bytes and operations a
kernel call must move and do, and the required work of a whole fit or
generate call.

Peaks are NVIDIA's data-sheet numbers for one H100 SXM at its full 700 W
limit: 3.35 TB/s of HBM and 67 TFLOP/s in float32 outside the tensor
cores (the configurations compute in float32). A share of a roofline or
of a peak is stated against them, with the card's power limit beside it.
"""
from __future__ import annotations

HBM_BYTES_S = 3.35e12
PEAK_FP32_FLOP_S = 67e12


def bound_s(nbytes: float, ops: float) -> float:
    """The least time of ``nbytes`` moved and ``ops`` done at the peaks."""
    return max(nbytes / HBM_BYTES_S, ops / PEAK_FP32_FLOP_S)


def hist_bytes_ops(n, p, out, S, n_nodes, n_bins, code_bytes, E=1):
    """Bytes a histogram call must move (each input read once, each output
    written once: E ensembles' codes and weights, S lanes' node ids,
    gradients and histograms) and the adds it does (one per row, feature
    and column of each lane)."""
    nbytes = (E * n * p * code_bytes + 4 * (S * n + S * n * out + E * n)
              + 4 * S * n_nodes * p * n_bins * (out + 1))
    return nbytes, n * p * S * out


def predict_bytes_ops(B, S, T, depth, p, out, n):
    """Bytes a forest-predict call must move (each input read once, the
    output written once) and the compares and adds it does."""
    H, L = 2 ** depth - 1, 2 ** depth
    nbytes = 4 * (B * n * p + 2 * B * S * T * H + B * S * T * L * out
                  + B * S * n * out)
    ops = B * S * n * T * (depth + out)
    return nbytes, ops


def fit_round_s(n: int, p: int, out: int, depth: int, n_bins: int) -> float:
    """The least time of one boosting round of one multi-output lane at
    the peaks: at every level the histograms written once and read once by
    the split search, the codes (1 byte, the least that holds the bins)
    and the gradients read once, one add per row, feature and output; then
    the leaf sums (gradients read, leaves written)."""
    total = 0.0
    for level in range(depth):
        hist = 4 * 2 ** level * p * n_bins * (out + 1)
        total += bound_s(2 * hist + n * p + 4 * n * out, n * p * out)
    leaves = 2 ** depth
    return total + bound_s(4 * n * out + 4 * leaves * (out + 1), n * out)


def generate_call_s(n_y: int, rows: int, p: int, T: int, depth: int,
                    out: int, steps: int) -> float:
    """The least time of an euler call of ``rows`` rows at the peaks: at
    each solver step the rows read and written once and the step's trees
    (every class's) read once, one add per row, tree and output."""
    H, L = 2 ** depth - 1, 2 ** depth
    trees = 4 * n_y * T * (2 * H + L * out)
    return steps * bound_s(8 * rows * p + trees, rows * T * out)
