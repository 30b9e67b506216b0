"""The chip's published peaks and the least work of the port's two
physics kernels at a cell's shapes.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the full 700 W power limit
(the run prints the card's own limit beside every share).  Work is counted
from the shapes alone, as the least the algorithm needs: every input byte
read once and every output byte written once, and for the hull sweep its
operations (the Newton solve's operations depend on its iteration counts,
which the env step does not expose, so its bound is its bytes alone).
"""

from __future__ import annotations

H100_BYTES_PER_S = 3.35e12      # HBM3
H100_F32_FLOPS = 67e12          # float32 outside the tensor cores
CDIM = 4                        # constraint rows per contact slot


def hull_sweep_work(B, G, ND, P, Vmax, counts):
    """(bytes, operations) of one hull sweep over B envs: G hull geoms
    with `counts` vertices each (padded to Vmax in the vertex table), ND
    directions, P hull pairs.  Inputs: poses p (3G, B) and R (9G, B), the
    vertex table (G, 3 Vmax), the directions (ND, 3), the counts and the
    pair indices (int32); output: depth and normal (4P, B).  Operations per
    env and direction: 15 for the local direction, 5 per vertex support
    and 2 per vertex max/min after the first, 5 for d.p and 2 adds per
    geom; a subtract and a compare per pair."""
    nbytes = 4 * (3 * G * B + 9 * G * B + G * 3 * Vmax + ND * 3 + 4 * P * B) \
        + 4 * (G + 2 * P)
    ops = B * ND * (sum(27 + 7 * (v - 1) for v in counts) + 2 * P)
    return nbytes, ops


def newton_solve_bytes(B, nv, neq, nf, nl, K):
    """Bytes of one fused Newton solve over B envs: the packed inputs
    J (nv NE, B), aref and D (NE, B), aux (2 nf + 2 K + 1, B), the cone
    scales (CDIM K, B), the lower triangle of M (nv (nv + 1) / 2, B), the
    unconstrained and warm-start accelerations (nv, B) each, read once, and
    the (2 nv + 1, B) result written once; NE = neq + nf + nl + CDIM K."""
    NE = neq + nf + nl + CDIM * K
    rows = nv * NE + 2 * NE + (2 * nf + 2 * K + 1) + CDIM * K \
        + nv * (nv + 1) // 2 + 2 * nv + (2 * nv + 1)
    return 4 * rows * B


def least_seconds(nbytes, ops=0.0):
    """The least time the chip needs: the larger of the bytes at the
    memory bandwidth and the operations at the float32 rate."""
    return max(nbytes / H100_BYTES_PER_S, ops / H100_F32_FLOPS)
