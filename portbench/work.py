"""The yardstick of the roofline shares: the work a pass-A call and a rebin
move need, counted from the physics, and the card's published peaks.

The counts do not look at how a kernel packs its rows or pads its slots,
so they read the same whatever implements the pass:

- bytes: each valid particle's rows that the pass needs, read once, and
  each row it produces, written once, 4 bytes a row (float32);
- operations: the ordered pairs inside the support h (full neighbour
  lists: each pair is evaluated from both of its ends), counted by the
  benchmark on the state's positions, times the float32 operations the
  pair body costs (``PAIR_FLOPS``, derived below);
- the move: each valid particle's rows that live from one step to the
  next, read once and written once.  Its integer work is not counted.
"""

from __future__ import annotations

# NVIDIA H100 SXM, data sheet, dense: HBM3 bytes/s and float32 FLOP/s
# outside the tensor cores.  Both assume the card's 700 W power limit.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12


def pass_a_rows(dim: int, filt: bool) -> tuple:
    """(rows in, rows out) per particle of the transport-velocity pass A.
    In: x, v, vest (dim each), rho, the type (mass, B, c0 and the pair
    tables follow from it) and the wall flag; rhoI on Shepard-filter steps.
    Out: f, ddv and the wall normal nw (dim each), drho, de, the number
    density and the wall fraction phi; the two Shepard sums on filter
    steps."""
    rows_in = 3 * dim + 3 + (1 if filt else 0)
    rows_out = 3 * dim + 4 + (2 if filt else 0)
    return rows_in, rows_out


# float32 operations of one ordered pair inside the support, transport-
# velocity body, counted term by term (a multiply-add counts as 2; a
# square root and a reciprocal as 1 each).  d = dim components:
#   separation and distance: dx (d), r^2 (2d - 1), r (1), q (1)      -> 3d + 1
#   kernel: 1 - q, clamp, W (5), W'/r (2)                          -> 9
#   number density V_j^2 W (2), ddv 70 B (Vi^2+Vj^2) W' dx (3 + 2d)  -> 2d + 5
#   momentum: velvec (d), transport tensor: (v-vest).dx twice
#     (2 (3d - 1)), the two rho b vest products and their half sum
#     (4d + 2), times (Vi^2+Vj^2) W' (d + 1); viscosity (2) times velvec
#     (2d); pressure with the switch (6) times dx (2d); artificial
#     stress (wf/wdelta)^4 and its coefficient (7) times dx (2d);
#     the sum into f (4d)                                          -> 17d + 14
#   continuity: (v_i - v_j).dx (3d - 1), the two transport corrections
#     (2 (3d - 1) + 3), the products (6)                           -> 9d + 6
#   energy de (2d + 6), wall fraction and normal (3 + 2d)          -> 4d + 9
PAIR_FLOPS = {d: (3 * d + 1) + 9 + (2 * d + 5) + (17 * d + 14) + (9 * d + 6)
              + (4 * d + 9) for d in (2, 3)}


def pass_a_bound(n_valid: int, pairs: int, dim: int, filt: bool) -> tuple:
    """(seconds, what bounds it): the least time one pass-A call over
    ``n_valid`` particles with ``pairs`` ordered pairs inside the support
    could take on the card."""
    rows_in, rows_out = pass_a_rows(dim, filt)
    t_bytes = 4 * n_valid * (rows_in + rows_out) / PEAK_BYTES
    t_ops = pairs * PAIR_FLOPS[dim] / PEAK_F32
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def move_rows(dim: int, n_species: int) -> int:
    """Rows a particle carries from one step to the next: x, v, vest, f and
    ddv (dim each), rho and drho, its tag, its type and its wall flags, and
    one count per stochastic species."""
    return 5 * dim + 2 + 3 + n_species


def move_bound(n_valid: int, dim: int, n_species: int) -> tuple:
    """(seconds, "bytes"): the least time one rebin move could take."""
    return 2 * 4 * n_valid * move_rows(dim, n_species) / PEAK_BYTES, "bytes"
