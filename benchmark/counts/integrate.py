"""Operations and bytes of the opacity-field integrate (K5), frozen.

Derivation. GOF's integrate has no early exit: a query point multiplies
(1 - alpha) over every row of its tile's list. So the pairs the inputs need
are, per view, the sum over tiles of (points projecting into the tile) x
(rows binned to the tile), counted by the benchmark's own binning
(benchmark/reference/render.py) on the cell's tetra points.

f32 operations per pair (45): the point's ray (rx, ry, 1) in the
gaussian's frame, d = M r (12), d.d (5), u0.d (5), t = -u0.d / d.d (2),
the depth clamp min(t, z) (1), v = u0 + t* d (6), |v|^2 (5), alpha =
min(op exp(-|v|^2 / 2), 0.99) (4), the two activity tests and the select
(3), T *= 1 - alpha (2).

Bytes per view, each once: the tile lists' rows (16 floats), the tile
bounds, each point's ray (3 floats), id and result.
"""

PAIR_OPS = 45
ROW_FLOATS = 16
POINT_FLOATS = 5

K5 = ("integrate_kernel",)


def k5(pairs: int, rows: int, points: int, tiles: int) -> dict:
    return {"ops": pairs * PAIR_OPS,
            "bytes": 4 * (rows * ROW_FLOATS + (tiles + 1) + points * POINT_FLOATS)}
