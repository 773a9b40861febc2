"""Operations and bytes of the forward blend (K1), the backward blend (K3)
and the per-gaussian reduce (K4), per (pixel, row) pair and per row, frozen
here so that a later change to a kernel cannot move its yardstick.

Derivation. A "visited" pair is a pixel and a row of its tile's
depth-sorted list that the pixel needs: the rows it meets while its
transmittance T is still above 1e-4 (GOF blends nothing after that). An
"active" pair is a visited pair whose alpha passes (the peak depth beyond
the near plane and alpha >= 1/255). Both are counted by the benchmark's own
binning and blend (benchmark/reference/gof.py) on the cell's inputs, never
read from the program.

f32 operations, each add, multiply, compare-and-select, divide, exp, sqrt
or rsqrt one, a fused multiply-add two:

- CHAIN (41, every visited pair, forward and backward alike): the ray
  (rx, ry, 1) through the pixel in the gaussian's frame, d = M r (6
  multiplies, 6 adds), d.d (5), u0.d (5), t = -u0.d / d.d (2), v = u0 + t d
  (6), |v|^2 (5), alpha = min(op exp(-|v|^2 / 2), 0.99) (4), the two
  activity tests (2).
- FWD_BLEND (11, every active pair): the T > 1e-4 test, the weight a T
  (2), three colour sums (6), the alpha sum and the T update (2).
- FWD_REG (39, every active pair, with the regularizer channels): the NDC
  depth of t (5), the normal M^T d (15) normalised (6: dot, rsqrt, 3
  scales) and summed (3), the distortion's two sums (4), the median test
  and its select (6).
- BWD_GRAD (53, every active pair): the colour, alpha and transmittance
  gradients of the pair back through alpha, v, t and d to the row's 16
  values (rgb 3, opacity 1, M 9, u0 3).
- BWD_REG (81, with the regularizer channels): the normal's and depth's
  and distortion's share of the same chain.
- BWD_STATS (23, with the densification statistics): the screen-space
  gradient of the mean through the conic.

Bytes, each read once and each written once:

- K1 reads its walked rows (16 floats each) and the tile bounds, and writes
  per pixel the 9 image channels and the 3 the backward keeps (final T,
  the distortion sum, the median's index).
- K3 reads the walked rows, the forward's 12 per-pixel floats and the
  image's 9-channel gradient, and writes per walked row its 16 gradient
  floats and its gaussian id.
- K4 reads those per-row gradients and ids once and writes the 16 summed
  floats of every gaussian that appears among them.

A tile's walked rows are the rows up to the last one any of its pixels
needs.
"""

CHAIN = 41
FWD_BLEND = 11
FWD_REG = 39
BWD_GRAD = 53
BWD_REG = 81
BWD_STATS = 23
ROW_FLOATS = 16
FWD_KEEP = 12
IMAGE_CH = 9

K1 = ("fwd_kernel",)
K3 = ("order_kernel", "bwd_kernel")
K4 = ("count_kernel", "scan_kernel", "fill_kernel", "reduce_kernel")


def k1(visited: int, active: int, rows: int, pixels: int, tiles: int, with_reg: bool) -> dict:
    return {"ops": visited * CHAIN + active * (FWD_BLEND + FWD_REG * with_reg),
            "bytes": 4 * (rows * ROW_FLOATS + (tiles + 1) + pixels * IMAGE_CH
                          + pixels * (FWD_KEEP - IMAGE_CH))}


def k3(visited: int, active: int, rows: int, pixels: int, with_reg: bool,
       with_stats: bool) -> dict:
    grad = BWD_GRAD + BWD_REG * with_reg + BWD_STATS * with_stats
    return {"ops": visited * CHAIN + active * grad,
            "bytes": 4 * (rows * ROW_FLOATS + pixels * (FWD_KEEP + IMAGE_CH)
                          + rows * (ROW_FLOATS + 1))}


def k4(rows: int, gaussians: int) -> dict:
    return {"ops": rows * ROW_FLOATS,
            "bytes": 4 * (rows * (ROW_FLOATS + 1) + gaussians * ROW_FLOATS)}
