"""f32 operations of one whole unit of work, frozen, for the `mfu`
metrics: a training step, an eval render, a field call.

Derivation (each add, multiply, select, divide, exp, sqrt one):

- PREPROCESS (610 a gaussian, every slot of the model): the 3D filter on
  scale and opacity (27), the SH mask (48), depth and NDC projection (31),
  the rotation (49), the 3D covariance (51), the EWA 2D covariance with
  the dilation and its compensation (137), the conic (8), the screen
  extent (20), SH degree 3 colour (143), the view-to-gaussian factor M, u0
  (99). PREPROCESS_BWD is twice that, reverse mode's usual cost.
- The blend, forward and backward: K1's and K3's counts (blend.py) on the
  step's visited and active pairs, and K4's adds.
- LOSS (2,400 a pixel, forward and backward): L1 (9), SSIM's five 11+11-tap
  separable blurs of 3 channels (660) and its formula (60), the
  depth-to-normal (40), the depth-normal term (25) and the distortion mean
  (1), about 800 forward; twice that backward.
- ADAM (14 a parameter): both moments (7), the bias-corrected update (6)
  and its add (1), over the 59 floats of a gaussian at SH degree 3.

A step whose liveness bound proved stale runs the forward half only (the
preprocess, K1 and the loss forward, LOSS_FWD) and no update.

An eval render is the preprocess and K1. A field call is, per view, the
preprocess without colour or 3D filter (PREPROCESS_FIELD, 405 a gaussian:
PREPROCESS less the filter 27, the SH mask 48 and degree-3 colour 143, plus
degree-0 colour 13) and K5; the point binning is integer work.
"""

PREPROCESS = 610
PREPROCESS_BWD = 2 * PREPROCESS
PREPROCESS_FIELD = 405
LOSS = 2400
LOSS_FWD = 800
ADAM = 14
PARAMS_PER_GAUSSIAN = 59


def ops(gaussians: int, pixels: int, k1_ops: float, k3_ops: float, k4_ops: float,
        backward: bool = True) -> float:
    if not backward:
        return gaussians * PREPROCESS + pixels * LOSS_FWD + k1_ops
    return (gaussians * (PREPROCESS + PREPROCESS_BWD + ADAM * PARAMS_PER_GAUSSIAN)
            + pixels * LOSS + k1_ops + k3_ops + k4_ops)


def render_ops(gaussians: int, k1_ops: float) -> float:
    return gaussians * PREPROCESS + k1_ops


def field_ops(gaussians: int, views: int, k5_ops: float) -> float:
    return gaussians * views * PREPROCESS_FIELD + k5_ops
