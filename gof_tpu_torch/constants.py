"""Rendering constants.

A copy of gof_tpu/constants.py. Mirrors the semantic constants of the
reference rasterizer (diff-gaussian-rasterization cuda_rasterizer/
auxiliary.h:18-36, config.h:15-17). The tile stays 32x32 pixels as in
gof_tpu, so binning compares slot by slot with the JAX package.
"""

# Ray-marching clip planes used by the blend quadratic and the 2DGS NDC depth
# mapping (auxiliary.h:27-28).
NEAR_PLANE = 0.2
FAR_PLANE = 100.0

# A Gaussian below this alpha is skipped (forward.cu:534).
ALPHA_MIN = 1.0 / 255.0
# Alpha is clamped to this maximum (forward.cu:533).
ALPHA_MAX = 0.99
# Blending terminates once transmittance falls below this (forward.cu:537).
TRANSMITTANCE_EPS = 1e-4
# A pixel is "unsaturated" for the median-depth channel while T > 0.5
# (forward.cu:568-571).
MEDIAN_THRESHOLD = 0.5

# TPU-native tile geometry: 32x32 spatial pixels laid out row-major into an
# (8, 128) block so every VPU op is fully lane-utilized.
TILE_W = 32
TILE_H = 32
TILE_PIXELS = TILE_W * TILE_H  # 1024
TILE_SUBLANES = 8
TILE_LANES = 128

# Output image channel layout (auxiliary.h:21-24): RGB, blended normal,
# median depth, accumulated alpha, normalized depth distortion.
NUM_CHANNELS = 3
DEPTH_OFFSET = 6
ALPHA_OFFSET = 7
DISTORTION_OFFSET = 8
OUTPUT_CHANNELS = 9

# Maximum number of tiles a single Gaussian may be binned into. The reference
# has no bound (rasterizer_impl.cu:70-111 duplicates dynamically); a static
# bound keeps all shapes jit-stable. Gaussians whose tile rect exceeds this are
# clamped to a centered sub-rect (only affects very large screen-space
# Gaussians early in training).
MAX_TILES_PER_GAUSSIAN = 64

# Frustum near-cull threshold for Gaussian centers (auxiliary.h:177-202).
FRUSTUM_NEAR = 0.2

# Camera projection clip planes (scene/cameras.py:50-51 in the reference).
CAMERA_ZNEAR = 0.01
CAMERA_ZFAR = 100.0
