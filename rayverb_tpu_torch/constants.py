"""Physical and algorithmic constants shared across the framework.

Mirrors the constant surface of the reference implementation:
  - NUM_IMAGE_SOURCE / SPEED_OF_SOUND: reference rayverb/clstructs.h:4-5
  - EPSILON: reference rayverb/kernel.cpp:11
  - per-band air absorption coefficients: reference rayverb/rayverb.cpp:632-641
  - multiband crossover edges: reference rayverb/filters.cpp:295-305
  - HRTF analysis band edges: reference hrtf_analysis/analyse_hrtf.py:10
"""

import numpy as np

# Number of frequency bands carried per impulse (the reference's float8
# VolumeType, clstructs.h:13).
NUM_BANDS = 8

# Image-source search depth: the direct path plus NUM_IMAGE_SOURCE - 1
# specular early reflections (clstructs.h:4).
NUM_IMAGE_SOURCE = 10

# Speed of sound in m/s (clstructs.h:5).
SPEED_OF_SOUND = 340.0
SECONDS_PER_METER = 1.0 / SPEED_OF_SOUND

# Geometric tolerance used by the intersection and path-validation code
# (kernel.cpp:11).
EPSILON = 1e-4

# Per-band exponential air absorption coefficients, applied as
# exp(distance * coefficient) (kernel.cpp:194-198; values rayverb.cpp:632-641).
AIR_COEFFICIENT = np.array(
    [0.001 * c for c in (-0.1, -0.2, -0.5, -1.1, -2.7, -9.4, -29.0, -60.0)],
    dtype=np.float32,
)

# Crossover band edges for the 8-band output filter bank; the first edge is
# the configurable `hipass` cutoff (filters.cpp:297-298).
FILTER_EDGES_UPPER = (175.0, 350.0, 700.0, 1400.0, 2800.0, 5600.0, 11200.0, 20000.0)
DEFAULT_HIPASS = 45.0

# Band edges used when reducing HRIRs to 8-band energy gains
# (hrtf_analysis/analyse_hrtf.py:10).
HRTF_BAND_EDGES = (0.0, 190.0, 380.0, 760.0, 1520.0, 3040.0, 6080.0, 12160.0, 20000.0)

# HRTF table resolution: per channel, per degree of azimuth/elevation
# (rayverb.h:255-257).
HRTF_AZIMUTHS = 360
HRTF_ELEVATIONS = 180

# Interaural half-width in metres used for the HRTF time-of-arrival shift
# (kernel.cpp:597).
HRTF_EAR_OFFSET = 0.1

# Amplitude floor used by trimTail (rayverb.cpp:146).
TRIM_TAIL_FLOOR = 1e-5
