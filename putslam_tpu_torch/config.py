"""Configuration: the JAX package's dataclass tree, re-exported.

``putslam_tpu.config`` is pure dataclasses with no JAX import, so both
packages share one source of truth for every operating point.
"""

from putslam_tpu.config import (  # noqa: F401
    BackendConfig, CameraConfig, DetectorConfig, LoopClosureConfig,
    MapConfig, MatcherConfig, MotionModelConfig, RansacConfig, SlamConfig,
    TrackerConfig, tiny_test_config, tum_fr1_config)
