"""Typed configuration tree of putslam_tpu_torch.

The port's own copy of the JAX package's ``putslam_tpu/config.py``: the same
ten classes, field names, defaults, ``replace`` method and the two presets,
so that a config of either package converts to the other field by field
(``convert.config_from_jax``). It imports nothing of the JAX package.

One dataclass tree replaces the reference's layered tinyXML2 config files
(reference: resources/putslamconfigGlobal.xml, putslammatcherOpenCVParameters.xml,
putslammapConfig.xml, datasetConfig/<seq>.xml; parsed in PUTSLAM.cpp:454-576 and
the per-component nested ``Config`` ctors, e.g. matcher.h:177-369,
featuresMap.h:184-387). Parameter names are kept close to the reference's XML
attribute names so operating points are directly comparable.

All capacity fields (``max_features`` etc.) are *static* shapes: every runtime
array in the engine is fixed-capacity + validity mask, so no shape depends
on the data.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class CameraConfig:
    """Pinhole + distortion + depth-noise model.

    Mirrors resources/datasetConfig/freiburg1_desk.xml (focalLength, focalAxis,
    rgbDistortion, variance/varianceDepth) and depthSensorModel.h:51-138.
    """

    fu: float = 517.3
    fv: float = 516.5
    cu: float = 318.6
    cv: float = 255.3
    # OpenCV-style radial-tangential distortion (k1, k2, p1, p2, k3).
    k1: float = -0.0410
    k2: float = 0.3286
    p1: float = 0.0087
    p2: float = 0.0051
    k3: float = -0.5643
    width: int = 640
    height: int = 480
    depth_image_scale: float = 5000.0
    # Pixel / depth measurement noise (Park model), depthSensorModel.cpp:28-36.
    sigma_u: float = 1.1046
    sigma_v: float = 0.6416
    # depth variance polynomial c3*z^3 + c2*z^2 + c1*z + c0 (millimetre fit).
    var_c3: float = 0.567602
    var_c2: float = 0.888951
    var_c1: float = 0.418786
    var_c0: float = 0.964182
    # Valid depth gate used when lifting features (PUTSLAM.cpp:117, RANSAC.cpp:64-74).
    min_depth: float = 0.1
    max_depth: float = 6.0


@dataclass(frozen=True)
class DetectorConfig:
    """FAST/ORB-style detection. Mirrors matcherOpenCV.cpp:118-180 grid policy."""

    max_features: int = 512          # detection cap (reference: 500, padded to 512)
    fast_threshold: float = 20.0     # FAST intensity threshold (0..255 scale)
    grid_rows: int = 6               # gridRows in matcher XML
    grid_cols: int = 8               # gridCols in matcher XML
    n_pyramid_levels: int = 4        # ORB scale pyramid depth
    scale_factor: float = 1.41421356 # per-level downscale (sqrt(2))
    nms_radius: int = 3              # DBScan-equivalent declustering radius (dbscan.cpp:79-123)
    # grid detection cap: "subtile" = one winner per subtile (fast,
    # slightly stronger spatial spread); "exact" = the reference's
    # per-cell top-k verbatim (matcherOpenCV.cpp:118-180, ~4× cap cost)
    grid_policy: str = "subtile"
    # read by the JAX package only (its Pallas kernel against its XLA
    # chain); the port ignores it: a CUDA tensor always takes the CUDA
    # kernel. Kept so that a config converts losslessly.
    use_pallas_detect: bool = False
    patch_size: int = 32             # descriptor patch (rBRIEF standard)
    descriptor: str = "brief"        # "brief" (rBRIEF) | "ldb" (grid tests, src/LDB)
    border: int = 20                 # keypoint exclusion border


@dataclass(frozen=True)
class RansacConfig:
    """Batched RANSAC. Mirrors <RANSAC .../> in putslammatcherOpenCVParameters.xml
    and RANSAC.cpp:50-174 behavior (adaptive iterations replaced by a fixed,
    larger hypothesis batch evaluated in parallel)."""

    n_hypotheses: int = 1024             # replaces sequential adaptive loop RANSAC.cpp:87-150
    used_pairs: int = 3                  # usedPairs
    inlier_threshold_euclidean: float = 0.04   # inlierThresholdEuclidean (m)
    inlier_threshold_reprojection: float = 2.0 # inlierThresholdReprojection (px)
    inlier_threshold_mahalanobis: float = 2e-4
    minimal_inlier_ratio: float = 0.2    # minimalInlierRatioThreshold → identity fallback
    minimal_num_matches: int = 15        # minimalNumberOfMatches
    error_version: int = 0               # 0 Euclid, 1 reproj, 2 both, 3 Mahalanobis, 4 adaptive
    refit_iterations: int = 2            # re-fit on inliers (RANSAC.cpp:152-158), iterated
    # PROSAC-style quality-ordered sampling (the USAC variant's PROSAC option,
    # USAC_wrapper.cpp:62-100): bias hypothesis sampling toward low-distance
    # matches with weight ∝ exp(−dist/quality_tau); 0 disables (uniform)
    quality_tau: float = 0.0


@dataclass(frozen=True)
class MatcherConfig:
    """Descriptor matching / guided map matching. Mirrors matcher.h config +
    matchXYZ semantics (matcher.cpp:606-798)."""

    cross_check: bool = True
    max_hamming: int = 64                  # descriptor distance acceptance gate
    matching_xyz_sphere_radius: float = 0.12   # matchingXYZSphereRadius
    matching_xyz_acceptance_ratio: float = 0.55  # matchingXYZacceptRatio
    # guided-match acceptance: "hamming" = absolute distance gate;
    # "ratio" = ratio-of-best test (best < ratio·second-best, the
    # discriminativeness analog of matcher.cpp:734-747's band acceptance)
    acceptance: str = "hamming"
    # multi-mate guided matching (matcher.cpp:734-747: the reference hands
    # RANSAC EVERY candidate within ratio-of-best per map feature): >1
    # keeps up to this many band-accepted mates per landmark as
    # (landmark, feature) pairs for the absolute-pose RANSAC — helps on
    # repetitive texture where the single best mate aliases. 1 = best-only.
    max_mates: int = 1
    octave_window: int = 1                 # octave +-1 gate, matcher.cpp:699-711
    retries: int = 2                       # map-matching retry with widened radius
    retry_radius_growth: float = 2.0       # PUTSLAM.cpp:791-798 widening
    # retry trigger: widen the sphere when the map-RANSAC inlier ratio is
    # below this (the reference retries while matchingRatio < 0.1)
    retry_inlier_ratio: float = 0.1
    # OPTIONAL widened-gate rescue (round-5, off by default): retries can
    # ALSO widen the Hamming acceptance by this many bits and scale the
    # RANSAC inlier threshold by retry_threshold_growth (under heavy depth
    # noise the TRUE pair-error norm exceeds the clean-data gate); adopted
    # only when the strict pass failed outright. Measured: on the hard
    # stress preset this buys ~15 % on top of the drift-budget correction
    # gate (0.0527 → 0.0453 m), but widened-gate rescues of genuinely
    # degenerate frames cost ~2× in-loop ATE on sparse-map sequences
    # (30-frame orbit) — hence off by default; the DRIFT-BUDGET gate
    # below/cfg.map_correction_growth is the automatic recovery mechanism.
    # 0 / 1.0 disable.
    retry_hamming_slack: float = 0.0
    retry_threshold_growth: float = 1.0
    # Sticky degraded mode: an EMA (decay degraded_ema_decay) of the STRICT
    # first-pass map inlier ratio is carried in the state; while it sits
    # below degraded_health_ratio the widened-gate retries fire on EVERY
    # frame (not only outright failures) and the VO retry trigger relaxes
    # too. The first pass always runs with the strict gates, so the health
    # signal cannot be fooled by its own recovery. Clean sequences never
    # enter the mode (first-pass ratios stay high).
    degraded_health_ratio: float = 0.35
    degraded_ema_decay: float = 0.9


@dataclass(frozen=True)
class TrackerConfig:
    """Pyramidal KLT tracking (VOVersion=1). Mirrors matcherOpenCV.cpp:209-300."""

    win_size: int = 7
    max_levels: int = 3
    max_iter: int = 20
    eps: float = 0.01
    error_threshold: float = 8.0
    min_tracked_features: int = 300
    # extra single-level photometric polish of the tracked locations with a
    # widened window (MatchingOnPatches ``optimizeLocation`` wired into the
    # tracking pipeline; src/Matcher/MatchingOnPatches.cpp)
    patch_refine: bool = False
    patch_refine_win: int = 11


@dataclass(frozen=True)
class MapConfig:
    """Feature map capacities + policies. Mirrors putslammapConfig.xml and
    featuresMap.cpp keyframe/compression logic."""

    max_landmarks: int = 8192
    max_keyframes: int = 256
    descriptor_views: int = 4             # multi-descriptor slots (featuresMap.cpp:1172-1213)
    view_angle_new_descriptor: float = 0.5236  # 30 deg gate for a new descriptor slot
    covisibility_keyframe: float = 0.9    # new keyframe when covisibility < thr (featuresMap.cpp:292-333)
    min_keyframe_matches: int = 30        # also keyframe when map matches drop below this
    marginalization_thr: float = 0.3      # marginalize when covisibility < thr
    min_frames_between_keyframes: int = 0
    max_frames_window: int = 250          # maxFramesNo
    add_pose_to_pose_edges: bool = True
    max_measurements_pose_to_pose: int = 80     # maxMeasurementsToAddPoseToPoseEdge
    min_measurements_pose_to_feature: int = 45  # minMeasurementsToAddPoseToFeatureEdge
    add_features_when_map_size_less_than: int = 350
    add_features_when_measurements_less_than: int = 100
    max_once_feature_add: int = 200
    min_euclidean_distance_of_features: float = 0.03
    min_image_distance_of_features: float = 2.0
    add_no_features_when_map_size_greater_than: int = 1000
    use_uncertainty: bool = False
    # observation-uncertainty shaping (depthSensorModel.cpp:28-95):
    # "sensor"   — J·R_uvd·Jᵀ pinhole+depth-noise propagation only
    # "normal"   — additionally shrink variance along the surface normal
    #              (points on a wall are well-constrained normal to it)
    # "gradient" — shrink variance across the image-gradient direction
    uncertainty_model: str = "sensor"
    scale_uncertainty_normal: float = 0.1    # scaleUncertaintyNormal
    scale_uncertainty_gradient: float = 0.1  # scaleUncertaintyGradient
    life_value_init: float = 10.0          # feature aging (featuresMap.cpp:474-516)
    life_value_measurement_bonus: float = 5.0
    # 0 disables aging-death (the reference's default: weakFeatureThr=-1,
    # putslammapConfig.xml) — long-gap loop closure needs old landmarks alive
    life_value_decay: float = 0.0


@dataclass(frozen=True)
class BackendConfig:
    """Bundle-adjustment / pose-graph solver. Mirrors graph_g2o.cpp:32-65 solver
    choice (PCG + block solver + Gauss-Newton) rebuilt as dense-block Schur +
    CG on the reduced camera system."""

    max_pose_pose_edges: int = 1024
    # pose-landmark measurement capacity. This is a *ring*: the oldest
    # observations are overwritten once it wraps, which (with window fixing)
    # is the marginalization behavior of featuresMap.cpp:1056-1104. 8192
    # ≈ 80 keyframes × ~100 measurements — comfortably covers the active
    # window.
    max_observations: int = 8192
    # GN iterations per optimize() call. The reference's continuous thread
    # runs 1-iteration passes (featuresMap.cpp:881-1026); the JAX package
    # settled on 2 at the every-5-keyframes cadence (the end-of-run final
    # polish equalizes all settings anyway).
    gn_iterations: int = 2
    # linear solver for the reduced camera system:
    # "dense_schur_mm" (default) — matmul formulation: the whitened
    #   coupling G is built by one-hot matmuls and the Schur subtrahend is a
    #   single G·Gᵀ product; no (K, L) scatter exists. Curvature accumulates
    #   from bf16 in f32 — the f32-exact gradient pins the fixed point.
    # "dense_schur" — scatter-based f32 reference implementation.
    # "pcg" — matrix-free block-Jacobi CG (the reference's LinearSolverPCG
    #   architecture, graph_g2o.cpp:35 — for maps too large to densify).
    solver: str = "dense_schur_mm"
    # Active-window compaction for the in-loop dense_schur_mm solver: the
    # ≤ ba_window free (non-fixed, valid) keyframes are gathered into a
    # compact block so the reduced camera system is (6·W)² instead of
    # (6·K)² — the reference optimizes the active subgraph only
    # (graph_g2o.cpp:873-933 with marginalization fixing the rest); frozen
    # keyframes keep anchoring landmarks through H_ll/b_l exactly as
    # before. 0 disables (full-K system — used by the end-of-run finalize).
    ba_window: int = 64
    # Landmark-axis compaction for dense_schur_mm: the ≤ ba_lm_block VALID
    # landmarks are gathered into a compact block and every obs↔landmark
    # gather/scatter becomes a one-hot f32 matmul. Surplus valid landmarks
    # beyond the block are gracefully dropped from that BA call (their
    # edges gate out). 0 disables (full-L axis).
    ba_lm_block: int = 2048
    pcg_iterations: int = 64
    pcg_tol: float = 1e-6
    damping: float = 1e-5                 # LM-style relative diagonal damping
    robust_kernel: str = "cauchy"         # "none" | "cauchy" | "huber" (graph_g2o.cpp:367-383)
    robust_delta: float = 1.0
    huber_delta: float = 0.1
    chi2_ratio_termination: float = 0.999  # graph_g2o.cpp:888-908 convergence loop
    # normalized-chi² threshold for dropping observation edges after BA
    # (optimizeAndPrune / edges3DPrunningThreshold, graph_g2o.cpp:1394-1505)
    chi2_prune_threshold: float = 25.0
    optimize_every_n_frames: int = 5
    error_type: int = 0                   # 0 euclidean Edge3D, 1 reprojection
    # Reprojection-factor pixel noise: information weight = 1/σ_px²
    # (edge_se3_pointxyz_reprojectionError.h information default)
    obs_pixel_sigma: float = 1.0
    # Use the stored full 3×3 per-observation information matrices (whitened
    # normal equations) instead of the scalar obs_w — the useUncertainty mode
    # of putslammapConfig.xml (sensor model depthSensorModel.cpp:28-95).
    # Pair with MapConfig.use_uncertainty so the engine stores the matrices.
    use_obs_info: bool = False
    # --- end-of-run final optimization (featuresMap.cpp:980-1025) ---------
    final_gn_iterations: int = 12         # full-graph polish pass length
    final_min_obs: int = 2                # removeWeakFeatures threshold analog
    # trajectory sanity repair (checkTrajectory/cleanCamTrajectory,
    # graph_g2o.cpp:1026-1080, featuresMap.cpp:1224-1270): a keyframe whose
    # optimized relative motion differs from its odometry edge by more than
    # this (metres) is re-composed from odometry instead; ≤0 disables
    trajectory_repair_threshold: float = 0.3


@dataclass(frozen=True)
class LoopClosureConfig:
    """Place recognition + verification. Mirrors loopClosureLocal.cpp:51-125 and
    featuresMap.cpp:733-873 (FAB-MAP replaced by binary BoW cosine scoring)."""

    enabled: bool = False
    vocab_size: int = 512                  # binary word count for BoW scoring
    tail_skip: int = 15                    # skip this many most-recent frames
    queue_capacity: int = 64               # priority queue trim (reference 100→50)
    min_probability: float = 0.3
    min_features_lc: int = 35              # minNumberOfFeaturesLC
    matching_ratio_threshold: float = 0.4  # matchingRatioThresholdLC


@dataclass(frozen=True)
class MotionModelConfig:
    """Decaying-velocity EKF (decayingVelocityModel.cpp:3-215)."""

    enabled: bool = False
    decay: float = 0.95
    q_pos: float = 1e-4
    q_vel: float = 1e-3
    q_quat: float = 1e-4
    q_angvel: float = 1e-3
    r_pos: float = 1e-4
    r_quat: float = 1e-4


@dataclass(frozen=True)
class SlamConfig:
    """Top-level engine config (the putslamconfigGlobal.xml equivalent)."""

    camera: CameraConfig = field(default_factory=CameraConfig)
    detector: DetectorConfig = field(default_factory=DetectorConfig)
    ransac: RansacConfig = field(default_factory=RansacConfig)
    matcher: MatcherConfig = field(default_factory=MatcherConfig)
    tracker: TrackerConfig = field(default_factory=TrackerConfig)
    map: MapConfig = field(default_factory=MapConfig)
    backend: BackendConfig = field(default_factory=BackendConfig)
    loop_closure: LoopClosureConfig = field(default_factory=LoopClosureConfig)
    motion_model: MotionModelConfig = field(default_factory=MotionModelConfig)
    only_vo: bool = False                  # onlyVO — disable the map/backend
    vo_version: int = 0                    # 0 matching, 1 tracking (VOVersion)
    # VO translation sanity gate → identity increment (PUTSLAM.cpp:735-737).
    max_vo_translation: float = 0.1
    # Map-matching pose correction sanity gate: reject absolute-pose fixes
    # further than this from the VO prediction (same spirit as the VO gate;
    # junk guided matches can otherwise assemble a confident wrong pose).
    max_map_correction: float = 0.08
    # DRIFT-BUDGET gate growth (round-5 fix): a FIXED gate deadlocks under
    # degradation — once VO drifts past it, every absolute fix is rejected,
    # which locks in more drift (measured on the hard stress preset:
    # map-correction acceptance 5.5 % of frames, ATE 0.35 m; growing the
    # gate 0.08 → 0.3 restored acceptance and ATE 0.035 m). The gate grows
    # by this many metres per frame since the last ACCEPTED correction
    # (the VO drift budget) and snaps back to max_map_correction on
    # acceptance. Clean runs accept nearly every frame, so the gate never
    # leaves its floor there. 0 restores the fixed gate.
    map_correction_growth: float = 0.02
    max_map_correction_cap: float = 0.5
    # OPTIONAL smoothed output trajectory: the emitted pose chain follows
    # the internal estimate with a first-order lag, pose_s ← (pose_s ∘ vo)
    # ⊕ α·log(·⁻¹ ∘ pose), suppressing the per-frame re-draw of the
    # absolute map-RANSAC noise (internal logic always uses the full-snap
    # pose). α = 1 (default) disables it. Measured (round 5): on
    # VO-jitter-dominated runs α=0.3 halves frame-to-frame RPE (0.0137 →
    # 0.0063 on the 120-frame orbit); on the keyframe-dense acceptance
    # sequence it instead LAGS the per-frame BA corrections and worsens
    # 1-second RPE (0.0092 → 0.0161) — hence off by default; a deployment
    # with sparse keyframes/BA cadence can enable it. Corrections larger
    # than pose_blend_snap metres (tracking recovery) always snap fully.
    pose_blend_alpha: float = 1.0
    pose_blend_snap: float = 0.04
    dtype: str = "float32"

    def replace(self, **kw) -> "SlamConfig":
        return dataclasses.replace(self, **kw)


def tum_fr1_config(**overrides) -> SlamConfig:
    """The reference's default fr1_desk operating point (BASELINE.md)."""
    cfg = SlamConfig()
    return cfg.replace(**overrides) if overrides else cfg


def tiny_test_config() -> SlamConfig:
    """Small capacities for fast CPU tests."""
    return SlamConfig(
        camera=CameraConfig(fu=80.0, fv=80.0, cu=64.0, cv=48.0,
                            k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0,
                            width=128, height=96),
        detector=DetectorConfig(max_features=128, grid_rows=3, grid_cols=4,
                                n_pyramid_levels=2, border=8),
        # the tiny camera has fu≈80: 1 px ≈ 37 mm at 3 m, so the Euclidean
        # inlier gate must be correspondingly looser than the fr1 default
        ransac=RansacConfig(n_hypotheses=128, inlier_threshold_euclidean=0.10),
        map=MapConfig(max_landmarks=512, max_keyframes=32),
        # scatter-based dense path on the tiny CPU config (solver
        # equivalence is covered by tests/test_torch_ba.py)
        backend=BackendConfig(max_pose_pose_edges=64, max_observations=4096,
                              pcg_iterations=32, solver="dense_schur"),
    )
