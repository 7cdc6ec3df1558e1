"""Shared helpers of the putslam_tpu_torch parity tests (test_torch_*.py).

The same numpy inputs go through the JAX package (on the CPU, as
conftest.py forces) and through its PyTorch port; states cross over with
putslam_tpu_torch.convert. A test makes its config once, with the JAX
package, and hands the port ``port_cfg(cfg)``: the same values in the port's
own config classes."""

import numpy as np
import torch

from putslam_tpu_torch.backend import graph as tgraph
from putslam_tpu_torch.convert import config_from_jax as port_cfg  # noqa: F401
from putslam_tpu_torch.geometry import se3 as tse3
from putslam_tpu_torch.slam_map import features_map as tfm

torch.set_num_threads(1)   # tier-1 runs several xdist workers
try:
    # numpy's BLAS too: building an LDB bank makes thousands of small
    # matrix-vector products, and six workers with a pool of threads each
    # take 100 s for what one thread does in a second
    import threadpoolctl
    threadpoolctl.threadpool_limits(1, "blas")
except ImportError:
    pass


def t(x, dtype=None):
    """numpy / JAX array → CPU torch tensor (a copy)."""
    out = torch.as_tensor(np.array(x))
    return out if dtype is None else out.to(dtype)


def n(x):
    """torch tensor or JAX array → numpy."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _pose(rng, t_scale, r_scale):
    t = rng.normal(size=3) * t_scale
    return tse3.exp(torch.tensor(np.concatenate(
        [t, rng.normal(size=3) * r_scale]), dtype=torch.float32))


def trajectory_map(K, E, seed, n_kf, corrupt=(), invalid=(), shift=0,
                   duplicates=False):
    """A map of ``n_kf`` keyframes (sequence numbers 3.. on), the keyframe
    of sequence s in ring slot (s + shift) % K, and its graph: one odometry
    edge a consecutive pair (the true increment with millimetre noise),
    appended to a pose-pose ring that wrapped, plus a loop-closure edge, a
    stale-generation edge and an invalid edge that contradict everything.
    ``corrupt``: walk positions moved by 0.5-0.9 m; ``invalid``: walk
    positions whose slot is marked invalid (a random pose left in it);
    ``duplicates``: each of two pairs gets a second odometry edge, older
    and wrong for the first pair, newer and wrong for the second. Returns
    numpy arrays: kf_pose, kf_valid, kf_seq, kf_gen, and pp_i, pp_j,
    pp_rel, pp_w, pp_gen_i, pp_gen_j, pp_valid, n_pp."""
    rng = np.random.default_rng(seed)
    true = [tse3.identity()]
    for _ in range(n_kf - 1):
        true.append(tse3.compose(true[-1], _pose(rng, 0.08, 0.05)))
    slot = [(s + shift) % K for s in range(n_kf)]
    kf_pose = np.tile(np.array([0, 0, 0, 1, 0, 0, 0], np.float32), (K, 1))
    kf_valid = np.zeros(K, bool)
    kf_seq = np.full(K, -1, np.int32)
    kf_gen = rng.integers(0, 3, K).astype(np.int32)
    for s in range(n_kf):
        p = true[s]
        if s in corrupt:
            p = tse3.compose(p, _pose(rng, 0.0, 0.0))
            p = p.clone()
            p[:3] += torch.tensor(rng.uniform(0.5, 0.9, 3) / np.sqrt(3),
                                  dtype=torch.float32)
        kf_pose[slot[s]] = p.numpy()
        kf_valid[slot[s]] = s not in invalid
        kf_seq[slot[s]] = s + 3
    for s in invalid:
        kf_pose[slot[s]] = _pose(rng, 1.0, 1.0).numpy()

    edges = []          # (i, j, rel, gen_i, gen_j, valid), in append order

    def odo(s, rel=None):
        if rel is None:
            rel = tse3.compose(tse3.relative(true[s - 1], true[s]),
                               _pose(rng, 1e-3, 1e-3))
        edges.append((slot[s - 1], slot[s], rel.numpy(), kf_gen[slot[s - 1]],
                      kf_gen[slot[s]], True))

    wrong = _pose(rng, 0.0, 0.0).clone()
    wrong[:3] = torch.tensor([0.0, 0.6, 0.0])
    for s in range(1, n_kf):
        if duplicates and s == 2:
            odo(s, wrong)                      # older and wrong: loses
        odo(s)
        if duplicates and s == 4:
            odo(s, wrong)                      # newer and wrong: wins
    big = _pose(rng, 3.0, 0.5)
    edges.append((slot[0], slot[n_kf - 1], big.numpy(), kf_gen[slot[0]],
                  kf_gen[slot[n_kf - 1]], True))           # loop closure
    edges.append((slot[2], slot[3], big.numpy(), kf_gen[slot[2]] + 1,
                  kf_gen[slot[3]], True))                  # stale generation
    edges.append((slot[3], slot[4], big.numpy(), kf_gen[slot[3]],
                  kf_gen[slot[4]], False))                 # invalid
    # the ring's append cursor has wrapped: edge t sits in slot (start+t) % E
    start = E - 5
    pp = dict(pp_i=np.zeros(E, np.int32), pp_j=np.zeros(E, np.int32),
              pp_rel=np.tile(np.array([0, 0, 0, 1, 0, 0, 0], np.float32),
                             (E, 1)),
              pp_w=np.ones(E, np.float32), pp_gen_i=np.zeros(E, np.int32),
              pp_gen_j=np.zeros(E, np.int32), pp_valid=np.zeros(E, bool))
    assert len(edges) <= E
    for t_, (i, j, rel, gi, gj, v) in enumerate(edges):
        k = (start + t_) % E
        pp["pp_i"][k], pp["pp_j"][k], pp["pp_rel"][k] = i, j, rel
        pp["pp_gen_i"][k], pp["pp_gen_j"][k], pp["pp_valid"][k] = gi, gj, v
    pp["n_pp"] = np.int32(start + len(edges))
    return dict(kf_pose=kf_pose, kf_valid=kf_valid, kf_seq=kf_seq,
                kf_gen=kf_gen, **pp)


def port_trajectory_map(cfg, arrays, device):
    """The port's (map, graph) holding ``trajectory_map``'s arrays, for the
    port's config ``cfg`` (its ``max_keyframes`` the arrays' K)."""
    mk = ("kf_pose", "kf_valid", "kf_seq", "kf_gen")
    m = tfm.init_map(cfg, device)._replace(
        **{k: torch.as_tensor(arrays[k], device=device) for k in mk})
    g = tgraph.init_graph(64, cfg.backend.max_pose_pose_edges, device)
    g = g._replace(**{k: torch.as_tensor(np.asarray(v), device=device)
                      for k, v in arrays.items() if k not in mk})
    return m, g


# A small reference-style resources/ tree: the element and attribute names
# the XML readers look for (io/xml_config.py), one file with several
# top-level elements, an XML declaration and unresolved conflict markers for
# the lenient parser.
GLOBAL = """<?xml version="1.0" encoding="UTF-8"?>
<PUTSLAM verbose="0" onlyVO="0" />
<ThreadSettings loopClosureThreadVersion="1" />
"""

MODEL = """<<<<<<< HEAD
<Model datasetFile="datasetConfig/desk.xml" />
=======
<Model datasetFile="datasetConfig/other.xml" />
>>>>>>> branch
<somethingElse value="3" />
"""

DATASET = """<?xml version="1.0" ?>
<Model>
  <focalLength fu="525.0" fv="526.5" />
  <focalAxis Cu="319.5" Cv="239.5" />
  <rgbDistortion k1="0.01" k2="-0.02" p1="0.001" p2="-0.002" k3="0.3" />
  <imageSize sizeU="320" sizeV="240" />
  <variance sigmaU="1.5" sigmaV="0.75" />
  <varianceDepth c3="0.1" c2="0.2" c1="0.3" c0="0.4" />
</Model>
<datasetPath base="/data" depthImageScale="1000.0" />
"""

OTHER = """<Model>
  <focalLength fu="481.2" fv="480.0" />
  <focalAxis Cu="100.0" Cv="90.0" />
</Model>
"""

MATCHER = """<Matcher VOVersion="1">
  <RANSAC errorVersionVO="2" inlierThresholdEuclidean="0.05"
          inlierThresholdReprojection="3.5" inlierThresholdMahalanobis="9.0"
          minimalInlierRatioThreshold="0.15" minimalNumberOfMatches="12"
          usedPairs="4" />
  <MatcherOpenCV detector="FAST" descriptor="LDB" gridRows="5" gridCols="7"
                 DBScanEps="4.0" matchingXYZSphereRadius="0.2"
                 matchingXYZacceptRatioOfBestMatch="0.6" winSize="9"
                 maxLevels="2" maxIter="15" eps="0.02"
                 trackingErrorThreshold="6.0" minimalTrackedFeatures="250" />
  <MatchingOnPatches warping="1" patchSize="13" />
</Matcher>
"""

MAP = """<MapConfig>
  <parameters useUncertainty="true" uncertaintyModel="2"
              optimizationErrorType="1" addPoseToPoseEdges="0"
              maxMeasurementsToAddPoseToPoseEdge="70"
              minMeasurementsToAddPoseToFeatureEdge="40"
              addFeaturesWhenMapSizeLessThan="300"
              addFeaturesWhenMeasurementSizeLessThan="90"
              maxOnceFeatureAdd="150" minEuclideanDistanceOfFeatures="0.02"
              minImageDistanceOfFeatures="3.0"
              addNoFeaturesWhenMapSizeGreaterThan="900" />
  <mapCompression covisibilityKeyframes="0.8" marginalizationThr="0.25"
                  minFramesNo="2" maxFramesNo="120" />
</MapConfig>
"""


def write_resources(res):
    """Write the resources/ tree above into the directory ``res`` (a
    pathlib.Path); returns it."""
    (res / "datasetConfig").mkdir(parents=True)
    (res / "putslamconfigGlobal.xml").write_text(GLOBAL)
    (res / "putslamfileModel.xml").write_text(MODEL)
    (res / "datasetConfig" / "desk.xml").write_text(DATASET)
    (res / "datasetConfig" / "other.xml").write_text(OTHER)
    (res / "putslammatcherOpenCVParameters.xml").write_text(MATCHER)
    (res / "putslammapConfig.xml").write_text(MAP)
    return res


# Stand-ins for the reference's evaluation scripts (evaluate_ate.py,
# evaluate_rpe.py, associate.py), which neither machine holds: Python 2
# source (print statements, tab-indented blocks, a dict's keys() list
# mutated) that tools/run_reference_eval.py shims and runs. Each reads its
# two trajectory files and prints a number fixed by the number of poses
# the estimate holds.
STAND_IN_ASSOCIATE = """import sys

def read_file_list(filename):
\tlines = open(filename).read().splitlines()
\tlist = [[v.strip() for v in l.split(" ") if v.strip() != ""]
\t        for l in lines if len(l) > 0 and l[0] != "#"]
\treturn dict([(float(l[0]), l[1:]) for l in list if len(l) > 1])

def associate(first, second):
\tfirst_keys = first.keys()
\tsecond_keys = second.keys()
\tmatches = []
\tfor a in sorted(first_keys):
\t\tif a in second_keys:
\t\t\tsecond_keys.remove(a)
\t\t\tmatches.append((a, a))
\treturn matches
"""

STAND_IN_EVAL = """import sys
import associate

if __name__ == "__main__":
\tfirst = associate.read_file_list(sys.argv[1])
\tsecond = associate.read_file_list(sys.argv[2])
\tmatches = associate.associate(first, second)
\tif len(matches) < 2:
\t\tsys.exit("too few matches")
\tprint "%f" % ({base} + 0.001 * len(second))
"""


def write_reference_stand_ins(root):
    """Write the stand-in scripts into ``root`` (a pathlib.Path; made if
    absent) and return it: point ``run_reference_eval.REF_SCRIPTS`` at it.
    evaluate_ate.py prints 0.01 + 0.001 × poses, evaluate_rpe.py 0.02 +
    0.001 × poses."""
    root.mkdir(parents=True, exist_ok=True)
    (root / "associate.py").write_text(STAND_IN_ASSOCIATE)
    (root / "evaluate_ate.py").write_text(STAND_IN_EVAL.format(base=0.01))
    (root / "evaluate_rpe.py").write_text(STAND_IN_EVAL.format(base=0.02))
    return root
