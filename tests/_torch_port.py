"""Shared helpers of the putslam_tpu_torch parity tests (test_torch_*.py).

The same numpy inputs go through the JAX package (on the CPU, as
conftest.py forces) and through its PyTorch port; states cross over with
putslam_tpu_torch.convert. A test makes its config once, with the JAX
package, and hands the port ``port_cfg(cfg)``: the same values in the port's
own config classes."""

import numpy as np
import torch

from putslam_tpu_torch.convert import config_from_jax as port_cfg  # noqa: F401

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
