"""handheld_trajectory: the host random walk is drawn from the same numpy
generator in the same order, so the port's trajectory equals the JAX
package's to 1e-6 (float32 exponential map)."""

import numpy as np
import pytest

from putslam_tpu.io import synthetic as jsyn
from putslam_tpu_torch.io import synthetic as tsyn


@pytest.mark.parametrize("frames,seed", [(16, 0), (64, 3), (200, 7)])
def test_handheld_trajectory_equal(frames, seed):
    ref = np.asarray(jsyn.handheld_trajectory(frames, seed=seed))
    out = tsyn.handheld_trajectory(frames, seed=seed)
    assert tuple(out.shape) == (frames, 7) and out.dtype.is_floating_point
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)
    q = out.numpy()[:, 3:]
    np.testing.assert_allclose(np.linalg.norm(q, axis=1), 1.0, atol=1e-6)


def test_handheld_steps_follow_the_arguments():
    """Median per-frame translation step of the x channel is step_t; the
    amplitude clamp holds."""
    p = tsyn.handheld_trajectory(300, seed=1, step_t=0.02,
                                 pos_amp=(0.05, 0.45, 0.6)).numpy()
    assert np.abs(p[:, 0]).max() <= 0.05 + 1e-6
    ref = np.asarray(jsyn.handheld_trajectory(300, seed=1, step_t=0.02,
                                              pos_amp=(0.05, 0.45, 0.6)))
    np.testing.assert_allclose(p, ref, atol=1e-6)
    free = tsyn.handheld_trajectory(300, seed=1, step_t=0.02,
                                    pos_amp=(10.0, 10.0, 10.0)).numpy()
    assert abs(np.median(np.abs(np.diff(free[:, 0]))) - 0.02) < 1e-4
