"""The slice as a whole with the front-end options (multi-mate guided matching; the exact grid cap with
the LDB descriptor and ratio acceptance; the Hamming-slack retries on
degraded frames): the port's
slam_step against the JAX engine frame by frame, as test_torch_slam.py does
for the main path. Tolerances: test_torch_slam.follow_option_case."""

import pytest
from test_torch_slam import OPTION_CASES, follow_option_case


@pytest.mark.parametrize(
    "case", [c for c in sorted(OPTION_CASES) if c.startswith(('d_', 'e_', 'f_'))])
def test_options_follow_jax_frame_by_frame(case, monkeypatch):
    follow_option_case(case, monkeypatch)
