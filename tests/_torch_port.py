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
