#!/usr/bin/env python
"""Where the elementwise multiply and add kernels of a replayed SLAM frame
come from, on one CUDA card.

Usage (repository root, one card):
    python tools/attribute_launches_torch.py [--repo PATH] [--frames 4]
                                             [--json-out FILE]

The cell is ``chip_smoke.py`` phase 7b's bench: the fr1 config, the
64-frame orbit (radius 0.10 m, yaw 0.1) rendered on the card, frames 1 to
``--frames`` from one ``slam_init`` state with the same per-frame draws.

* The replay: ``slam_sequence`` from CUDA graphs (captured by a first
  call), then profiled: kernels a frame as torch.profiler (CUPTI) records
  them, and among them the float multiplies (a ``MulFunctor``) and adds (a
  ``CUDAFunctor_add``, which ``sub`` launches too).
* The same frames through the frame runner without graphs
  (``compiled.run_sequence(capture=False)``: every branch a host read of
  its predicate, so the branches that run are the replay's): each
  ``mul`` / ``add`` / ``sub`` operator on a CUDA tensor (one kernel each)
  attributed to the innermost function of the port's package on the
  Python stack, by a ``TorchDispatchMode``; and the calls of RANSAC's refit
  (``ops/kabsch.py``: ``weighted_kabsch``) and, where the checkout has
  them, of its hypotheses and scores (``ops/ransac_score.py``:
  ``hypotheses``, ``score``) a frame.
* One refit alone (512 matches), profiled: the kernels it launches; and
  one ``ransac.estimate`` call at the fr1 widths (1024 hypotheses, 512
  matches, two refits): its kernels, by kind, and its sampler's alone.

``--repo`` imports ``putslam_tpu_torch`` from another checkout (a parent
commit, unpacked with ``git archive``), so that two versions are counted on
one card in one call. One JSON line, then the card's ``nvidia-smi`` name
and power limit.
"""

import argparse
import collections
import json
import os
import subprocess
import sys
import warnings

FRAMES = 64
ELEMENTWISE = ("mul", "add", "sub")


def kernel_kind(name: str) -> str:
    """'mul', 'add' or 'other' for a CUDA kernel's name."""
    if "MulFunctor" in name:
        return "mul"
    if "CUDAFunctor_add" in name or "AddFunctor" in name:
        return "add"
    return "other"


def profiled_kernels(torch, fn):
    """Counter of the CUDA kernels one call of ``fn`` launches, by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    return collections.Counter(
        e.name for e in prof.events() if e.device_type == DeviceType.CUDA
        and not e.name.startswith(("Memcpy", "Memset")))


def by_kind(kernels) -> dict:
    out = collections.Counter()
    for name, n in kernels.items():
        out[kernel_kind(name)] += n
    return dict(out)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout to import the port from")
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--json-out", help="append the JSON line there too")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    if not torch.cuda.is_available():
        sys.exit("attribute_launches_torch: needs a CUDA card")
    import putslam_tpu_torch
    from putslam_tpu_torch.config import tum_fr1_config
    from putslam_tpu_torch.io import synthetic
    from putslam_tpu_torch.frontend import ransac
    from putslam_tpu_torch.models import compiled, slam
    from putslam_tpu_torch.ops import kabsch
    try:
        from putslam_tpu_torch.ops import ransac_score
    except ImportError:         # a checkout from before the kernel
        ransac_score = None

    pkg = os.path.dirname(os.path.abspath(putslam_tpu_torch.__file__))

    def site() -> str:
        """The innermost function of the port on the Python stack."""
        f = sys._getframe(2)
        while f is not None:
            path = os.path.abspath(f.f_code.co_filename)
            if path.startswith(pkg + os.sep):
                return f"{os.path.relpath(path, pkg)}:{f.f_code.co_name}"
            f = f.f_back
        return "outside the package"

    class OpSites(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.counts = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            op = func._schema.name.split("::")[-1].rstrip("_")
            if op in ELEMENTWISE and any(
                    isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                self.counts[(op, site())] += 1
            return func(*args, **(kwargs or {}))

    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    cfg = tum_fr1_config()
    poses = synthetic.orbit_trajectory(FRAMES, radius=0.10, yaw_amp=0.1,
                                       device=dev)
    grays, depths = synthetic.render_sequence(cfg.camera, poses)
    state0 = slam.slam_init(cfg, grays[0], depths[0], poses[0])
    k = args.frames
    gen = torch.Generator(device=dev).manual_seed(0)
    draws = [slam.frame_draws(cfg, gen, dev) for _ in range(k)]
    g, d = grays[1:k + 1], depths[1:k + 1]

    def replay():
        return slam.slam_sequence(cfg, state0, g, d, draws=draws, graph=True)

    replay()                                  # captures
    replayed = profiled_kernels(torch, replay)

    def host():
        return compiled.run_sequence(cfg, state0, g, d, draws=draws,
                                     capture=False)

    host()
    fits = collections.Counter()
    real = {(kabsch, "weighted_kabsch"): kabsch.weighted_kabsch}
    if ransac_score is not None:
        real.update({(ransac_score, name): getattr(ransac_score, name)
                     for name in ("hypotheses", "score")})

    def counting(key):
        def call(*a, **kw):
            fits[key[1]] += 1
            return real[key](*a, **kw)
        return call

    for key in real:
        setattr(*key, counting(key))
    try:
        with OpSites() as sites:
            host()
        torch.cuda.synchronize()
    finally:
        for key, fn in real.items():
            setattr(*key, fn)

    gen = torch.Generator(device=dev).manual_seed(1)
    p, q = (torch.rand((512, 3), generator=gen, device=dev)
            for _ in range(2))
    w = (torch.rand((512,), generator=gen, device=dev) < 0.7).float()
    one_fit = {"weighted_kabsch": profiled_kernels(
        torch, lambda: kabsch.weighted_kabsch(p, q, w))}

    # one RANSAC call at the fr1 widths, and its sampler alone
    rcfg = cfg.ransac
    pr, qr = (torch.rand((512, 3), generator=gen, device=dev) + 1.0
              for _ in range(2))
    valid = torch.rand((512,), generator=gen, device=dev) < 0.9
    u = torch.rand((rcfg.used_pairs, rcfg.n_hypotheses), generator=gen,
                   device=dev)
    call = profiled_kernels(torch, lambda: ransac.estimate(
        rcfg, cfg.camera, pr, qr, valid, u=u))
    sampler = profiled_kernels(torch, lambda: ransac.sample_indices(
        rcfg, valid, u))
    one_call = dict(kernels=sum(call.values()), by_kind=by_kind(call),
                    sampler_kernels=sum(sampler.values()))

    per_site = collections.defaultdict(dict)
    for (op, where), n in sorted(sites.counts.items(),
                                 key=lambda kv: -kv[1]):
        per_site[op][where] = n / k
    line = dict(
        repo=os.path.abspath(args.repo), frames=k,
        replay=dict(kernels_per_frame=sum(replayed.values()) / k,
                    by_kind_per_frame={x: n / k for x, n in
                                       by_kind(replayed).items()}),
        host_branching=dict(
            ops_per_frame={op: sum(v.values()) for op, v in
                           per_site.items()},
            by_site_per_frame=per_site),
        fits_per_frame={name: fits[name] / k for _, name in real},
        kernels_per_fit={name: dict(kernels=sum(c.values()),
                                    by_kind=by_kind(c))
                         for name, c in one_fit.items()},
        kernels_per_ransac_call=one_call,
        device=smi)
    print(json.dumps(line), flush=True)
    if args.json_out:
        with open(args.json_out, "a") as f:
            f.write(json.dumps(line) + "\n")
    print(smi)


if __name__ == "__main__":
    main()
