"""Probes of RANSAC's fit against the JAX package on the CPU, run by hand
(not collected by pytest).

    python tests/_kabsch_probe.py ulps
        # the plain fit against the formulation it replaced, per case of
        # tests/test_torch_kabsch.py: the largest difference in ulps of 1.0
    python tests/_kabsch_probe.py drift CASE [--fit port|jax-eager|jax-jit]
                                        [--perturb SEED] [--resync]
        # one case of test_torch_slam.OPTION_CASES frame by frame against
        # the JAX engine, as follow_option_case runs it: the pose difference
        # of every frame, the worst, and the chi² of the frames with a BA.
        # --fit: the port's fit, or the JAX package's (eager or jitted) in
        # its place; --perturb: the fit's outputs moved by -1, 0 or +1 ulp
        # (a generator seeded with SEED); --resync: the port's state set to
        # JAX's before every frame

Both packages are imported, so it runs where the tests run (JAX on the
CPU)."""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from putslam_tpu.ops import kabsch as jkabsch  # noqa: E402
from putslam_tpu_torch.ops import kabsch as tkabsch  # noqa: E402


def ulps():
    import test_torch_kabsch as T
    from _torch_port import t

    for kind in T.WEIGHTED + ["sampled_" + k for k in T.SAMPLED]:
        if kind.startswith("sampled_"):
            comps = [t(c) for c in T._sampled_case(kind[len("sampled_"):])]
            new, old = tkabsch.plain_kabsch_soa(*comps), T._old_soa(*comps)
        else:
            p, q, w = (t(x) for x in T._weighted_case(kind))
            new = tkabsch.plain_weighted_kabsch(p, q, w)
            old = T._old_weighted(p, q, w)
        print(f"{kind}: {float((new - old).abs().max()) / T.EPS:.1f} ulps")


def _jax_fit(jit):
    soa, weighted = jkabsch.kabsch_soa, jkabsch.weighted_kabsch
    if jit:
        soa, weighted = jax.jit(soa), jax.jit(weighted)

    def kabsch_soa(*comps, iters=30):
        return torch.from_numpy(np.array(soa(*(jnp.asarray(c.numpy())
                                               for c in comps))))

    def weighted_kabsch(p, q, w, iters=30):
        return torch.from_numpy(np.array(weighted(
            *(jnp.asarray(x.numpy()) for x in (p, q, w)))))
    return kabsch_soa, weighted_kabsch


def drift(case, fit, perturb, resync):
    import test_torch_slam as T
    from _torch_port import n, port_cfg, t

    if fit != "port":
        tkabsch.kabsch_soa, tkabsch.weighted_kabsch = _jax_fit(
            fit == "jax-jit")
    if perturb:
        gen = torch.Generator().manual_seed(perturb)

        def moved(f):
            def call(*a, **k):
                out = f(*a, **k)
                step = torch.randint(-1, 2, out.shape, generator=gen)
                return out * (1 + step.float() * 2.0 ** -23)
            return call
        tkabsch.kabsch_soa = moved(tkabsch.kabsch_soa)
        tkabsch.weighted_kabsch = moved(tkabsch.weighted_kabsch)
    cfg = T._replace(T.slice_config(), **T.OPTION_CASES[case])
    pcfg = port_cfg(cfg)
    frames = 12
    orbit = 30 if cfg.map.use_uncertainty else frames
    poses = np.asarray(T.jsyn.orbit_trajectory(orbit, radius=0.10,
                                               yaw_amp=0.1))[:frames]
    g, d = (np.asarray(x) for x in T.jsyn.render_sequence(
        cfg.camera, jnp.asarray(poses)))
    js = T.jslam.slam_init(cfg, g[0], d[0], poses[0])
    ts = T.convert.from_numpy(jax.tree.map(np.asarray, js), "cpu")
    worst = 0.0
    for i in range(1, frames):
        if resync:
            ts = T.convert.from_numpy(jax.tree.map(np.asarray, js), "cpu")
        draws, _ = T.jax_draws(cfg, js.key)
        js, jo = T.jslam.slam_step(cfg, js, g[i], d[i])
        ts, to = T.tslam.slam_step(pcfg, ts, t(g[i]), t(d[i]), draws=draws)
        diff = float(np.abs(n(to.pose) - np.asarray(jo.pose)).max())
        worst = max(worst, diff)
        ba = f"; BA chi² port {n(to.chi2)} JAX {np.asarray(jo.chi2)}" \
            if bool(jo.ba_ran) else ""
        print(f"frame {i}: pose {diff:.2e}{ba}")
    print(f"{case} fit={fit} perturb={perturb} resync={resync}: worst "
          f"{worst:.2e} ({'within' if worst <= 1e-4 else 'over'} 1e-4)")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="what", required=True)
    sub.add_parser("ulps")
    dr = sub.add_parser("drift")
    dr.add_argument("case")
    dr.add_argument("--fit", choices=("port", "jax-eager", "jax-jit"),
                    default="port")
    dr.add_argument("--perturb", type=int, default=0)
    dr.add_argument("--resync", action="store_true")
    args = ap.parse_args()
    if args.what == "ulps":
        ulps()
    else:
        drift(args.case, args.fit, args.perturb, args.resync)


if __name__ == "__main__":
    main()
