"""``utils/control.cond``, the port's ``lax.cond``, on the CPU.

The masked mode (the eager step's) and the host mode (the CPU's stand-in
for a CUDA-graph IF node) must give the same ``out`` for a true and a false
predicate; the host mode must not run a body whose predicate is false;
branches nest (the SLAM frame's is_keyframe → run_ba → Gauss-Newton
iteration, three deep); an ``out`` that is also the body's input, or
whose leaves the body hands back swapped, receives the body's result as
if it had been read first; the capture mode outside a capture raises; and
the write guard (``control.checking``) refuses a body that writes in place
to a tensor it did not make. The capture mode itself runs on the card
(``tests/test_torch_cond_cuda.py``)."""

import pytest
import torch

from putslam_tpu_torch.utils import control

MODES = ("masked", "host")


def _run(mode, fn):
    with control.branching(mode):
        return fn()


@pytest.mark.parametrize("pred", [True, False])
def test_masked_and_host_give_the_same_out(pred):
    x = torch.arange(6, dtype=torch.float32)
    outs = {}
    for mode in MODES:
        out = (torch.full((6,), -1.0), torch.zeros((), dtype=torch.int32))
        p = torch.tensor(pred)
        _run(mode, lambda: control.cond(
            p, lambda: (x * 2.0, (x > 2).sum().to(torch.int32)), out))
        outs[mode] = out
    for a, b in zip(outs["masked"], outs["host"]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    want = x * 2.0 if pred else torch.full((6,), -1.0)
    assert torch.equal(outs["host"][0], want)


def test_host_mode_skips_a_false_body_and_reads_once():
    calls = []
    out = torch.zeros(3)
    before = control.predicate_reads

    def body():
        calls.append(1)
        return torch.ones(3)

    with control.branching("host"):
        control.cond(torch.tensor(False), body, out)
    assert calls == [] and torch.equal(out, torch.zeros(3))
    with control.branching("host"):
        control.cond(torch.tensor(True), body, out)
    assert calls == [1] and torch.equal(out, torch.ones(3))
    assert control.predicate_reads - before == 2
    # masked runs the body whatever the predicate, and reads nothing
    control.cond(torch.tensor(False), body, out)
    assert calls == [1, 1] and control.predicate_reads - before == 2


def _nested(is_kf, run_ba, stop_at, n_iter=4):
    """The SLAM frame's three levels with a device carry."""
    src = torch.ones(4)
    out = torch.full((4,), -5.0)

    def kf_body():
        carry = (src * 10.0, torch.zeros(()),
                 torch.zeros((), dtype=torch.bool))

        def ba_body():
            x = carry[0].clone()
            k = torch.zeros(())
            done = torch.zeros((), dtype=torch.bool)
            for _ in range(n_iter):
                control.cond(~done, lambda: (x + 1.0, k + 1.0,
                                             k + 1.0 >= stop_at), (x, k, done))
            return x, k, done

        control.cond(torch.tensor(run_ba), ba_body, carry)
        return carry[0] + carry[1]

    control.cond(torch.tensor(is_kf), kf_body, out)
    return out


@pytest.mark.parametrize("mode", MODES)
def test_three_nested_levels(mode):
    for is_kf in (False, True):
        for run_ba in (False, True):
            for stop in (1.0, 3.0, 9.0):
                out = _run(mode, lambda: _nested(is_kf, run_ba, stop))
                iters = min(stop, 4) if run_ba else 0.0
                want = 10.0 + 2.0 * iters if is_kf else -5.0
                assert torch.equal(out, torch.full((4,), want)), \
                    (mode, is_kf, run_ba, stop)


@pytest.mark.parametrize("mode", MODES)
def test_out_that_shares_storage_with_the_inputs(mode):
    a = torch.arange(4, dtype=torch.float32)
    b = torch.arange(4, 8, dtype=torch.float32)
    # the body swaps the two leaves of its out: both read before a write
    _run(mode, lambda: control.cond(torch.tensor(True),
                                    lambda: (b, a), (a, b)))
    assert torch.equal(a, torch.arange(4, 8, dtype=torch.float32))
    assert torch.equal(b, torch.arange(4, dtype=torch.float32))
    # a view of an out leaf handed back for another leaf
    buf = torch.arange(8, dtype=torch.float32)
    lo, hi = buf[:4], buf[4:]
    _run(mode, lambda: control.cond(torch.tensor(True),
                                    lambda: (hi, lo * 10.0), (lo, hi)))
    assert torch.equal(buf, torch.tensor([4., 5., 6., 7., 0., 10., 20., 30.]))
    # a leaf handed back unchanged is left alone
    c = torch.ones(2)
    _run(mode, lambda: control.cond(torch.tensor(True),
                                    lambda: (c, c * 3.0), (c, a[:2])))
    assert torch.equal(c, torch.ones(2))


def test_capture_mode_needs_a_capture():
    with control.branching("capture"), pytest.raises(RuntimeError,
                                                     match="capture"):
        control.cond(torch.tensor(True), lambda: torch.ones(1),
                     torch.zeros(1))
    with pytest.raises(ValueError, match="branching mode"):
        with control.branching("sometimes"):
            pass


def test_predicate_and_result_shapes_are_checked():
    with pytest.raises(ValueError, match="0-d bool"):
        control.cond(torch.tensor([True]), lambda: torch.ones(1),
                     torch.zeros(1))
    with pytest.raises(ValueError, match="0-d bool"):
        control.cond(torch.tensor(1), lambda: torch.ones(1), torch.zeros(1))
    with pytest.raises(ValueError, match="destination"):
        control.cond(torch.tensor(True), lambda: torch.ones(2),
                     torch.zeros(1))
    with pytest.raises(ValueError, match="destination"):
        control.cond(torch.tensor(True),
                     lambda: torch.ones(1, dtype=torch.float64),
                     torch.zeros(1))


@pytest.mark.parametrize("mode", MODES)
def test_write_guard(mode):
    outside = torch.zeros(3)
    out = torch.zeros(3)

    def writes_outside():
        outside.add_(1.0)
        return outside * 2.0

    def writes_its_own():
        t = torch.zeros(3)
        t[1] = 5.0
        t.view(3)[2:].add_(1.0)
        return t

    with control.checking(), control.branching(mode):
        control.cond(torch.tensor(True), writes_its_own, out)
        assert torch.equal(out, torch.tensor([0.0, 5.0, 1.0]))
        with pytest.raises(RuntimeError, match="did not create"):
            control.cond(torch.tensor(True), writes_outside, out)
    # an inner branch writes its out, made by the outer body: allowed
    with control.checking(), control.branching(mode):
        def outer():
            carry = torch.zeros(2)
            control.cond(torch.tensor(True), lambda: carry + 1.0, carry)
            return carry.sum()

        res = torch.zeros(())
        control.cond(torch.tensor(True), outer, res)
    assert float(res) == 2.0
