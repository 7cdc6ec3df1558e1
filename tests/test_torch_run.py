"""The port's command-line runner writes the reference's output files."""

import json

import pytest

from putslam_tpu_torch import run


def test_run_synthetic_writes_outputs(tmp_path, capsys):
    assert run.main(["--synthetic", "3", "--device", "cpu", "--out",
                     str(tmp_path)]) == 0
    for name in ("VO_trajectory.res", "graph_trajectory.res", "fps.res",
                 "times.txt"):
        assert (tmp_path / name).stat().st_size > 0, name
    assert len((tmp_path / "graph_trajectory.res").read_text()
               .splitlines()) == 3
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["frames"] == 3 and report["device"] == "cpu"


@pytest.mark.parametrize("flag", [["--loop-closure"], ["--dataset", "x"],
                                  ["--global-ba"], ["--vo-version", "1"],
                                  ["--plots"]])
def test_unported_flags_exit_with_error(flag, capsys):
    with pytest.raises(SystemExit) as e:
        run.main(["--synthetic", "3", "--device", "cpu", *flag])
    assert e.value.code != 0
    assert "not yet ported" in capsys.readouterr().err


def test_cuda_requested_without_a_card_raises(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        run.main(["--synthetic", "3", "--out", str(tmp_path)])
