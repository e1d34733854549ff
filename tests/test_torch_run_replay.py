"""The port's replay CLI (`orbslam2_nmi_torch.run_replay`), on the CPU.

`--synthetic 12` runs the JAX package's synthetic replay configuration
(the seed-3 point world at 320x240, NMI latches on its point model) over a
12-frame path; at that cadence the init pair's baseline gives 28 points and
tracking is lost at frame 5 and reset, in both packages (measured), so the
test holds the run's end and its files, not its accuracy (the end-to-end
bars are `tests/test_torch_system.py`'s).
"""

import pytest

from orbslam2_nmi_torch import run_replay


def test_synthetic_replay_writes_outputs(tmp_path, capsys):
    assert run_replay.main(["--synthetic", "12", "--device", "cpu", "--output",
                            str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "tracked" in out and "/12 frames" in out and "median tracking time" in out
    for name in ("FullTrajectory.txt", "FullTrajectory_twc.txt", "KeyFrameTrajectory.txt",
                 "MapPoints.xyz", "_log.txt"):
        assert (tmp_path / name).exists(), name
    log = (tmp_path / "_log.txt").read_text()
    assert "frame 0: NMI ok" in log and "NMI initialization" in log


@pytest.mark.parametrize("flag", [["--viz", "5"], ["--debug-images"]])
def test_visualization_flags_stop_with_an_error(tmp_path, capsys, flag):
    with pytest.raises(SystemExit) as e:
        run_replay.main(["--synthetic", "3", "--device", "cpu", "--output", str(tmp_path)]
                        + flag)
    assert e.value.code == 2
    assert "visualization module" in capsys.readouterr().err
    assert not any(tmp_path.iterdir())


def test_device_choices(capsys):
    with pytest.raises(SystemExit) as e:
        run_replay.main(["--synthetic", "3", "--device", "tpu"])
    assert e.value.code == 2 and "invalid choice" in capsys.readouterr().err
