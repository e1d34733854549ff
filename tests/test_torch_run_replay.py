"""The port's replay CLI (`orbslam2_nmi_torch.run_replay`), on the CPU.

`--synthetic 12` runs the JAX package's synthetic replay configuration
(the seed-3 point world at 320x240, NMI latches on its point model) over a
12-frame path; at that cadence the init pair's baseline gives 28 points and
tracking is lost at frame 5 and reset, in both packages (measured), so the
test holds the run's end and its files, not its accuracy (the end-to-end
bars are `tests/test_torch_system.py`'s).
"""

import re

import numpy as np
import pytest

from orbslam2_nmi_torch import run_replay


def _image(path):
    """An artifact as an array: a PNG file, or its `.npy` where PIL is absent."""
    try:
        from PIL import Image
    except ImportError:
        return np.load(str(path) + ".npy")
    return np.asarray(Image.open(path))


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
    """The two visualization flags, which stopped with an error before the
    port had `viz/`, now write their artifacts: `--viz 5` a keypoint drawing
    every 5th frame and the top-down map at exit (25 frames, so the map
    holds keyframes at the end), `--debug-images` the localizer's best and
    middle overlays of every grid evaluation, named by the grid cell (frame
    0's NMI latch, four grids)."""
    viz = flag[0] == "--viz"
    n = 25 if viz else 1
    assert run_replay.main(["--synthetic", str(n), "--device", "cpu", "--output",
                            str(tmp_path)] + flag) == 0
    assert f"/{n} frames" in capsys.readouterr().out
    files = sorted(p.name.removesuffix(".npy") for p in tmp_path.iterdir())
    drawings = [f for f in files if f.startswith("frame_")]
    overlays = (sorted(p.name.removesuffix(".npy") for p in (tmp_path / "nmi_debug").iterdir())
                if not viz else [])
    if viz:
        assert drawings == [f"frame_{i:06d}.png" for i in range(4, n, 5)]
        assert "map_topdown.png" in files and "nmi_debug" not in files
    else:
        assert not drawings and "map_topdown.png" not in files
        assert len(overlays) >= 4 and len(overlays) % 2 == 0
        for a, b in zip(overlays[::2], overlays[1::2]):  # each sweep: best, then middle
            assert re.fullmatch(r"\d{4}_best_s\d+_r\d+_nmi[-\d.]+\.png", a), a
            assert re.fullmatch(r"\d{4}_middle_s\d+_r\d+_nmi[-\d.]+\.png", b), b
            assert a[:4] == b[:4]
    for name in drawings + ["map_topdown.png"] * viz:
        img = _image(tmp_path / name)
        assert img.dtype == np.uint8 and img.shape[2] == 3
    for name in overlays:
        img = _image(tmp_path / "nmi_debug" / name)
        assert img.shape == (240, 320, 3) and not img[..., 2].any()


def test_device_choices(capsys):
    with pytest.raises(SystemExit) as e:
        run_replay.main(["--synthetic", "3", "--device", "tpu"])
    assert e.value.code == 2 and "invalid choice" in capsys.readouterr().err
