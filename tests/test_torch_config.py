"""The port's configuration against the JAX package's: the dataclasses, the
ORB level budget and the OpenCV-YAML reader, all exact (pure Python)."""

import dataclasses

import numpy as np
import pytest

from orbslam2_nmi_torch import config as tconfig
from orbslam2_nmi_torch import convert
from orbslam2_nmi_tpu import config as jconfig

YAML = """%YAML:1.0
# comment
Camera.fx: 435.5
Viewer.PointSize:2
NMI.Init1: !!opencv-matrix
    rows: 4
    cols: 4
    dt: f
    data: [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1]
"""

# a settings file in the reference's layout (ETH_small.yaml's keys), with a
# matrix whose data runs over several lines
SETTINGS = """%YAML:1.0
Camera.fx: 435.04593205
Camera.fy: 435.04593205
Camera.cx: 475.55781765
Camera.cy: 274.7487729
Camera.k1: -0.01
Camera.fps: 25.0
Camera.RGB: 0
Camera.Width: 960
Camera.Height: 540
ORBextractor.nFeatures: 1500
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 6
ORBextractor.iniThFAST: 18
ORBextractor.minThFAST: 6
Viewer.KeyFrameSize: 0.05
Viewer.ViewpointY: -0.7
NMI.Offset: 12
NMI.Treshold: 0.09
NMI.SynthNumX: 5
NMI.WarpStepZ: 0.04
NMI.Render.Object: "model.obj"
NMI.Init1: !!opencv-matrix
   rows: 4
   cols: 4
   dt: f
   data: [ 0.1, 0.2, 0.3, -73.0683,
           0.4, 0.5, 0.6, 1.5,
           0.7, 0.8, 0.9, 2.5e-1,
           0, 0, 0, 1 ]
"""

NAMES = ["CameraConfig", "ORBConfig", "NMIGridConfig", "NMIConfig", "ViewerConfig",
         "TrackingConfig", "SystemConfig"]


def test_parse_opencv_yaml_scalars_and_matrices():
    """tests/test_config.py's inline YAML, through both readers."""
    t, j = tconfig.parse_opencv_yaml(YAML), jconfig.parse_opencv_yaml(YAML)
    assert t.keys() == j.keys()
    assert t["Camera.fx"] == j["Camera.fx"] == 435.5
    assert t["Viewer.PointSize"] == j["Viewer.PointSize"] == 2
    assert type(t["Viewer.PointSize"]) is type(j["Viewer.PointSize"]) is int
    np.testing.assert_array_equal(t["NMI.Init1"], j["NMI.Init1"])
    assert t["NMI.Init1"].dtype == np.float32 and t["NMI.Init1"].shape == (4, 4)


def test_load_yaml_config_matches_reference(tmp_path):
    path = tmp_path / "settings.yaml"
    path.write_text(SETTINGS)
    t, j = tconfig.load_yaml_config(str(path)), jconfig.load_yaml_config(str(path))
    dt, dj = dataclasses.asdict(t), dataclasses.asdict(j)
    np.testing.assert_array_equal(dt["nmi"].pop("init1"), dj["nmi"].pop("init1"))
    assert dt == dj
    assert t.orb.n_features == 1500 and t.nmi.grid.synth_num == (5, 3, 3)
    assert t.tracking.max_frames == 25 and t.camera.k1 == -0.01
    assert abs(float(t.nmi.init1[0, 3]) + 73.0683) < 1e-4


@pytest.mark.parametrize("n_features,n_levels,scale", [(2000, 8, 1.2), (500, 8, 1.2),
                                                       (200, 4, 1.2), (1000, 5, 1.5),
                                                       (7, 8, 1.2)])
def test_features_per_level(n_features, n_levels, scale):
    kw = dict(n_features=n_features, n_levels=n_levels, scale_factor=scale)
    t = tconfig.ORBConfig(**kw).features_per_level()
    np.testing.assert_array_equal(t, jconfig.ORBConfig(**kw).features_per_level())
    # the reference's rounding can overshoot a tiny budget (7 -> 8), never a real one
    assert t.dtype == np.int32 and (t.sum() == n_features or n_features < n_levels)
    np.testing.assert_array_equal(tconfig.ORBConfig(**kw).scale_factors,
                                  jconfig.ORBConfig(**kw).scale_factors)


@pytest.mark.parametrize("name", NAMES)
def test_default_dataclasses_match_reference(name):
    t, j = getattr(tconfig, name)(), getattr(jconfig, name)()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_system_config_converts():
    j = jconfig.SystemConfig(orb=jconfig.ORBConfig(n_features=500),
                             tracking=jconfig.TrackingConfig(pose_opt_iters=5))
    t = convert.system_config_from_dict(dataclasses.asdict(j))
    assert t == tconfig.SystemConfig(orb=tconfig.ORBConfig(n_features=500),
                                     tracking=tconfig.TrackingConfig(pose_opt_iters=5))
    assert t.replace(output_dir="x").output_dir == "x"
