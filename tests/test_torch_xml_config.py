"""The port's reader of the reference's XML configuration files against the
JAX package's: a small ``resources/`` tree written here, with the element
and attribute names the readers look for (and one file with several
top-level elements, an XML declaration and unresolved conflict markers for
the lenient parser), loaded by both and held field by field through
``convert.config_from_jax``. Exact: both read the same text into Python
floats and ints."""

import dataclasses

import pytest
from _torch_port import port_cfg, write_resources

from putslam_tpu.config import SlamConfig as JSlamConfig
from putslam_tpu.io import xml_config as jxml
from putslam_tpu_torch import config as tconfig
from putslam_tpu_torch.io import xml_config as txml

@pytest.fixture()
def resources(tmp_path):
    return write_resources(tmp_path / "resources")


def _same(ours, ref):
    """Field by field, nested configs included."""
    assert type(ours).__name__ == type(ref).__name__
    converted = port_cfg(ref)
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(converted, f.name), f.name
    assert ours == converted


def test_lenient_parser(resources):
    for name in ("putslamconfigGlobal.xml", "putslamfileModel.xml",
                 "datasetConfig/desk.xml"):
        ours = txml._parse_lenient(str(resources / name))
        ref = jxml._parse_lenient(str(resources / name))
        assert [(e.tag, dict(e.attrib)) for e in ours.iter()] == \
            [(e.tag, dict(e.attrib)) for e in ref.iter()]
    model = txml._parse_lenient(str(resources / "putslamfileModel.xml"))
    assert [e.get("datasetFile") for e in model.iter("Model")] == \
        ["datasetConfig/desk.xml"]                 # the HEAD side is kept


def test_load_camera_config_equal(resources):
    path = str(resources / "datasetConfig" / "desk.xml")
    ours = txml.load_camera_config(path)
    _same(ours, jxml.load_camera_config(path))
    assert isinstance(ours, tconfig.CameraConfig)
    assert (ours.fu, ours.cv, ours.width, ours.height) == \
        (525.0, 239.5, 320, 240)
    assert ours.depth_image_scale == 1000.0 and ours.var_c0 == 0.4
    # a file without the optional elements keeps the base's values
    base = tconfig.CameraConfig(width=64, height=48, k1=0.5)
    part = txml.load_camera_config(
        str(resources / "datasetConfig" / "other.xml"), base)
    assert (part.fu, part.cu, part.width, part.k1) == (481.2, 100.0, 64, 0.5)


def test_load_matcher_and_map_config_equal(resources):
    mpath = str(resources / "putslammatcherOpenCVParameters.xml")
    ours = txml.load_matcher_config(mpath, tconfig.SlamConfig())
    _same(ours, jxml.load_matcher_config(mpath, JSlamConfig()))
    assert ours.vo_version == 1 and ours.ransac.used_pairs == 4
    assert ours.detector.descriptor == "ldb" and ours.detector.nms_radius == 4
    assert ours.tracker.patch_refine and ours.tracker.patch_refine_win == 13
    ppath = str(resources / "putslammapConfig.xml")
    ours = txml.load_map_config(ppath, tconfig.SlamConfig())
    _same(ours, jxml.load_map_config(ppath, JSlamConfig()))
    assert ours.map.use_uncertainty and ours.map.uncertainty_model == "gradient"
    assert ours.backend.error_type == 1
    assert ours.map.add_pose_to_pose_edges is False
    assert ours.map.max_frames_window == 120


@pytest.mark.parametrize("dataset", [None, "other", "desk.xml", "absent"])
def test_load_reference_config_equal(resources, dataset):
    ours = txml.load_reference_config(str(resources), dataset)
    _same(ours, jxml.load_reference_config(str(resources), dataset))
    assert isinstance(ours, tconfig.SlamConfig)
    assert ours.loop_closure.enabled and not ours.only_vo
    want = {None: 525.0, "other": 481.2, "desk.xml": 525.0,
            "absent": tconfig.CameraConfig().fu}[dataset]
    assert ours.camera.fu == want


def test_empty_resources_give_the_defaults(tmp_path):
    assert txml.load_reference_config(str(tmp_path)) == tconfig.SlamConfig()
