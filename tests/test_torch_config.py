"""The port's own configuration module against the JAX package's: the same
classes, field names, defaults and presets, and convert.config_from_jax as
the lossless bridge between them."""

import dataclasses

import pytest

from putslam_tpu import config as jconfig
from putslam_tpu_torch import config as tconfig
from putslam_tpu_torch.convert import config_from_jax

CLASSES = ["CameraConfig", "DetectorConfig", "RansacConfig", "MatcherConfig",
           "TrackerConfig", "MapConfig", "BackendConfig", "LoopClosureConfig",
           "MotionModelConfig", "SlamConfig"]


def test_the_class_list_is_complete():
    """Every dataclass of the JAX package's config module is in CLASSES."""
    found = sorted(k for k, v in vars(jconfig).items()
                   if isinstance(v, type) and dataclasses.is_dataclass(v))
    assert found == sorted(CLASSES)


@pytest.mark.parametrize("preset", ["tiny_test_config", "tum_fr1_config"])
def test_presets_equal_the_jax_package(preset):
    ref = getattr(jconfig, preset)()
    got = getattr(tconfig, preset)()
    assert type(got) is tconfig.SlamConfig
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


@pytest.mark.parametrize("name", CLASSES)
def test_same_fields_and_defaults(name):
    jcls, tcls = getattr(jconfig, name), getattr(tconfig, name)
    assert tcls is not jcls and tcls.__module__ == "putslam_tpu_torch.config"
    jf, tf = dataclasses.fields(jcls), dataclasses.fields(tcls)
    assert [f.name for f in tf] == [f.name for f in jf]
    assert [f.type for f in tf] == [f.type for f in jf]
    assert dataclasses.asdict(tcls()) == dataclasses.asdict(jcls())
    with pytest.raises(dataclasses.FrozenInstanceError):
        setattr(tcls(), tf[0].name, None)


def _non_default():
    """A JAX-package config with one non-default value in every sub-config
    and at the top level."""
    c = jconfig.SlamConfig()
    return c.replace(
        camera=dataclasses.replace(c.camera, fu=500.0, width=320),
        detector=dataclasses.replace(c.detector, use_pallas_detect=True,
                                     nms_radius=5),
        ransac=dataclasses.replace(c.ransac, n_hypotheses=64),
        matcher=dataclasses.replace(c.matcher, acceptance="ratio"),
        tracker=dataclasses.replace(c.tracker, patch_refine=True),
        map=dataclasses.replace(c.map, max_keyframes=17),
        backend=dataclasses.replace(c.backend, solver="pcg", damping=1e-3),
        loop_closure=dataclasses.replace(c.loop_closure, enabled=True),
        motion_model=dataclasses.replace(c.motion_model, decay=0.5),
        vo_version=1, max_vo_translation=0.25)


def test_config_from_jax_round_trips():
    ref = _non_default()
    for src in (ref, dataclasses.asdict(ref)):
        got = config_from_jax(src)
        assert type(got) is tconfig.SlamConfig
        for f in dataclasses.fields(got):
            sub = getattr(got, f.name)
            if dataclasses.is_dataclass(sub):
                assert type(sub) is getattr(tconfig, type(sub).__name__)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    # and back: the JAX package's classes from the port's dict
    d = dataclasses.asdict(config_from_jax(ref))
    back = jconfig.SlamConfig(**{
        k: (type(getattr(ref, k))(**v) if isinstance(v, dict) else v)
        for k, v in d.items()})
    assert back == ref


def test_config_from_jax_takes_a_sub_config():
    got = config_from_jax(jconfig.TrackerConfig(win_size=9))
    assert got == tconfig.TrackerConfig(win_size=9)
    assert config_from_jax(tconfig.tiny_test_config()) == \
        tconfig.tiny_test_config()


@pytest.mark.parametrize("bad", [
    {"no_such_field": 1},
    {"camera": {"fu": 1.0, "focal": 2.0}},
])
def test_config_from_jax_raises_on_an_unknown_field(bad):
    with pytest.raises(TypeError, match="no field"):
        config_from_jax(bad)


def test_config_from_jax_raises_on_an_unknown_class():
    @dataclasses.dataclass
    class ImuConfig:
        rate: float = 200.0

    with pytest.raises(TypeError):
        config_from_jax(ImuConfig())
    with pytest.raises(TypeError):
        config_from_jax(3)


def test_replace_behaves_as_the_jax_package():
    jc, tc = jconfig.tum_fr1_config(), tconfig.tum_fr1_config()
    j2 = jc.replace(vo_version=1, only_vo=True)
    t2 = tc.replace(vo_version=1, only_vo=True)
    assert dataclasses.asdict(t2) == dataclasses.asdict(j2)
    assert tc.vo_version == 0 and t2 is not tc      # a copy, not in place
    with pytest.raises(TypeError):
        tc.replace(no_such_field=1)
    with pytest.raises(TypeError):
        jc.replace(no_such_field=1)
    assert tconfig.tum_fr1_config(vo_version=1).vo_version == 1
    assert dataclasses.asdict(tconfig.tum_fr1_config(only_vo=True)) == \
        dataclasses.asdict(jconfig.tum_fr1_config(only_vo=True))
