import pytest

from slam3d_gx import config


def test_defaults_cover_reference_keys():
    pr = config.ParameterReader(None)
    for key in config.REFERENCE_KEYS + config.INTRINSIC_KEYS:
        assert pr.GetPara(key) != ""


def test_parses_reference_yaml_dialect(reference_dir):
    pr = config.ParameterReader(reference_dir + "/parameters.yaml")
    assert pr.GetPara("detector_name") == "SIFT"
    assert pr.get_int("start_index") == 1
    assert pr.get_int("end_index") == 2800
    assert pr.get_float("max_pos_change") == 0.25
    assert pr.get_bool("loop_closure_detection") is True
    assert pr.get_bool("use_odometry") is False
    intr = pr.intrinsics
    assert intr.fx == 517.0 and intr.factor == 5000.0


def test_unknown_key_raises():
    pr = config.ParameterReader(None)
    with pytest.raises(KeyError):
        pr.GetPara("nope")


def test_overrides_and_validation(tmp_path):
    p = tmp_path / "p.yaml"
    p.write_text("%YAML:1.0\n# c\nstart_index: 5\nend_index: 9\ndetector_name: FAST # trailing\n")
    pr = config.ParameterReader(str(p))
    assert pr.get_int("start_index") == 5
    assert pr.GetPara("detector_name") == "FAST"
    with pytest.raises(ValueError):
        config.ParameterReader(str(p), overrides={"end_index": "5"})


def test_presets():
    fr1 = config.CameraIntrinsics.preset("fr1")
    assert fr1.cx == 318.6
    default = config.CameraIntrinsics.preset("default")
    assert default.factor == 1000.0
