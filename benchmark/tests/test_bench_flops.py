"""Each configuration's frozen operation counts recounted: one GAN train
step at 512 rows (`train/flops.canonical_train_step_flops` with the
configuration's variant) and one eval-mode generator window forward of one
clip (`train/flops.fn_flops`), exactly."""

import pytest
import torch

from bench_tiny import core

CONFIGS = [c["name"] for c in core.benchmark_file()["configs"]]


def _files(name):
    conf = next(c for c in core.benchmark_file()["configs"] if c["name"] == name)
    import json
    return json.loads((core.ROOT / conf["file"]).read_text())


def _port_cfg(config):
    from benchmark.drivers.train import _port_config

    return _port_config(core.model_dims(config), 512)


@pytest.mark.parametrize("name", CONFIGS)
def test_train_step_flops(name):
    from speech2affective_gestures_torch.train.flops import canonical_train_step_flops

    config = _files(name)
    dims = core.model_dims(config)
    got = canonical_train_step_flops(_port_cfg(config), 512, n_words=dims["n_words"],
                                     n_speakers=dims["n_speakers"], variant=dims["variant"])
    assert got == config["flops"]["train_step_b512"]


def test_s2ag_count_is_the_one_perf_md_gives():
    assert _files("s2ag")["flops"]["train_step_b512"] == 1_705_916_637_227


@pytest.mark.parametrize("name", CONFIGS)
def test_window_forward_flops(name):
    from speech2affective_gestures_torch.models.generator import make_pose_generator
    from speech2affective_gestures_torch.train.flops import fn_flops

    config = _files(name)
    dims = core.model_dims(config)
    gen = make_pose_generator(_port_cfg(config), dims["n_words"], dims["n_speakers"],
                              dims["variant"]).eval()
    t = dims["n_poses"]
    args = (torch.zeros(1, t, 28), torch.zeros(1, t, dtype=torch.long),
            torch.zeros(1, dims["num_mfcc_combined"], dims["mfcc_length"]),
            torch.zeros(1, dtype=torch.long))
    with torch.no_grad():
        got = fn_flops(lambda *a: gen(*a, eps=torch.zeros(1, 16)), *args)
    assert got == config["flops"]["window_forward_b1"]
