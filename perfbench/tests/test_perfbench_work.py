"""The yardstick's counts against the ones worked out by hand."""
import pytest

from perfbench import work
from perfbench.bench import load_json
from perfbench.tests.conftest import ROOT

MURA = load_json(ROOT / "perfbench/configs/mura-vgg19.json")
COVID = load_json(ROOT / "perfbench/configs/covid-ct-cnn.json")


def test_vgg19_multiply_adds():
    # block 1 at 224^2: 1->64 and 64->64 convolutions
    assert work.client_macs(MURA) == 224 * 224 * 9 * (1 * 64 + 64 * 64)
    assert work.client_macs(MURA) / 1e9 == pytest.approx(1.879, abs=5e-4)
    assert work.trunk_macs(MURA) / 1e9 == pytest.approx(17.69, abs=5e-3)
    assert work.first_trunk_macs(MURA) == 112 * 112 * 9 * 64 * 128


def test_covid_cnn_multiply_adds():
    total = work.client_macs(COVID) + work.trunk_macs(COVID)
    assert total / 1e6 == pytest.approx(19.53, abs=5e-3)
    assert work.client_macs(COVID) == 64 * 64 * 9 * 16


def test_operations_a_row():
    assert work.serve_flops_per_row(MURA) == 2 * (work.client_macs(MURA) + work.trunk_macs(MURA))
    t = work.trunk_macs(MURA)
    assert work.detached_train_flops_per_row(MURA) == 2 * (
        work.client_macs(MURA) + 3 * t - work.first_trunk_macs(MURA))


def test_feature_shape_and_sigma():
    assert work.feature_shape(MURA, 3) == (3, 112, 112, 64)
    assert work.feature_shape(COVID, 256) == (256, 32, 32, 16)
    assert work.sigma(MURA["guard"]) == pytest.approx(9.6896, abs=1e-4)


def test_bounds_of_the_kernels():
    # the release: x and the output a float each, and the noise
    r = work.release_work((3, 112, 112, 64), 9.69)
    n = 3 * 112 * 112 * 64
    assert r["bytes"] == 12 * n and r["flops"] == 5 * n and r["bound_by"] == "bytes"
    assert r["bound_s"] == pytest.approx(12 * n / 3.35e12)
    c = work.conv_work(256, 64, 64, 1, 16, 0.05)
    out = 256 * 32 * 32 * 16
    assert c["bytes"] == 4 * (256 * 64 * 64 + 9 * 16 + 16 + 2 * out)
    assert c["flops"] == 256 * 64 * 64 * 16 * 20 + 5 * out
    assert work.bound(0, 67e12)["bound_s"] == pytest.approx(1.0)
