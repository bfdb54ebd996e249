"""Checkpoints carry across: a JAX ``SplitSession.save`` restores into the
port by its keys, and a port save loads with ``repro``'s ``load_checkpoint``,
leaf-equal both ways."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.io import load_checkpoint as j_load_checkpoint
from repro.configs.paper_models import COVID_CNN
from repro.core import SplitSession, SplitTrainConfig
from repro.core.adapters import cnn_adapter
from repro.optim import adamw
from repro.privacy import DPConfig
from repro_torch.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from repro_torch.common.bridge import flatten, to_torch

SMALL_CNN = dataclasses.replace(
    COVID_CNN, input_hw=(16, 16), stages=((8, 1), (16, 1)), dense_units=(16,))


@pytest.fixture(scope="module")
def session():
    s = SplitSession(cnn_adapter(SMALL_CNN),
                     SplitTrainConfig(server_batch=12, privacy=DPConfig(clip_norm=1.0)),
                     adamw(1e-3), engine="auto", seed=0)
    return s


def _assert_leaf_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_jax_checkpoint_restores_into_port(session, tmp_path):
    path = session.save(str(tmp_path))
    assert latest_checkpoint(str(tmp_path)) == path
    tree, manifest = load_checkpoint(path, device="cpu")
    assert manifest["metadata"]["adapter"] == SMALL_CNN.name
    assert isinstance(tree["server"]["stages"], list)
    assert isinstance(tree["step"], torch.Tensor) and tree["step"].dtype == torch.int32
    _assert_leaf_equal(flatten(tree), flatten(jax.device_get(session.state)))


def test_port_checkpoint_loads_in_jax(session, tmp_path):
    state = to_torch(session.state, "cpu")
    path = save_checkpoint(str(tmp_path), int(state["step"]), state, {"from": "port"})
    restored, manifest = j_load_checkpoint(path, session.state)
    assert manifest["metadata"] == {"from": "port"}
    _assert_leaf_equal(flatten(restored), flatten(jax.device_get(session.state)))
    # and back into the port from its own file
    again, _ = load_checkpoint(path, device="cpu")
    _assert_leaf_equal(flatten(again), flatten(state))


def _bridge_tree():
    return {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "stages": [{"b": jax.numpy.ones((3,), jax.numpy.float32)},
                       (np.int32(7), None)],
            "t": torch.arange(4, dtype=torch.int64)}


def test_to_torch_default_device_is_the_card(monkeypatch):
    """``device=None`` means the card, as everywhere in the port: with no
    card it raises rather than leave the tree on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        to_torch(_bridge_tree())


def test_to_torch_on_cpu_copies_arrays_and_keeps_tensors():
    tree = _bridge_tree()
    got = to_torch(tree, "cpu")
    assert got["w"].dtype == torch.float32 and got["w"].device.type == "cpu"
    np.testing.assert_array_equal(got["w"].numpy(), tree["w"])
    assert not np.shares_memory(got["w"].numpy(), tree["w"])  # a copy
    assert torch.equal(got["stages"][0]["b"], torch.ones(3))  # a JAX array leaf
    assert got["stages"][1][0].dtype == torch.int32 and int(got["stages"][1][0]) == 7
    assert got["stages"][1][1] is None and isinstance(got["stages"][1], list)
    assert got["t"] is tree["t"]  # already there: not copied
