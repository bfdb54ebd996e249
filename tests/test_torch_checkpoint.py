"""Checkpoints carry across: a JAX ``SplitSession.save`` restores into the
port by its keys, and a port save loads with ``repro``'s ``load_checkpoint``,
leaf-equal both ways."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.io import load_checkpoint as j_load_checkpoint
from repro.checkpoint.io import save_checkpoint as j_save_checkpoint
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


def _bf16_tree():
    """bfloat16 leaves whose bits a float32 round trip would not keep: a
    NaN payload, -0, the largest finite value, a subnormal, and a 0-d one."""
    bits = np.array([0x7FC1, 0x8000, 0x7F7F, 0x0001, 0x3EAB, 0xC2F7], np.uint16)
    rng = np.random.default_rng(4)
    return {"w": jax.numpy.asarray(rng.standard_normal((3, 5)), jax.numpy.bfloat16),
            "odd": [jax.lax.bitcast_convert_type(jax.numpy.asarray(bits), jax.numpy.bfloat16)],
            "s": jax.numpy.asarray(1.5, jax.numpy.bfloat16),
            "f": jax.numpy.ones((2,), jax.numpy.float32)}


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint16)


def test_to_torch_carries_bfloat16_bits():
    tree = _bf16_tree()
    got = to_torch(tree, "cpu")
    for key, want in (("w", tree["w"]), ("s", tree["s"]), ("odd", tree["odd"][0])):
        t = got[key][0] if key == "odd" else got[key]
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == want.shape, key
        np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                      _bits(want), err_msg=key)
    assert got["f"].dtype == torch.float32


def test_port_checkpoint_round_trips_bfloat16(tmp_path):
    state = to_torch(_bf16_tree(), "cpu")
    flat = flatten(state)
    assert flat["w"].dtype == np.dtype("V2")  # the JAX writer's bits on disk
    path = save_checkpoint(str(tmp_path), 3, state)
    again, _ = load_checkpoint(path, device="cpu")
    got = flatten(again)
    assert sorted(got) == sorted(flat)
    for k, want in flat.items():
        assert got[k].dtype == want.dtype and got[k].shape == want.shape, k
        assert got[k].tobytes() == want.tobytes(), k
    assert again["w"].dtype == torch.bfloat16 and again["f"].dtype == torch.float32


def test_jax_bfloat16_checkpoint_loads_in_port(tmp_path):
    tree = _bf16_tree()
    path = j_save_checkpoint(str(tmp_path), 5, tree)
    got, manifest = load_checkpoint(path, device="cpu")
    assert manifest["step"] == 5
    for key, want in (("w", tree["w"]), ("s", tree["s"]), ("odd", tree["odd"][0])):
        t = got[key][0] if key == "odd" else got[key]
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == want.shape, key
        np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                      _bits(want), err_msg=key)
