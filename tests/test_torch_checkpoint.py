"""The port's checkpointing (repro_torch.checkpoint) against the JAX
package's (repro.checkpoint), and ``--ckpt-dir`` through both trainers.

Mirrors the checkpoint tests of tests/test_substrate.py (4) and three of
the four of tests/test_population.py::TestCheckpoint; the fourth,
``test_store_save_restore``, is mirrored with the port's
``PopulationStore`` in tests/test_torch_population.py.  Across the
packages: a tree with an f32, a bf16 and a 0-d int32 leaf written by one
is read by the other bit for bit, both ways, and the two packages write
byte-identical files for the same tree, DeepSeek-V2-Lite's MoE and MLA
parameter and decode-cache trees and Gemma3-12B's and Nemotron-4-15B's
(smoke size, bf16 caches) among them.  Both trainers, run with
``--ckpt-dir`` at a tiny size under the replayed draws of
tests/test_torch_train.py, save checkpoints at the same steps with the
same keys, shapes, dtypes and step leaves, parameters within
1e-5·max|x|.
"""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as ref_ckpt
from repro.configs import get_config as ref_get_config
from repro.configs.base import FedConfig as RefFedConfig
from repro.data.federated_lm import make_federated_lm as ref_make_data
from repro.launch import train as ref_train
from repro.models import build_model as ref_build_model
from repro_torch.checkpoint import (latest_population_step, latest_step,
                                    load_checkpoint, load_population,
                                    require_codecs, save_checkpoint,
                                    save_population)
from repro_torch.configs import get_config
from repro_torch.configs.base import FedConfig
from repro_torch.core import flat as flat_lib
from repro_torch.launch import train as port_train
from repro_torch.models import build_model
from repro_torch.tree import sorted_leaves, tree_map
from test_torch_train import (BATCH, D_MODEL, LAYERS, SEQ, VOCAB,
                              ReplayTrainDraws)

# ---------------------------------------------------------------------------
# tests/test_substrate.py::TestCheckpoint
# ---------------------------------------------------------------------------


def test_roundtrip_structure_and_dtypes(tmp_path):
    tree = {"a": torch.arange(6).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.bfloat16),
                  "d": torch.zeros((), dtype=torch.int32)}}
    save_checkpoint(str(tmp_path), 3, tree)
    out = load_checkpoint(str(tmp_path), 3)
    assert out["b"]["c"].dtype == torch.bfloat16
    assert out["b"]["d"].dtype == torch.int32 and out["b"]["d"].shape == ()
    assert torch.equal(out["a"], tree["a"])


def test_latest_and_atomicity(tmp_path):
    d = str(tmp_path)
    assert latest_step(d) is None
    for s in (1, 5, 3):
        save_checkpoint(d, s, {"x": torch.zeros(2)})
    assert latest_step(d) == 5
    assert not any(f.endswith(".tmp") for f in os.listdir(d))
    assert torch.equal(load_checkpoint(d)["x"], torch.zeros(2))


def test_restore_with_template_casts(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"x": torch.ones((2, 2))})
    like = {"x": torch.zeros((2, 2), dtype=torch.bfloat16,
                             device="meta")}
    out = load_checkpoint(str(tmp_path), 1, like=like)
    assert out["x"].dtype == torch.bfloat16 and out["x"].device.type == "meta"
    out = load_checkpoint(str(tmp_path), 1,
                          like={"x": torch.zeros((2, 2), dtype=torch.float64)})
    assert torch.equal(out["x"], torch.ones((2, 2), dtype=torch.float64))


def test_leaf_count_mismatch_raises(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"x": torch.zeros(2)})
    with pytest.raises(ValueError, match="1 leaves, template has 2"):
        load_checkpoint(str(tmp_path), 1, like={"x": torch.zeros(2),
                                                "y": torch.zeros(2)})


# ---------------------------------------------------------------------------
# tests/test_population.py::TestCheckpoint (the store's own test is in
# tests/test_torch_population.py)
# ---------------------------------------------------------------------------


def test_chunked_roundtrip(tmp_path):
    rows = np.arange(40, dtype=np.float32).reshape(10, 4)
    last = np.arange(10, dtype=np.int64) - 1
    save_population(str(tmp_path), 7, rows, last, chunk_rows=3)
    for mmap in (True, False):
        got, got_last, meta = load_population(str(tmp_path), mmap=mmap)
        np.testing.assert_array_equal(got, rows)
        np.testing.assert_array_equal(got_last, last)
    assert meta["n_total"] == 10 and meta["d"] == 4 and meta["step"] == 7
    assert latest_population_step(str(tmp_path)) == 7
    # the reference reads the port's snapshot
    got, got_last, _ = ref_ckpt.load_population(str(tmp_path), mmap=False)
    np.testing.assert_array_equal(got, rows)
    np.testing.assert_array_equal(got_last, last)


def test_latest_picks_max_step(tmp_path):
    rows = np.zeros((4, 2), np.float32)
    last = np.zeros(4, np.int64)
    for step in (3, 12, 5):
        save_population(str(tmp_path), step, rows, last)
    assert latest_population_step(str(tmp_path)) == 12
    assert latest_population_step(str(tmp_path / "nope")) is None


def test_save_validates_shapes(tmp_path):
    with pytest.raises(ValueError, match="rows must be"):
        save_population(str(tmp_path), 0, np.zeros((3, 2)), np.zeros(4))


# ---------------------------------------------------------------------------
# Across the packages
# ---------------------------------------------------------------------------


def _trees(seed: int = 0):
    """(reference tree, port tree): an f32, a bf16 and a 0-d int32 leaf,
    the same bits; keys out of order at both levels."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((3, 5), dtype=np.float32)
    h = rng.standard_normal((7,), dtype=np.float32).astype(ml_dtypes.bfloat16)
    ref = {"step": jnp.asarray(np.int32(11)),
           "params": {"w": jnp.asarray(w), "h": jnp.asarray(h)}}
    port = {"step": torch.tensor(11, dtype=torch.int32),
            "params": {"w": torch.from_numpy(w.copy()),
                       "h": torch.from_numpy(h.view(np.int16).copy()).view(
                           torch.bfloat16)}}
    return ref, port


def _assert_same_bits(port_tree, ref_tree):
    got, want = list(sorted_leaves(port_tree)), list(sorted_leaves(
        jax.tree.map(np.asarray, ref_tree)))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).removeprefix("torch.") == w.dtype.name, path
        bits = g.view(torch.int16) if g.dtype == torch.bfloat16 else g
        wbits = w.view(np.int16) if w.dtype.name == "bfloat16" else w
        np.testing.assert_array_equal(bits.numpy(), wbits, err_msg=str(path))


def test_reference_checkpoint_loads_into_the_port(tmp_path):
    ref, _ = _trees(1)
    ref_ckpt.save_checkpoint(str(tmp_path), 11, ref)
    _assert_same_bits(load_checkpoint(str(tmp_path)), ref)


def test_port_checkpoint_loads_into_the_reference(tmp_path):
    ref, port = _trees(2)
    save_checkpoint(str(tmp_path), 11, port)
    back = ref_ckpt.load_checkpoint(str(tmp_path))
    assert back["params"]["h"].dtype == jnp.bfloat16
    assert back["step"].dtype == np.int32 and back["step"].shape == ()
    _assert_same_bits(port, back)
    # and onto a template: the reference casts to it, as the port does
    like = jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32), ref)
    cast = ref_ckpt.load_checkpoint(str(tmp_path), like=like)
    port_cast = load_checkpoint(str(tmp_path), like=tree_map(
        lambda x: torch.zeros(x.shape), port))
    for (_, g), w in zip(sorted_leaves(port_cast), jax.tree.leaves(cast)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_the_packages_write_byte_identical_files(tmp_path):
    ref, port = _trees(3)
    a = ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 11, ref)
    b = save_checkpoint(str(tmp_path / "port"), 11, port)
    assert os.path.basename(a) == os.path.basename(b)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "gemma3-12b",
                                  "nemotron-4-15b"])
def test_zoo_trees_round_trip_byte_identically(tmp_path, name):
    """A smoke config's parameters (the reference's, carried over) and an
    empty bf16 decode-cache tree (MLA's latent cache for DeepSeek): the
    two packages write the same bytes, and each reads the other's file
    back bit for bit."""
    pytest.importorskip("msgpack")
    pytest.importorskip("zstandard")
    ref_model = ref_build_model(ref_get_config(name).smoke())
    model = build_model(get_config(name).smoke())
    params = jax.jit(ref_model.init)(jax.random.key(3))
    ref = {"step": jnp.asarray(np.int32(5)), "params": params,
           "caches": ref_model.init_caches(1, 4, dtype=jnp.bfloat16)}
    port = {"step": torch.tensor(5, dtype=torch.int32),
            "params": flat_lib.params_from_numpy(jax.tree.map(np.asarray,
                                                              params)),
            "caches": model.init_caches(1, 4, dtype=torch.bfloat16,
                                        device="cpu")}
    _assert_same_bits(port, ref)
    a = ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 5, ref)
    b = save_checkpoint(str(tmp_path / "port"), 5, port)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    _assert_same_bits(load_checkpoint(str(tmp_path / "ref")), ref)
    _assert_same_bits(port, ref_ckpt.load_checkpoint(str(tmp_path / "port")))


def test_missing_codec_raises_the_reference_message(monkeypatch):
    monkeypatch.setattr(ref_ckpt, "zstandard", None)
    with pytest.raises(ModuleNotFoundError) as want:
        ref_ckpt._require_codecs()
    monkeypatch.setitem(sys.modules, "zstandard", None)  # import fails
    with pytest.raises(ModuleNotFoundError) as got:
        require_codecs()
    assert str(got.value) == str(want.value)
    assert "zstandard" in str(got.value)


def test_missing_codec_fails_before_the_first_step(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "zstandard", None)
    with pytest.raises(ModuleNotFoundError, match="zstandard"):
        port_train.train_loop(
            port_train.tiny_lm_config(64, 1, vocab=64), FedConfig(n_agents=3),
            steps=1, per_agent_batch=1, seq_len=8, log_every=0,
            device="cpu", ckpt_dir=str(tmp_path),
            draws=_NoDraws())
    assert not os.listdir(tmp_path)


class _NoDraws:
    """Draws that fail if anything is drawn: nothing may be built."""

    def __getattr__(self, name):
        raise AssertionError(f"train_loop drew ({name}) before failing")


def test_sweep_lattice_refuses_ckpt_dir_with_the_reference_message(
        tmp_path):
    kw = dict(steps=1, per_agent_batch=1, seq_len=8, log_every=0,
              sweep_runs=2, state_layout="flat", ckpt_dir=str(tmp_path))
    with pytest.raises(ValueError) as want:
        ref_train.train_loop(ref_train.tiny_lm_config(64, 1, vocab=64),
                             RefFedConfig(n_agents=3), **kw)
    with pytest.raises(ValueError) as got:
        port_train.train_loop(port_train.tiny_lm_config(64, 1, vocab=64),
                              FedConfig(n_agents=3), device="cpu", **kw)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# --ckpt-dir through both trainers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused,layout", [(True, "flat"), (False, "tree")])
def test_train_checkpoints_match_the_reference(tmp_path, fused, layout):
    """4 steps, H 2, ``ckpt_every`` 3: a fused run saves at 4 (a multiple
    of 3 falls in the round (2, 4]) and at the end, a per-step run at 3
    and 4; the same files, trees and steps from both packages."""
    seed, n = 1, 4
    fed = dict(n_agents=n, h=2, k=2, graph="ring2", gossip_impl="pallas")
    kw = dict(steps=4, per_agent_batch=BATCH, seq_len=SEQ, log_every=0,
              seed=seed, fused=fused, state_layout=layout, ckpt_every=3)
    ref_cfg = ref_train.tiny_lm_config(D_MODEL, LAYERS, vocab=VOCAB)
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref_train.train_loop(ref_cfg, RefFedConfig(**fed),
                         ckpt_dir=str(ref_dir), **kw)
    params0 = jax.jit(ref_build_model(ref_cfg).init)(jax.random.key(seed))
    draws = ReplayTrainDraws(seed, ref_make_data(VOCAB, n, SEQ, alpha=0.3,
                                                 seed=seed))
    port_train.train_loop(
        port_train.tiny_lm_config(D_MODEL, LAYERS, vocab=VOCAB),
        FedConfig(**fed), ckpt_dir=str(port_dir), device="cpu", draws=draws,
        params0=flat_lib.params_from_numpy(jax.tree.map(np.asarray,
                                                        params0)), **kw)
    files = sorted(os.listdir(ref_dir))
    assert files == sorted(os.listdir(port_dir))
    assert files == (["ckpt_4.msgpack.zst"] if fused else
                     ["ckpt_3.msgpack.zst", "ckpt_4.msgpack.zst"])
    for step in (3, 4) if not fused else (4,):
        want = ref_ckpt.load_checkpoint(str(ref_dir), step)
        got = load_checkpoint(str(port_dir), step)
        assert got["step"].dtype == torch.int32 and got["step"].shape == ()
        assert int(got["step"]) == int(want["step"]) == step + 1
        ref_leaves = list(sorted_leaves(want["params"]))
        got_leaves = list(sorted_leaves(got["params"]))
        assert [p for p, _ in got_leaves] == [p for p, _ in ref_leaves]
        atol = 1e-5 * max(np.abs(w).max() for _, w in ref_leaves)
        for (path, g), (_, w) in zip(got_leaves, ref_leaves):
            assert g.dtype == torch.float32 and w.dtype == np.float32
            assert tuple(g.shape) == w.shape and w.shape[0] == n, path
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=atol,
                                       err_msg=str(path))


def test_cli_saves_at_the_end(tmp_path, capsys):
    port_train.main(["--device", "cpu", "--steps", "3", "--agents", "3",
                     "--batch", "1", "--seq", "8", "--d-model", "64",
                     "--layers", "1", "--vocab", "64", "--h", "2",
                     "--ckpt-dir", str(tmp_path)])
    assert "[train] done: loss " in capsys.readouterr().out
    assert os.listdir(tmp_path) == ["ckpt_3.msgpack.zst"]
    tree = load_checkpoint(str(tmp_path))
    assert int(tree["step"]) == 4
    assert tree["params"]["embed"]["table"].shape == (3, 64, 64)
