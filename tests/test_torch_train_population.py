"""Population mode (``--n-total``): ``population_loop`` against the
reference's on 16 agents, cohorts of 4, under its replayed cohort tokens
and server draws (losses 1e-5 relative, the store 1e-5·max|x|, the
staleness counters equal), the CLI on the CPU (overlap and sync, the
stale sampler with two clusters, ``--delta full``, the store saved by
``--ckpt-dir``), and its refusals with the reference's messages (the
helpers in tests/_torch_train_common.py).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

from repro.configs.base import FedConfig as RefFedConfig
from repro.data.federated_lm import make_federated_lm as ref_make_data
from repro.launch import train as ref_train
from repro.models import build_model as ref_build_model
from repro_torch.configs.base import FedConfig
from repro_torch.core import flat as flat_lib
from repro_torch.launch import train as port_train
from _torch_train_common import (D_MODEL, H, K, N, POP, POP_ARGV,
                                 ReplayPopulationDraws)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("extra", [
    dict(),
    dict(sampling="stale", staleness=0.5, n_clusters=2)])
def test_population_loop_matches_the_reference(extra):
    seed = 0
    fed = dict(n_agents=N, h=H, k=K, graph="ring2")
    ref_cfg = ref_train.tiny_lm_config(D_MODEL, 1, vocab=64)
    ref_store, ref_losses = ref_train.population_loop(
        ref_cfg, RefFedConfig(**fed), seed=seed, **POP, **extra)
    params0 = jax.jit(ref_build_model(ref_cfg).init)(jax.random.key(seed))
    draws = ReplayPopulationDraws(
        seed, ref_make_data(64, POP["n_total"], POP["seq_len"], alpha=0.3,
                            seed=seed))
    store, losses = port_train.population_loop(
        port_train.tiny_lm_config(D_MODEL, 1, vocab=64), FedConfig(**fed),
        seed=seed, device="cpu", draws=draws,
        params0=flat_lib.params_from_numpy(jax.tree.map(np.asarray,
                                                        params0)),
        **POP, **extra)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    got = store.gather(np.arange(POP["n_total"]))
    want = ref_store.gather(np.arange(POP["n_total"]))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(store.last_round, ref_store.last_round)




@pytest.mark.parametrize("extra", [[], ["--no-overlap"],
                                   ["--sampling", "stale", "--staleness",
                                    "0.5", "--n-clusters", "2"],
                                   ["--delta", "full"]])
def test_cli_population_runs_on_cpu(capsys, extra, tmp_path):
    from repro_torch.core.population import PopulationStore
    port_train.main([*POP_ARGV, *extra, "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[train] population: " in out and "n_total=16 (cohort 4" in out
    assert "[train] population: 4 steps in 2 rounds" in out
    assert "[train] done: loss" in out
    if extra == ["--delta", "full"]:
        assert "delta=full" in out
        assert any(p.startswith("deltapop_") for p in
                   (x.name for x in tmp_path.iterdir()))
    else:
        back = PopulationStore.restore(str(tmp_path))
        assert back.rows.shape[0] == 16 and np.isfinite(back.rows).all()
        assert (back.last_round >= 0).sum() >= 4




def test_cli_population_overlap_and_sync_print_the_same_losses(capsys):
    lines = []
    for extra in ([], ["--no-overlap"]):
        port_train.main([*POP_ARGV, *extra])
        lines.append([line for line in capsys.readouterr().out.splitlines()
                      if line.startswith("[train] done:")])
    assert lines[0] == lines[1] and lines[0]




@pytest.mark.parametrize("extra", [
    ["--sweep-runs", "2"], ["--fuse-update-mix"], ["--optimizer", "momentum"],
    ["--fedavg"], ["--per-step"]])
def test_cli_population_refusals_are_the_reference_messages(extra,
                                                             monkeypatch):
    argv = POP_ARGV[2:] + extra       # the reference's CLI has no --device
    monkeypatch.setattr("sys.argv", ["train", *argv])
    with pytest.raises(SystemExit) as ref_err:
        ref_train.main()
    with pytest.raises(SystemExit) as err:
        port_train.main(["--device", "cpu", *argv])
    assert str(err.value) == str(ref_err.value)
    assert str(err.value).startswith("population mode (--n-total) does "
                                     "not compose with")




@pytest.mark.parametrize("kw", [dict(steps=3), dict(gossip_compress="int8"),
                                dict(graph="geo0.5")])
def test_population_loop_errors_are_the_reference_messages(kw):
    fed = dict(n_agents=N, h=H, k=K, graph=kw.pop("graph", "ring2"),
               gossip_compress=kw.pop("gossip_compress", "none"))
    pop_kw = {**POP, **kw}
    with pytest.raises(ValueError) as ref_err:
        ref_train.population_loop(ref_train.tiny_lm_config(D_MODEL, 1,
                                                           vocab=64),
                                  RefFedConfig(**fed), **pop_kw)
    with pytest.raises(ValueError) as err:
        port_train.population_loop(port_train.tiny_lm_config(D_MODEL, 1,
                                                             vocab=64),
                                   FedConfig(**fed), device="cpu", **pop_kw)
    assert str(err.value) == str(ref_err.value)
