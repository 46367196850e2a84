"""Mistral-Large-123B's and DeepSeek-V3-671B's bf16 parameters through the
trainers, against the JAX package's.

The full configs keep bf16 weights (their smoke variants f32, as the
reference's smoke() gives them): here the smoke configs with bf16
parameters and compute on both sides train through the flat engine's
fused update, whose plain version (kernels/ref.py:_local_step_bf16)
rounds as the reference's Pallas kernel does under XLA; and both
training CLIs print the same header for the two ids.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.launch import train as ref_train
from repro_torch.launch import train as port_train
from repro_torch.tree import leaves
from test_torch_train import _ref_and_port, _ref_smoke


# the bf16 smoke runs against the reference: measured, the losses 2.5e-4
# (Mistral-Large) and 1.3e-4 (DeepSeek-V3) apart relative, the final
# buffers 1.95e-3 and 6.9e-4 × max|x| (about 0.5% of the elements one bf16
# step or more apart); held to about 4× those
BF16_LOSS_RTOL = 1e-3
BF16_FLAT_TOL = 2.0 ** -7


@pytest.mark.parametrize("arch,layers", [("mistral-large-123b", 2),
                                         ("deepseek-v3-671b", 1)])
def test_bf16_smoke_fused_sgd_matches_reference(arch, layers, monkeypatch):
    """The smoke config with bf16 parameters on both sides (the full
    configs' param dtype; smoke() gives f32) through the flat engine's
    fused sgd (kernel #3's plain version, the reference's update_mix_pallas
    in interpret mode), 2 steps on 2 agents with bf16 compute: the flat
    buffer is bf16 on both sides, the losses agree within BF16_LOSS_RTOL
    and the final buffers within BF16_FLAT_TOL·max|x|.  The bf16 forward
    and backward round otherwise in the two frameworks, so the gradients
    differ in the last bf16 bits; the fused step rounds alike.
    DeepSeek-V3 keeps its one dense layer, as the card's path (M2) keeps
    its three: an MoE layer's f32 router makes the buffer f32 (the
    promotion of the leaves' dtypes, in the reference as here).  The
    reference's interpret-mode kernel takes D in tiles of 2^18 (one
    column's arithmetic does not depend on the tile)."""
    import dataclasses

    import jax.numpy as jnp

    from repro_torch.configs import get_config
    monkeypatch.setenv("REPRO_BLOCK_D", str(1 << 18))
    fed = dict(n_agents=2, h=2, k=2, graph="ring2", gossip_impl="pallas")
    bf16 = dict(param_dtype=jnp.bfloat16, compute_dtype=jnp.bfloat16,
                num_layers=layers)
    port_cfg = dataclasses.replace(get_config(arch).smoke(),
                                   param_dtype=torch.bfloat16,
                                   compute_dtype=torch.bfloat16,
                                   num_layers=layers)
    (ref_state, ref_losses), (state, losses) = _ref_and_port(
        fed, 7, ref_cfg=_ref_smoke(arch, **bf16), port_cfg=port_cfg,
        steps=2, fused=True, state_layout="flat", fuse_update_mix=True)
    assert len(losses) == len(ref_losses) == 2
    np.testing.assert_allclose(losses, ref_losses, rtol=BF16_LOSS_RTOL)
    assert all(p.dtype == torch.bfloat16 for p in leaves(state.params)
               if p.ndim > 1)
    want = np.concatenate([np.asarray(r, np.float32).reshape(2, -1)
                           for r in jax.tree.leaves(ref_state.params)], 1)
    got = np.concatenate([p.float().numpy().reshape(2, -1)
                          for p in leaves(state.params)], 1)
    assert np.abs(got - want).max() <= BF16_FLAT_TOL * np.abs(want).max()


@pytest.mark.parametrize("arch,agents", [("mistral-large-123b", 4),
                                         ("deepseek-v3-671b", 1)])
def test_cli_smoke_header_is_the_reference_header(capsys, monkeypatch, arch,
                                                  agents):
    """--arch mistral-large-123b and deepseek-v3-671b --smoke through both
    training CLIs, each given --agents 2, print the same header line (the
    port's adds ', device=cpu').  Both train the replicated layout's agent
    count whatever --agents says, 4 and 1 (sharding.n_agents_for,
    repro/sharding/__init__.py:60-68)."""
    argv = ["--steps", "2", "--agents", "2", "--batch", "1", "--seq",
            "16", "--h", "2", "--arch", arch, "--smoke"]
    monkeypatch.setattr("sys.argv", ["train", *argv])
    ref_train.main()
    ref_out = capsys.readouterr().out.splitlines()
    port_train.main(["--device", "cpu", *argv])
    out = capsys.readouterr().out.splitlines()
    header = next(line for line in out if line.startswith(f"[train] {arch}"))
    assert header == next(line for line in ref_out if line.startswith(
        f"[train] {arch}")) + ", device=cpu"
    assert f" params × {agents} agents, " in header
    assert out[-1].startswith("[train] done: loss ")
    assert ref_out[-1].startswith("[train] done: loss ")
