"""The zoo configs through the trainers: the smoke variants of
RecurrentGemma-9B, Mamba2-2.7B, DeepSeek-V2-Lite-16B, Mistral-Large-123B
and DeepSeek-V3-671B against the reference's train_loop (impl 'xla', 2
steps, losses within 1e-4 relative, on the tree and the flat engine),
and the agent-count rule of every config against the reference's
``build_fed_setup`` (the helpers in tests/_torch_train_common.py).
"""

from __future__ import annotations

import numpy as np
import pytest

from repro.configs.base import FedConfig as RefFedConfig
from repro.launch import train as ref_train
from repro.sharding import MeshAxes as RefMeshAxes
from repro_torch.configs.base import FedConfig
from repro_torch.core import feddec
from repro_torch.launch import train as port_train
from _torch_train_common import _ref_and_port, _ref_smoke
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("arch,layout,fused", [
    ("recurrentgemma-9b", "tree", False), ("mamba2-2.7b", "flat", True),
    ("deepseek-v2-lite-16b", "flat", True),
    ("mistral-large-123b", "flat", True), ("deepseek-v3-671b", "tree",
                                           False)])
def test_zoo_smoke_train_loop_matches_reference_losses(arch, layout, fused):
    """The zoo configs' smoke variants train through both trainers (impl
    'xla'), on the tree and the flat engine: 2 steps, losses within 1e-4
    relative (DeepSeek-V2-Lite's and DeepSeek-V3's with the MoE aux term,
    their MoE under the engine's vmap over the agents)."""
    from repro_torch.configs import get_config
    fed = dict(n_agents=2, h=2, k=2, graph="ring2", gossip_impl="pallas")
    (_, ref_losses), (state, losses) = _ref_and_port(
        fed, 7, ref_cfg=_ref_smoke(arch),
        port_cfg=get_config(arch).smoke(), steps=2, fused=fused,
        state_layout=layout)
    assert len(losses) == len(ref_losses) == 2
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    assert isinstance(state, feddec.FedState) and state.step == 3




@pytest.mark.parametrize("arch,agents", [
    (a, n) for a in ("tiny", "recurrentgemma-9b", "mamba2-2.7b",
                     "qwen1.5-4b", "gemma3-12b", "nemotron-4-15b",
                     "deepseek-v2-lite-16b", "qwen2-vl-2b",
                     "seamless-m4t-large-v2", "mistral-large-123b",
                     "deepseek-v3-671b") for n in (2, 8)])
def test_build_fed_setup_counts_the_reference_agents(arch, agents):
    """The trainers' agent-count rule (repro/launch/steps.py:56-84): given
    the same --agents, both build the same federation: the layout's agent
    count (--agents for 'sharded', 4 for Mistral-Large-123B and 1 for
    DeepSeek-V3-671B, 'replicated'), the same graph and the same K."""
    from repro.configs import get_config as ref_get_config
    from repro.launch.steps import build_fed_setup as ref_build_fed_setup
    from repro_torch.configs import get_config
    if arch == "tiny":
        ref_cfg = ref_train.tiny_lm_config()
        cfg = port_train.tiny_lm_config()
    else:
        ref_cfg, cfg = ref_get_config(arch), get_config(arch)
    assert (cfg.fed_agent_layout, cfg.fed_n_agents_replicated) == \
        (ref_cfg.fed_agent_layout, ref_cfg.fed_n_agents_replicated)
    fed = dict(n_agents=agents, h=2, k=2, graph="ring2")
    ref_fcfg, ref_n = ref_build_fed_setup(
        ref_cfg, RefMeshAxes(("data",), "model", {"data": agents,
                                                  "model": 1}),
        RefFedConfig(**fed))
    port_fed = FedConfig(**fed)
    fcfg, n = port_train.build_fed_setup(cfg, port_train.fed_axes(port_fed),
                                         port_fed)
    assert n == ref_n == {"mistral-large-123b": 4,
                          "deepseek-v3-671b": 1}.get(arch, agents)
    assert fcfg.k == ref_fcfg.k
    np.testing.assert_array_equal(fcfg.mixing.graph.adjacency,
                                  np.asarray(ref_fcfg.mixing.graph.adjacency))
