"""The training CLI (``repro_torch.launch.train.main``) on the CPU: the
reference's header and done lines, every codec path under each impl and
executor, identity printing the uncompressed lines, no codec without an
exchange, the sweep lattice and the compressed lattice, and the
refusals and sweep errors with the reference's messages (small runs:
d_model 64, 1 layer, vocab 64, 3 agents; the helpers in
tests/_torch_train_common.py).
"""

from __future__ import annotations

import pytest

from repro.configs.base import FedConfig as RefFedConfig
from repro.launch import train as ref_train
from repro_torch.launch import serve as port_serve
from repro_torch.launch import train as port_train
from _torch_train_common import _cli_lines
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


def test_cli_runs_on_cpu_and_prints_the_reference_lines(capsys):
    port_train.main(["--device", "cpu", "--steps", "2", "--agents", "3",
                     "--batch", "1", "--seq", "8", "--d-model", "64",
                     "--layers", "1", "--vocab", "64", "--h", "2",
                     "--gossip-impl", "pallas", "--fuse-update-mix"])
    out = capsys.readouterr().out
    assert "[train] tiny-lm: " in out and "gossip=pallas" in out
    assert "fused-update-mix" in out and "[train] done: loss " in out




@pytest.mark.parametrize("codec", ["identity", "bf16", "int8", "topk:0.25"])
@pytest.mark.parametrize("impl", ["dense", "pallas", "sparse"])
@pytest.mark.parametrize("executor", [["--fuse-update-mix"], ["--per-step"]],
                         ids=["fused-update-mix", "per-step"])
def test_cli_runs_every_codec_path_on_cpu(capsys, codec, impl, executor):
    out = _cli_lines(capsys, ["--gossip-impl", impl, "--gossip-compress",
                              codec, *executor])
    header = next(line for line in out if line.startswith("[train] tiny"))
    assert f"gossip={impl}" in header
    assert f", compress={codec}, device=cpu" in header
    assert out[-1].startswith("[train] done: loss ")




@pytest.mark.parametrize("impl", ["dense", "pallas", "sparse"])
def test_cli_identity_prints_the_uncompressed_done_line(capsys, impl):
    plain = _cli_lines(capsys, ["--gossip-impl", impl])
    ident = _cli_lines(capsys, ["--gossip-impl", impl, "--gossip-compress",
                                "identity"])
    assert ident[-1] == plain[-1] and ident[-1].startswith("[train] done:")




@pytest.mark.parametrize("argv", [["--fedavg"], ["--gossip-impl", "none"]])
def test_cli_no_exchange_means_no_codec(capsys, argv):
    """--fedavg and --gossip-impl none exchange nothing: no codec runs and
    the header names none (repro/launch/train.py:171-172)."""
    out = _cli_lines(capsys, [*argv, "--gossip-compress", "int8"])
    assert not any("compress=" in line for line in out)
    assert out[-1].startswith("[train] done: loss ")




def test_cli_runs_a_sweep_lattice_on_cpu(capsys):
    port_train.main(["--device", "cpu", "--steps", "2", "--agents", "3",
                     "--batch", "1", "--seq", "8", "--d-model", "64",
                     "--layers", "1", "--vocab", "64", "--h", "1",
                     "--gossip-impl", "pallas", "--sweep-runs", "2",
                     "--sweep-axis", "h"])
    out = capsys.readouterr().out
    assert "(sweep lattice R=2 axis=h)" in out
    assert "[train] sweep finals (last-step loss per run): r0=" in out
    assert ", r1=" in out and "[train] done: loss " in out




@pytest.mark.parametrize("codec,impl,argv", [
    ("int8", "pallas", ["--sweep-axis", "seed", "--fuse-update-mix",
                        "--optimizer", "momentum"]),
    ("topk:0.25", "sparse", ["--sweep-axis", "h"]),
    ("bf16", "dense", ["--sweep-axis", "h", "--fuse-update-mix"]),
    ("int8", "sparse", ["--sweep-axis", "seed", "--fedavg"])])
def test_cli_trains_a_compressed_sweep_lattice_on_cpu(capsys, codec, impl,
                                                      argv):
    """--sweep-runs with --gossip-compress: the header names the lattice
    and the codec (none under --fedavg: nothing is exchanged), and the
    per-run finals are printed."""
    out = _cli_lines(capsys, ["--gossip-impl", impl, "--sweep-runs", "2",
                              "--gossip-compress", codec, *argv])
    header = next(line for line in out if line.startswith("[train] tiny"))
    assert "(sweep lattice R=2 axis=" in header
    if "--fedavg" in argv:
        assert "compress=" not in header
    else:
        assert f", compress={codec}, device=cpu" in header
    finals = next(line for line in out if line.startswith(
        "[train] sweep finals (last-step loss per run): r0="))
    assert ", r1=" in finals and out[-1].startswith("[train] done: loss ")




def test_cli_identity_lattice_prints_the_uncompressed_lines(capsys):
    sweep_argv = ["--gossip-impl", "pallas", "--sweep-runs", "2",
                  "--sweep-axis", "h"]
    plain = _cli_lines(capsys, sweep_argv)
    ident = _cli_lines(capsys, sweep_argv + ["--gossip-compress",
                                             "identity"])
    assert ident[-2:] == plain[-2:]
    assert ident[-2].startswith("[train] sweep finals")




@pytest.mark.parametrize("case", ["per-step", "topology-ring2", "tree"])
def test_cli_sweep_errors_are_the_reference_messages(case):
    small = ["--steps", "1", "--agents", "3", "--batch", "1", "--seq", "8",
             "--d-model", "64", "--layers", "1", "--vocab", "64",
             "--sweep-runs", "2"]
    extra, ref_kw = {
        "per-step": (["--per-step"], dict(fused=False)),
        "topology-ring2": (["--sweep-axis", "topology"],
                           dict(sweep_axis="topology")),
        "tree": (["--state-layout", "tree"], dict(state_layout="tree")),
    }[case]
    ref_kw = {"state_layout": "flat", "fused": True, **ref_kw}
    with pytest.raises(ValueError) as ref_err:
        ref_train.train_loop(ref_train.tiny_lm_config(64, 1, vocab=64),
                             RefFedConfig(n_agents=3, h=10, k=2,
                                          graph="ring2"),
                             steps=1, per_agent_batch=1, seq_len=8,
                             log_every=0, sweep_runs=2, **ref_kw)
    with pytest.raises(ValueError) as err:
        port_train.main(["--device", "cpu", *small, *extra])
    assert str(err.value) == str(ref_err.value)




@pytest.mark.parametrize("argv", [
    ["--mesh-agents", "2"], ["--mesh-model", "2"],
    ["--n-total", "64", "--ckpt-dir", "c", "--mesh-agents", "2"],
    ["--delta", "topk:4", "--n-total", "64", "--mesh-model", "2"],
    ["--mesh-agents", "2", "--mesh-model", "2"]])
def test_cli_rejects_what_is_not_ported(argv, capsys):
    """--delta, --ckpt-dir, --n-total, --mesh-agents and --mesh-model are
    ported; the CLI refuses what the reference refuses with them.
    --mesh-model without --mesh-agents is the reference's ValueError, and
    population mode composes with neither mesh flag
    (repro/launch/train.py:127-131, 568-579).  Without torchrun the world
    is one rank, which --mesh-agents 2 (and with --mesh-model 2, its 4
    ranks) refuses."""
    if argv == ["--mesh-model", "2"]:
        with pytest.raises(ValueError) as ref_err:
            ref_train.train_loop(ref_train.tiny_lm_config(64, 1, vocab=64),
                                 RefFedConfig(n_agents=4, h=2, k=2),
                                 steps=1, per_agent_batch=1, seq_len=8,
                                 mesh_model=2)
        with pytest.raises(ValueError) as err:
            port_train.main(["--device", "cpu", *argv])
        assert str(err.value) == str(ref_err.value)
        return
    with pytest.raises(SystemExit) as err:
        port_train.main(["--device", "cpu", *argv])
    if "--n-total" in argv:
        flag = "--mesh-model" if "--mesh-model" in argv else "--mesh-agents"
        assert err.value.code == ("population mode (--n-total) does not "
                                  f"compose with {flag}")
    elif "--mesh-model" in argv:
        assert err.value.code == 2
        assert "--mesh-agents 2 --mesh-model 2 needs 4 ranks, one process " \
            "a rank, but this world has 1" in capsys.readouterr().err
    else:
        assert err.value.code == 2
        assert "--mesh-agents 2 needs 2 ranks, one process a rank, but " \
            "this world has 1" in capsys.readouterr().err




@pytest.mark.parametrize("cli,argv", [
    (port_train, ["--n-total", "64", "--arch", "llama-9"]),
    (port_train, ["--arch", "mistral-large"]),
    (port_serve, ["--arch", "deepseek-v3"])])
def test_clis_refuse_an_unknown_arch(cli, argv, capsys):
    """Every id of the reference's registry is ported (Mistral-Large-123B
    and DeepSeek-V3-671B last): an unknown id exits 2 before anything
    runs, naming the ids there are, and nothing as not ported yet."""
    with pytest.raises(SystemExit) as err:
        cli.main(["--device", "cpu", *argv])
    assert err.value.code == 2
    err = capsys.readouterr().err
    assert f"unknown --arch {argv[-1]!r}; choose from tiny, " in err
    assert "mistral-large-123b, deepseek-v3-671b" in err
    assert "not yet" not in err




@pytest.mark.parametrize("argv", [
    ["--arch", "qwen2-vl-2b"], ["--arch", "seamless-m4t-large-v2", "--smoke"],
    ["--arch", "qwen2-vl-2b", "--smoke", "--n-total", "64"]])
def test_cli_refuses_the_models_the_reference_cli_cannot_train(argv,
                                                                capsys):
    """The reference's train_loop fails on Qwen2-VL-2B and
    SeamlessM4T-Large-v2 at its first step: its batches carry only tokens
    and positions (no mrope_positions, repro/models/attention.py:219; no
    enc_embeds, repro/models/transformer.py:353).  The port's CLI refuses
    them with exit 2 and says why, before it allocates anything; both
    train through the engine API (tests/test_torch_multimodal.py)."""
    with pytest.raises(SystemExit) as err:
        port_train.main(["--device", "cpu", *argv])
    assert err.value.code == 2
    err = capsys.readouterr().err
    arch = argv[1]
    assert f"--arch {arch} is not trained by this CLI" in err
    assert "train_loop fails on it at its first step" in err
    assert ("mrope_positions" if arch == "qwen2-vl-2b"
            else "enc_embeds") in err
