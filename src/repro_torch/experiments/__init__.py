"""The paper's §4 experiments on the port's float64 sweep lattice.

Each driver runs as ``python -m repro_torch.experiments.<name>`` on the
card (``--device cpu`` for the CPU), prints its claim checks as ``# ...
PASS|FAIL`` lines and one ``name,us_per_call,derived`` line, and writes
its CSV under results/torch/.
"""
