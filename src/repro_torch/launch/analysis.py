"""Analytic cost models of the port (repro/launch/analysis.py, in part).

Only the population engine's bytes-a-round model so far; the rest of the
reference's analysis module (the gossip, sweep, compression and delta
models, the roofline and collective parsing) is still to be ported.
Plain arithmetic on shapes, equal to the reference's.
"""

from __future__ import annotations

__all__ = ["H2D_BW", "population_cost_model"]

#: Host↔device bytes/s of the population stream: the reference's nominal
#: PCIe-class constant (repro/launch/analysis.py:37), kept so that the
#: models agree.  It is not a number measured on the H100's machine:
#: ``chip_smoke.py`` phase 4e measures the card's pinned and pageable
#: rates beside it.
H2D_BW = 16e9


def population_cost_model(*, n_total: int, cohort_size: int, d: int,
                          max_degree: int, h: int, param_bytes: int = 4,
                          idx_bytes: int = 4, counter_bytes: int = 8,
                          h2d_bw: float = H2D_BW) -> dict:
    """Bytes-a-round model of the population engine
    (repro/launch/analysis.py:412-455).

    The (n_total, D) store is on the host and one cohort is streamed a
    round, so every device-side term depends on the cohort only:

      * ``host_store_bytes``: n_total·(D·b + counter_bytes), the memmap
        rows and each agent's last-participation counter (host only);
      * ``upload_bytes_round`` / ``writeback_bytes_round``: cohort·D·b
        each, ``hostdev_bytes_round`` their sum;
      * ``subgraph_edge_bytes_round``: the cohort's ELL tables,
        cohort·max_degree·(idx + param bytes) + cohort·(diag + cluster);
      * ``peak_device_bytes``: two cohort buffers in flight and two sets
        of tables, 2·(cohort·D·b) + 2·edge tables, with no n_total term;
      * ``transfer_us_round``: hostdev_bytes_round / h2d_bw, the
        synchronous transfer time that the overlap can hide.
    """
    row_bytes = float(cohort_size * d * param_bytes)
    edge_bytes = float(cohort_size * max_degree * (idx_bytes + param_bytes)
                       + cohort_size * (param_bytes + idx_bytes))
    hostdev = 2.0 * row_bytes
    return {
        "n_total": int(n_total),
        "cohort_size": int(cohort_size),
        "d": int(d),
        "max_degree": int(max_degree),
        "steps_per_round": int(h),
        "host_store_bytes": float(n_total * (d * param_bytes
                                             + counter_bytes)),
        "upload_bytes_round": row_bytes,
        "writeback_bytes_round": row_bytes,
        "hostdev_bytes_round": hostdev,
        "subgraph_edge_bytes_round": edge_bytes,
        "peak_device_bytes": 2.0 * row_bytes + 2.0 * edge_bytes,
        "transfer_us_round": hostdev / h2d_bw * 1e6,
    }
