"""Checkpointing: msgpack + zstd tree save/restore, and chunked
population-store snapshots (raw .bin, streamed in row chunks)."""

from repro_torch.checkpoint.checkpoint import (latest_population_step,
                                               latest_step, load_checkpoint,
                                               load_population,
                                               require_codecs,
                                               save_checkpoint,
                                               save_population)

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step",
           "save_population", "load_population", "latest_population_step",
           "require_codecs"]
