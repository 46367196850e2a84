"""The port's models: the dense LM (GQA or MLA attention, a dense MLP or
an MoE), Griffin and Mamba2 stacks."""

from repro_torch.models.model import Model, build_model

__all__ = ["Model", "build_model"]
