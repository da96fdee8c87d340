"""The model families of the port (counterpart of ``repro.models``): dense,
MoE, SSM, hybrid and VLM decoder-only LMs and the Whisper-style
encoder-decoder, as ``nn.Module``s."""

from repro_torch.models.model import ModelApi, build_model, input_specs

__all__ = ["ModelApi", "build_model", "input_specs"]
