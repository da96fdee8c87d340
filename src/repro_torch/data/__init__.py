"""Data pipeline of the port (counterpart of ``repro.data``)."""

from repro_torch.data.pipeline import DataConfig, batches, document_stream, pack_documents

__all__ = ["DataConfig", "batches", "document_stream", "pack_documents"]
