"""Validation runs of the PyTorch port that need more than one process
(counterpart of ``repro.testing``)."""
