"""Launchers of the port (counterpart of ``repro.launch``); the serving
launcher is :mod:`repro_torch.launch.serve`."""
