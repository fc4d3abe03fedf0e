"""Metrics of the port: the JAX package's host metrics, and the device
metrics of ``-device-metrics`` in PyTorch (``metrics/device.py``)."""
