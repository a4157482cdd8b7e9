"""Synthetic data made on the device from a seed."""
