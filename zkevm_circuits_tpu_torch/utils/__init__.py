"""Utilities of the port: circuit-shape statistics and phase timers."""
