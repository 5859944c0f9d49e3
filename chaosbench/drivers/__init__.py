"""Drivers: one per kind of traffic mix (a mix names its ``driver``)."""
