"""Entries, one module per kind of cell, found by the `entry` of a
workload file: `setup`, `window`, `traced` and `check`."""
