"""Batched sweeps: policies as tensors, grids of cells, and the PIAG
runner that advances every cell of a bucket with one kernel launch per
event (counterpart of ``repro.sweep``)."""
