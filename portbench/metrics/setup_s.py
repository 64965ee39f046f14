"""Seconds from the start of the process to the window's opening: torch's
import, the weights drawn on the device, the engine's AMAT quantization,
the kernels' build or load, and the warm-up steps of the cell's own
traffic."""


def read(run):
    return run.setup_s
