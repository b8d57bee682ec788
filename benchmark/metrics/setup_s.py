"""End to end: process start to the start of the window: imports, CUDA
start-up, kernel load (or first build), scene parse, acceleration
structure and device tables, and the warm-up of the cell's shapes (host
clock)."""


def read(rec):
    return rec["setup_s"]
