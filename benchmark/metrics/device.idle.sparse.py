"""device.idle.sparse: device.idle.train's reading in the sparse training cell, under a name of its
own so that it moves the sparse cell's own end-to-end metric, whose bound
follows that cell's host noise (PERF.md §2)."""

from pathlib import Path

from harness.spec import module

read = module(Path(__file__).resolve().parents[2], "metrics", "device.idle.train").read
